"""graftrank rules GR001–GR005: cross-rank divergence and deadlock.

The port's copy of the JAX package's ``analysis/rank.py``, its
vocabulary widened to ``torch.distributed`` (``dist.get_rank()``, the
c10d collectives and point-to-point calls) and to the port's own
collective helpers (``parallel/collectives.py``: ``axis_sum``,
``ring_hop``, ``start_permute``, ...). The store and barrier attributes
and the rules' logic are the JAX module's.

graftlint's GL rules audit one program; these audit the *relationship
between* the N copies of that program an elastic multi-process run
executes. The failure mode is always the same: rank r takes a code path
the other ranks don't, the collective/barrier schedules diverge, and the
job hangs until the watchdog converts the hang into a process loss.

The shared substrate is **rank taint**: a value is rank-tainted when it
is derived from something that differs per process — ``rank`` /
``process_index()`` / coordinator flags, heartbeat and death-note reads,
or ``os.environ`` — propagated through assignments, expressions, and
returns of module-local functions.

========  ===========================  =====================================
rule      name                         what it catches
========  ===========================  =====================================
GR001     rank-divergent-collective    rank-tainted ``if`` guarding a
                                       collective / store barrier /
                                       ``append_event`` on one side only
GR002     conditional-barrier-skip     early ``return``/``raise`` edges that
                                       skip a store barrier some ranks reach
GR003     blocking-io-under-lock       collectives or blocking store I/O
                                       invoked while holding a
                                       ``threading.Lock``
GR004     wall-clock-cross-rank        ``time.time()`` in heartbeat-age or
                                       cross-rank ordering math where the
                                       monotonic stamps exist
GR005     unlocked-shared-mutation     mutating state a background thread
                                       reads, outside the lock that
                                       otherwise guards it
========  ===========================  =====================================

Like the GL rules, every heuristic errs toward silence; intended
divergence (chaos fault targeting, coordinator-only event writes) is
suppressed inline with a reason.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.context import (
    PORT,
    ModuleContext,
    assigned_names,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.core import Finding

__all__ = ["RANK_RULES"]

#: identifiers that ARE a per-process value wherever they appear
_RANK_NAME_RE = re.compile(
    r"^((global_|local_|proc(ess)?_)?rank\d*|process_id|proc_id|"
    r"(is_)?coordinator|is_leader|leader_rank|process_index)$"
)

#: resolved dotted calls whose result differs per process
_RANK_CALLS = {
    "jax.process_index",
    "jax.lax.axis_index",
    "jax.axis_index",
    "torch.distributed.get_rank",
    "torch.distributed.get_global_rank",
    "torch.distributed.get_group_rank",
    "torch.distributed.get_node_local_rank",
    "get_global_rank",
    "os.getenv",
    "os.environ.get",
}

#: store/membership reads that reflect per-run, per-process liveness state
_MEMBERSHIP_ATTR_RE = re.compile(r"heartbeat|death|dead|alive_ranks")

#: jax/torch collective call names (last dotted component), and the
#: port's collective helpers
_COLLECTIVE_NAMES = {
    # torch.distributed
    "all_reduce_sum",
    "all_gather_into_tensor",
    "all_gather_object",
    "reduce_scatter_tensor",
    "all_to_all_single",
    "broadcast",
    "broadcast_object_list",
    "gather",
    "scatter",
    "reduce",
    "send",
    "recv",
    "isend",
    "irecv",
    "batch_isend_irecv",
    # the port's helpers (parallel/collectives.py)
    "all_reduce_mean",
    "gather_scatter_mean",
    "star_mean",
    "ring_hop",
    "ring_all_reduce_rows",
    "ring_all_reduce",
    "ring_all_reduce_mean",
    "reduce_scatter_sum",
    "all_gather_flat",
    "axis_sum",
    "axis_mean",
    "reduce_by_axes",
    "start_permute",
    "axis_gather_rows",
    "broadcast_host",
    "psum",
    "pmean",
    "pmax",
    "pmin",
    "all_gather",
    "all_to_all",
    "ppermute",
    "pshuffle",
    "psum_scatter",
    "reduce_scatter",
    "all_reduce",
    "pbroadcast",
    "broadcast_one_to_all",
    "process_allgather",
    "sync_global_devices",
}

#: packages whose calls of a ``_COLLECTIVE_NAMES`` name are collectives
_COLLECTIVE_ROOTS = ("jax", "torch", PORT)

#: rendezvous-store methods that every rank of a generation must reach
_BARRIER_ATTRS = {"barrier", "barrier_stamp", "wait_at_barrier"}

#: store methods that are cross-rank-visible I/O (divergence observable)
_STORE_EVENT_ATTRS = {"append_event"}

#: store/thread calls that can block indefinitely on a peer or on disk
_BLOCKING_ATTRS = _BARRIER_ATTRS | _STORE_EVENT_ATTRS | {"heartbeat"}

#: lock-looking context-manager identifiers (``self._lock``, ``_IO_LOCK``)
_LOCK_NAME_RE = re.compile(r"(?i)(^|_)(r?lock|mutex)$|lock$")

#: thread-safe containers whose methods need no external lock
_THREADSAFE_CTORS = {
    "threading.Event",
    "threading.Condition",
    "threading.Semaphore",
    "threading.BoundedSemaphore",
    "queue.Queue",
    "queue.SimpleQueue",
    "collections.deque",
}

#: context tokens that mark age/ordering math over per-rank timestamps
_AGE_TOKEN_RE = re.compile(
    r"(?i)heartbeat|\bhb\b|beat|death|dead|\bage\b|last_seen|\bseen\b"
    r"|alive|stale|expir|deadline|skew"
)

_WALL_CALLS = {"time.time", "time.time_ns"}

_MUTATING_METHODS = {
    "append",
    "extend",
    "add",
    "update",
    "pop",
    "popleft",
    "clear",
    "remove",
    "discard",
    "insert",
    "setdefault",
}


def _finding(
    ctx: ModuleContext, node: ast.AST, rule: str, name: str, message: str
) -> Finding:
    return Finding(
        path=ctx.path,
        line=getattr(node, "lineno", 1),
        col=getattr(node, "col_offset", 0) + 1,
        rule=rule,
        name=name,
        message=message,
    )


def _own_statements(fn: ast.AST) -> Iterator[ast.stmt]:
    """All statements of a function EXCLUDING nested function/class
    bodies (those are separate scopes)."""

    def walk(block: list[ast.stmt]) -> Iterator[ast.stmt]:
        for stmt in block:
            if isinstance(
                stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                continue
            yield stmt
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, field, None)
                if sub:
                    yield from walk(sub)
            for handler in getattr(stmt, "handlers", ()):
                yield from walk(handler.body)

    body = getattr(fn, "body", [])
    if isinstance(body, list):  # a Lambda's body is an expression
        yield from walk(body)


def _idents(node: ast.AST) -> set[str]:
    """Every identifier token of an expression: Name ids, Attribute
    attrs, and string subscript keys."""
    out: set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            out.add(n.id)
        elif isinstance(n, ast.Attribute):
            out.add(n.attr)
        elif isinstance(n, ast.Constant) and isinstance(n.value, str):
            out.add(n.value)
    return out


# ------------------------------------------------------------- rank taint
class RankTaint:
    """Per-module rank-taint oracle.

    ``tainted_fns`` is the set of module-local function names whose
    return value is rank-tainted (computed to a fixpoint so helpers that
    forward ``process_index()`` through a wrapper still taint their call
    sites); :meth:`fn_tainted_names` gives the tainted local names of one
    function; :meth:`expr` decides one expression.
    """

    def __init__(self, ctx: ModuleContext) -> None:
        self.ctx = ctx
        self.tainted_fns: set[str] = set()
        fns = [
            f
            for f in ctx.functions
            if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        for _ in range(len(fns) + 1):
            changed = False
            for fn in fns:
                if fn.name in self.tainted_fns:
                    continue
                local = self.fn_tainted_names(fn)
                for stmt in _own_statements(fn):
                    if isinstance(stmt, ast.Return) and stmt.value is not None:
                        if self.expr(stmt.value, local):
                            self.tainted_fns.add(fn.name)
                            changed = True
                            break
            if not changed:
                break

    # -- seeds -------------------------------------------------------------
    def _seed_call(self, node: ast.Call) -> bool:
        dotted = self.ctx.resolve(node.func)
        if dotted in _RANK_CALLS:
            return True
        if isinstance(node.func, ast.Attribute) and _MEMBERSHIP_ATTR_RE.search(
            node.func.attr
        ):
            return True
        return False

    # -- expression taint --------------------------------------------------
    def expr(self, node: ast.AST, local: set[str]) -> bool:
        if isinstance(node, ast.Name):
            return node.id in local or bool(_RANK_NAME_RE.match(node.id))
        if isinstance(node, ast.Attribute):
            if _RANK_NAME_RE.match(node.attr):
                return True
            return self.expr(node.value, local)
        if isinstance(node, ast.Subscript):
            if self.ctx.resolve(node.value) == "os.environ":
                return True
            if isinstance(node.slice, ast.Constant) and isinstance(
                node.slice.value, str
            ):
                if _RANK_NAME_RE.match(node.slice.value):
                    return True
            return self.expr(node.value, local) or self.expr(node.slice, local)
        if isinstance(node, ast.Call):
            if self._seed_call(node):
                return True
            if (
                isinstance(node.func, ast.Name)
                and node.func.id in self.tainted_fns
            ):
                return True
            parts = list(node.args) + [kw.value for kw in node.keywords]
            if isinstance(node.func, ast.Attribute):
                parts.append(node.func.value)
            return any(self.expr(p, local) for p in parts)
        if isinstance(node, ast.Lambda):
            return False
        return any(
            self.expr(child, local)
            for child in ast.iter_child_nodes(node)
            if isinstance(child, ast.expr)
        )

    # -- per-function local taint ------------------------------------------
    def fn_tainted_names(self, fn: ast.AST) -> set[str]:
        local: set[str] = set()
        args = getattr(fn, "args", None)
        if args is not None:
            for a in (
                list(args.posonlyargs)
                + list(args.args)
                + list(args.kwonlyargs)
            ):
                if _RANK_NAME_RE.match(a.arg):
                    local.add(a.arg)
        # Two forward passes so a name tainted late in a loop body taints
        # its earlier uses on the second pass.
        for _ in range(2):
            for stmt in _own_statements(fn):
                value = getattr(stmt, "value", None)
                if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                    if value is not None and self.expr(value, local):
                        if isinstance(stmt, ast.Assign):
                            for t in stmt.targets:
                                local |= assigned_names(t)
                        else:
                            local |= assigned_names(stmt.target)
                elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                    if self.expr(stmt.iter, local):
                        local |= assigned_names(stmt.target)
                elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                    for item in stmt.items:
                        if item.optional_vars is not None and self.expr(
                            item.context_expr, local
                        ):
                            local |= assigned_names(item.optional_vars)
        return local

    def module_tainted_names(self) -> set[str]:
        """Module-level names assigned from tainted expressions (e.g.
        ``RANK = int(os.environ.get("RANK", "0"))``)."""
        local: set[str] = set()
        for _ in range(2):
            for stmt in self.ctx.tree.body:
                if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                    value = stmt.value
                    if value is not None and self.expr(value, local):
                        if isinstance(stmt, ast.Assign):
                            for t in stmt.targets:
                                local |= assigned_names(t)
                        else:
                            local |= assigned_names(stmt.target)
        return local


def _schedule_key(ctx: ModuleContext, call: ast.Call) -> str | None:
    """Canonical key when ``call`` is part of the cross-rank schedule:
    a collective, a store barrier, or a store event append."""
    func = call.func
    dotted = ctx.resolve(func)
    if dotted is not None:
        last = dotted.rsplit(".", 1)[-1]
        root = dotted.split(".", 1)[0]
        if last in _COLLECTIVE_NAMES and root in _COLLECTIVE_ROOTS:
            return last
    if isinstance(func, ast.Attribute):
        if func.attr in _BARRIER_ATTRS or func.attr in _STORE_EVENT_ATTRS:
            return func.attr
    return None


def _branch_schedule(ctx: ModuleContext, block: list[ast.stmt]) -> list[str]:
    """Sorted multiset of schedule keys reachable in a branch (nested
    defs excluded — they run in their own scope, not on this edge)."""
    keys: list[str] = []

    class V(ast.NodeVisitor):
        def visit_FunctionDef(self, node):  # noqa: N802
            pass

        visit_AsyncFunctionDef = visit_FunctionDef
        visit_Lambda = visit_FunctionDef
        visit_ClassDef = visit_FunctionDef

        def visit_Call(self, node):  # noqa: N802
            key = _schedule_key(ctx, node)
            if key is not None:
                keys.append(key)
            self.generic_visit(node)

    v = V()
    for stmt in block:
        v.visit(stmt)
    return sorted(keys)


def _continuation(ctx: ModuleContext, stmt: ast.stmt) -> list[ast.stmt]:
    """The statements that execute after ``stmt`` in its enclosing block
    (the fall-through edge of an If whose body always exits)."""
    parent = ctx.parent.get(stmt)
    for field in ("body", "orelse", "finalbody"):
        block = getattr(parent, field, None)
        if isinstance(block, list) and stmt in block:
            return block[block.index(stmt) + 1 :]
    return []


# -------------------------------------------------------------------- GR001
def check_rank_divergent_collective(ctx: ModuleContext) -> Iterator[Finding]:
    """rank-divergent-collective: a rank-tainted condition guards a
    collective / store-barrier / ``append_event`` call on only one side,
    so ranks lower different collective schedules and the job hangs."""
    taint = RankTaint(ctx)
    module_env = taint.module_tainted_names()
    env_cache: dict[ast.AST | None, set[str]] = {None: module_env}

    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.If, ast.IfExp)):
            continue
        fn = ctx.enclosing_function(node)
        if fn not in env_cache:
            env_cache[fn] = taint.fn_tainted_names(fn) | module_env
        local = env_cache[fn]
        if not taint.expr(node.test, local):
            continue
        if isinstance(node, ast.IfExp):
            body: list[ast.stmt] = [ast.Expr(value=node.body)]
            orelse: list[ast.stmt] = [ast.Expr(value=node.orelse)]
        else:
            body, orelse = node.body, node.orelse
            if (
                not orelse
                and body
                and isinstance(body[-1], (ast.Return, ast.Raise))
            ):
                # ``if rank == 0: return psum(...)`` followed by a
                # fall-through: the "other side" every non-matching rank
                # runs is the continuation after the If, not an empty
                # else block.
                orelse = _continuation(ctx, node)
        sched_body = _branch_schedule(ctx, body)
        sched_else = _branch_schedule(ctx, orelse)
        if sched_body == sched_else:
            continue
        only = sorted(
            set(sched_body).symmetric_difference(sched_else)
        ) or sorted(set(sched_body) | set(sched_else))
        yield _finding(
            ctx,
            node,
            "GR001",
            "rank-divergent-collective",
            f"rank-tainted branch runs {{{', '.join(only)}}} on one side "
            f"only — ranks taking different sides lower different "
            f"collective/barrier schedules, and the skipped side hangs "
            f"the peers (schedule {sched_body or '[]'} vs "
            f"{sched_else or '[]'})",
        )


# -------------------------------------------------------------------- GR002
def _early_exits_before(
    fn: ast.AST, barrier_stmt: ast.stmt, ctx: ModuleContext
) -> list[ast.stmt]:
    """Conditional ``return``/``raise`` statements lexically before the
    barrier on a path that would skip it: exits nested under an ``if`` /
    ``except`` whose enclosing conditional starts before the barrier and
    does not itself contain the barrier."""
    out: list[ast.stmt] = []
    b_line = barrier_stmt.lineno
    for stmt in _own_statements(fn):
        if not isinstance(stmt, (ast.Return, ast.Raise)):
            continue
        if stmt.lineno >= b_line:
            continue
        # Conditional? — an If or an exception handler between the exit
        # and the function body makes the edge path-dependent.
        cond: ast.AST | None = None
        cur = ctx.parent.get(stmt)
        while cur is not None and cur is not fn:
            if isinstance(cur, (ast.If, ast.ExceptHandler)):
                cond = cur
                break
            cur = ctx.parent.get(cur)
        if cond is None:
            continue
        # The conditional must not contain the barrier itself (then the
        # exit and the barrier are on the same side and no rank skips it).
        if any(n is barrier_stmt for n in ast.walk(cond)):
            continue
        out.append(stmt)
    return out


def check_conditional_barrier_skip(ctx: ModuleContext) -> Iterator[Finding]:
    """conditional-barrier-skip: an early ``return``/``raise`` edge lets
    some ranks skip a store barrier the straight-line path reaches — the
    ranks that do arrive wait forever."""
    for fn in ctx.functions:
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        barriers: list[tuple[ast.stmt, str]] = []
        for stmt in _own_statements(fn):
            for call in ast.walk(stmt):
                if isinstance(call, ast.Call) and isinstance(
                    call.func, ast.Attribute
                ):
                    if call.func.attr in _BARRIER_ATTRS:
                        barriers.append((stmt, call.func.attr))
                        break
        for stmt, attr in barriers:
            exits = _early_exits_before(fn, stmt, ctx)
            if not exits:
                continue
            first = exits[0]
            kind = "return" if isinstance(first, ast.Return) else "raise"
            yield _finding(
                ctx,
                first,
                "GR002",
                "conditional-barrier-skip",
                f"conditional {kind} skips the `{attr}` barrier at line "
                f"{stmt.lineno} on this path — a rank exiting here "
                f"desynchronizes from peers blocked at the barrier "
                f"(release every enter on all return/raise edges, or "
                f"suppress with the reason the exit is rank-uniform)",
            )


# -------------------------------------------------------------------- GR003
def _lock_like(ctx: ModuleContext, expr: ast.AST) -> str | None:
    if isinstance(expr, ast.Name) and _LOCK_NAME_RE.search(expr.id):
        return expr.id
    if isinstance(expr, ast.Attribute) and _LOCK_NAME_RE.search(expr.attr):
        return expr.attr
    return None


def check_blocking_io_under_lock(ctx: ModuleContext) -> Iterator[Finding]:
    """blocking-io-under-lock: a collective or blocking rendezvous-store
    call inside ``with <lock>:`` — the watchdog/heartbeat threads contend
    on the same lock, so a peer-dependent wait under it is a deadlock."""
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.With, ast.AsyncWith)):
            continue
        lock_names = [
            n
            for n in (
                _lock_like(ctx, item.context_expr) for item in node.items
            )
            if n is not None
        ]
        if not lock_names:
            continue
        for call in _walk_calls_excluding_defs(node.body):
            dotted = ctx.resolve(call.func)
            blocking: str | None = None
            if dotted is not None:
                last = dotted.rsplit(".", 1)[-1]
                root = dotted.split(".", 1)[0]
                if last in _COLLECTIVE_NAMES and root in _COLLECTIVE_ROOTS:
                    blocking = f"collective `{last}`"
                elif dotted == "time.sleep":
                    blocking = "`time.sleep`"
            if (
                blocking is None
                and isinstance(call.func, ast.Attribute)
                and call.func.attr in _BLOCKING_ATTRS
            ):
                blocking = f"store I/O `{call.func.attr}`"
            if blocking is None:
                continue
            yield _finding(
                ctx,
                call,
                "GR003",
                "blocking-io-under-lock",
                f"{blocking} invoked while holding "
                f"`{lock_names[0]}` — background watchdog/heartbeat "
                f"threads serialize on this lock, so a peer-dependent "
                f"or disk-blocking wait under it deadlocks the process",
            )


def _walk_calls_excluding_defs(block: list[ast.stmt]) -> Iterator[ast.Call]:
    for stmt in block:
        for n in ast.walk(stmt):
            if isinstance(
                n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                continue
            if isinstance(n, ast.Call):
                yield n


# -------------------------------------------------------------------- GR004
def check_wall_clock_cross_rank(ctx: ModuleContext) -> Iterator[Finding]:
    """wall-clock-cross-rank: ``time.time()`` in heartbeat-age or
    cross-rank ordering math — NTP steps shear wall clocks across
    processes; the runtime stamps a monotonic twin for exactly this."""
    for fn in ctx.functions:
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        wall_names: set[str] = set()
        for stmt in _own_statements(fn):
            if isinstance(stmt, ast.Assign) and isinstance(
                stmt.value, ast.Call
            ):
                if ctx.resolve(stmt.value.func) in _WALL_CALLS:
                    for t in stmt.targets:
                        wall_names |= assigned_names(t)

        def is_wall(expr: ast.AST) -> bool:
            if isinstance(expr, ast.Name):
                return expr.id in wall_names
            for n in ast.walk(expr):
                if isinstance(n, ast.Call) and (
                    ctx.resolve(n.func) in _WALL_CALLS
                ):
                    return True
            return False

        for stmt in _own_statements(fn):
            for node in ast.walk(stmt):
                if isinstance(node, ast.BinOp) and isinstance(
                    node.op, ast.Sub
                ):
                    pairs = [
                        (node.left, node.right),
                        (node.right, node.left),
                    ]
                elif isinstance(node, ast.Compare) and len(node.comparators) == 1:
                    pairs = [
                        (node.left, node.comparators[0]),
                        (node.comparators[0], node.left),
                    ]
                else:
                    continue
                for wall_side, other in pairs:
                    if not is_wall(wall_side) or is_wall(other):
                        continue
                    tokens = _idents(other) | {fn.name}
                    if isinstance(stmt, ast.Assign):
                        for t in stmt.targets:
                            tokens |= assigned_names(t)
                    if any(_AGE_TOKEN_RE.search(t) for t in tokens):
                        yield _finding(
                            ctx,
                            node,
                            "GR004",
                            "wall-clock-cross-rank",
                            "wall-clock (`time.time`) delta in "
                            "heartbeat-age/ordering math — an NTP step "
                            "shears wall clocks between processes; use "
                            "the monotonic stamp recorded alongside "
                            "(or suppress with the reason the reading "
                            "is genuinely cross-host wall time)",
                        )
                        break

    # Second pattern: ``heartbeat_age`` calls that pass neither ``now=``
    # (the explicit wall path) nor ``now_mono=`` fall back to wall math
    # by accident — the supervisor-sweep bug class.
    for call in ctx.calls:
        if not (
            isinstance(call.func, ast.Attribute)
            and call.func.attr == "heartbeat_age"
        ):
            continue
        kwargs = {kw.arg for kw in call.keywords if kw.arg}
        if "now" in kwargs or "now_mono" in kwargs:
            continue
        yield _finding(
            ctx,
            call,
            "GR004",
            "wall-clock-cross-rank",
            "`heartbeat_age` called without `now_mono=` (or an explicit "
            "`now=`) — each call samples its own clock, so ages compared "
            "across ranks in one sweep disagree about 'now'; hoist one "
            "`now_mono=time.monotonic()` per sweep (cross-host callers "
            "that want the wall path should pass `now=` explicitly)",
        )


# -------------------------------------------------------------------- GR005
def _self_attr(node: ast.AST) -> str | None:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _is_thread_class(ctx: ModuleContext, cls: ast.ClassDef) -> bool:
    for base in cls.bases:
        dotted = ctx.resolve(base)
        if dotted in ("threading.Thread", "Thread"):
            return True
    for node in ast.walk(cls):
        if isinstance(node, ast.Call) and ctx.resolve(node.func) == (
            "threading.Thread"
        ):
            return True
    return False


def _thread_body_methods(ctx: ModuleContext, cls: ast.ClassDef) -> list[str]:
    """Names of methods that run on the background thread: ``run`` for
    Thread subclasses, plus every ``target=self._x`` of an in-class
    ``threading.Thread(...)`` construction."""
    out: list[str] = []
    if any(
        ctx.resolve(b) in ("threading.Thread", "Thread") for b in cls.bases
    ):
        out.append("run")
    for node in ast.walk(cls):
        if not (
            isinstance(node, ast.Call)
            and ctx.resolve(node.func) == "threading.Thread"
        ):
            continue
        for kw in node.keywords:
            if kw.arg == "target":
                attr = _self_attr(kw.value)
                if attr is not None:
                    out.append(attr)
    return out


def check_unlocked_shared_mutation(ctx: ModuleContext) -> Iterator[Finding]:
    """unlocked-shared-mutation: an attribute the background thread
    reads, and which other methods mutate under the instance lock, is
    mutated somewhere WITHOUT that lock — a torn read for the thread."""
    for cls in ast.walk(ctx.tree):
        if not isinstance(cls, ast.ClassDef) or not _is_thread_class(ctx, cls):
            continue
        methods = {
            m.name: m
            for m in cls.body
            if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        lock_attrs = set()
        threadsafe_attrs = set()
        init = methods.get("__init__")
        for m in methods.values():
            for node in ast.walk(m):
                if isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Call
                ):
                    dotted = ctx.resolve(node.value.func)
                    for t in node.targets:
                        attr = _self_attr(t)
                        if attr is None:
                            continue
                        if dotted in ("threading.Lock", "threading.RLock"):
                            lock_attrs.add(attr)
                        elif dotted in _THREADSAFE_CTORS:
                            threadsafe_attrs.add(attr)
        if not lock_attrs:
            continue

        def stmts_under_lock(m: ast.AST) -> set[ast.stmt]:
            guarded: set[ast.stmt] = set()
            for node in ast.walk(m):
                if not isinstance(node, (ast.With, ast.AsyncWith)):
                    continue
                if not any(
                    _self_attr(item.context_expr) in lock_attrs
                    for item in node.items
                ):
                    continue
                for stmt in node.body:
                    guarded.update(
                        n for n in ast.walk(stmt) if isinstance(n, ast.stmt)
                    )
                    guarded.add(stmt)
            return guarded

        body_names = _thread_body_methods(ctx, cls)
        # Attributes the background thread touches at all.
        thread_attrs: set[str] = set()
        for name in body_names:
            m = methods.get(name)
            if m is None:
                continue
            for node in ast.walk(m):
                attr = _self_attr(node)
                if attr is not None:
                    thread_attrs.add(attr)
        # ... restricted to ones the class actually guards somewhere —
        # config read once at start-up needs no lock.
        guarded_attrs: set[str] = set()
        for m in methods.values():
            guarded = stmts_under_lock(m)
            for stmt in guarded:
                for node in ast.walk(stmt):
                    attr = _self_attr(node)
                    if attr is not None:
                        guarded_attrs.add(attr)
        shared = (
            thread_attrs & guarded_attrs
        ) - lock_attrs - threadsafe_attrs
        if not shared:
            continue

        for name, m in methods.items():
            if name == "__init__" and m is init:
                continue  # runs before the thread starts
            guarded = stmts_under_lock(m)
            for stmt in ast.walk(m):
                if not isinstance(stmt, ast.stmt) or stmt in guarded:
                    continue
                mutated = _mutated_self_attrs(stmt)
                for attr in sorted(mutated & shared):
                    yield _finding(
                        ctx,
                        stmt,
                        "GR005",
                        "unlocked-shared-mutation",
                        f"`self.{attr}` is read by the `{cls.name}` "
                        f"background thread and guarded by "
                        f"`self.{sorted(lock_attrs)[0]}` elsewhere, but "
                        f"mutated here without the lock — the thread can "
                        f"observe a torn update",
                    )


def _mutated_self_attrs(stmt: ast.stmt) -> set[str]:
    out: set[str] = set()
    if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
        targets = (
            stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
        )
        for t in targets:
            attr = _self_attr(t)
            if attr is not None:
                out.add(attr)
            if isinstance(t, ast.Subscript):
                attr = _self_attr(t.value)
                if attr is not None:
                    out.add(attr)
    if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
        func = stmt.value.func
        if (
            isinstance(func, ast.Attribute)
            and func.attr in _MUTATING_METHODS
        ):
            attr = _self_attr(func.value)
            if attr is not None:
                out.add(attr)
    return out


RANK_RULES = {
    "GR001": check_rank_divergent_collective,
    "GR002": check_conditional_barrier_skip,
    "GR003": check_blocking_io_under_lock,
    "GR004": check_wall_clock_cross_rank,
    "GR005": check_unlocked_shared_mutation,
}
