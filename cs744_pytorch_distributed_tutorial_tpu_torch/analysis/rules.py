"""graftlint rules GL001–GL010 for the port's PyTorch sources.

The twins of the JAX package's ``analysis/rules.py``, under the same IDs
and names so that a reader finds each rule's counterpart. Each rule is a
callable ``check(ctx) -> Iterator[Finding]`` over a
:class:`~.context.ModuleContext`. Rules are deliberately heuristic —
they trade exhaustive dataflow for zero dependencies and speed — and
every heuristic errs toward silence (skip when unresolvable) so the
findings that DO fire are worth reading. The escape hatches are inline
``# graftlint: disable=RULE -- reason`` pragmas and the baseline file.

Where JAX's object is a trace, the port's is a ``torch.compile``,
``torch.jit`` or CUDA-graph capture scope (``context.py``); where JAX's
is a ``jax.jit`` step loop, the port's is a host loop that runs an
engine's step. GL003 and GL004 have no object in PyTorch and keep their
IDs with the reason (``NOT_APPLICABLE``).
"""

from __future__ import annotations

import ast
from typing import Callable, Iterator

from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.context import (
    GRAPH_CONSTRUCTORS,
    PORT,
    PORT_MESH_AXES,
    ModuleContext,
    assigned_names,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.core import Finding

RuleFn = Callable[[ModuleContext], Iterator[Finding]]

_BLOCK_FIELDS = ("body", "orelse", "finalbody")

#: ``x.<method>()`` calls that force a device->host sync wherever they
#: appear (or break a compile/capture scope).
_SYNC_METHODS = {"item", "tolist", "numpy", "cpu"}
_CONVERTERS = {"float", "int", "bool", "complex"}
_NUMPY_SYNCERS = {"numpy.asarray", "numpy.array", "numpy.copy"}
#: Calls that block the host until the device drains.
_SYNC_CALLS = {"torch.cuda.synchronize", "torch.cuda.current_stream.synchronize"}

#: The port's collectives on mesh axes (``parallel/collectives.py``) and
#: the positional index of their axis argument(s); ``*`` = every
#: positional argument from that index on.
_COLLECTIVE_AXIS_POS = {
    "axis_sum": (2, True),
    "axis_mean": (2, True),
    "reduce_by_axes": (1, False),
    "start_permute": (2, False),
    "all_to_all": (2, False),
    "axis_gather_rows": (2, False),
}

_TIME_CALLS = {
    "time.time",
    "time.time_ns",
    "time.perf_counter",
    "time.perf_counter_ns",
    "time.monotonic",
    "time.monotonic_ns",
    "time.process_time",
    "time.sleep",
    "datetime.datetime.now",
    "datetime.datetime.utcnow",
}

_MUTABLE_CONSTRUCTORS = {
    "list",
    "dict",
    "set",
    "bytearray",
    "defaultdict",
    "OrderedDict",
    "Counter",
    "deque",
}

#: Rules kept by ID with no object in PyTorch, and why.
NOT_APPLICABLE = {
    "GL003": "not applicable: PyTorch has no buffer donation (no donate_argnums); "
             "an eager step updates its state in place, which TA002 audits",
    "GL004": "not applicable: a torch.Generator advances its state on every draw, "
             "so two draws from one generator never repeat each other",
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


def _walk_expr_nodes(stmt: ast.stmt) -> Iterator[ast.AST]:
    """All nodes of a statement EXCLUDING nested statement bodies and
    nested function/class definitions (those are separate scopes/steps)."""
    stack: list[ast.AST] = [stmt]
    while stack:
        node = stack.pop()
        if node is not stmt and isinstance(
            node, (ast.stmt, ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)
        ):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _iter_blocks(stmt: ast.stmt) -> Iterator[list[ast.stmt]]:
    for field in _BLOCK_FIELDS:
        block = getattr(stmt, field, None)
        if block:
            yield block
    for handler in getattr(stmt, "handlers", ()):
        yield handler.body


def _sync_label(ctx: ModuleContext, node: ast.Call, levels: dict[str, int]) -> str | None:
    """What makes ``node`` a blocking device->host read, or None: a sync
    method, ``torch.cuda.synchronize()`` (or a stream's/event's
    ``.synchronize()``), ``np.asarray`` of a device value, or a Python
    converter of a device value."""
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS and not node.args:
        return f"'.{f.attr}()'"
    dotted = ctx.resolve(f)
    if dotted in _SYNC_CALLS or (
        isinstance(f, ast.Attribute) and f.attr == "synchronize" and not node.args
    ):
        return "torch.cuda.synchronize()" if dotted in _SYNC_CALLS else "'.synchronize()'"
    if dotted in _NUMPY_SYNCERS and node.args and ctx.expr_level(node.args[0], levels) >= 2:
        return f"{dotted}() of a device value"
    if (
        isinstance(f, ast.Name)
        and f.id in _CONVERTERS
        and len(node.args) == 1
        and ctx.expr_level(node.args[0], levels) >= 2
    ):
        return f"{f.id}() of a device value"
    return None


# ------------------------------------------------------------ taint walk
def _run_taint_block(
    ctx: ModuleContext, stmts: list[ast.stmt], levels: dict[str, int]
) -> Iterator[Finding]:
    """Order-aware walk of a traced statement block: flag sync points
    against the current taint levels, then update them from assignments.
    Branch taint merges as a per-name max; loop bodies run twice so
    loop-carried taint is seen."""
    for stmt in stmts:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        yield from _scan_stmt_exprs(ctx, stmt, levels)
        if isinstance(stmt, ast.If):
            t_body, t_else = dict(levels), dict(levels)
            yield from _run_taint_block(ctx, stmt.body, t_body)
            yield from _run_taint_block(ctx, stmt.orelse, t_else)
            for branch in (t_body, t_else):
                for k, v in branch.items():
                    if v > levels.get(k, 0):
                        levels[k] = v
            continue
        if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
            for _ in range(2):
                for block in _iter_blocks(stmt):
                    _only_taint_updates(ctx, block, levels)
            if isinstance(stmt, (ast.For, ast.AsyncFor)):
                iter_lvl = ctx.expr_level(stmt.iter, levels)
                if iter_lvl:
                    for n in assigned_names(stmt.target):
                        levels[n] = max(levels.get(n, 0), iter_lvl)
            for block in _iter_blocks(stmt):
                yield from _run_taint_block(ctx, block, levels)
            continue
        if isinstance(stmt, (ast.With, ast.AsyncWith, ast.Try)):
            for block in _iter_blocks(stmt):
                yield from _run_taint_block(ctx, block, levels)
            continue
        _update_taint(ctx, stmt, levels)


def _only_taint_updates(ctx, block, levels) -> None:
    for stmt in block:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        _update_taint(ctx, stmt, levels)
        for inner in _iter_blocks(stmt):
            _only_taint_updates(ctx, inner, levels)


def _update_taint(ctx, stmt, levels) -> None:
    if isinstance(stmt, ast.Assign):
        lvl = ctx.expr_level(stmt.value, levels)
        names = set()
        for t in stmt.targets:
            names |= assigned_names(t)
        for n in names:
            if lvl:
                levels[n] = lvl
            else:
                levels.pop(n, None)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)) and stmt.value is not None:
        names = assigned_names(stmt.target)
        lvl = ctx.expr_level(stmt.value, levels)
        if lvl:
            for n in names:
                levels[n] = max(levels.get(n, 0), lvl)
        elif isinstance(stmt, ast.AnnAssign):
            for n in names:
                levels.pop(n, None)


def _scan_stmt_exprs(
    ctx: ModuleContext, stmt: ast.AST, levels: dict[str, int]
) -> Iterator[Finding]:
    rule, name = "GL001", "host-sync-in-jit-scope"
    nodes = _walk_expr_nodes(stmt) if isinstance(stmt, ast.stmt) else ast.walk(stmt)
    for node in nodes:
        if isinstance(node, ast.Call):
            label = _sync_label(ctx, node, levels)
            if label is not None:
                yield _finding(
                    ctx, node, rule, name,
                    f"{label} forces a blocking device->host sync inside a compiled "
                    "or graph-captured scope (a graph break under torch.compile, an "
                    "error or a frozen value under CUDA-graph capture)",
                )
            continue
        if isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
            test = node.test
            if isinstance(test, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                for op in test.ops
            ):
                continue
            if ctx.expr_level(test, levels) >= 2:
                yield _finding(
                    ctx, node, rule, name,
                    "branching on a device value inside a compiled or captured scope "
                    "reads it on the host (a graph break, or a branch frozen into the "
                    "CUDA graph); use torch.where",
                )


# ======================================================================= GL001
def check_host_sync(ctx: ModuleContext) -> Iterator[Finding]:
    """GL001 host-sync-in-jit-scope.

    Inside a ``torch.compile``/``torch.jit``/CUDA-graph capture scope:
    ``.item()``/``.tolist()``/``.cpu()``/``.numpy()``,
    ``torch.cuda.synchronize()``, ``np.asarray`` or
    ``float()``/``int()``/``bool()`` of device values, and branching on
    device values — each a graph break under the compiler, and an error
    or a value frozen at capture time under a CUDA graph. The host step
    loop's syncs are GL009's.
    """
    for fn in ctx.functions:
        if fn not in ctx.traced:
            continue
        if isinstance(fn, ast.Lambda):
            yield from _scan_stmt_exprs(ctx, fn.body, {})
            continue
        args = fn.args
        # Parameters are WEAK taint (level 1): they can be tensors OR
        # static Python config riding along; values from torch.* calls
        # are STRONG (level 2) and safe to flag.
        levels = {
            a.arg: 1
            for a in (*args.posonlyargs, *args.args, *args.kwonlyargs)
            if a.arg not in ("self", "cls")
        }
        yield from _run_taint_block(ctx, fn.body, levels)
    for block in ctx.capture_blocks:
        if ctx.enclosing_function(block) in ctx.traced:
            continue  # already walked with its function
        yield from _run_taint_block(ctx, block.body, {})


# ======================================================================= GL002
def check_retrace_hazard(ctx: ModuleContext) -> Iterator[Finding]:
    """GL002 retrace-hazard.

    ``torch.compile``/``torch.jit.script``/``torch.jit.trace``/
    ``make_graphed_callables`` wrappers or ``torch.cuda.CUDAGraph()``
    objects constructed inside a ``for``/``while`` body: each iteration
    builds a fresh wrapper with an empty cache (or a fresh graph to
    capture), so every step recompiles or re-records — hoist it out.
    """
    rule, name = "GL002", "retrace-hazard"
    for call in ctx.calls:
        dotted = ctx.resolve(call.func)
        if dotted not in GRAPH_CONSTRUCTORS:
            continue
        anc = ctx.parent.get(call)
        while anc is not None and not isinstance(
            anc, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            if isinstance(anc, (ast.For, ast.AsyncFor, ast.While)):
                yield _finding(
                    ctx, call, rule, name,
                    f"{dotted} constructed inside a loop: a fresh wrapper has an "
                    "empty cache (a fresh graph must be captured again), so every "
                    "iteration recompiles — hoist it out of the loop",
                )
                break
            anc = ctx.parent.get(anc)


# ================================================================ GL003/GL004
def check_donation_after_use(ctx: ModuleContext) -> Iterator[Finding]:
    """GL003 donation-after-use — not applicable: PyTorch has no buffer
    donation (no donate_argnums); an eager step updates its state in
    place, which TA002 audits."""
    return iter(())


def check_prng_key_reuse(ctx: ModuleContext) -> Iterator[Finding]:
    """GL004 prng-key-reuse — not applicable: a torch.Generator advances
    its state on every draw, so two draws from one generator never
    repeat each other."""
    return iter(())


# ======================================================================= GL005
def _axis_literals(ctx: ModuleContext, node: ast.AST) -> Iterator[tuple[str, ast.AST]]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        yield node.value, node
    elif isinstance(node, (ast.Tuple, ast.List)):
        for elt in node.elts:
            yield from _axis_literals(ctx, elt)
    elif isinstance(node, ast.Name) and node.id in ctx.module_str_consts:
        yield ctx.module_str_consts[node.id], node


def _string_pool(node: ast.AST) -> set[str]:
    return {
        n.value for n in ast.walk(node)
        if isinstance(n, ast.Constant) and isinstance(n.value, str)
    }


def _axis_universe(ctx: ModuleContext) -> set[str]:
    """Axis names this module declares: ``*AXIS*`` string constants, the
    keyword names and ``sizes``/``axis_names`` strings of ``Mesh(...)``
    constructions, and the port mesh's axes when the module builds a
    ``Mesh`` or imports a ``*_AXIS`` constant from ``parallel/mesh.py``."""
    universe: set[str] = {
        v for k, v in ctx.module_str_consts.items() if "AXIS" in k.upper()
    }
    mesh_mod = f"{PORT}.parallel.mesh"
    if any(
        full.startswith(mesh_mod + ".") and full.rsplit(".", 1)[-1].endswith("_AXIS")
        for full in ctx.aliases.values()
    ):
        universe |= set(PORT_MESH_AXES)
    for call in ctx.calls:
        dotted = ctx.resolve(call.func) or ""
        tail = dotted.rsplit(".", 1)[-1]
        head = dotted.rsplit(".", 2)[-2] if dotted.count(".") >= 1 else ""
        if tail == "Mesh" or (tail == "get" and head == "Mesh"):
            if dotted.startswith(PORT) or tail == "get":
                universe |= set(PORT_MESH_AXES)
            universe |= {kw.arg for kw in call.keywords if kw.arg}
        for kw in call.keywords:
            if kw.arg in ("axis_names", "mesh_axes", "sizes"):
                if isinstance(kw.value, ast.Dict):
                    universe |= {k.value for k in kw.value.keys
                                 if isinstance(k, ast.Constant) and isinstance(k.value, str)}
                else:
                    universe |= _string_pool(kw.value)
    return universe


def check_collective_axis_drift(ctx: ModuleContext) -> Iterator[Finding]:
    """GL005 collective-axis-drift.

    Hardcoded axis-name literals passed to the port's collectives on
    mesh axes (``parallel/collectives.py``: ``axis_sum``, ``axis_mean``,
    ``reduce_by_axes``, ``start_permute``, ``all_to_all``,
    ``axis_gather_rows``) are checked against the module's declared axis
    universe (``Mesh`` constructions, ``*AXIS*`` constants, the mesh
    module's axis constants). A literal outside it is an axis name that
    drifted from the mesh — a ``KeyError`` at best, a wrong reduction
    group at worst. Modules that declare no axes are skipped."""
    rule, name = "GL005", "collective-axis-drift"
    universe = _axis_universe(ctx)
    if not universe:
        return
    coll_mod = f"{PORT}.parallel.collectives."
    for call in ctx.calls:
        dotted = ctx.resolve(call.func) or ""
        tail = dotted.rsplit(".", 1)[-1]
        if tail not in _COLLECTIVE_AXIS_POS:
            continue
        if not (dotted.startswith(coll_mod) or "." not in dotted):
            continue
        pos, star = _COLLECTIVE_AXIS_POS[tail]
        axis_nodes = list(call.args[pos:]) if star else call.args[pos : pos + 1]
        axis_nodes += [kw.value for kw in call.keywords if kw.arg in ("axis", "axes")]
        for axis_node in axis_nodes:
            for value, lit in _axis_literals(ctx, axis_node):
                if value not in universe:
                    yield _finding(
                        ctx, lit, rule, name,
                        f"collective '{tail}' names axis '{value}' but this module's "
                        f"meshes declare {sorted(universe)} — the axis drifted from "
                        "the mesh",
                    )


# ======================================================================= GL006
def check_mutable_default(ctx: ModuleContext) -> Iterator[Finding]:
    """GL006 mutable-default-arg: ``def f(x, acc=[])`` aliases ONE list
    across every call — the classic shared-state footgun."""
    rule, name = "GL006", "mutable-default-arg"
    for fn in ctx.functions:
        if isinstance(fn, ast.Lambda):
            defaults = list(fn.args.defaults)
        else:
            defaults = list(fn.args.defaults) + [
                d for d in fn.args.kw_defaults if d is not None
            ]
        for d in defaults:
            if isinstance(d, (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp, ast.SetComp)):
                kind = type(d).__name__.lower()
            elif (
                isinstance(d, ast.Call)
                and isinstance(d.func, ast.Name)
                and d.func.id in _MUTABLE_CONSTRUCTORS
                and not d.args
                and not d.keywords
            ):
                kind = f"{d.func.id}()"
            else:
                continue
            fn_name = getattr(fn, "name", "<lambda>")
            yield _finding(
                ctx, d, rule, name,
                f"mutable default ({kind}) in '{fn_name}' is shared across "
                "calls; default to None and construct inside the body",
            )


# ======================================================================= GL007
def check_time_in_trace(ctx: ModuleContext) -> Iterator[Finding]:
    """GL007 unguarded-time-in-trace: ``time.time()`` (and friends)
    inside a compiled or CUDA-graph-captured scope runs once when the
    code is compiled or captured — the replayed graph repeats no clock
    read (and ``sleep`` blocks the capture, not the step). Time on the
    host around the call, with CUDA events for device time."""
    rule, name = "GL007", "unguarded-time-in-trace"
    for call in ctx.calls:
        dotted = ctx.resolve(call.func)
        if dotted not in _TIME_CALLS:
            continue
        if not ctx.in_traced_scope(call):
            continue
        yield _finding(
            ctx, call, rule, name,
            f"{dotted}() inside a compiled or captured scope runs once, when it "
            "is compiled or captured, and is not replayed; time on the host or "
            "with CUDA events",
        )


# ======================================================================= GL008
def iter_dead_imports(
    ctx: ModuleContext,
) -> Iterator[tuple[ast.stmt, ast.alias, str]]:
    """``(import statement, alias, bound name)`` for every module-level
    import binding never referenced — shared by GL008 and the ``--fix``
    rewriter (``analysis/fix.py``). Exempt: ``__init__.py`` (imports
    there are the re-export surface), underscore-prefixed bindings (the
    explicit side-effect-import convention), ``__all__``-exported names,
    and ``__future__`` imports."""
    if ctx.path.rsplit("/", 1)[-1] == "__init__.py":
        return
    used: set[str] = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            used.add(node.id)
    exported: set[str] = set()
    for stmt in ctx.tree.body:
        if (
            isinstance(stmt, ast.Assign)
            and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in stmt.targets
            )
        ):
            exported |= _string_pool(stmt.value)
    for stmt in ctx.tree.body:
        body_stmts = [stmt]
        if isinstance(stmt, ast.Try):
            body_stmts = (
                stmt.body
                + [s for h in stmt.handlers for s in h.body]
                + stmt.orelse
                + stmt.finalbody
            )
        for s in body_stmts:
            if isinstance(s, ast.Import):
                pairs = [(a, a.asname or a.name.split(".")[0]) for a in s.names]
            elif isinstance(s, ast.ImportFrom):
                if s.module == "__future__":
                    continue
                pairs = [
                    (a, a.asname or a.name) for a in s.names if a.name != "*"
                ]
            else:
                continue
            for alias, bound in pairs:
                if bound.startswith("_") or bound in used or bound in exported:
                    continue
                yield s, alias, bound


def check_dead_import(ctx: ModuleContext) -> Iterator[Finding]:
    """GL008 dead-import: module-level imports never referenced.
    ``__init__.py`` files are exempt (imports there are the re-export
    surface), as are underscore-prefixed bindings (the explicit
    side-effect-import convention) and ``__future__`` imports.
    Auto-fixable: ``--fix`` removes the dead bindings in place."""
    rule, name = "GL008", "dead-import"
    for stmt, _alias, bound in iter_dead_imports(ctx):
        yield _finding(
            ctx, stmt, rule, name,
            f"'{bound}' is imported but never used in this module",
        )


# ======================================================================= GL009
def _under_cadence_gate(ctx: ModuleContext, node: ast.AST, loop: ast.AST) -> bool:
    cur = ctx.parent.get(node)
    while cur is not None and cur is not loop:
        if isinstance(cur, (ast.If, ast.IfExp)):
            return True
        cur = ctx.parent.get(cur)
    return False


def _step_loop_body_nodes(loop: ast.AST) -> Iterator[ast.AST]:
    """Every node of a loop's body, nested defs and classes excluded
    (they run when called, not on this loop's path)."""
    stack: list[ast.AST] = list(ast.iter_child_nodes(loop))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def check_blocking_sync_in_step_loop(ctx: ModuleContext) -> Iterator[Finding]:
    """GL009 blocking-sync-in-step-loop.

    The GL001 calls — ``.item()``/``.tolist()``/``.cpu()``/``.numpy()``,
    ``float()``/``int()`` of a step's device output,
    ``torch.cuda.synchronize()`` and ``.synchronize()`` — on the hot path
    of a host loop that runs an engine's step (a compiled or captured
    callable, ``graph.replay()``, or ``train_step``/``_decode_step``/...).
    CUDA launches are asynchronous: the loop's job is to keep the device
    queue full, and a blocking read between one step and the next drains
    it and exposes the host's time. Calls behind a cadence gate (any
    ``if`` between the loop and the call) are not flagged — fetching
    occasionally is the sanctioned pattern.
    """
    rule, name = "GL009", "blocking-sync-in-step-loop"
    for loop in ast.walk(ctx.tree):
        if not isinstance(loop, (ast.For, ast.While)):
            continue
        if ctx.in_traced_scope(loop):
            continue
        # Only OUTERMOST step loops: inner loops are covered by the walk
        # starting at the outer one.
        anc = ctx.parent.get(loop)
        is_nested = False
        while anc is not None and not isinstance(
            anc, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            if isinstance(anc, (ast.For, ast.While)):
                is_nested = True
                break
            anc = ctx.parent.get(anc)
        if is_nested:
            continue
        body = list(_step_loop_body_nodes(loop))
        step_calls = [c for c in body if isinstance(c, ast.Call) and ctx.is_step_call(c)]
        if not step_calls:
            continue
        # Device values: names bound from a step call or a torch call in
        # the loop (loop-carried, so the whole body is one pass).
        levels: dict[str, int] = {}
        for _ in range(2):
            for node in body:
                if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                    _update_taint(ctx, node, levels)
        for call in body:
            if not isinstance(call, ast.Call):
                continue
            label = _sync_label(ctx, call, levels)
            if label is None or _under_cadence_gate(ctx, call, loop):
                continue
            yield _finding(
                ctx, call, rule, name,
                f"{label} on the step-loop hot path blocks until the device queue "
                "drains, exposing the host's time between steps; fetch behind a "
                "cadence gate or drop the wait",
            )


# ======================================================================= GL010
def _spec_literals(ctx: ModuleContext) -> Iterator[ast.AST]:
    """Per-tensor axis specs the module writes out: tuples of axis-name
    strings and ``None`` that are values of a dict bound to a ``*spec*``
    name or attribute, values of a ``param_specs=`` keyword, or tuples
    returned by a ``*spec*`` function."""
    def tuples_in(node: ast.AST) -> Iterator[ast.AST]:
        if isinstance(node, ast.Dict):
            for v in node.values:
                yield from tuples_in(v)
        elif isinstance(node, (ast.Tuple, ast.List)) and node.elts and all(
            isinstance(e, ast.Constant) and (e.value is None or isinstance(e.value, str))
            or (isinstance(e, ast.Name) and e.id in ctx.module_str_consts)
            for e in node.elts
        ):
            yield node

    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Assign):
            names = [t.id if isinstance(t, ast.Name) else getattr(t, "attr", "")
                     for t in node.targets]
            if any("spec" in n.lower() for n in names):
                yield from tuples_in(node.value)
        elif isinstance(node, ast.keyword) and node.arg == "param_specs":
            yield from tuples_in(node.value)
        elif isinstance(node, ast.Return) and node.value is not None:
            fn = ctx.enclosing_function(node)
            if fn is not None and "spec" in getattr(fn, "name", "").lower():
                yield from tuples_in(node.value)


def check_partition_spec_mismatch(ctx: ModuleContext) -> Iterator[Finding]:
    """GL010 partition-spec-mismatch.

    The port's per-tensor axes (``param_specs``: a tuple a tensor, an
    axis name or ``None`` a dimension): an axis name the module's mesh
    universe lacks splits the tensor over an axis no process group
    carries, and one axis named twice in a spec is impossible on any mesh
    (an axis can split at most one dimension). The second check runs even
    in modules with no declared mesh."""
    rule, name = "GL010", "partition-spec-mismatch"
    universe = _axis_universe(ctx)
    for spec in _spec_literals(ctx):
        seen: set[str] = set()
        for value, lit in _axis_literals(ctx, spec):
            if value in seen:
                yield _finding(
                    ctx, lit, rule, name,
                    f"spec names axis '{value}' twice — a mesh axis can split at "
                    "most one dimension, so this spec is impossible on any mesh",
                )
            seen.add(value)
            if universe and value not in universe:
                yield _finding(
                    ctx, lit, rule, name,
                    f"spec names axis '{value}' but this module's meshes declare "
                    f"{sorted(universe)} — no process group splits that axis",
                )


ALL_RULES: dict[str, RuleFn] = {
    "GL001": check_host_sync,
    "GL002": check_retrace_hazard,
    "GL003": check_donation_after_use,
    "GL004": check_prng_key_reuse,
    "GL005": check_collective_axis_drift,
    "GL006": check_mutable_default,
    "GL007": check_time_in_trace,
    "GL008": check_dead_import,
    "GL009": check_blocking_sync_in_step_loop,
    "GL010": check_partition_spec_mismatch,
}

# graftrank (GR001–GR005): cross-rank divergence and distributed-deadlock
# rules, defined in their own module — they share the engine, pragma and
# baseline machinery with the GL family.
from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.rank import (  # noqa: E402
    RANK_RULES,
)

ALL_RULES.update(RANK_RULES)
