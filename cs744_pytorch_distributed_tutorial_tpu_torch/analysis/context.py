"""Per-module AST context shared by all graftlint rules.

The port's twin of the JAX package's ``analysis/context.py``. Three
analyses every PyTorch-aware rule needs:

- **alias resolution**: ``import torch.distributed as dist`` / ``from
  torch import nn`` / ``from ...parallel import collectives as C`` are
  folded into one map so a call site resolves to a dotted path
  (``dist.all_reduce`` -> ``torch.distributed.all_reduce``,
  ``C.axis_sum`` -> ``<port>.parallel.collectives.axis_sum``) regardless
  of import style;
- **traced-scope inference**: which code a compiler or a CUDA graph
  records instead of running it line by line. Seeds are decorators
  (``@torch.compile``, ``@torch.compile(...)``, ``@torch.jit.script``),
  functions passed to ``torch.compile``/``torch.jit.script``/
  ``torch.jit.trace``/``torch.cuda.make_graphed_callables``, and the
  bodies of ``with torch.cuda.graph(...)`` capture blocks; tracedness then
  propagates to lexically nested functions and to functions invoked by
  name from traced code;
- **step registry**: names and attributes bound to compiled or captured
  callables (the JAX ``jax.jit`` registry's twin), which with the engines'
  step methods (``train_step``, ``_decode_step``, ...) mark a host loop
  as a step loop for GL009.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass

__all__ = ["JitEntry", "ModuleContext", "PORT", "PORT_MESH_AXES"]

#: The port's package: calls resolving under it are the port's own helpers.
PORT = "cs744_pytorch_distributed_tutorial_tpu_torch"

#: ``parallel/mesh.py::AXES``: the axis names every ``Mesh`` of the port
#: carries. A module that builds a ``Mesh`` or imports its ``*_AXIS``
#: constants declares these.
PORT_MESH_AXES = ("data", "pipe", "seq", "tensor")

#: Calling one of these (dotted, fully resolved) compiles or captures its
#: function argument.
TRACE_WRAPPERS = {
    "torch.compile",
    "torch.jit.script",
    "torch.jit.trace",
    "torch.jit.trace_module",
    "torch.cuda.make_graphed_callables",
    "torch.cuda.graphs.make_graphed_callables",
    "torch.func.functionalize",
    "torch.export.export",
}

#: ``with <one of these>(...):`` records its body into a CUDA graph.
CAPTURE_CONTEXTS = {"torch.cuda.graph", "torch.cuda.graphs.graph"}

#: Constructors of graph or compiled objects (GL002's twin set).
GRAPH_CONSTRUCTORS = TRACE_WRAPPERS | {"torch.cuda.CUDAGraph", "torch.cuda.graphs.CUDAGraph"}

#: Attribute reads on a tensor that are host metadata — they break value
#: taint (``x.shape[0]`` is a Python int, no device read).
STATIC_ARRAY_ATTRS = {
    "shape",
    "ndim",
    "dtype",
    "device",
    "layout",
    "is_cuda",
    "is_sparse",
    "requires_grad",
    "itemsize",
    "nbytes",
    "names",
    "grad_fn",
}

#: Tensor methods returning host metadata (no device read).
STATIC_TENSOR_METHODS = {
    "size",
    "dim",
    "numel",
    "element_size",
    "stride",
    "storage_offset",
    "is_contiguous",
    "data_ptr",
    "get_device",
    "is_floating_point",
    "is_complex",
}

#: Builtins whose result is host-static even on tensor arguments.
_STATIC_BUILTINS = {"isinstance", "len", "type", "hasattr", "getattr", "callable", "id", "repr", "str"}

#: torch-namespace calls that return host METADATA (dtypes, devices,
#: device counts, ranks), never tensors — branching on them is ordinary
#: specialization, not a host sync.
_STATIC_TORCH_CALLS = {
    "torch.cuda.is_available",
    "torch.cuda.device_count",
    "torch.cuda.current_device",
    "torch.cuda.get_device_name",
    "torch.cuda.get_device_capability",
    "torch.cuda.is_current_stream_capturing",
    "torch.is_tensor",
    "torch.is_floating_point",
    "torch.is_complex",
    "torch.is_grad_enabled",
    "torch.is_inference_mode_enabled",
    "torch.promote_types",
    "torch.result_type",
    "torch.can_cast",
    "torch.finfo",
    "torch.iinfo",
    "torch.get_default_dtype",
    "torch.device",
    "torch.Size",
    "torch.dtype",
    "torch.compiler.is_compiling",
    "torch.distributed.is_available",
    "torch.distributed.is_initialized",
    "torch.distributed.get_rank",
    "torch.distributed.get_world_size",
    "torch.distributed.get_backend",
    "torch.distributed.get_global_rank",
}

#: Host-loop callees that mark a loop as a STEP loop (besides the
#: compiled/captured registry): the engines' step functions and methods.
STEP_CALL_RE = re.compile(r"^(_?(train|eval|decode|prefill|serve|forward)_)?steps?$")


@dataclass
class JitEntry:
    """One compiled or captured callable bound to a name or attribute
    (``f = torch.compile(g)``, ``self.step = torch.cuda.make_graphed_callables(...)``,
    a ``@torch.compile``-decorated def)."""

    kind: str  # "name" | "attr"
    name: str
    node: ast.AST

    def matches_call(self, call: ast.Call) -> bool:
        f = call.func
        if self.kind == "name":
            return isinstance(f, ast.Name) and f.id == self.name
        return isinstance(f, ast.Attribute) and f.attr == self.name


class ModuleContext:
    def __init__(self, path: str, src: str, tree: ast.Module) -> None:
        self.path = path
        self.src = src
        self.tree = tree
        self.lines = src.splitlines()
        self.parent: dict[ast.AST, ast.AST] = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self.parent[child] = node
        self.aliases = self._collect_aliases()
        self.functions = [
            n
            for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
        ]
        self.defs_by_name: dict[str, list[ast.AST]] = {}
        for fn in self.functions:
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.defs_by_name.setdefault(fn.name, []).append(fn)
        self.calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)]
        #: ``with torch.cuda.graph(...)`` blocks: their bodies are captured.
        self.capture_blocks = [
            n
            for n in ast.walk(tree)
            if isinstance(n, (ast.With, ast.AsyncWith))
            and any(
                isinstance(item.context_expr, ast.Call)
                and self.resolve(item.context_expr.func) in CAPTURE_CONTEXTS
                for item in n.items
            )
        ]
        self.traced = self._infer_traced()
        self.jit_registry = self._collect_jit_registry()
        #: Module-level ``NAME = "literal"`` string constants (axis-name
        #: indirection like ``DATA_AXIS = "data"``).
        self.module_str_consts: dict[str, str] = {}
        for stmt in tree.body:
            if (
                isinstance(stmt, ast.Assign)
                and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
                and isinstance(stmt.value, ast.Constant)
                and isinstance(stmt.value.value, str)
            ):
                self.module_str_consts[stmt.targets[0].id] = stmt.value.value

    # -------------------------------------------------------------- aliases
    def _collect_aliases(self) -> dict[str, str]:
        aliases: dict[str, str] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        aliases[a.asname] = a.name
                    else:
                        root = a.name.split(".")[0]
                        aliases[root] = root
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                for a in node.names:
                    if a.name == "*":
                        continue
                    full = f"{mod}.{a.name}" if mod else a.name
                    aliases[a.asname or a.name] = full
        return aliases

    def resolve(self, node: ast.AST | None) -> str | None:
        """Dotted path of a Name/Attribute chain through the import
        aliases; unknown bare names resolve to themselves (dot-free, so
        torch-qualification checks reject them)."""
        if isinstance(node, ast.Name):
            return self.aliases.get(node.id, node.id)
        if isinstance(node, ast.Attribute):
            base = self.resolve(node.value)
            return None if base is None else f"{base}.{node.attr}"
        return None

    @staticmethod
    def is_torch_path(dotted: str | None) -> bool:
        return bool(dotted) and dotted.split(".", 1)[0] == "torch"

    def is_trace_wrapper(self, node: ast.AST) -> bool:
        return self.resolve(node) in TRACE_WRAPPERS

    def _is_trace_wrapper_decorator(self, dec: ast.AST) -> bool:
        if isinstance(dec, ast.Call):
            dotted = self.resolve(dec.func)
            if dotted in ("functools.partial", "partial"):
                return bool(dec.args) and self._is_trace_wrapper_decorator(
                    dec.args[0]
                )
            return self.is_trace_wrapper(dec.func)
        return self.is_trace_wrapper(dec)

    def in_capture_block(self, node: ast.AST) -> bool:
        """Whether ``node`` sits lexically in the body of a ``with
        torch.cuda.graph(...)`` block."""
        cur = self.parent.get(node)
        child = node
        while cur is not None:
            if cur in self._capture_set and child in getattr(cur, "body", ()):
                return True
            child, cur = cur, self.parent.get(cur)
        return False

    # -------------------------------------------------------- traced scopes
    def _infer_traced(self) -> set[ast.AST]:
        self._capture_set = set(self.capture_blocks)
        traced: set[ast.AST] = set()
        for fn in self.functions:
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) and any(
                self._is_trace_wrapper_decorator(d) for d in fn.decorator_list
            ):
                traced.add(fn)
        for call in self.calls:
            if not self.is_trace_wrapper(call.func):
                continue
            cands = list(call.args) + [kw.value for kw in call.keywords]
            for arg in cands:
                for item in (arg.elts if isinstance(arg, (ast.Tuple, ast.List)) else [arg]):
                    if isinstance(item, ast.Lambda):
                        traced.add(item)
                    elif isinstance(item, ast.Name):
                        traced.update(self.defs_by_name.get(item.id, ()))
        if not traced and not self._capture_set:
            return traced  # nothing compiled or captured in this module
        # Propagate: lexical nesting + direct by-name calls from traced code
        # (a capture block's calls included).
        for _ in range(len(self.functions) + 1):
            changed = False
            for fn in self.functions:
                if fn not in traced and self.in_traced_scope(fn, traced):
                    traced.add(fn)
                    changed = True
            for call in self.calls:
                if not isinstance(call.func, ast.Name):
                    continue
                if self.in_traced_scope(call, traced):
                    for fn in self.defs_by_name.get(call.func.id, ()):
                        if fn not in traced:
                            traced.add(fn)
                            changed = True
            if not changed:
                break
        return traced

    def enclosing_function(self, node: ast.AST) -> ast.AST | None:
        cur = self.parent.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                return cur
            cur = self.parent.get(cur)
        return None

    def in_traced_scope(
        self, node: ast.AST, traced: set[ast.AST] | None = None
    ) -> bool:
        """Inside a compiled/captured function, or lexically inside a
        CUDA-graph capture block."""
        traced = self.traced if traced is None else traced
        if self._capture_set and self.in_capture_block(node):
            return True
        fn = self.enclosing_function(node)
        while fn is not None:
            if fn in traced:
                return True
            fn = self.enclosing_function(fn)
        return False

    # --------------------------------------------------------- jit registry
    def _collect_jit_registry(self) -> list[JitEntry]:
        entries: list[JitEntry] = []
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                if self.resolve(node.value.func) not in TRACE_WRAPPERS:
                    continue
                for target in node.targets:
                    if isinstance(target, ast.Name):
                        kind, name = "name", target.id
                    elif isinstance(target, ast.Attribute):
                        kind, name = "attr", target.attr
                    else:
                        continue
                    entries.append(JitEntry(kind, name, node))
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if any(self._is_trace_wrapper_decorator(d) for d in node.decorator_list):
                    entries.append(JitEntry("name", node.name, node))
        return entries

    def is_step_call(self, call: ast.Call) -> bool:
        """A call that runs one step of an engine: a compiled/captured
        callable, ``graph.replay()``, or a step function by the engines'
        names (``train_step``, ``_decode_step``, ``prefill_step``, ...)."""
        if any(e.matches_call(call) for e in self.jit_registry):
            return True
        f = call.func
        name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")
        return bool(STEP_CALL_RE.match(name)) or (
            isinstance(f, ast.Attribute) and f.attr == "replay" and not call.args
        )

    # ----------------------------------------------------------- value taint
    def expr_level(self, node: ast.AST, levels: dict[str, int]) -> int:
        """Taint level of an expression's VALUE: 0 = host-static, 1 =
        WEAK (derived from a traced function's parameters — may be a
        tensor OR a static Python scalar passed alongside; never worth
        flagging a branch on), 2 = STRONG (derived from a torch-namespace
        call or a step call — certainly a tensor on the device). Static
        tensor attributes and methods (``.shape``, ``.size()``) and
        shape-reading builtins reset to 0."""
        if isinstance(node, ast.Name):
            return levels.get(node.id, 0)
        if isinstance(node, ast.Attribute):
            if node.attr in STATIC_ARRAY_ATTRS:
                return 0
            return self.expr_level(node.value, levels)
        if isinstance(node, ast.Call):
            if (
                isinstance(node.func, ast.Name)
                and node.func.id in _STATIC_BUILTINS
            ):
                return 0
            if (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in STATIC_TENSOR_METHODS
            ):
                return 0
            dotted = self.resolve(node.func)
            if self.is_torch_path(dotted):
                return 0 if dotted in _STATIC_TORCH_CALLS else 2
            if self.is_step_call(node):
                return 2
            if dotted is not None and dotted.split(".", 1)[0] in ("numpy", "math", "time"):
                return 0
            parts = list(node.args) + [kw.value for kw in node.keywords]
            if isinstance(node.func, ast.Attribute):
                parts.append(node.func)
            return max(
                (self.expr_level(p, levels) for p in parts), default=0
            )
        if isinstance(node, ast.Lambda):
            return 0
        return max(
            (
                self.expr_level(child, levels)
                for child in ast.iter_child_nodes(node)
                if isinstance(child, ast.expr)
            ),
            default=0,
        )


def assigned_names(node: ast.AST) -> set[str]:
    """Names bound by an assignment target (tuple-unpacking aware)."""
    out: set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and isinstance(n.ctx, (ast.Store, ast.Del)):
            out.add(n.id)
    return out


def stmt_targets(stmt: ast.stmt) -> set[str]:
    """Names a statement (re)binds at its own level."""
    if isinstance(stmt, ast.Assign):
        out: set[str] = set()
        for t in stmt.targets:
            out |= assigned_names(t)
        return out
    if isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        return assigned_names(stmt.target)
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        return assigned_names(stmt.target)
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        out = set()
        for item in stmt.items:
            if item.optional_vars is not None:
                out |= assigned_names(item.optional_vars)
        return out
    return set()
