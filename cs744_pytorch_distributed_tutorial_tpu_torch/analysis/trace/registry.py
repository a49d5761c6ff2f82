"""Entry-point registry for graftcheck and graftmem on the port.

The twin of the JAX package's ``analysis/trace/registry.py``. The audits
need REAL steps — the port's own ``Trainer``, ``LMTrainer`` and
``ServingEngine`` running one step of their own code, with their real
sync strategy and process group — not reconstructions that could drift
from production. So the engine modules define factories, registered by
:func:`load_builtin_entrypoints` (no production path imports this
package)::

    # in train/engine.py
    register_entrypoint("cifar", _cifar_entry)

A factory is called lazily by the CLI with the device to build on
(building a trainer is not free) and returns a :class:`TracedStep`
bundling a callable that runs one step, the state the step promises to
update in place, and the engine's own expectations (schedule, wire
bytes) for TA003 to cross-check against the recording. A factory builds
on the process group that exists, or joins a world of one
(:func:`ensure_process_group`).

Registration captures the CALLER's file and line so that graftlint-style
``# graftlint: disable=TA00x`` pragmas placed on the registering line
suppress findings for that entry — trace findings have no single source
line of their own, so the registration site is their anchor.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, Callable

import torch


@dataclasses.dataclass
class TracedStep:
    """One auditable step plus everything the audits need.

    ``fn`` runs ONE real step of the engine (no arguments; its inputs are
    bound) and returns what the step returns. ``state()`` returns, by
    collection, the tensors the step promises to update IN PLACE
    (parameters, momentum, AdamW moments, KV pools) as the engine holds
    them now — the eager twin of JAX's ``donate_argnums``: TA002 reads it
    before and after the step and checks the storages are the same.
    ``args`` names the step's other inputs (the batch); with the state
    they are the memory ledger's argument set.
    """

    name: str
    fn: Callable[[], Any]
    state: Callable[[], dict[str, list[torch.Tensor]]]
    args: dict[str, list[torch.Tensor]]
    #: mesh axis sizes, e.g. ``{"data": 4}``
    axis_sizes: dict[str, int]
    #: sync strategy name (``parallel.sync.SYNC_STRATEGIES`` key) or None
    sync: str | None = None
    grad_compress: str = "none"
    compute_dtype: str = "float32"
    #: expected gradient-collective counts per JAX class; None skips the
    #: schedule assertion
    expected_schedule: dict[str, int] | None = None
    #: the engine's analytic per-device bytes-on-wire per step (what it
    #: logs as ``grad_sync_bytes``); None skips the bytes cross-check
    expected_wire_bytes: float | None = None
    #: whether the step promises in-place state (enables TA002/TA010)
    check_donation: bool = True
    #: ``state`` collections the sync strategy promises to SHARD (zero1
    #: momentum rows, fsdp parameter rows), each with its leaves' GLOBAL
    #: ``(shape, dtype)``: TA008 flags a leaf this rank holds whole
    sharded_state: dict[str, list[tuple[tuple[int, ...], torch.dtype]]] = dataclasses.field(
        default_factory=dict)
    #: TA006: named variants of the step taken on a runtime predicate, each
    #: a callable running the step one way; their schedules must agree
    branches: dict[str, Callable[[], Any]] = dataclasses.field(default_factory=dict)
    #: extra context echoed into the JSON report
    detail: dict[str, Any] = dataclasses.field(default_factory=dict)

    def arg_tensors(self) -> list[torch.Tensor]:
        return [t for ts in self.args.values() for t in ts]


@dataclasses.dataclass(frozen=True)
class TraceEntry:
    """A registered (but not yet built) entry point."""

    name: str
    factory: Callable[..., TracedStep]
    path: str
    line: int
    tags: tuple[str, ...] = ()

    def build(self, device: str = "cuda") -> TracedStep:
        step = self.factory(device=device)
        if step.name != self.name:
            step = dataclasses.replace(step, name=self.name)
        return step


_REGISTRY: dict[str, TraceEntry] = {}


def register_entrypoint(
    name: str,
    factory: Callable[..., TracedStep],
    *,
    tags: tuple[str, ...] = (),
) -> TraceEntry:
    """Register ``factory`` (called as ``factory(device=...)``) under
    ``name``, anchoring findings to the caller's file/line. Re-registering
    a name replaces the old entry, so repeated loads are harmless."""
    frame = sys._getframe(1)
    entry = TraceEntry(
        name=name,
        factory=factory,
        path=frame.f_code.co_filename,
        line=frame.f_lineno,
        tags=tuple(tags),
    )
    _REGISTRY[name] = entry
    return entry


def get_entrypoints(names: list[str] | None = None) -> list[TraceEntry]:
    """Registered entries, insertion-ordered; ``names`` filters and
    raises on unknowns so typos fail loudly."""
    if names is None:
        return list(_REGISTRY.values())
    missing = [n for n in names if n not in _REGISTRY]
    if missing:
        known = ", ".join(sorted(_REGISTRY)) or "<none>"
        raise KeyError(
            f"unknown trace entrypoint(s) {missing}; registered: {known}"
        )
    return [_REGISTRY[n] for n in names]


def load_builtin_entrypoints() -> None:
    """Register the engines' entry points (the JAX registry's nine names).
    Import errors propagate (a broken engine should fail the audit, not
    silently shrink its coverage); the call is idempotent."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.serve import engine as serve_engine
    from cs744_pytorch_distributed_tutorial_tpu_torch.train import engine, lm

    engine._register_trace_entries()
    lm._register_lm_trace_entries()
    serve_engine._register_serve_trace_entries()


def ensure_process_group(device: torch.device) -> None:
    """Join a world of one when no process group exists (NCCL for a card,
    Gloo for the CPU), so that every strategy's collectives run; an
    existing group is used as it is."""
    import torch.distributed as dist

    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import mesh

    if not dist.is_initialized():
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        mesh.initialize(None, 1, 0, device=device)
