"""On-device metrics and the host-side ``Telemetry`` front-end.

A port of the JAX package's ``obs/metrics.py``. The device half computes
scalars where the tensors live (``tree_sq_norm``, ``tree_l2_norm``,
``expert_load_entropy``; ``speculative_accept_rate`` is host
arithmetic); the host reads them only at a fetch the engine
already makes. ``Telemetry`` owns the sinks (a ring always, which the
watchdog flushes; a rank-0 JSONL stream when ``metrics_dir`` is set),
stamps records with run, kind and time, amortizes ``step_time_s`` over
the steps between emissions, and derives MFU where the engine declared
its FLOPs a step and the card's peak is known (``obs/flops.py``).

Records are flat JSON objects: ``kind="step"`` (``run, step, time,
mono, process_id, generation, global_rank, step_time_s, loss, lr,
grad_sync_bytes, grad_norm, param_norm, ...``), ``kind="system"``
(device memory and kernel builds, ``obs/system.py``) and
``kind="event"`` (restores, non-finite losses, stragglers, evals,
watchdog and flight dumps).
"""

from __future__ import annotations

import math
import os
import time
from typing import Any, Iterable, Sequence

import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.obs import flops as _flops
from cs744_pytorch_distributed_tutorial_tpu_torch.obs import run_manifest as _run_manifest
from cs744_pytorch_distributed_tutorial_tpu_torch.obs import system as _system
from cs744_pytorch_distributed_tutorial_tpu_torch.obs.sinks import (
    JsonlSink,
    MultiSink,
    RingSink,
    rank_zero,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.collectives import reduce_by_axes
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.mesh import Mesh, world

__all__ = ["Telemetry", "expert_load_entropy", "tree_l2_norm", "tree_sq_norm"]

METRICS_NAME = "metrics.jsonl"


@torch.no_grad()
def tree_sq_norm(tensors: Sequence[torch.Tensor], axes: Sequence[tuple[str, ...]] | None = None,
                 mesh: Any = None) -> torch.Tensor:
    """Sum of squares over ``tensors`` in fp32 (each tensor's from its
    norm, one multi-tensor launch for them all), a 0-d tensor on their
    device, the same on every rank. ``axes`` (one tuple a tensor, of
    ``parallel/mesh.py``'s axis names): the axes over which the tensor is
    this rank's piece (a split parameter's ``spec_axes``; a sharded
    optimizer's rows add the data axis), so its squared sum is summed
    over them (JAX's psum a leaf) and a split tensor counts all its pieces,
    a replicated one once; one all-reduce for the tensors of each set of
    axes. ``mesh`` defaults to the process group as one data axis."""
    sq = torch.stack(torch._foreach_norm(list(tensors), 2, dtype=torch.float32)).square()
    if axes is not None:
        sq = torch.stack(reduce_by_axes(list(sq.unbind()), axes,
                                        mesh if mesh is not None else Mesh.get(world()[0]),
                                        mean=False))
    return sq.sum()


def tree_l2_norm(tensors: Sequence[torch.Tensor], axes: Sequence[tuple[str, ...]] | None = None,
                 mesh: Any = None) -> torch.Tensor:
    """Global L2 norm of ``tensors`` (see :func:`tree_sq_norm`)."""
    return tree_sq_norm(tensors, axes, mesh).sqrt()


def expert_load_entropy(load: torch.Tensor) -> torch.Tensor:
    """Normalized entropy of per-expert token-load fractions [..., E]:
    entropy / log(E) in [0, 1], averaged over leading dimensions (1.0 is
    balanced routing, 0.0 total collapse onto one expert); 1.0 for one
    expert. A 0-d fp32 tensor on ``load``'s device."""
    load = load.float()
    e = load.shape[-1]
    if e <= 1:
        return torch.ones((), device=load.device)
    p = load / load.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    ent = -(p * torch.log(p + 1e-9)).sum(dim=-1)
    return ent.mean() / math.log(e)


def speculative_accept_rate(new_tokens: int, target_calls: int, k: int) -> float | None:
    """The realized draft acceptance of a speculative decode: each target
    call yields one token of its own plus its accepted drafts, so the
    rate is ``(new_tokens / target_calls - 1) / k``, clipped to [0, 1];
    None without calls or drafts."""
    if target_calls <= 0 or k <= 0:
        return None
    rate = (new_tokens / target_calls - 1.0) / k
    return max(0.0, min(1.0, rate))


def _labels() -> dict[str, int]:
    """This process's identity stamps (``parallel/multihost.py::
    runtime_labels``: the supervisor's generation and global rank under
    an elastic launch, else the process group's rank)."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.multihost import runtime_labels

    labels = runtime_labels()
    return {k: labels[k] for k in ("process_id", "generation", "global_rank")}


class Telemetry:
    """The one object the engines talk to.

    ``due(step)`` is the emission gate the engines check at their
    existing fetch points; Telemetry never fetches from the device.
    """

    def __init__(
        self,
        metrics_dir: str | None = None,
        every: int = 1,
        run: str = "train",
        *,
        ring_capacity: int = 256,
        system_every: int = 5,  # a system record every N step records; 0 = off
        flops_per_step: float | None = None,
        n_chips: int = 1,
        device_kind: str | None = None,
        device: Any = None,
        extra_sinks: Iterable[Any] = (),
    ):
        self.metrics_dir = metrics_dir
        self.every = max(1, int(every))
        self.run = run
        self.flops_per_step = flops_per_step
        self.n_chips = max(1, int(n_chips))
        self.device_kind = device_kind
        self.device = device
        self.ring = RingSink(ring_capacity)
        sinks: list[Any] = [self.ring, *extra_sinks]
        self.path: str | None = None
        if metrics_dir is not None:
            os.makedirs(metrics_dir, exist_ok=True)
            self.path = os.path.join(metrics_dir, METRICS_NAME)
            sinks.append(rank_zero(JsonlSink(self.path)))
        self._sink = MultiSink(sinks)
        self._system = _system.SystemMonitor(device)
        self._system_every = max(0, int(system_every))
        self._emits = 0
        self._last_step: int | None = None
        self._last_mono: float | None = None
        self._closed = False

    def write_manifest(self, config: Any = None, **extra: Any) -> str | None:
        """``manifest.json`` beside the metrics (without a
        ``metrics_dir``, nothing; rank 0 only)."""
        if self.metrics_dir is None:
            return None
        return _run_manifest.write_manifest(self.metrics_dir, config=config,
                                            device=self.device, run=self.run, **extra)

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._sink.close()

    def due(self, step: int) -> bool:
        """Should the engine emit (and so fetch) at this step?"""
        return step % self.every == 0

    def emit_step(self, step: int, **fields: Any) -> None:
        """One step record. ``step_time_s`` is amortized over the steps
        since the previous record; MFU derives from it when the engine
        declared ``flops_per_step``."""
        now = time.monotonic()
        record: dict[str, Any] = {"kind": "step", "run": self.run, "step": int(step),
                                  "time": time.time(), "mono": now, **_labels()}
        step_time = None
        if self._last_mono is not None and self._last_step is not None:
            dsteps = int(step) - self._last_step
            if dsteps > 0:
                step_time = (now - self._last_mono) / dsteps
        self._last_mono, self._last_step = now, int(step)
        record["step_time_s"] = step_time
        if step_time and self.flops_per_step:
            record["mfu"] = _flops.mfu(self.flops_per_step / step_time / self.n_chips,
                                       self.device_kind or "")
        record.update(fields)
        self._sink.emit(record)
        self._emits += 1
        if self._system_every and self._emits % self._system_every == 0:
            self.emit_system(step)

    def emit_system(self, step: int | None = None) -> None:
        record: dict[str, Any] = {"kind": "system", "run": self.run, "time": time.time()}
        if step is not None:
            record["step"] = int(step)
        record.update(self._system.snapshot())
        self._sink.emit(record)

    def emit_event(self, event: str, **fields: Any) -> None:
        labels = _labels()
        record: dict[str, Any] = {
            "kind": "event", "run": self.run, "event": event, "time": time.time(),
            "monotonic": time.monotonic(), "process_id": labels["process_id"],
            "generation": labels["generation"],
        }
        record.update(fields)
        self._sink.emit(record)
