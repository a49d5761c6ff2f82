"""Per-phase attribution of a training step (the JAX package's
``obs/phases.py``).

A step's wall-clock time says nothing of how many milliseconds are
forward, backward, gradient sync or optimizer. This module builds that
instrument for both trainers:

1. **Segmented step.** The step is cut into eager callables on the
   trainer's own model, sync and optimizer: ``forward`` (the loss),
   ``grads`` (forward plus ``backward()``, the gradients left local),
   ``sync`` (the gradient sync alone) and ``opt`` (the update alone), and
   ``fused`` (the trainer's own ``train_step``). Each is timed by
   ``capture_device_profile`` (the one trace-capture path;
   ``utils/profiling.py::device_op_breakdown`` is a shim over it).
   Backward is ``t(grads) - t(forward)``; the forward segment records its
   autograd graph, as the grads segment does, so the difference is the
   backward pass.
2. **Parity.** The segments composed must give the fused step's loss and
   parameters within the sync-parity tolerances (``PARITY_*``): the
   attribution of a step that computes something else is worthless.
3. **Costs.** ``segment_costs``: FLOPs from
   ``torch.utils.flop_counter.FlopCounterMode``, bytes from a dispatch
   mode that sums every aten op's input and output bytes, each plus what
   the hand-written kernels report (``ops/_cost.py``); the sync's wire
   bytes from ``parallel/sync.py::sync_wire_bytes``; MFU against the
   card's peak (``obs/flops.py``) and a compute/memory/comms roofline
   class.
4. **sync_exposed_ms** = ``max(0, fused - (grads + opt))``: the sync time
   the fused step did not hide behind compute. It goes to ~0 when the
   overlap works while the isolated sync segment stays constant.

Restrictions (``ValueError``, raised before any work, as in JAX): the
sync must be a separate pass, so ``accum_steps == 1``, no ``fsdp`` (its
gradient reduction is the backward of its parameter all-gather), no
``fused_optimizer`` (JAX's one whole-tree kernel); zero1 only bucketed
over more than one rank (the per-tensor path has no buckets to carve).
zero1's sync segment is its per-bucket reduce-scatter (or int8 wire),
its optimizer segment the chunk updates and the delta all-gathers, as
JAX counts them. ``'auto'`` (DDP) and ``'none'`` are segmented through
the explicit allreduce, numerically the same mean; a world of one
without a process group (``'none'``, and the one-device LM) has no sync
program: its phase reads 0 ms and is not traced.

The port's trainers are stateful where JAX's are functional: every timed
call moves BatchNorm's running statistics, the step, the augmentation
generator, error feedback and the optimizer's moments. The profilers
take ``capture_state(clone=True)`` first and restore it after the parity
runs and after each segment's timing, so the fused and the segmented
runs start from one state and the caller gets the trainer back as it
gave it (gradients included).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import sys
import time
from typing import Any, Callable, Iterator

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_leaves

from cs744_pytorch_distributed_tutorial_tpu_torch.obs import flops as _flops
from cs744_pytorch_distributed_tutorial_tpu_torch.ops import _cost

__all__ = [
    "PARITY_RTOL",
    "PARITY_ATOL",
    "PARITY_LOSS_RTOL",
    "PHASE_NAMES",
    "DEVICE_CLOCKS",
    "DeviceProfile",
    "capture_device_profile",
    "world_agree",
    "segment_costs",
    "roofline_classify",
    "PhaseStat",
    "PhaseReport",
    "CifarSegments",
    "LMSegments",
    "build_cifar_segments",
    "build_lm_segments",
    "profile_phases",
    "profile_lm_phases",
    "render_phase_table",
    "phase_records_from_stream",
]

# The sync-parity tolerances (the JAX suite's tests/test_sync_parity.py):
# the segmented composition must agree with the fused step to float32
# noise. Loosened only for sub-f32 compute dtypes (``_parity_tols``).
PARITY_RTOL = 1e-5
PARITY_ATOL = 1e-6
PARITY_LOSS_RTOL = 1e-6

PHASE_NAMES = ("forward", "backward", "grad_sync", "optimizer")

# The roofline's ridge (FLOPs a byte) for a device without known peaks:
# the JAX package's figure, a TPU v5e's 197e12 / 819e9 ~= 240. A known
# card uses its own (obs/flops.py: an H100 SXM's 989e12 / 3.35e12 ~= 295).
DEFAULT_RIDGE_FLOPS_PER_BYTE = 240.0

# Seconds of idle time inside a card's trace on each side of the timed
# calls, one a trace attempt (the profiler now and then returns a trace
# without device events). The profiler keeps only the device events
# whose timestamps, mapped to the host clock, fall inside its window, and
# late in a long process it loses some or all of a short trace's events.
# When every attempt comes back empty, CUDA events time the calls.
_TRACE_PADS_S = (0.1, 0.5, 2.0)
_TRACE_ATTEMPTS = len(_TRACE_PADS_S)

# The clocks that time work on a card: the trace's device events, or CUDA
# events on the current stream when the traces held none.
DEVICE_CLOCKS = ("device", "events")


# ---------------------------------------------------------------------------
# Trace capture: the shared path (device_op_breakdown is a shim over it)
# ---------------------------------------------------------------------------


def _first_tensor(tree: Any) -> torch.Tensor | None:
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            return leaf
    return None


def _device_of(*trees: Any) -> torch.device:
    for tree in trees:
        t = _first_tensor(tree)
        if t is not None:
            return t.device
    return torch.device("cpu")


def _fence(device: torch.device) -> None:
    """The completion fence: every launch on the card has finished."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class DeviceProfile:
    """One timed region: device time (the interval union of the trace's
    device events, or the CUDA events' span when the traces held none),
    fenced host wall time, and the top op rows, all per iteration."""

    device_ms: float  # 0.0 when the trace has no device lanes (CPU)
    wall_ms: float
    op_rows: list  # [(ms_per_iter, op_name), ...] descending
    iters: int
    from_events: bool = False  # device_ms from CUDA events, op_rows empty

    @property
    def clock(self) -> str:
        """Which clock ``best_ms`` reports: ``"device"`` when the trace
        yielded device lanes, ``"events"`` when CUDA events timed the
        calls instead, else the fenced ``"wall"`` clock."""
        if self.device_ms <= 0.0:
            return "wall"
        return "events" if self.from_events else "device"

    def best_ms(self) -> float:
        return self.device_ms if self.device_ms > 0.0 else self.wall_ms


def _interval_union_us(lane: list[tuple[float, float]]) -> float:
    """Total time covered by ``(start, duration)`` intervals: JAX
    ``_parse_trace``'s union over one device lane. Nested events count
    once, overlapping ones their tail past the covered end. Ties sort by
    ``-duration`` so a parent sharing its first child's start wins."""
    total, end = 0.0, float("-inf")
    for ts, dur in sorted(lane, key=lambda td: (td[0], -td[1])):
        if ts >= end:
            total += dur
            end = ts + dur
        elif ts + dur > end:
            total += ts + dur - end
            end = ts + dur
    return total


def _device_events(prof) -> list:
    """The trace's device events (kernels, copies, sets), less the user
    annotations the profiler also lays on the device timeline."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def _parse_events(events: list, iters: int, top: int) -> tuple[float, list]:
    """Device events -> (device ms per iteration, top op rows). The total
    is the per-device union of the events over all streams (NCCL's stream
    and the compute stream overlap, so a sum would count time twice)."""
    durs: collections.Counter = collections.Counter()
    lanes: dict = collections.defaultdict(list)
    for e in events:
        dur = e.time_range.elapsed_us()
        if dur > 0:
            durs[e.name] += dur
            lanes[e.device_index].append((e.time_range.start, dur))
    rows = sorted(((v / iters / 1e3, k) for k, v in durs.items()), reverse=True)
    total_us = sum(_interval_union_us(lane) for lane in lanes.values())
    return total_us / iters / 1e3, rows[:top]


def _events_ms(fn: Callable, args: tuple, iters: int, device: torch.device) -> float:
    """Device ms a call of ``fn(*args)``: the span between two CUDA events
    on the device's current stream around ``iters`` calls, fenced."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    stream = torch.cuda.current_stream(device)
    start.record(stream)
    for _ in range(iters):
        fn(*args)
    end.record(stream)
    _fence(device)
    return start.elapsed_time(end) / iters


def capture_device_profile(
    fn: Callable,
    *args: Any,
    iters: int = 3,
    top: int = 20,
    trace_dir: str | None = None,
    agree: Callable[[bool], bool] | None = None,
) -> DeviceProfile:
    """Run ``fn(*args)`` ``iters`` times under ``torch.profiler`` (CPU and,
    for work on a card, CUDA activity) after one warm-up call outside the
    trace; ``torch.cuda.synchronize()`` fences the timed calls. Returns
    the per-iteration device time, wall time and top device-op rows; with
    ``trace_dir`` the Chrome trace is written there.

    The card is the device of the first tensor ``fn`` returns (else of
    its arguments). On the CPU there are no device lanes: ``device_ms``
    is 0.0 and the clock ``"wall"``. On a card the timed calls sit
    between two idle pads inside the trace (``_TRACE_PADS_S``), and a
    trace with no device event is retaken up to ``_TRACE_ATTEMPTS`` times
    with a longer pad (the profiler now and then returns one empty); each
    empty trace is reported on stderr. When all come back empty, CUDA
    events time ``iters`` more calls: the clock is ``"events"``, the span
    on the current stream (idle gaps between launches included), and
    there are no op rows. The wall clock never stands in for a card's.

    ``agree`` takes the decision to retake out of one rank's hands: given
    whether this rank's trace holds device events, it returns whether
    every rank's does (``world_agree``, a MIN all-reduce over the process
    group). A caller whose ``fn`` issues collectives on several ranks
    passes it, so all retake together, fall back to the events together,
    or stop together; a rank that went on alone would run ``fn``'s
    collectives while the others wait in theirs. Without it (a caller on
    one rank, even under an initialized group) the trace decides."""
    from torch.profiler import ProfilerActivity, profile

    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    device = _device_of(fn(*args), args)  # the warm-up, outside the trace
    _fence(device)
    on_card = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    for attempt in range(_TRACE_ATTEMPTS):
        pad_s = _TRACE_PADS_S[attempt] if on_card else 0.0
        with profile(activities=activities) as prof:
            time.sleep(pad_s)
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            _fence(device)
            wall_ms = (time.perf_counter() - t0) * 1e3 / iters
            time.sleep(pad_s)
        events = _device_events(prof) if on_card else []
        if not on_card or (agree(bool(events)) if agree is not None else events):
            break
        what = "another rank's trace holds" if events else "holds"
        print(f"capture_device_profile: trace {attempt + 1} of {_TRACE_ATTEMPTS} on {device} "
              f"(pads {pad_s} s) {what} no device event", file=sys.stderr, flush=True)
    else:
        device_ms = _events_ms(fn, args, iters, device)
        print(f"capture_device_profile: timed with CUDA events instead: {device_ms:.4f} ms a "
              f"call on {device} (wall {wall_ms:.4f} ms)", file=sys.stderr, flush=True)
        return DeviceProfile(device_ms=device_ms, wall_ms=wall_ms, op_rows=[], iters=iters,
                             from_events=True)
    if trace_dir is not None:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, f"phases_{time.time_ns()}.json"))
    device_ms, rows = _parse_events(events, iters, top)
    return DeviceProfile(device_ms=device_ms, wall_ms=wall_ms, op_rows=rows, iters=iters)


# ---------------------------------------------------------------------------
# Cost counting + roofline
# ---------------------------------------------------------------------------


def _moves_no_bytes(func) -> bool:
    """Views and uninitialised allocations read and write nothing."""
    return func.is_view or func.overloadpacket.__name__.startswith(("empty", "new_empty"))


def _bytes_of(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _bytes_mode():
    from torch.utils._python_dispatch import TorchDispatchMode

    class BytesMode(TorchDispatchMode):
        """Every aten op's input and output tensor bytes, summed."""

        def __init__(self):
            super().__init__()
            self.nbytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not _moves_no_bytes(func):
                self.nbytes += _bytes_of((args, kwargs)) + _bytes_of(out)
            return out

    return BytesMode()


def segment_costs(fn: Callable, *args: Any) -> dict[str, float | None]:
    """``{'flops': F, 'bytes_accessed': B}`` of one call of ``fn(*args)``
    (which it runs, fenced).

    ``flops`` is what ``FlopCounterMode`` counts (matrix products,
    convolutions, attention; 2 a multiply-add) plus the products of the
    hand-written kernels, which ``ctypes`` launches out of the
    dispatcher's sight and which report their own (``ops/_cost.py``).
    ``bytes_accessed`` sums each aten op's input and output tensor bytes,
    views and empty allocations aside, plus each kernel's bytes: the
    unfused analog of XLA's "bytes accessed", higher than a fused count,
    since every intermediate is written by one op and read by the next.
    Elementwise work adds no FLOPs, as in ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode

    bytes_mode = _bytes_mode()
    with _cost.counting() as kernels, FlopCounterMode(display=False) as flop_mode, bytes_mode:
        out = fn(*args)
    _fence(_device_of(out, args))
    return {
        "flops": float(flop_mode.get_total_flops() + kernels.flops),
        "bytes_accessed": float(bytes_mode.nbytes + kernels.bytes_accessed),
    }


def roofline_classify(
    flops: float | None,
    bytes_accessed: float | None,
    device_kind: str | None,
    *,
    comm_bytes: float = 0.0,
) -> str:
    """'comms' | 'compute' | 'memory' | 'unknown'.

    A phase that puts bytes on the wire is comms-bound by construction.
    Otherwise its arithmetic intensity is held against the card's ridge
    (peak FLOP/s over memory bytes/s, ``obs/flops.py::card_peaks``), or,
    for a device without known peaks, ``DEFAULT_RIDGE_FLOPS_PER_BYTE``."""
    if comm_bytes and comm_bytes > 0:
        return "comms"
    if not flops or not bytes_accessed:
        return "unknown"
    peaks = _flops.card_peaks(device_kind or "")
    ridge = peaks[0] / peaks[1] if peaks else DEFAULT_RIDGE_FLOPS_PER_BYTE
    return "compute" if flops / bytes_accessed >= ridge else "memory"


# ---------------------------------------------------------------------------
# Report types
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PhaseStat:
    name: str
    device_ms: float
    wall_ms: float
    clock: str
    flops: float | None
    bytes_accessed: float | None
    comm_bytes: float
    mfu: float | None
    roofline: str

    def best_ms(self) -> float:
        return self.device_ms if self.device_ms > 0.0 else self.wall_ms


@dataclasses.dataclass
class PhaseReport:
    """Per-phase stats and the fused-vs-segmented comparison,
    serializable as flat telemetry records."""

    phases: list[PhaseStat]
    fused_ms: float
    fused_clock: str
    segmented_total_ms: float
    sync_exposed_ms: float
    parity_ok: bool
    loss_fused: float
    loss_segmented: float
    max_param_abs_diff: float
    n_chips: int
    device_kind: str
    batch: int | None
    iters: int

    def phase(self, name: str) -> PhaseStat:
        for p in self.phases:
            if p.name == name:
                return p
        raise KeyError(name)

    def records(self, run: str = "phase") -> list[dict[str, Any]]:
        """Flat sink-ready records: one ``kind="phase"`` per phase plus
        one ``kind="phase_summary"``."""
        recs: list[dict[str, Any]] = []
        for p in self.phases:
            recs.append(
                {
                    "kind": "phase",
                    "run": run,
                    "phase": p.name,
                    "device_ms": round(p.device_ms, 4),
                    "wall_ms": round(p.wall_ms, 4),
                    "clock": p.clock,
                    "flops": p.flops,
                    "bytes_accessed": p.bytes_accessed,
                    "comm_bytes": p.comm_bytes,
                    "mfu": p.mfu,
                    "roofline": p.roofline,
                    "iters": self.iters,
                }
            )
        recs.append(
            {
                "kind": "phase_summary",
                "run": run,
                "fused_step_ms": round(self.fused_ms, 4),
                "fused_clock": self.fused_clock,
                "segmented_total_ms": round(self.segmented_total_ms, 4),
                "sync_exposed_ms": round(self.sync_exposed_ms, 4),
                "parity_ok": self.parity_ok,
                "loss_fused": self.loss_fused,
                "loss_segmented": self.loss_segmented,
                "max_param_abs_diff": self.max_param_abs_diff,
                "n_chips": self.n_chips,
                "device_kind": self.device_kind,
                "batch": self.batch,
                "iters": self.iters,
            }
        )
        return recs

    def table(self) -> str:
        return render_phase_table(self.records())


def _fmt_num(v: Any) -> str:
    if v is None:
        return "-"
    if isinstance(v, bool):
        return str(v)
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def render_phase_table(records: list[dict[str, Any]]) -> str:
    """Render ``kind="phase"``/``kind="phase_summary"`` records (any mixed
    stream; other kinds are ignored) into the phase table, shared by
    ``python -m ...obs report`` and ``bench.py --phase-breakdown``."""
    phases = [r for r in records if r.get("kind") == "phase"]
    summaries = [r for r in records if r.get("kind") == "phase_summary"]
    if not phases and not summaries:
        return "(no phase records)"
    cols = ("phase", "ms", "clock", "flops", "bytes", "comm B", "MFU", "roofline")
    rows = [cols]
    for r in phases:
        ms = r.get("device_ms") if r.get("clock") in DEVICE_CLOCKS else r.get("wall_ms")
        rows.append(
            (
                str(r.get("phase")),
                _fmt_num(ms),
                str(r.get("clock", "-")),
                _fmt_num(r.get("flops")),
                _fmt_num(r.get("bytes_accessed")),
                _fmt_num(r.get("comm_bytes")),
                _fmt_num(r.get("mfu")),
                str(r.get("roofline", "-")),
            )
        )
    widths = [max(len(row[i]) for row in rows) for i in range(len(cols))]
    lines = [
        "  ".join(cell.ljust(widths[i]) for i, cell in enumerate(row)).rstrip()
        for row in rows
    ]
    for s in summaries:
        lines.append("")
        lines.append(
            f"fused step: {_fmt_num(s.get('fused_step_ms'))} ms "
            f"({s.get('fused_clock', '-')})   segmented total: "
            f"{_fmt_num(s.get('segmented_total_ms'))} ms"
        )
        lines.append(
            f"sync_exposed_ms: {_fmt_num(s.get('sync_exposed_ms'))}   "
            f"parity_ok: {s.get('parity_ok')}   "
            f"loss fused/segmented: {_fmt_num(s.get('loss_fused'))}/"
            f"{_fmt_num(s.get('loss_segmented'))}"
        )
    return "\n".join(lines)


def phase_records_from_stream(
    records: list[dict[str, Any]],
) -> list[dict[str, Any]]:
    """Filter a telemetry stream down to the phase records."""
    return [
        r for r in records if r.get("kind") in ("phase", "phase_summary")
    ]


# ---------------------------------------------------------------------------
# Parity
# ---------------------------------------------------------------------------


@torch.no_grad()
def _check_parity(
    loss_fused: float,
    loss_segmented: float,
    params_fused: list[torch.Tensor],
    params_segmented: list[torch.Tensor],
    *,
    rtol: float,
    atol: float,
    loss_rtol: float,
) -> tuple[bool, float]:
    """(parity_ok, max param abs diff) under the sync-parity discipline:
    ``|a - b| <= atol + rtol |b|`` element by element, in float64."""
    ok = abs(loss_fused - loss_segmented) <= max(loss_rtol * abs(loss_fused), 1e-12)
    max_diff = 0.0
    for a, b in zip(params_fused, params_segmented, strict=True):
        a, b = a.double(), b.double()
        if a.numel():
            max_diff = max(max_diff, float((a - b).abs().max()))
        if not torch.allclose(a, b, rtol=rtol, atol=atol):
            ok = False
    return ok, max_diff


def _parity_tols(compute_dtype: str) -> tuple[float, float, float]:
    """(rtol, atol, loss_rtol): the f32 sync-parity tolerances, loosened
    when the compute dtype rounds harder than f32: the fused and the
    segmented step may take other kernels, so bf16 sums in another order."""
    if compute_dtype in ("float32", "f32"):
        return PARITY_RTOL, PARITY_ATOL, PARITY_LOSS_RTOL
    return 1e-2, 1e-3, 1e-2


# ---------------------------------------------------------------------------
# CIFAR engine segments
# ---------------------------------------------------------------------------


class CifarSegments:
    """The segments of one CIFAR ``Trainer`` step, on its own model, sync
    and optimizer. Each mutates the trainer as the step it is cut from:
    ``grads`` leaves the local gradients in ``p.grad`` (and moves the
    BatchNorm statistics and the augmentation generator), ``sync`` syncs
    them in place (and moves the error feedback), ``opt`` updates the
    parameters and the step. ``sync`` is None where there is no sync
    program (a world of one without a process group)."""

    def __init__(self, trainer: Any):
        cfg = trainer.cfg
        if cfg.accum_steps != 1:
            raise ValueError(
                "phase segmentation requires accum_steps=1: with accumulation the "
                "sync runs per microbatch or after the sum and cannot be carved into "
                "its own segment"
            )
        if trainer._fsdp or cfg.fused_optimizer:
            raise ValueError(
                f"phase segmentation does not support sync={cfg.sync!r}/"
                f"fused_optimizer={cfg.fused_optimizer}: fsdp's gradient reduction "
                "is the backward of its parameter all-gather (inside backward) and "
                "the fused update is one whole-model kernel; neither has a separable "
                "sync phase. allreduce/ring/zero1 (fused or overlapped) are segmentable"
            )
        if trainer._zero1 and not (trainer._bucket_bytes and trainer.world_size > 1):
            raise ValueError(
                "zero1 phase segmentation requires the bucketed multi-rank path "
                "(sync_bucket_mb > 0, world size > 1): the per-tensor path has no "
                "bucket lanes to carve"
            )
        self.trainer = trainer
        self.compress = trainer._compress
        self.overlap = trainer._overlap
        self.zero1 = trainer._zero1
        # 'auto' and 'none' have no explicit sync pass; the explicit
        # allreduce is the same mean.
        self.sync_name = "allreduce" if cfg.sync in ("auto", "none") else cfg.sync
        self.sync = self._sync if dist.is_initialized() else None

    def _loss(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """The engine's exact loss (``Trainer.train_step``): augmentation
        from the trainer's generator, autocast (the ViT casts itself), the
        ViT's dropout under the step's key, label smoothing; on the bare
        module, outside DDP, so backward leaves the gradients local."""
        from cs744_pytorch_distributed_tutorial_tpu_torch.data.augment import (
            augment_train_batch,
            eval_batch,
        )
        from cs744_pytorch_distributed_tutorial_tpu_torch.train.engine import _smoothed_xent

        tr, cfg = self.trainer, self.trainer.cfg
        x = augment_train_batch(tr.augment_gen, x) if cfg.augment else eval_batch(x)
        tr.model.train()
        key = tr._dropout_key(0)
        with tr._autocast():
            logits = tr.model(x) if key is None else tr.model(x, dropout=key)
        return _smoothed_xent(logits.float(), y, cfg.label_smoothing)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """The local loss (its autograd graph recorded, then dropped)."""
        return self._loss(x, y).detach()

    def grads(self, x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, list]:
        """(local loss, local gradients)."""
        params = self.trainer.params
        for p in params:
            p.grad = None
        loss = self._loss(x, y)
        loss.backward()
        return loss.detach(), [p.grad for p in params]

    def _layout(self):
        from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.overlap import overlap_layout

        tr = self.trainer
        if self.zero1:
            return tr.tx.layout(tr.params)
        return overlap_layout(tr.params, tr.cfg.sync, tr.world_size, tr._bucket_bytes,
                              compressed=self.compress)

    @torch.no_grad()
    def _sync(self, grads: list) -> list:
        """The gradient sync alone (``sync``). The fused schedule's syncs the
        gradients in place and returns them; the overlapped schedule's
        (``parallel/overlap.py``) returns each reverse-order bucket's
        synced buffer; zero1's each bucket's rows of the mean
        (reduce-scatter, or the int8 wire). The int8 wire's residuals go
        to the error feedback, as in the step."""
        from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import buckets as B
        from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.sync import (
            sync_bucket,
            sync_bucket_compressed,
            sync_grads,
            sync_grads_compressed,
        )

        tr = self.trainer
        ef = tr.state.ef
        if not (self.overlap or self.zero1):
            if self.compress:
                sync_grads_compressed(grads, ef, tr.cfg.sync, tr.world_size,
                                      bucket_bytes=tr._bucket_bytes)
            else:
                sync_grads(grads, self.sync_name, tr.world_size, tr._bucket_bytes)
            return grads
        layout = self._layout()
        out = []
        for b, members in enumerate(B.bucket_members(layout)):
            gbuf = B.flatten_bucket(grads, layout, b, members)
            ebuf = B.flatten_bucket(ef, layout, b, members) if self.compress else None
            if self.zero1:
                synced, resid = tr.tx.scatter_bucket(gbuf, ebuf)
            elif self.compress:
                synced, resid = sync_bucket_compressed(gbuf, ebuf, tr.cfg.sync, tr.world_size)
            else:
                synced, resid = sync_bucket(gbuf, tr.cfg.sync, tr.world_size), None
            if resid is not None:
                for i in members:
                    ef[i].copy_(B.leaf_view(resid, layout, layout.slots[i]))
            out.append(synced)
        return out

    @torch.no_grad()
    def opt(self, synced: list) -> list:
        """The update alone, from ``sync``'s output (or the local
        gradients where there is no sync): the trainer's optimizer, the
        overlapped schedule's per-bucket fused SGD, or zero1's chunk
        updates and delta all-gathers."""
        from cs744_pytorch_distributed_tutorial_tpu_torch.ops.fused_sgd import fused_sgd_multi_
        from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import buckets as B

        tr, cfg = self.trainer, self.trainer.cfg
        params, momentum = tr.state.params, tr.state.momentum
        if not (self.overlap or self.zero1):
            tr.tx.apply(params, momentum, synced)
        else:
            layout = self._layout()
            for b, members in enumerate(B.bucket_members(layout)):
                if self.zero1:
                    tr.tx.update_bucket(params, momentum, layout, members, synced[b])
                    continue
                fused_sgd_multi_(
                    [params[i] for i in members], [momentum[i] for i in members],
                    [B.leaf_view(synced[b], layout, layout.slots[i]) for i in members],
                    lr=cfg.learning_rate, mu=cfg.momentum, wd=cfg.weight_decay)
        tr.state.step += 1
        return params

    def fused(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """The trainer's own step: its local loss."""
        return self.trainer.train_step(x, y)

    def segmented_step(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """The segments composed into one full step; the local loss."""
        loss, g = self.grads(x, y)
        self.opt(g if self.sync is None else self.sync(g))
        return loss


def build_cifar_segments(trainer: Any) -> CifarSegments:
    return CifarSegments(trainer)


# ---------------------------------------------------------------------------
# LM engine segments
# ---------------------------------------------------------------------------


class LMSegments:
    """The segments of one ``LMTrainer`` step (pure data-parallel layouts
    only, as in JAX: seq and tensor collectives live inside the forward).
    ``sync`` is the data-parallel reduction the step runs (JAX
    ``obs/phases.py``'s LM carving): the all-reduce mean, the int8 wire
    with this rank's residuals, or under ``sync_overlap`` each
    reverse-order bucket's; at a world of one it runs as copies. It is
    None only without a process group, where the step has no sync. Under
    dropout the segments draw the masks of the trainer's step
    (``objective``'s key), as the fused step does, and JAX's segments at
    that step. The losses the segments return are the world's means."""

    def __init__(self, trainer: Any):
        cfg = trainer.cfg
        if cfg.accum_steps != 1:
            raise ValueError("phase segmentation requires accum_steps=1")
        if cfg.zero1 or cfg.fsdp:
            raise ValueError(
                "LM phase segmentation does not support zero1/fsdp: the data-parallel "
                "reduction is fused into the sharded update (and for fsdp it is the "
                "backward of the parameter all-gather). Time those schedules with the CIFAR "
                "engine's zero1 segments, or from a profile_dir trace"
            )
        if (cfg.seq_parallel > 1 or cfg.tensor_parallel > 1 or cfg.moe_expert_parallel):
            raise ValueError(
                "LM phase segmentation requires a pure data-parallel layout "
                "(seq_parallel=1, no tensor axis, no expert parallelism): other axes' "
                "collectives run inside the forward and cannot be separated into a "
                "sync phase"
            )
        if trainer.model is None:
            raise ValueError("LM phase segmentation needs an initialized trainer (init())")
        self.trainer = trainer
        self.compress = trainer._compress
        self.overlap = trainer._overlap
        self.sync = self._sync if trainer._synced else None

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """The engine's loss (``LMTrainer.objective``), its graph dropped."""
        return self.trainer.objective(x, y)[0].detach()

    def grads(self, x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, list]:
        """(the world's mean loss, this rank's local gradients)."""
        params = self.trainer.optimizer.params
        for p in params:
            p.grad = None
        loss, _ = self.trainer.objective(x, y)
        loss.backward()
        return self.trainer.world_mean({"loss": loss.detach()})["loss"], [p.grad for p in params]

    @torch.no_grad()
    def _sync(self, grads: list) -> list:
        """The gradient sync alone: in place for the fused schedule (its
        gradients returned), each reverse-order bucket's synced buffer for
        the overlapped one; the int8 wire's residuals go to the trainer's
        error feedback, as in the step."""
        from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import buckets as B
        from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.sync import (
            sync_bucket,
            sync_bucket_compressed,
            sync_grads,
            sync_grads_compressed,
        )

        tr = self.trainer
        ef, n = tr._ef, tr.world_size
        if not self.overlap:
            if self.compress:
                sync_grads_compressed(grads, ef, "int8_allreduce", n,
                                      bucket_bytes=tr._bucket_bytes)
            else:
                sync_grads(grads, "allreduce", n, tr._bucket_bytes)
            return grads
        layout = tr.overlap.layout
        out = []
        for b, members in enumerate(B.bucket_members(layout)):
            gbuf = B.flatten_bucket(grads, layout, b, members)
            if self.compress:
                synced, resid = sync_bucket_compressed(
                    gbuf, B.flatten_bucket(ef, layout, b, members), "allreduce", n)
                for i in members:
                    ef[i].copy_(B.leaf_view(resid, layout, layout.slots[i]))
            else:
                synced = sync_bucket(gbuf, "allreduce", n)
            out.append(synced)
        return out

    @torch.no_grad()
    def opt(self, synced: list) -> list:
        """The update alone from ``sync``'s output (or the local gradients
        where there is no sync): the trainer's optimizer, or the
        overlapped schedule's fused SGD a bucket."""
        from cs744_pytorch_distributed_tutorial_tpu_torch.ops.fused_sgd import fused_sgd_multi_
        from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import buckets as B

        tr, cfg = self.trainer, self.trainer.cfg
        opt = tr.optimizer
        if not self.overlap:
            opt.tx.apply(opt.params, opt.momentum, synced)
        else:
            layout = tr.overlap.layout
            for b, members in enumerate(B.bucket_members(layout)):
                fused_sgd_multi_(
                    [opt.params[i] for i in members], [opt.momentum[i] for i in members],
                    [B.leaf_view(synced[b], layout, layout.slots[i]) for i in members],
                    lr=cfg.learning_rate, mu=cfg.momentum, wd=cfg.weight_decay)
        tr.step += 1
        return opt.params

    def fused(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return self.trainer.train_step(x, y)["loss"]

    def segmented_step(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        loss, g = self.grads(x, y)
        self.opt(g if self.sync is None else self.sync(g))
        return loss


def build_lm_segments(trainer: Any) -> LMSegments:
    return LMSegments(trainer)


# ---------------------------------------------------------------------------
# The profiler
# ---------------------------------------------------------------------------


def _sub(a: float | None, b: float | None) -> float | None:
    if a is None or b is None:
        return None
    return max(0.0, a - b)


def _phase_stat(
    name: str,
    prof: DeviceProfile,
    costs: dict[str, float | None],
    device_kind: str,
    *,
    comm_bytes: float = 0.0,
) -> PhaseStat:
    ms = prof.best_ms()
    mfu = None
    peak = _flops.peak_flops_per_card(device_kind)
    if peak and costs["flops"] and ms > 0:
        mfu = costs["flops"] / (ms / 1e3) / peak
    return PhaseStat(
        name=name,
        device_ms=prof.device_ms,
        wall_ms=prof.wall_ms,
        clock=prof.clock,
        flops=costs["flops"],
        bytes_accessed=costs["bytes_accessed"],
        comm_bytes=comm_bytes,
        mfu=mfu,
        roofline=roofline_classify(
            costs["flops"],
            costs["bytes_accessed"],
            device_kind,
            comm_bytes=comm_bytes,
        ),
    )


def _derived_backward(
    grads_prof: DeviceProfile,
    fwd_prof: DeviceProfile,
    grads_costs: dict[str, float | None],
    fwd_costs: dict[str, float | None],
    device_kind: str,
) -> PhaseStat:
    """backward = (fwd+bwd) - fwd, per clock and per cost counter."""
    device_ms = max(0.0, grads_prof.device_ms - fwd_prof.device_ms)
    wall_ms = max(0.0, grads_prof.wall_ms - fwd_prof.wall_ms)
    costs = {
        "flops": _sub(grads_costs["flops"], fwd_costs["flops"]),
        "bytes_accessed": _sub(
            grads_costs["bytes_accessed"], fwd_costs["bytes_accessed"]
        ),
    }
    prof = DeviceProfile(
        device_ms=device_ms,
        wall_ms=wall_ms,
        op_rows=[],
        iters=grads_prof.iters,
        from_events=grads_prof.from_events or fwd_prof.from_events,
    )
    return _phase_stat("backward", prof, costs, device_kind)


def _assemble_report(
    *,
    fwd,
    grads,
    sync,
    opt,
    fused,
    comm_bytes: float,
    parity_ok: bool,
    loss_fused: float,
    loss_segmented: float,
    max_param_abs_diff: float,
    n_chips: int,
    device_kind: str,
    batch: int | None,
    iters: int,
) -> PhaseReport:
    """(prof, costs) pairs per segment -> the PhaseReport."""
    fwd_prof, fwd_costs = fwd
    grads_prof, grads_costs = grads
    sync_prof, sync_costs = sync
    opt_prof, opt_costs = opt
    fused_prof = fused
    phases = [
        _phase_stat("forward", fwd_prof, fwd_costs, device_kind),
        _derived_backward(
            grads_prof, fwd_prof, grads_costs, fwd_costs, device_kind
        ),
        _phase_stat(
            "grad_sync",
            sync_prof,
            sync_costs,
            device_kind,
            comm_bytes=comm_bytes,
        ),
        _phase_stat("optimizer", opt_prof, opt_costs, device_kind),
    ]
    fused_ms = fused_prof.best_ms()
    segmented_total = (
        grads_prof.best_ms() + sync_prof.best_ms() + opt_prof.best_ms()
    )
    # Sync time the fused step did NOT hide: what the fused step costs
    # beyond its comm-free work (fwd+bwd + opt). The isolated sync
    # segment's time bounds it from above on a quiet machine.
    sync_exposed = max(
        0.0, fused_ms - (grads_prof.best_ms() + opt_prof.best_ms())
    )
    return PhaseReport(
        phases=phases,
        fused_ms=fused_ms,
        fused_clock=fused_prof.clock,
        segmented_total_ms=segmented_total,
        sync_exposed_ms=sync_exposed,
        parity_ok=parity_ok,
        loss_fused=loss_fused,
        loss_segmented=loss_segmented,
        max_param_abs_diff=max_param_abs_diff,
        n_chips=n_chips,
        device_kind=device_kind,
        batch=batch,
        iters=iters,
    )


@contextlib.contextmanager
def _preserved(trainer: Any, params: list[torch.Tensor]) -> Iterator[Callable[[], None]]:
    """Yield ``restore()``, which puts the trainer back in the state it had
    on entry (``capture_state(clone=True)``); on exit, restore it and the
    parameters' ``grad`` too."""
    saved = trainer.capture_state(clone=True)
    grads = [p.grad for p in params]

    def restore() -> None:
        trainer.restore_state(saved)

    try:
        yield restore
    finally:
        restore()
        for p, g in zip(params, grads):
            p.grad = g


def _world_reduce(value: float, op) -> float:
    """``value`` reduced over the process group's ranks (itself alone
    without one)."""
    if not (dist.is_initialized() and dist.get_world_size() > 1):
        return value
    t = torch.tensor([value], dtype=torch.float64)
    if dist.get_backend() == "nccl":
        t = t.cuda()
    dist.all_reduce(t, op=op)
    return float(t)


def world_agree(flag: bool) -> bool:
    """Whether ``flag`` holds on every rank of the process group: a MIN
    all-reduce, as ``_world_reduce``; every rank must call it."""
    return _world_reduce(float(flag), dist.ReduceOp.MIN) == 1.0


def _profile(segs: Any, params: list[torch.Tensor], x: Any, y: Any, *, iters: int, top: int,
             compute_dtype: str, comm_bytes: float, device: torch.device, n_chips: int,
             batch: int, global_mean: Callable[[torch.Tensor], float]) -> PhaseReport:
    """Parity-check the segments against the fused step, then cost and time
    each one, the trainer restored after each."""
    trainer = segs.trainer
    rtol, atol, loss_rtol = _parity_tols(compute_dtype)
    # Every rank times the segments' collectives together: one decision a
    # trace for all of them.
    cap = lambda fn, *a: capture_device_profile(  # noqa: E731
        fn, *a, iters=iters, top=top, agree=world_agree)

    def timed(fn, *args) -> tuple[DeviceProfile, dict]:
        costs = segment_costs(fn, *args)
        restore()
        prof = cap(fn, *args)
        restore()
        return prof, costs

    def sync_inputs() -> list:
        return segs.grads(x, y)[1]

    with _preserved(trainer, params) as restore:
        loss_f = segs.fused(x, y)
        params_f = [p.detach().clone() for p in params]
        restore()
        loss_s = segs.segmented_step(x, y)
        params_s = [p.detach().clone() for p in params]
        restore()
        ok, max_diff = _check_parity(float(loss_f), float(loss_s), params_f, params_s,
                                     rtol=rtol, atol=atol, loss_rtol=loss_rtol)
        del params_f, params_s
        parity_ok = _world_reduce(float(ok), dist.ReduceOp.MIN) == 1.0
        max_diff = _world_reduce(max_diff, dist.ReduceOp.MAX)
        loss_fused, loss_segmented = global_mean(loss_f), global_mean(loss_s)

        fwd = timed(segs.forward, x, y)
        grads = timed(segs.grads, x, y)
        if segs.sync is None:
            # No sync program: nothing runs, on any clock.
            sync = (DeviceProfile(0.0, 0.0, [], iters), {"flops": None, "bytes_accessed": None})
            synced = sync_inputs()
        else:
            sync_costs = segment_costs(segs.sync, sync_inputs())
            restore()
            sync_prof = cap(segs.sync, sync_inputs())
            restore()
            sync = (sync_prof, sync_costs)
            synced = segs.sync(sync_inputs())
        restore()
        opt = timed(segs.opt, synced)
        del synced
        fused = cap(segs.fused, x, y)
    device_kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return _assemble_report(
        fwd=fwd, grads=grads, sync=sync, opt=opt, fused=fused, comm_bytes=comm_bytes,
        parity_ok=parity_ok, loss_fused=loss_fused, loss_segmented=loss_segmented,
        max_param_abs_diff=max_diff, n_chips=n_chips, device_kind=device_kind, batch=batch,
        iters=iters,
    )


def profile_phases(
    trainer: Any,
    x: torch.Tensor,
    y: torch.Tensor,
    *,
    iters: int = 3,
    top: int = 10,
) -> PhaseReport:
    """Segment, parity-check and time one CIFAR ``Trainer`` step on this
    rank's uint8 batch ``x`` and labels ``y`` (every rank calls it
    together). The trainer is restored to its state on entry. The parity
    check runs first, on the inputs the timed calls use; ``parity_ok`` and
    the largest parameter gap are the world's, the losses the world's
    means."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.sync import sync_wire_bytes

    segs = build_cifar_segments(trainer)
    cfg = trainer.cfg
    # The strategy the segments time, so the bytes describe it.
    comm_bytes = float(sync_wire_bytes(trainer.params, segs.sync_name, trainer.world_size,
                                       cfg.grad_compress, bucket_bytes=trainer._bucket_bytes,
                                       overlap=segs.overlap))
    return _profile(segs, trainer.params, x, y, iters=iters, top=top,
                    compute_dtype=cfg.compute_dtype, comm_bytes=comm_bytes,
                    device=trainer.device, n_chips=trainer.world_size,
                    batch=cfg.global_batch_size, global_mean=trainer.global_mean)


def profile_lm_phases(
    trainer: Any,
    x: torch.Tensor,
    y: torch.Tensor,
    *,
    iters: int = 3,
    top: int = 10,
) -> PhaseReport:
    """The LM counterpart of :func:`profile_phases`, on an initialized
    ``LMTrainer`` and a batch ``(x, y)`` of its ``split_batch``."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.sync import (
        lm_strategy,
        sync_wire_bytes,
    )

    segs = build_lm_segments(trainer)
    cfg = trainer.cfg
    params = trainer.optimizer.params
    comm_bytes = float(sync_wire_bytes(params, lm_strategy(False, False, cfg.grad_compress),
                                       trainer.world_size, cfg.grad_compress,
                                       bucket_bytes=trainer._bucket_bytes, overlap=segs.overlap))
    return _profile(segs, params, x, y, iters=iters, top=top,
                    compute_dtype=cfg.compute_dtype, comm_bytes=comm_bytes,
                    device=trainer.device, n_chips=trainer.world_size,
                    batch=cfg.global_batch_size, global_mean=float)
