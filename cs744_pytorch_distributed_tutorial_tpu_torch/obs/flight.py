"""Flight recorder: straggler detection and dumps when a run goes wrong.

A port of the JAX package's ``obs/flight.py``. A bounded in-memory tail
of per-step wall times, cheap enough to keep always on, dumped as
``kind="event"`` records when something goes wrong:

- ``StragglerMonitor``: MAD outliers over a ring of per-step wall times
  (the median and MAD are robust to the outliers they hunt; a sigma
  floor keeps sub-millisecond steps from flagging scheduler noise);
- ``HbmHighWater``: per-device peak allocated bytes that rose since the
  last look (``torch.cuda.memory_stats``; nothing on the CPU);
- ``FlightRecorder``: dumps the above through a ``Telemetry``.
  ``install()`` chains ``sys.excepthook`` and, from the main thread
  only, SIGTERM; the watchdog (``utils/failure.py``) dumps on a hang.
"""

from __future__ import annotations

import signal
import statistics
import sys
import threading
import time
from collections import deque
from typing import Any, Callable

import torch

__all__ = ["StragglerMonitor", "HbmHighWater", "FlightRecorder"]

# 1 MAD of a normal distribution = 1/1.4826 sigma.
_MAD_TO_SIGMA = 1.4826


class StragglerMonitor:
    """Per-step wall-time ring with MAD outlier detection.

    ``record(step, wall_s)`` judges the new step against the PRIOR
    window (so an outlier cannot vote on its own threshold), then
    appends it. Returns an outlier dict or None. Thread-compatible with
    the engines' single-threaded step loops; not locked.
    """

    def __init__(
        self,
        window: int = 512,
        mad_k: float = 5.0,
        min_samples: int = 16,
        floor_s: float = 1e-4,
        max_outliers: int = 32,
    ):
        if window < 2:
            raise ValueError(f"window must be >= 2, got {window}")
        self.window = window
        self.mad_k = float(mad_k)
        self.min_samples = int(min_samples)
        self.floor_s = float(floor_s)
        # (step, wall_s, t_wall, t_mono) — the record-time stamp pair
        # makes dumped tails placeable on the merged fleet timeline.
        self._ring: deque[tuple[int, float, float, float]] = deque(
            maxlen=window
        )
        self.outliers: deque[dict[str, Any]] = deque(maxlen=max_outliers)
        self.steps_recorded = 0
        self._max_s = 0.0

    def _median_mad(self) -> tuple[float, float]:
        vals = [entry[1] for entry in self._ring]
        med = statistics.median(vals)
        mad = statistics.median(abs(v - med) for v in vals)
        return med, mad

    def record(self, step: int, wall_s: float) -> dict[str, Any] | None:
        """Record one step; return an outlier record if this step is a
        straggler relative to the window BEFORE it."""
        wall_s = float(wall_s)
        out = None
        if len(self._ring) >= self.min_samples:
            med, mad = self._median_mad()
            # Floored sigma: MAD=0 (perfectly uniform window) must not
            # make every jitter an outlier, and a 5%-of-median floor
            # absorbs ordinary scheduler noise on fast steps.
            sigma = max(_MAD_TO_SIGMA * mad, 0.05 * med, self.floor_s)
            if wall_s > med + self.mad_k * sigma:
                out = {
                    "step": int(step),
                    "wall_s": wall_s,
                    "median_s": med,
                    "mad_s": mad,
                    "excess_sigma": (wall_s - med) / sigma,
                    "t_wall": time.time(),
                    "t_mono": time.monotonic(),
                }
                self.outliers.append(out)
        self._ring.append((int(step), wall_s, time.time(), time.monotonic()))
        self.steps_recorded += 1
        self._max_s = max(self._max_s, wall_s)
        return out

    def stats(self) -> dict[str, Any]:
        s: dict[str, Any] = {
            "steps_recorded": self.steps_recorded,
            "window": len(self._ring),
            "outlier_count": len(self.outliers),
            "max_s": self._max_s,
        }
        if len(self._ring) >= 2:
            med, mad = self._median_mad()
            s["median_s"] = med
            s["mad_s"] = mad
        return s

    def tail(self, n: int = 32) -> list[dict[str, Any]]:
        return [
            {
                "step": step,
                "wall_s": wall_s,
                "t_wall": t_wall,
                "t_mono": t_mono,
            }
            for step, wall_s, t_wall, t_mono in list(self._ring)[-n:]
        ]


class HbmHighWater:
    """Per-device peak allocated bytes through ``obs/system.py::hbm_stats``.

    ``snapshot()`` re-reads each device and returns those whose
    ``peak_bytes_in_use`` rose since the last snapshot. Devices without
    memory statistics (the CPU) contribute nothing.
    """

    def __init__(self, devices: Any = None):
        from cs744_pytorch_distributed_tutorial_tpu_torch.obs.system import hbm_stats

        self._hbm_stats = hbm_stats
        if devices is None:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        self.devices = list(devices)
        self._peaks: dict[int, int] = {}
        self.snapshot()  # the baseline

    def snapshot(self) -> list[dict[str, Any]]:
        deltas = []
        for i, d in enumerate(self.devices):
            stats = self._hbm_stats(d)
            if not stats or "peak_bytes_in_use" not in stats:
                continue
            peak = int(stats["peak_bytes_in_use"])
            prev = self._peaks.get(i)
            if prev is not None and peak > prev:
                deltas.append(
                    {
                        "device": i,
                        "peak_bytes_in_use": peak,
                        "delta_bytes": peak - prev,
                        "bytes_in_use": stats.get("bytes_in_use"),
                    }
                )
            self._peaks[i] = peak
        return deltas

    def highwater(self) -> dict[str, int]:
        return {f"hbm_peak_dev{i}": p for i, p in sorted(self._peaks.items())}


class FlightRecorder:
    """Dumps the straggler/timing tail as structured telemetry events.

    One ``flight_dump`` header event (reason, straggler stats, HBM
    high-water), then one ``flight_step`` event per tail step and one
    ``flight_straggler`` event per recorded outlier — flat records so
    every sink (JSONL, stream, ring) can carry them and
    ``metrics_summary`` can count them. Dump triggers: watchdog fire
    (wired in ``utils/failure.py``), uncaught exception + SIGTERM (via
    ``install()``), or an explicit call.

    Engines can attach state of their own: ``header_fn`` returns extra
    flat fields merged into the ``flight_dump`` header, and each
    ``tails`` entry (name -> zero-arg fn returning flat records) dumps
    its last ``ring_tail`` records as ``flight_<name>`` events.
    """

    def __init__(
        self,
        telemetry: Any = None,
        straggler: StragglerMonitor | None = None,
        hbm: HbmHighWater | None = None,
        ring_tail: int = 32,
        emit: Callable[..., None] | None = None,
        tails: dict[str, Callable[[], list]] | None = None,
        header_fn: Callable[[], dict] | None = None,
    ):
        if telemetry is None and emit is None:
            raise ValueError("FlightRecorder needs a telemetry or an emit fn")
        self._emit = emit if emit is not None else telemetry.emit_event
        self.straggler = straggler
        self.hbm = hbm
        self._tails = dict(tails or {})
        self._header_fn = header_fn
        self.ring_tail = int(ring_tail)
        self.dumps = 0
        self._lock = threading.Lock()
        self._prev_sigterm: Any = None
        self._prev_excepthook: Any = None
        self._installed = False

    def dump(self, reason: str, **extra: Any) -> None:
        """Emit the flight tail. Never raises: this runs on the way down
        (crash, preemption, hang) and must not mask the original error."""
        with self._lock:
            self.dumps += 1
            try:
                header: dict[str, Any] = {"reason": reason, **extra}
                if self.straggler is not None:
                    for k, v in self.straggler.stats().items():
                        header[f"straggler_{k}"] = v
                if self.hbm is not None:
                    self.hbm.snapshot()
                    header.update(self.hbm.highwater())
                if self._header_fn is not None:
                    header.update(self._header_fn())
                self._emit("flight_dump", **header)
                if self.straggler is not None:
                    for rec in self.straggler.tail(self.ring_tail):
                        self._emit("flight_step", **rec)
                    for out in list(self.straggler.outliers):
                        self._emit("flight_straggler", **out)
                for name, tail_fn in self._tails.items():
                    for rec in list(tail_fn())[-self.ring_tail:]:
                        self._emit(f"flight_{name}", **rec)
            except Exception:
                pass

    # -- process-level triggers ------------------------------------------

    def install(self, sigterm: bool = True, excepthook: bool = True) -> None:
        """Chain SIGTERM + uncaught-exception dumps. Previous handlers
        still run (preemption semantics are preserved: after dumping, a
        default-action SIGTERM is re-raised so the process still dies)."""
        if self._installed:
            return
        if excepthook:
            prev_hook = sys.excepthook
            self._prev_excepthook = prev_hook

            def hook(exc_type, exc, tb):
                self.dump("exception", error=repr(exc))
                prev_hook(exc_type, exc, tb)

            sys.excepthook = hook
        if sigterm:
            # Signal handlers can be set from the main thread only (not
            # from a thread or a test runner's worker thread); the
            # excepthook and watchdog triggers work anywhere.
            if threading.current_thread() is threading.main_thread():
                self._prev_sigterm = signal.signal(signal.SIGTERM, self._on_sigterm)
        self._installed = True

    def _on_sigterm(self, signum, frame):
        self.dump("sigterm")
        prev = self._prev_sigterm
        if callable(prev):
            prev(signum, frame)
        elif prev == signal.SIG_DFL:
            # Honor the default action: die of SIGTERM with the handler
            # out of the way so the re-raise isn't caught again.
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            signal.raise_signal(signal.SIGTERM)

    def uninstall(self) -> None:
        if not self._installed:
            return
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
            self._prev_excepthook = None
        if self._prev_sigterm is not None:
            try:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
            except ValueError:
                pass
            self._prev_sigterm = None
        self._installed = False
