"""Profiler traces and annotations (the JAX package's ``utils/profiling.py``).

The reference's only instrumentation is wall-clock deltas printed at
batch 10 (``master/part1/part1.py:39-44``), which on an asynchronous
device measure the launches, not the work. Here: ``torch.profiler``
traces over CPU and CUDA activity, written as Chrome traces (viewable in
``chrome://tracing`` or ui.perfetto.dev), plus named regions that show
on them; ``device_op_breakdown``, the device time of a function by
kernel.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile, record_function


class Trace:
    """One capture: ``start()``, then ``stop()`` writes
    ``trace_rank<r>_<ns>.json`` into ``log_dir`` and returns its path."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self.path: str | None = None

    def start(self) -> None:
        self._prof.start()

    def stop(self) -> str:
        self._prof.stop()
        os.makedirs(self.log_dir, exist_ok=True)
        rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
        self.path = os.path.join(self.log_dir, f"trace_rank{rank}_{time.time_ns()}.json")
        self._prof.export_chrome_trace(self.path)
        return self.path


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[Trace]:
    """Capture a trace of the enclosed region into ``log_dir``::

        with profiling.trace("/tmp/trace"):
            trainer.train_step(x, y)
            torch.cuda.synchronize()
    """
    capture = Trace(log_dir)
    capture.start()
    try:
        yield capture
    finally:
        capture.stop()


def annotate(name: str):
    """A named region on the profiler's timeline::

        with profiling.annotate("input_fetch"):
            batch = next(loader)
    """
    return record_function(name)


def step_annotation(name: str, step: int):
    """A step marker: the region ``<name>#<step>``."""
    return record_function(f"{name}#{step}")


def device_op_breakdown(fn, *args, iters: int = 3, top: int = 20, trace_dir: str | None = None):
    """Run ``fn(*args)`` ``iters`` times under a profiler trace and return
    its per-op device time: ``(total_ms, [(ms_per_iter, op_name), ...])``,
    the device events summed by name and averaged over ``iters``, sorted
    descending; ``total_ms`` is their interval union per iteration (NCCL's
    stream and the compute stream overlap). One warm-up call runs outside
    the trace; ``torch.cuda.synchronize()`` fences the timed calls. On the
    CPU there are no device lanes: ``(0.0, [])``. When the profiler's
    traces of work on a card hold no device event, ``total_ms`` is the
    CUDA events' span and there are no rows.

    A shim over ``obs.phases.capture_device_profile``: the phase profiler
    and this breakdown share one warm-up, fence and trace-parsing path."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.obs.phases import capture_device_profile

    prof = capture_device_profile(fn, *args, iters=iters, top=top, trace_dir=trace_dir)
    return prof.device_ms, prof.op_rows
