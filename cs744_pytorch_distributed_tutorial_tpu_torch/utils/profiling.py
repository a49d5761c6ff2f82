"""Profiler traces and annotations (the JAX package's ``utils/profiling.py``).

The reference's only instrumentation is wall-clock deltas printed at
batch 10 (``master/part1/part1.py:39-44``), which on an asynchronous
device measure the launches, not the work. Here: ``torch.profiler``
traces over CPU and CUDA activity, written as Chrome traces (viewable in
``chrome://tracing`` or ui.perfetto.dev), plus named regions that show
on them.
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
