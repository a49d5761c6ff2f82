"""Per-step timing that respects asynchronous launches.

The reference times batches with ``datetime.now()`` at batches divisible
by 20, printing the delta at batch 10 divided by 9
(``master/part1/part1.py:39-44``). PyTorch returns before the card has
finished a step, so each ``tick()`` first records a ``torch.cuda.Event``
on the current stream and waits for it: the clock is read only once the
step's work is done. Step 0 (kernel builds, cuDNN autotuning, allocator
warm-up) is left out of the default window, batches 1-10.
"""

from __future__ import annotations

import time

import torch


class StepTimer:
    """Records per-step wall-clock; averages a window excluding step 0."""

    def __init__(self, window: tuple[int, int] = (1, 10), device: torch.device | None = None):
        self.window = window
        self.device = device
        self.durations: list[float] = []
        self._last: float | None = None

    def _fence(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            event.synchronize()

    def start(self) -> None:
        self._fence()
        self._last = time.perf_counter()

    def tick(self) -> float:
        self._fence()
        now = time.perf_counter()
        if self._last is None:
            self._last = now
            return 0.0
        dt = now - self._last
        self._last = now
        self.durations.append(dt)
        return dt

    @property
    def steps_recorded(self) -> int:
        return len(self.durations)

    def window_average(self) -> float | None:
        """Mean seconds/step over the configured window (0-indexed steps),
        or None until the window is complete."""
        first, last = self.window
        if len(self.durations) < last + 1:
            return None
        return sum(self.durations[first : last + 1]) / (last - first + 1)
