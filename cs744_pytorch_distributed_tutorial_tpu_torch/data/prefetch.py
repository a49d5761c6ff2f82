"""Background prefetch: overlap host batch assembly with the step.

The reference overlaps input work with training through DataLoader
worker processes and pinned staging memory (``num_workers=2,
pin_memory=True``, ``master/part1/part1.py:80-93``). Here, as in the JAX
package's ``data/prefetch.py``, a producer thread runs the loader
(index plan, native gather into pinned memory, copy to the device)
``depth`` batches ahead, so the host stages batch N+1 while the card
runs batch N.

On a card the copies must neither serialize with the step nor race it:

- the producer thread sets its device and issues every copy on a side
  ``torch.cuda.Stream`` of its own, then records an event behind the
  batch;
- the consumer makes its current stream wait on that event before it
  hands the batch out, and calls ``record_stream`` on each tensor, so the
  caching allocator does not reuse a batch's memory while the consumer's
  stream may still read it;
- one item behind, the producer synchronizes on the previous batch's
  event (the JAX package's one-behind ``block_until_ready``), so a
  device error surfaces on the producer and is relayed like any other.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Any, Iterable, Iterator, TypeVar

import torch

T = TypeVar("T")

_STOP = object()


def _tensors(item: Any) -> list[torch.Tensor]:
    if isinstance(item, torch.Tensor):
        return [item]
    if isinstance(item, (tuple, list)):
        return [t for x in item for t in _tensors(x)]
    return []


class PrefetchIterator(Iterator[T]):
    """Wrap any iterator; a daemon thread keeps ``depth`` items ready.

    ``device``, a CUDA device, puts the producer's work on a side stream
    (see the module's docstring); otherwise items pass as they are.
    Exceptions in the producer re-raise at the consuming ``next()``,
    after which the stream ends. ``close()`` (or garbage collection)
    stops the thread.
    """

    def __init__(self, iterable: Iterable[T], depth: int = 2,
                 device: torch.device | None = None):
        self._stop = threading.Event()
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._cuda = device is not None and torch.device(device).type == "cuda"
        self._device = torch.device(device) if self._cuda else None
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._exhausted = False
        self._thread = threading.Thread(
            target=self._produce, args=(iter(iterable),), daemon=True
        )
        self._thread.start()

    def _offer(self, item) -> bool:
        """Blocking put that still honors close(); True if enqueued."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self, it: Iterator[T]) -> None:
        try:
            ctx = contextlib.nullcontext()
            if self._cuda:
                torch.cuda.set_device(self._device)
                ctx = torch.cuda.stream(torch.cuda.Stream(self._device))
            with ctx:
                prev = None
                while True:
                    try:
                        item = next(it)
                    except StopIteration:
                        break
                    event = None
                    if self._cuda:
                        event = torch.cuda.Event()
                        event.record(torch.cuda.current_stream(self._device))
                    if prev is not None:
                        prev.synchronize()  # one behind: device errors surface here
                    prev = event
                    if not self._offer((item, event)):
                        return
                if prev is not None:
                    prev.synchronize()
            self._offer(_STOP)
        except BaseException as e:  # noqa: BLE001 — relayed to the consumer
            self._offer(e)
            # End the stream for a consumer that keeps reading after
            # catching the relayed exception.
            self._offer(_STOP)

    def __iter__(self) -> "PrefetchIterator[T]":
        return self

    def __next__(self) -> T:
        if self._exhausted:
            # StopIteration persists (the iterator protocol): the queue
            # holds one _STOP sentinel only.
            raise StopIteration
        got = self._q.get()
        if got is _STOP:
            self._exhausted = True
            raise StopIteration
        if isinstance(got, BaseException):
            raise got
        item, event = got
        if event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            for t in _tensors(item):
                if t.device.type == "cuda":
                    t.record_stream(stream)
        return item

    def close(self) -> None:
        self._stop.set()

    def __del__(self) -> None:  # pragma: no cover - GC timing
        self.close()


def prefetch(iterable: Iterable[T], depth: int = 2,
             device: torch.device | None = None) -> Iterator[T]:
    """Functional spelling: ``for batch in prefetch(loader.epoch(e), 2, dev):``;
    depth 0 is the iterator itself."""
    if depth == 0:
        return iter(iterable)
    return PrefetchIterator(iterable, depth, device)
