"""Analytic costs of the hand-written kernels, for cost counters.

A kernel launched through ``ctypes`` on raw pointers is invisible to
PyTorch's dispatcher, so neither ``torch.utils.flop_counter.FlopCounterMode``
nor a ``TorchDispatchMode`` sees it. Each wrapper therefore reports the
work of every launch here (``add``), beside its launch count, and the
phase profiler (``obs/phases.py::segment_costs``) reads it through
``counting()``. The counts are the ones behind ``PERF.md``'s bound
column: the bytes a launch must move (each input read once, each output
written once) and the FLOPs of its matrix products (2 a multiply-add), the
same quantity ``FlopCounterMode`` counts for PyTorch's own products; the
elementwise and reduction kernels (the cross-entropy, the SGD update, the
bf16 split, the bias column sums) add bytes only.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator


@dataclasses.dataclass
class KernelCosts:
    flops: float = 0.0
    bytes_accessed: float = 0.0


_active: list[KernelCosts] = []


@contextlib.contextmanager
def counting() -> Iterator[KernelCosts]:
    """Sum the costs of every kernel launched in the block, from any
    thread (the autograd engine runs CUDA backward on its own)."""
    costs = KernelCosts()
    _active.append(costs)
    try:
        yield costs
    finally:
        _active.remove(costs)


def active() -> bool:
    """Whether a counter is open: a wrapper whose cost needs a value on
    the card (the paged kernel's live rows) reads it only then."""
    return bool(_active)


def add(flops: float, nbytes: float) -> None:
    """A call's FLOPs and bytes, into every active counter."""
    for costs in _active:
        costs.flops += flops
        costs.bytes_accessed += nbytes
