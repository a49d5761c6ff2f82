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
bf16 split, the bias column sums) add bytes only. Each report also names
the launch's operands, the tensors whose pointers the kernel was given,
for a recording that sees no read inside the kernel
(``analysis/trace/dispatch.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Iterator, Sequence


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


def pointers(args: Sequence[Any]) -> tuple[list[Any], tuple[Any, ...]]:
    """A launch's arguments with each tensor among them replaced by its
    data pointer, and those tensors: its C arguments and its operands."""
    tensors = tuple(a for a in args if hasattr(a, "data_ptr"))
    return [a.data_ptr() if hasattr(a, "data_ptr") else a for a in args], tensors


def add(flops: float, nbytes: float, operands: Sequence[Any] = ()) -> None:
    """A call's FLOPs and bytes, into every active counter. ``operands``,
    the tensors the launch reads or writes, are for a recording's hook
    and count nothing here."""
    for costs in _active:
        costs.flops += flops
        costs.bytes_accessed += nbytes
