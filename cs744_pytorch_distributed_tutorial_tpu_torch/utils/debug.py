"""Replica-divergence detection.

The reference's collectives are synchronous (``async_op=False`` at
``master/part2a/part2a.py:44,52``), but nothing checks that the ranks'
models stay in lockstep. A wrong or missing gradient sync leaves each
rank training its own drifting model while every step succeeds.

Port of the JAX package's ``utils/debug.py``. With
``TrainConfig(debug_sync_check=True)`` the Trainer all-gathers each
rank's ``tree_checksum`` of its synced gradients (zero1: of its
parameters after the update) every step, one fp32 scalar a rank, and
hands the gathered tensor to ``DivergenceMonitor``; the values reach the
host when the monitor is read (at each epoch's end), so the check adds
no host sync to a step.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Sequence

import torch


def tree_checksum(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Scalar fingerprint of a list of tensors: the sum of their fp32 L1
    norms (0-dim, on their device). Equal synced gradients give equal
    checksums; a drifting rank shows within a step or two."""
    total = torch.zeros((), dtype=torch.float32,
                        device=tensors[0].device if tensors else None)
    for t in tensors:
        total = total + t.float().abs().sum()
    return total


class DivergenceMonitor:
    """(step, rank, checksum) records; flags steps where the ranks disagree.

    A step diverges when a checksum is not finite or differs from the
    step's first-seen rank by more than ``rtol`` (relative, floor 1).
    Records older than ``window`` steps are pruned; divergent step ids
    are kept."""

    def __init__(self, rtol: float = 1e-6, window: int = 4096):
        self.rtol = rtol
        self.window = window
        self._records: OrderedDict[int, dict[int, float]] = OrderedDict()
        self._divergent: set[int] = set()
        self._steps_seen = 0
        self._pending: list[tuple[int, torch.Tensor]] = []

    def record(self, step: int, replica: int, checksum: float) -> None:
        step, replica, checksum = int(step), int(replica), float(checksum)
        by_replica = self._records.get(step)
        if by_replica is None:
            by_replica = self._records[step] = {}
            self._steps_seen += 1
            while len(self._records) > self.window:
                self._records.popitem(last=False)
        if not math.isfinite(checksum):
            self._divergent.add(step)
        elif by_replica:
            ref = next(iter(by_replica.values()))
            if abs(checksum - ref) > self.rtol * max(abs(ref), 1.0):
                self._divergent.add(step)
        by_replica[replica] = checksum

    def record_world(self, step: int, checksums: torch.Tensor) -> None:
        """Every rank's checksum of ``step`` (``[world]``, rank order,
        possibly on the device): recorded when the monitor is next read."""
        self._pending.append((step, checksums))

    def flush(self) -> None:
        """Fetch the pending records to the host."""
        pending, self._pending = self._pending, []
        for step, checksums in pending:
            for replica, value in enumerate(checksums.tolist()):
                self.record(step, replica, value)

    @property
    def steps_recorded(self) -> int:
        self.flush()
        return self._steps_seen

    def replicas_seen(self, step: int) -> int:
        self.flush()
        return len(self._records.get(int(step), ()))

    def divergent_steps(self) -> list[int]:
        """Steps where a rank disagreed beyond rtol or was not finite."""
        self.flush()
        return sorted(self._divergent)

    def assert_in_sync(self) -> None:
        bad = self.divergent_steps()
        if bad:
            raise AssertionError(
                f"replica divergence detected at steps {bad[:10]}"
                + ("..." if len(bad) > 10 else "")
                + " — gradient sync is broken or numerics are non-finite"
            )
