"""In-memory snapshots: recovery that reads no file.

A port of the JAX package's ``utils/memstore.py``. ``ReplicatedSnapshot``
keeps the last ``max_to_keep`` certified training states
(``Trainer.capture_state``) as host-RAM copies. The engine feeds it
through the same pending/certify gate as the disk ``Checkpointer`` (a
state is kept only once a later finite loss certifies its parameters),
so a restore never hands back a state whose own forward pass diverged.

For the common transient failures (a flaky NaN, a step the watchdog
aborted) the state that was just live on the card is still in host RAM:
``restore_latest`` touches no file (the tests hold it to the
``Checkpointer``'s counters). ``save`` copies every tensor to the host
before it returns, so the next step may overwrite the live ones. The
copy lives in this process's RAM: a process that dies takes it along,
and the disk tier is what survives that.
"""

from __future__ import annotations

from cs744_pytorch_distributed_tutorial_tpu_torch.utils.checkpoint import to_host


class ReplicatedSnapshot:
    """Ring of the last ``max_to_keep`` states, keyed by step, in host RAM."""

    def __init__(self, max_to_keep: int = 2):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.max_to_keep = max_to_keep
        self._ring: dict[int, dict] = {}
        self.saves = 0
        self.restores = 0

    def save(self, state: dict, *, step: int | None = None) -> int:
        """Keep a host copy of ``state`` under ``step`` (default: its own
        ``"step"``); returns the key. Re-saving a step overwrites it."""
        host = to_host(state)
        step = int(host["step"]) if step is None else int(step)
        self._ring[step] = host
        while len(self._ring) > self.max_to_keep:
            del self._ring[min(self._ring)]
        self.saves += 1
        return step

    def steps(self) -> list[int]:
        return sorted(self._ring)

    def latest_step(self) -> int | None:
        return max(self._ring) if self._ring else None

    def restore_latest(self) -> dict | None:
        """The newest snapshot (host tensors), or None when empty. The
        caller copies it into its live tensors; the ring keeps its own."""
        step = self.latest_step()
        if step is None:
            return None
        self.restores += 1
        return self._ring[step]

    def clear(self) -> None:
        self._ring.clear()
