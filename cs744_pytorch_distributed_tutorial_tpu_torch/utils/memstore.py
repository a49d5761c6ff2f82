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
before it returns, so the next step may overwrite the live ones.

The JAX package's snapshot holds the global tree, because one controller
owns every device; a port rank holds only its own part. So that a
survivor of a lost rank can still restore with no file read, ``save``
at a world above one is a collective: every rank's state, less the
``shared`` collections (replicated on every rank: each rank keeps its
own copy of those), is all-gathered to every rank, and an entry holds
the whole world's states, as a checkpoint directory does.
``restore_latest(adapt=...)`` then re-cuts it for another world through
the trainer's ``elastic_state``, as ``Checkpointer.restore_latest`` does.
``gathered_bytes`` is what the last save received from the other ranks.
The copy lives in this process's RAM: a process that dies takes it
along, and the disk tier is what survives that.
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence

import torch
import torch.distributed as dist

from cs744_pytorch_distributed_tutorial_tpu_torch.utils.checkpoint import _group, to_host


def _tensor_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(v) for v in tree)
    return 0


class ReplicatedSnapshot:
    """Ring of the last ``max_to_keep`` states, keyed by step, in host RAM;
    an entry is every rank's state, in rank order."""

    def __init__(self, max_to_keep: int = 2):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.max_to_keep = max_to_keep
        self._ring: dict[int, list[dict]] = {}
        self.saves = 0
        self.restores = 0
        self.gathered_bytes = 0

    def save(self, state: dict, *, step: int | None = None, shared: Iterable[str] = ()) -> int:
        """Keep a host copy of ``state`` under ``step`` (default: its own
        ``"step"``); returns the key. Re-saving a step overwrites it. With
        more than one rank every rank calls this at the same point: the
        states (less the ``shared`` keys) are all-gathered."""
        host = to_host(state)
        step = int(host["step"]) if step is None else int(step)
        world, rank = _group()
        if world == 1:
            entry = [host]
            self.gathered_bytes = 0
        else:
            shared = set(shared)
            mine = {k: v for k, v in host.items() if k not in shared}
            every: list = [None] * world
            dist.all_gather_object(every, mine)
            entry = [dict(part, **{k: host[k] for k in shared}) for part in every]
            entry[rank] = host
            self.gathered_bytes = sum(_tensor_bytes(p) for r, p in enumerate(every) if r != rank)
        self._ring[step] = entry
        while len(self._ring) > self.max_to_keep:
            del self._ring[min(self._ring)]
        self.saves += 1
        return step

    def steps(self) -> list[int]:
        return sorted(self._ring)

    def latest_step(self) -> int | None:
        return max(self._ring) if self._ring else None

    def restore_latest(self, adapt: Callable[[Sequence[dict]], dict] | None = None
                       ) -> dict | None:
        """This rank's state from the newest snapshot (host tensors), or
        None when empty. ``adapt`` (a trainer's ``elastic_state``) builds
        it from every rank's state, which re-cuts a snapshot of another
        world; without it a snapshot of another world raises. The caller
        copies the result into its live tensors; the ring keeps its own."""
        step = self.latest_step()
        if step is None:
            return None
        entry = self._ring[step]
        world, rank = _group()
        if adapt is not None:
            state = adapt(entry)
        elif len(entry) != world:
            raise ValueError(
                f"snapshot of step {step} holds a world of {len(entry)} ranks; this world "
                f"has {world}: restore it with the trainer's elastic_state as adapt"
            )
        else:
            state = entry[rank]
        self.restores += 1
        return state

    def clear(self) -> None:
        self._ring.clear()
