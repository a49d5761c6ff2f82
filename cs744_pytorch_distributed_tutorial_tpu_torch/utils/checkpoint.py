"""Checkpoint and resume: a capability the reference lacks (no
``torch.save`` anywhere; training is one epoch from scratch,
``master/part1/part1.py:101``; SURVEY §5.4).

The JAX package saves its ``TrainState`` through Orbax. The port has a
format of its own: a step is a directory ``step_<n>/`` holding one
``torch.save`` file a rank, ``rank<r>.pt``, of the dict
``Trainer.capture_state`` returns (the step, the world size, this rank's
parameters, momentum and error feedback, the BatchNorm buffers, the
optimizer's own state and the augmentation generator's: everything a
bitwise resume needs).

- ``save`` copies the tensors to host memory before it returns, so the
  step after it may overwrite them; serialization and the disk write
  run on a background thread.
- A step is committed by renaming ``step_<n>.tmp/`` to ``step_<n>/``:
  each rank writes its file as ``rank<r>.pt.part`` and renames it, and
  rank 0 renames the directory once every rank's file is there (a
  barrier over the file system, so the background thread calls no
  collective). A crash mid-write leaves no readable half-checkpoint.
- ``latest_step``, ``restore_latest`` and ``close`` fence the background
  thread first (and, with more than one rank, then meet at a barrier),
  so each answers for what is durable.

The restore is elastic, as the JAX package's: a checkpoint written by a
world of N ranks restores into a world of M. The JAX package saves one
global tree and resizes its leaves; here each rank's file holds only its
own part, so ``restore_latest(adapt=...)`` hands the trainer's
``elastic_state`` every rank's state (``RankStates``: a file is read when
it is first needed) and the trainer builds this rank's state under the
JAX package's leaf rules (``adapt_host_leaf``): replicated tensors from
any file, once the files agree; per-replica state (BatchNorm buffers,
error feedback) sliced when shrinking and tiled cyclically when growing;
the flat ZeRO rows re-chunked through an ``adapt`` hook
(``parallel/zero.py::make_elastic_adapt``), or refused as JAX refuses
them where the trainer passes none. The in-memory tier
(``utils/memstore.py``) restores through the same hook.
"""

from __future__ import annotations

import os
import re
import shutil
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

_STEP_DIR = re.compile(r"^step_(\d+)$")
_RANK_FILE = re.compile(r"^rank(\d+)\.pt$")
_TMP_DIR = re.compile(r"^step_(\d+)\.tmp\.g(\d+)$")
COMMIT_TIMEOUT_S = 600.0


def to_host(tree: Any) -> Any:
    """``tree`` (dicts, lists, tensors, scalars) with every tensor copied to
    host memory; the copies are complete when this returns."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def _group() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _generation() -> int:
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.multihost import runtime_labels

    return runtime_labels()["generation"]


def adapt_host_leaf(key: str, saved: torch.Tensor, like_shape: Sequence[int],
                    adapt: Callable | None = None) -> torch.Tensor:
    """Resize one saved leaf to ``like_shape`` (the JAX package's
    ``adapt_host_leaf``). A leaf of that shape passes through untouched.
    Otherwise ``adapt(key, saved, like)`` is asked first (the ZeRO
    trainers re-chunk their flat rows there), then the default
    world-size rule: the leading axis is sliced down or tiled cyclically
    up; any other mismatch raises. In the port a leaf's leading axis is
    the rank: the trainers stack the ranks' per-replica tensors (or
    their ZeRO rows) into ``[world, ...]`` before calling this."""
    like_shape = tuple(like_shape)
    if tuple(saved.shape) == like_shape:
        return saved
    if adapt is not None:
        out = adapt(key, saved, torch.empty(like_shape, device="meta"))
        if out is not None:
            return out
    if tuple(saved.shape[1:]) != like_shape[1:] or saved.ndim == 0:
        raise ValueError(
            f"cannot adapt checkpoint leaf of shape {tuple(saved.shape)} to "
            f"{like_shape}: only the leading (world-size) axis may differ"
        )
    n = like_shape[0]
    if saved.shape[0] >= n:
        return saved[:n]
    reps = -(-n // saved.shape[0])
    return saved.repeat((reps,) + (1,) * (saved.ndim - 1))[:n]


def agreed(key: str, values: Sequence[Any]) -> Any:
    """The one value every rank saved for a replicated leaf (a tensor, or
    a scalar such as the step); ``ValueError`` when two ranks' values
    differ, bit for bit."""
    first = values[0]
    for v in values[1:]:
        same = (torch.equal(v, first) if isinstance(first, torch.Tensor)
                else v == first)
        if not same:
            raise ValueError(f"the ranks' saved {key!r} differ: it is not replicated")
    return first


class RankStates(Sequence):
    """Every rank's saved state of one checkpoint step, in rank order; a
    file is read when its state is first asked for (``read`` holds the
    ranks read so far), so a rank reads only the files its new state
    needs."""

    def __init__(self, paths: Sequence[str]):
        self._paths = list(paths)
        self._states: dict[int, dict] = {}
        self.read: set[int] = set()

    def __len__(self) -> int:
        return len(self._paths)

    def __getitem__(self, r: int) -> dict:
        r = range(len(self))[r]
        if r not in self._states:
            self._states[r] = torch.load(self._paths[r], map_location="cpu", weights_only=True)
            self.read.add(r)
        return self._states[r]


class Checkpointer:
    """Checkpoints keyed by training step under ``directory``, the newest
    ``max_to_keep`` kept.

    The class-wide ``total_saves`` and ``total_restores`` count file-system
    saves and restores across every instance: the tests read them to show
    that the in-memory tier (``utils/memstore.py``) read no file.
    """

    total_restores = 0
    total_saves = 0

    def __init__(self, directory: str, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.world_size, self.rank = _group()
        os.makedirs(self.directory, exist_ok=True)
        self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="checkpoint")
        self._pending: list[Future] = []
        self.last_read: list[int] = []  # the rank files the last restore read

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    def save(self, state: dict, *, force: bool = False, wait: bool = False) -> None:
        """Persist ``state`` (``Trainer.capture_state``) under its step.
        The device-to-host copy is done when this returns; the write
        proceeds in the background (``wait=True``: until durable).
        ``force`` skips a step that is already the newest checkpoint."""
        step = int(state["step"])
        if force and self.latest_step() == step:
            return
        host = to_host(state)
        Checkpointer.total_saves += 1
        self._pending.append(self._executor.submit(self._write, step, host))
        if wait:
            self._fence()

    def _write(self, step: int, host: dict) -> None:
        final = self._step_dir(step)
        if os.path.isdir(final):
            return  # this step is committed already
        # The generation in the name keeps a step that an earlier
        # generation (another world) left half-written apart from this
        # one's: its files never count toward this commit.
        generation = _generation()
        tmp = f"{final}.tmp.g{generation}"
        os.makedirs(tmp, exist_ok=True)
        part = os.path.join(tmp, f"rank{self.rank}.pt.part")
        torch.save(host, part)
        os.replace(part, os.path.join(tmp, f"rank{self.rank}.pt"))
        if self.rank != 0:
            return
        deadline = time.monotonic() + COMMIT_TIMEOUT_S
        want = {f"rank{r}.pt" for r in range(self.world_size)}
        while not want <= set(os.listdir(tmp)):
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"checkpoint step {step}: not every rank's file reached {tmp} in "
                    f"{COMMIT_TIMEOUT_S:.0f} s"
                )
            time.sleep(0.01)
        os.replace(tmp, final)
        for old in self._steps()[: -self.max_to_keep]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)
        for name in os.listdir(self.directory):  # earlier generations' leftovers
            m = _TMP_DIR.match(name)
            if m and int(m.group(2)) < generation:
                shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)

    def _fence(self) -> None:
        """Wait for this rank's writes (raising their errors), then for
        every rank's."""
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()
        if self.world_size > 1:
            dist.barrier()

    def _steps(self) -> list[int]:
        return sorted(int(m.group(1)) for name in os.listdir(self.directory)
                      if (m := _STEP_DIR.match(name)))

    def latest_step(self) -> int | None:
        """The newest committed step, or None; in-flight saves land first."""
        self._fence()
        steps = self._steps()
        return steps[-1] if steps else None

    def restore_latest(self, adapt: Callable[[Sequence[dict]], dict] | None = None
                       ) -> dict | None:
        """This rank's state from the newest checkpoint (tensors on the
        host), or None when the directory holds none. ``adapt`` (a
        trainer's ``elastic_state``) builds it from every rank's state
        (``RankStates``), which re-cuts a checkpoint of another world;
        without it, this rank's own file is read and a checkpoint of
        another world raises. ``last_read`` lists the rank files read."""
        step = self.latest_step()
        if step is None:
            return None
        d = self._step_dir(step)
        ranks = sorted(int(m.group(1)) for name in os.listdir(d) if (m := _RANK_FILE.match(name)))
        if ranks != list(range(len(ranks))):
            raise ValueError(f"checkpoint {d} holds rank files {ranks}: not one a rank")
        states = RankStates([os.path.join(d, f"rank{r}.pt") for r in ranks])
        if adapt is None:
            if len(ranks) != self.world_size:
                raise ValueError(
                    f"checkpoint {d} was written by a world of {len(ranks)} ranks; this "
                    f"world has {self.world_size}: restore it with the trainer's "
                    "elastic_state as adapt, which re-cuts it for this world"
                )
            state = states[self.rank]
        else:
            state = adapt(states)
        Checkpointer.total_restores += 1
        self.last_read = sorted(states.read)
        return state

    def close(self) -> None:
        self._fence()
        self._executor.shutdown(wait=True)
