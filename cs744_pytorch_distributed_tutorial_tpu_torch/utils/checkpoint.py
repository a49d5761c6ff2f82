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

A checkpoint restores onto the world size that wrote it; another world
raises ``ValueError`` (the JAX package's elastic restore, which re-cuts
state for another world, is not ported).
"""

from __future__ import annotations

import os
import re
import shutil
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any

import torch
import torch.distributed as dist

_STEP_DIR = re.compile(r"^step_(\d+)$")
_RANK_FILE = re.compile(r"^rank(\d+)\.pt$")
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
        tmp = final + ".tmp"
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

    def restore_latest(self) -> dict | None:
        """This rank's state from the newest checkpoint (tensors on the
        host), or None when the directory holds none."""
        step = self.latest_step()
        if step is None:
            return None
        d = self._step_dir(step)
        ranks = sorted(int(m.group(1)) for name in os.listdir(d) if (m := _RANK_FILE.match(name)))
        if len(ranks) != self.world_size:
            raise ValueError(
                f"checkpoint {d} was written by a world of {len(ranks)} ranks; this "
                f"world has {self.world_size}. Restoring onto another world size needs "
                "the elastic restore (the JAX package's utils/checkpoint.py adapt), "
                "which the port does not have yet"
            )
        Checkpointer.total_restores += 1
        return torch.load(os.path.join(d, f"rank{self.rank}.pt"), map_location="cpu",
                          weights_only=True)

    def close(self) -> None:
        self._fence()
        self._executor.shutdown(wait=True)
