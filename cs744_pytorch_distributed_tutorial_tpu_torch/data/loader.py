"""Batch loading: each rank's local batch as tensors on its device.

Replaces the reference's ``DataLoader(pin_memory=True)`` +
``DistributedSampler`` pair (``master/part1/part1.py:80-93``,
``master/part2a/part2a.py:103-113``). Each epoch is the JAX package's
deterministic global index plan (``epoch_permutation`` + ``wrap_pad``);
global batch ``b`` is split into equal contiguous slices and rank ``r``
takes slice ``r``, the layout the JAX package gives a data-sharded
global batch. On a card, the native gather (``data/native_batcher.py``)
writes the rows straight into one of a small ring of pinned staging
buffers, and the copy to the device is issued on the current stream
without blocking (on the prefetch thread, that is its side stream:
``data/prefetch.py``); a staging buffer is refilled only after the
event recorded behind its last copy has completed.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.data.native_batcher import (
    gather_rows,
    native_usable,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.data.sampler import (
    epoch_permutation,
    wrap_pad,
)


class BatchLoader:
    """Deterministic per-rank batch iterator over in-memory arrays.

    ``epoch(e)`` yields ``(images, labels)``: this rank's slice of each
    global batch of exactly ``global_batch_size`` (uint8 NHWC, int64),
    wrap-around padding the final batch unless ``drop_last``.
    ``epoch_padded(e)`` yields ``(images, labels, mask)`` where the tail
    batch is zero-padded and ``mask`` is 1.0 on real examples, so eval
    counts every example exactly once. ``native_batches`` counts the
    batches whose rows the native gather assembled.
    """

    STAGING_BUFFERS = 4

    def __init__(
        self,
        images: np.ndarray,
        labels: np.ndarray,
        global_batch_size: int,
        *,
        device: torch.device,
        world_size: int = 1,
        rank: int = 0,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = True,
    ):
        if len(images) != len(labels):
            raise ValueError(
                f"images/labels length mismatch: {len(images)} vs {len(labels)}"
            )
        if global_batch_size % world_size:
            raise ValueError(
                f"global batch {global_batch_size} not divisible by world "
                f"size {world_size}"
            )
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} out of range for world size {world_size}")
        self.images = np.ascontiguousarray(images)
        self.labels = np.ascontiguousarray(labels, dtype=np.int64)
        self.global_batch_size = int(global_batch_size)
        self.local = self.global_batch_size // world_size
        self.rank = rank
        self.device = device
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_examples = len(images)
        if self.num_examples == 0:
            raise ValueError("empty dataset")
        if drop_last and self.num_examples < self.global_batch_size:
            raise ValueError(
                f"dataset of {self.num_examples} examples yields ZERO batches of "
                f"{self.global_batch_size} with drop_last=True"
            )
        self.native_batches = 0
        self._staging: list[list] = []  # [pinned images, pinned labels, event]
        self._next_staging = 0

    def __len__(self) -> int:
        """Batches per epoch."""
        if self.drop_last:
            return self.num_examples // self.global_batch_size
        return -(-self.num_examples // self.global_batch_size)  # ceil

    def _staging_slot(self) -> list:
        """The next pinned staging buffers, once their last copy is done."""
        if len(self._staging) < self.STAGING_BUFFERS:
            self._staging.append([
                torch.empty((self.local, *self.images.shape[1:]),
                            dtype=torch.from_numpy(self.images[:0]).dtype).pin_memory(),
                torch.empty(self.local, dtype=torch.int64).pin_memory(),
                None,
            ])
        slot = self._staging[self._next_staging % len(self._staging)]
        self._next_staging += 1
        if slot[2] is not None:
            slot[2].synchronize()
        return slot

    def _put(self, idx: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        """This rank's rows ``idx`` as (images, labels) on the device."""
        if native_usable(self.images):
            self.native_batches += 1
        if self.device.type != "cuda":
            return (torch.from_numpy(gather_rows(self.images, idx)),
                    torch.from_numpy(gather_rows(self.labels, idx)))
        slot = self._staging_slot()
        gather_rows(self.images, idx, out=slot[0].numpy())
        gather_rows(self.labels, idx, out=slot[1].numpy())
        out = (slot[0].to(self.device, non_blocking=True),
               slot[1].to(self.device, non_blocking=True))
        slot[2] = torch.cuda.Event()
        slot[2].record(torch.cuda.current_stream(self.device))
        return out

    def _put_mask(self, mask: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(mask)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _local(self, idx: np.ndarray) -> np.ndarray:
        return idx[self.rank * self.local : (self.rank + 1) * self.local]

    def epoch(self, epoch: int, start: int = 0) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
        """This rank's part of every full-size training batch. ``start``
        skips the epoch's first batches by index arithmetic alone, with
        no gather or copy (the mid-epoch resume, ``train/engine.py``)."""
        order = epoch_permutation(self.num_examples, self.seed, epoch, self.shuffle)
        bsz = self.global_batch_size
        order = wrap_pad(order, len(self) * bsz)
        for b in range(start, len(self)):
            yield self._put(self._local(order[b * bsz : (b + 1) * bsz]))

    def epoch_padded(
        self, epoch: int
    ) -> Iterator[tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        """Eval batches with a validity mask; every example appears exactly
        once across ranks (pad entries replay index 0, mask 0.0)."""
        order = epoch_permutation(self.num_examples, self.seed, epoch, self.shuffle)
        bsz = self.global_batch_size
        for b in range(-(-self.num_examples // bsz)):
            idx = order[b * bsz : (b + 1) * bsz]
            n_real = len(idx)
            mask = np.zeros(bsz, dtype=np.float32)
            mask[:n_real] = 1.0
            if n_real < bsz:
                idx = np.concatenate([idx, np.zeros(bsz - n_real, dtype=idx.dtype)])
            yield (*self._put(self._local(idx)), self._put_mask(self._local(mask)))
