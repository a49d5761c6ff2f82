"""Sharded sampling: the ``DistributedSampler`` contract.

The reference shards the training set per rank with
``torch.utils.data.DistributedSampler`` (``master/part2a/part2a.py:107``):
a (seed, epoch)-deterministic permutation, wrap-around padding to a
multiple of the world size, then a strided rank split. The permutation
comes from numpy, so every rank, and the JAX package, computes the same
plan with no communication.
"""

from __future__ import annotations

import numpy as np


def epoch_permutation(
    num_examples: int, seed: int, epoch: int, shuffle: bool
) -> np.ndarray:
    """(seed, epoch)-deterministic example order."""
    if shuffle:
        return np.random.default_rng((seed, epoch)).permutation(num_examples)
    return np.arange(num_examples)


def wrap_pad(order: np.ndarray, total: int) -> np.ndarray:
    """Truncate or cyclically repeat ``order`` to exactly ``total`` entries."""
    if total <= len(order):
        return order[:total]
    return np.resize(order, total)


class ShardedSampler:
    """Deterministic equal-size sharding of ``range(num_examples)``.

    Every shard has ``ceil(n / num_shards)`` entries with wrap-around
    padding (``floor`` with ``drop_last``); ``indices(epoch)`` is a pure
    function of ``(seed, epoch, shard, num_shards)``; ``shuffle=False``
    gives the plain strided split ``[shard, shard + num_shards, ...]``.
    """

    def __init__(
        self,
        num_examples: int,
        num_shards: int,
        shard: int,
        *,
        seed: int = 0,
        shuffle: bool = True,
        drop_last: bool = False,
    ):
        if not 0 <= shard < num_shards:
            raise ValueError(f"shard {shard} out of range for {num_shards} shards")
        self.num_examples = num_examples
        self.num_shards = num_shards
        self.shard = shard
        self.seed = seed
        self.shuffle = shuffle
        if drop_last:
            self._per_shard = num_examples // num_shards
        else:
            self._per_shard = -(-num_examples // num_shards)  # ceil

    def __len__(self) -> int:
        return self._per_shard

    def indices(self, epoch: int) -> np.ndarray:
        """This shard's example indices for ``epoch``."""
        order = epoch_permutation(self.num_examples, self.seed, epoch, self.shuffle)
        order = wrap_pad(order, self._per_shard * self.num_shards)
        return order[self.shard :: self.num_shards]
