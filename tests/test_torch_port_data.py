"""The port's data pipeline against the JAX package's.

Synthetic data byte-identical from one seed; the same sampler and
per-rank batch plan; normalization equal to the JAX ``eval_batch`` (up
to the NHWC -> NCHW transpose) at rtol 1e-6. Crop/flip randomness comes
from a torch.Generator, so it is held against the transform's
definition at given offsets instead of against JAX's bits.
"""

import jax
import numpy as np
import pytest
import torch

from cs744_pytorch_distributed_tutorial_tpu.data import synthetic_cifar10 as jax_synthetic
from cs744_pytorch_distributed_tutorial_tpu.data.augment import eval_batch as jax_eval_batch
from cs744_pytorch_distributed_tutorial_tpu.data.loader import BatchLoader as JaxLoader
from cs744_pytorch_distributed_tutorial_tpu.data.sampler import (
    ShardedSampler as JaxSampler,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.data import (
    BatchLoader,
    ShardedSampler,
    synthetic_cifar10,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.data.augment import (
    augment_train_batch,
    crop_flip,
    eval_batch,
)

CPU = torch.device("cpu")


def test_synthetic_data_is_byte_identical():
    a, b = synthetic_cifar10(40, 12, seed=7), jax_synthetic(40, 12, seed=7)
    for field in ("train_images", "train_labels", "test_images", "test_labels"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and np.array_equal(x, y), field


@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("shuffle", [False, True])
def test_sampler_matches_jax(shuffle, drop_last):
    for shard in range(3):
        kw = dict(seed=5, shuffle=shuffle, drop_last=drop_last)
        ours, theirs = ShardedSampler(50, 3, shard, **kw), JaxSampler(50, 3, shard, **kw)
        assert len(ours) == len(theirs)
        for epoch in range(2):
            np.testing.assert_array_equal(ours.indices(epoch), theirs.indices(epoch))


def test_rank_batches_tile_the_jax_global_batches(mesh4):
    ds = synthetic_cifar10(70, 30, seed=1)
    world, bsz = 4, 16
    jax_train = JaxLoader(ds.train_images, ds.train_labels, bsz, mesh=mesh4,
                          shuffle=True, seed=3)
    ranks = [BatchLoader(ds.train_images, ds.train_labels, bsz, device=CPU,
                         world_size=world, rank=r, shuffle=True, seed=3)
             for r in range(world)]
    assert len(ranks[0]) == len(jax_train) == 4
    for epoch in range(2):
        ours = zip(*(r.epoch(epoch) for r in ranks))
        for parts, (jx, jy) in zip(ours, jax_train.epoch(epoch), strict=True):
            np.testing.assert_array_equal(
                torch.cat([p[0] for p in parts]).numpy(), np.asarray(jx))
            np.testing.assert_array_equal(
                torch.cat([p[1] for p in parts]).numpy(), np.asarray(jy))

    jax_test = JaxLoader(ds.test_images, ds.test_labels, bsz, mesh=mesh4,
                         shuffle=False, drop_last=False)
    ranks = [BatchLoader(ds.test_images, ds.test_labels, bsz, device=CPU,
                         world_size=world, rank=r, drop_last=False)
             for r in range(world)]
    ours = zip(*(r.epoch_padded(0) for r in ranks))
    for parts, jbatch in zip(ours, jax_test.epoch_padded(0), strict=True):
        for k in range(3):
            np.testing.assert_array_equal(
                torch.cat([p[k] for p in parts]).numpy(), np.asarray(jbatch[k]))


def test_normalize_matches_jax():
    images = synthetic_cifar10(6, 1, seed=2).train_images
    got = eval_batch(torch.from_numpy(images)).numpy()
    want = np.asarray(jax_eval_batch(jax.numpy.asarray(images))).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_crop_flip_is_the_padded_crop():
    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, (5, 32, 32, 3), dtype=np.uint8)
    off_h = torch.tensor([0, 8, 3, 4, 7])
    off_w = torch.tensor([8, 0, 5, 4, 1])
    flip = torch.tensor([False, True, True, False, True])
    out = crop_flip(torch.from_numpy(images), off_h, off_w, flip).numpy()
    padded = np.pad(images, ((0, 0), (4, 4), (4, 4), (0, 0)))
    for i in range(5):
        want = padded[i, off_h[i]:off_h[i] + 32, off_w[i]:off_w[i] + 32]
        if flip[i]:
            want = want[:, ::-1]
        np.testing.assert_array_equal(out[i], want)


def test_augment_is_seeded_and_nchw():
    images = torch.from_numpy(synthetic_cifar10(8, 1, seed=0).train_images)
    a = augment_train_batch(torch.Generator().manual_seed(1), images)
    b = augment_train_batch(torch.Generator().manual_seed(1), images)
    assert a.shape == (8, 3, 32, 32) and a.dtype == torch.float32
    assert torch.equal(a, b)
