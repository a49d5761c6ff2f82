"""The port's gradient buckets (``parallel/buckets.py``) against the JAX
package's.

The same ordered shapes go to both ``bucket_layout``s: the flat and the
row-chunked layout, reversed, with mixed dtypes and with buckets smaller
than a tensor. The layouts must be equal field by field, the bucket
buffers equal bit for bit, and ``unflatten`` must invert
``flatten_for_sync``. ``sync_bytes_per_step`` and ``sync_wire_bytes``
must give JAX's integers for every strategy on tiny_cnn's and
ResNet-18's parameter shapes (in the port's ``model.parameters()``
order), with and without buckets.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs744_pytorch_distributed_tutorial_tpu.parallel import buckets as JB
from cs744_pytorch_distributed_tutorial_tpu.parallel.sync import (
    sync_wire_bytes as jax_wire_bytes,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.models import get_model
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import buckets as B
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.sync import sync_wire_bytes

SHAPES = [(3, 5, 7), (10,), (1,), (16, 3, 3, 3), (33,), (64, 32), (7, 7)]
MIXED = [torch.float32, torch.bfloat16, torch.float32, torch.float32, torch.bfloat16,
         torch.float32, torch.bfloat16]
_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}

LAYOUTS = {
    "flat": dict(bucket_bytes=4 * 2**20, rows=0, reverse=False),
    "rows4": dict(bucket_bytes=4 * 2**20, rows=4, reverse=False),
    "reverse": dict(bucket_bytes=4 * 2**20, rows=0, reverse=True),
    "rows4_reverse": dict(bucket_bytes=4 * 2**20, rows=4, reverse=True),
    "tiny": dict(bucket_bytes=256, rows=0, reverse=False),
    "tiny_rows4_reverse": dict(bucket_bytes=256, rows=4, reverse=True),
    "one_byte": dict(bucket_bytes=1, rows=0, reverse=False),
}


def _tensors(dtypes, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=gen).to(d) for s, d in zip(SHAPES, dtypes)]


def _jax_leaves(tensors):
    return [jnp.asarray(t.float().numpy()).astype(_JNP[t.dtype]) for t in tensors]


@pytest.mark.parametrize("mixed", [False, True], ids=["f32", "mixed"])
@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_layout_and_buffers_match_jax(case, mixed):
    kw = LAYOUTS[case]
    tensors = _tensors(MIXED if mixed else [torch.float32] * len(SHAPES))
    leaves = _jax_leaves(tensors)
    got = B.bucket_layout(tensors, **kw)
    want = JB.bucket_layout(leaves, **kw)
    assert got.bucket_cols == want.bucket_cols
    assert got.bucket_dtypes == want.bucket_dtypes
    assert got.rows == want.rows
    for g, w in zip(got.slots, want.slots, strict=True):
        assert (g.bucket, g.offset, g.size, g.shape, g.dtype) == (
            w.bucket, w.offset, w.size, w.shape, w.dtype)
    assert B.bucket_layout([(t.shape, t.dtype) for t in tensors], **kw) is got  # cached

    bufs = B.flatten_for_sync(tensors, got)
    jbufs = JB.flatten_for_sync(leaves, want)
    for b, jb in zip(bufs, jbufs, strict=True):
        np.testing.assert_array_equal(b.float().numpy(), np.asarray(jb.astype(jnp.float32)))
    for t, u in zip(tensors, B.unflatten(bufs, got), strict=True):
        assert u.dtype == t.dtype and torch.equal(u, t)


def test_flat_leaf_views_share_the_bucket():
    tensors = _tensors([torch.float32] * len(SHAPES))
    layout = B.bucket_layout(tensors, rows=0)
    bufs = B.flatten_for_sync(tensors, layout)
    views = B.unflatten(bufs, layout)
    bufs[0].zero_()
    assert all(float(v.abs().sum()) == 0 for v in views)
    members = B.bucket_members(layout)
    assert sorted(i for m in members for i in m) == list(range(len(SHAPES)))


def _model_shapes(name):
    return [(tuple(p.shape), p.dtype) for p in get_model(name, num_classes=10).parameters()]


STRATEGIES = ["none", "allreduce", "ring", "auto", "zero1", "fsdp", "p2p_star",
              "gather_scatter", "int8_allreduce", "int8_ring", "zero1_int8"]


@pytest.mark.parametrize("model", ["tiny_cnn", "resnet18"])
def test_sync_bytes_per_step_match_jax(model):
    shapes = _model_shapes(model)
    structs = [jax.ShapeDtypeStruct(s, jnp.float32) for s, _ in shapes]
    elems = sum(int(np.prod(s)) for s, _ in shapes)
    for world in (1, 2, 4, 8):
        for strategy in STRATEGIES:
            for bucket_bytes in (None, 4 * 2**20, 2**16):
                for reverse in (False, True):
                    kw = dict(bucket_bytes=bucket_bytes, reverse=reverse)
                    want = JB.sync_bytes_per_step(structs, strategy, world, **kw)
                    assert B.sync_bytes_per_step(shapes, strategy, world, **kw) == want, (
                        strategy, world, kw)
            assert B.sync_bytes_per_step(elems, strategy, world) == JB.sync_bytes_per_step(
                elems, strategy, world)
        for name in ("allreduce", "ring", "int8_allreduce", "int8_ring", "zero1", "auto"):
            for compress in ("none", "int8"):
                kw = dict(grad_compress=compress, bucket_bytes=4 * 2**20, overlap=True)
                assert sync_wire_bytes(shapes, name, world, **kw) == jax_wire_bytes(
                    structs, name, world, **kw), (name, world, kw)
    with pytest.raises(ValueError, match="unknown sync strategy"):
        B.sync_bytes_per_step(shapes, "bogus", 4)


def test_int8_wire_is_about_four_times_smaller():
    shapes = _model_shapes("resnet18")
    f32 = B.sync_bytes_per_step(shapes, "allreduce", 4)
    int8 = B.sync_bytes_per_step(shapes, "int8_allreduce", 4, bucket_bytes=4 * 2**20)
    assert 3.5 <= f32 / int8 <= 4.0
