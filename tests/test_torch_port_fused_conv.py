"""The port's 3x3 conv weight gradient against the JAX package's.

The same numpy inputs (NHWC for JAX, NCHW for the port) go through the
Pallas wgrad kernel in interpret mode (``ops/fused_conv.py::
conv3x3_wgrad``, its ``[3, 3, C, K]`` result transposed to OIHW) and the
port's CPU path (the kernel's plain version), at both strides; and
through ``jax.grad`` of the SAME ``lax.conv`` and the port's ``conv3x3``,
which pins the stride-2 (0, 1) padding. Tolerance rtol 1e-4, atol 1e-4,
the JAX test's own (fp32 sums in another order). The JAX package is
imported inside the tests that use it, so the ``cuda``-marked test also
runs on a machine with a card and no flax.
"""

import numpy as np
import pytest
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_conv as K

# (stride, batch, side, C, K, Pallas block_batch): the shapes of the JAX
# package's tests/test_fused_conv.py, plus K = 10 and 12 (not powers of
# two) at both strides.
CASES = [
    (1, 8, 8, 16, 32, 2),
    (1, 4, 16, 8, 8, 2),
    (1, 6, 8, 8, 8, 3),
    (2, 8, 8, 16, 32, 2),
    (2, 4, 16, 8, 16, 4),
    (1, 3, 8, 5, 10, None),
    (2, 2, 6, 3, 12, None),
]


def _inputs(seed, b, side, c, k, stride):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, side, side, c)).astype(np.float32)
    g = rng.standard_normal((b, side // stride, side // stride, k)).astype(np.float32)
    return x, g


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("stride,b,side,c,k,bb", CASES)
def test_wgrad_matches_pallas_kernel_interpret(stride, b, side, c, k, bb):
    import jax.numpy as jnp

    from cs744_pytorch_distributed_tutorial_tpu.ops.fused_conv import (
        conv3x3_wgrad as jax_wgrad,
    )

    x, g = _inputs(0, b, side, c, k, stride)
    want = jax_wgrad(jnp.asarray(x), jnp.asarray(g), stride=stride,
                     block_batch=bb, interpret=True)
    want = np.asarray(want).transpose(3, 2, 0, 1)  # [3,3,C,K] -> [K,C,3,3]
    K.reset_launch_count()
    got = K.conv3x3_wgrad(_nchw(x), _nchw(g), stride)
    assert K.launch_count() == 0  # CPU tensors take the plain version
    assert got.dtype == torch.float32 and got.shape == (k, c, 3, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv3x3_grads_match_jax_same_conv(stride):
    """dx (library dgrad on the padded shape, cropped) and dW (the wgrad)
    against jax.vjp of lax.conv with padding="SAME"."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 8, 8, 8)).astype(np.float32)
    w = (0.1 * rng.standard_normal((3, 3, 8, 16))).astype(np.float32)  # HWIO
    g = rng.standard_normal((4, 8 // stride, 8 // stride, 16)).astype(np.float32)

    def conv(xx, ww):
        return lax.conv_general_dilated(
            xx, ww, (stride, stride), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
        )

    y, vjp = jax.vjp(conv, jnp.asarray(x), jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(g))

    tx = _nchw(x).requires_grad_()
    tw = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).requires_grad_()
    ty = K.conv3x3(tx, tw, stride)
    ty.backward(_nchw(g))
    np.testing.assert_allclose(ty.detach().numpy().transpose(0, 2, 3, 1), np.asarray(y),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tx.grad.numpy().transpose(0, 2, 3, 1), np.asarray(dx),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tw.grad.numpy().transpose(2, 3, 1, 0), np.asarray(dw),
                               rtol=1e-4, atol=1e-4)


def test_bfloat16_inputs_give_fp32_wgrad():
    """bf16 inputs are widened before the contraction: the result is the
    fp32 wgrad of the bf16 values."""
    x, g = _inputs(2, 2, 8, 4, 6, 1)
    xb, gb = _nchw(x).bfloat16(), _nchw(g).bfloat16()
    got = K.conv3x3_wgrad(xb, gb, 1)
    want = K.conv3x3_wgrad(xb.float(), gb.float(), 1)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_autocast_runs_conv_in_autocast_dtype():
    """Under bf16 autocast x and w reach the conv as bf16; the weight's
    gradient comes back in the parameter's fp32."""
    x, _ = _inputs(3, 2, 8, 4, 6, 1)
    w = torch.nn.Parameter(0.1 * torch.randn(6, 4, 3, 3))
    with torch.autocast("cpu", dtype=torch.bfloat16):
        y = K.conv3x3(_nchw(x), w, 1)
    assert y.dtype == torch.bfloat16
    y.float().sum().backward()
    assert w.grad.dtype == torch.float32 and bool(w.grad.abs().sum() > 0)


@pytest.mark.parametrize(
    "bad,exc",
    [
        ("stride3", ValueError),
        ("batch", ValueError),
        ("spatial", ValueError),
        ("odd_stride2", ValueError),
        ("dtype_mismatch", TypeError),
        ("float64", TypeError),
        ("rank3", ValueError),
    ],
)
def test_wgrad_rejects_bad_input(bad, exc):
    stride = 2 if bad == "odd_stride2" else 1
    x, g = torch.zeros(2, 3, 8, 8), torch.zeros(2, 5, 8, 8)
    if bad == "stride3":
        stride = 3
    elif bad == "batch":
        g = torch.zeros(3, 5, 8, 8)
    elif bad == "spatial":
        g = torch.zeros(2, 5, 4, 8)
    elif bad == "odd_stride2":
        x, g = torch.zeros(2, 3, 7, 8), torch.zeros(2, 5, 3, 4)
    elif bad == "dtype_mismatch":
        g = g.bfloat16()
    elif bad == "float64":
        x, g = x.double(), g.double()
    else:
        x, g = x[0], g[0]
    with pytest.raises(exc):
        K.conv3x3_wgrad(x, g, stride)


# Ragged shapes (B, C, K, H/W not multiples of the kernel's tiles) and
# ResNet-18's routed and stride-2 shapes at batch 8.
CARD_CASES = [
    (1, (3, 3, 8, 8), 10), (2, (3, 3, 8, 8), 10),
    (1, (5, 20, 6, 6), 7), (2, (5, 20, 6, 6), 7),
    (1, (8, 128, 16, 16), 128), (1, (8, 256, 8, 8), 256),
    (2, (8, 64, 32, 32), 128), (2, (8, 128, 16, 16), 256),
]


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version, fp32 and bf16, both
    strides: max abs err <= 1e-4 * max|plain| (fp32 sums in another
    order; the plain einsum in full fp32, TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    K.reset_launch_count()
    for dtype in (torch.float32, torch.bfloat16):
        for stride, shape, k in CARD_CASES:
            b, _, h, w = shape
            x = torch.randn(shape, generator=gen, device=dev).to(dtype)
            g = torch.randn((b, k, h // stride, w // stride), generator=gen, device=dev).to(dtype)
            got = K.conv3x3_wgrad(x, g, stride)
            want = K.conv3x3_wgrad_plain(x, g, stride)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            assert err <= 1e-4 * float(want.abs().max()), (dtype, stride, shape, k, err)
    assert K.launch_count() == 2 * len(CARD_CASES)
    assert K.launch_count(stride=2, dtype=torch.bfloat16) == 4
