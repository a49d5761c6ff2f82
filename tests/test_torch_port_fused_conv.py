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

The tensor-core route (``tc_route``) multiplies fp32 inputs as two bf16
pieces each and reads each tap from a plane of x shifted by its column
(``tap_planes_plain``) at a whole-row offset; ``conv3x3_wgrad_tc_plain`` is
that arithmetic and index map in plain PyTorch. It is held against the fp32 plain version and the
Pallas kernels within TC_LIMIT = 1e-5 x max|plain| (a tenth of
chip_smoke.py's WGRAD_RTOL; on random data it comes to about 5e-6), and
bf16 inputs (one exact piece) within 1e-6 x max|plain| (the order of the
fp32 sums).
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


TC_LIMIT = 1e-5  # x max|plain|: the two-piece products' error, a tenth of WGRAD_RTOL

# ResNet-like small shapes (batch 4 at ResNet-18's widths and sides), and
# ragged ones (C, K odd or under a tile; output planes of 16, 64 and 144
# positions, not all whole chunks of 64; rows of 4 and 6, which the
# tensor-core rule leaves to FFMA but the plain arithmetic still covers).
TC_CASES = [
    (1, 4, 16, 64, 64, 2),
    (1, 4, 8, 128, 128, 2),
    (2, 4, 32, 32, 64, 2),
    (2, 4, 16, 64, 128, 2),
    (1, 3, 8, 3, 10, None),
    (2, 3, 8, 5, 7, None),
    (1, 2, 12, 9, 6, None),
]


def _within(got: torch.Tensor, want: torch.Tensor, limit: float) -> float:
    share = float((got - want).abs().max()) / (limit * float(want.abs().max()))
    assert share <= 1.0, share
    return share


@pytest.mark.parametrize(
    "dtype,shape,stride,aligned,want",
    [("float32", (256, 128, 16, 16), 1, True, True),   # ResNet-18's routed convs
     ("float32", (256, 256, 8, 8), 1, True, True),
     ("bfloat16", (256, 128, 16, 16), 1, True, True),
     ("float32", (256, 64, 32, 32), 2, True, True),    # its stride-2 3x3 convs
     ("bfloat16", (256, 128, 16, 16), 2, True, True),
     ("float32", (3, 3, 8, 8), 1, True, True),         # rows of 8: 16 bytes
     ("float32", (3, 3, 8, 8), 2, True, False),        # rows of 4
     ("float32", (5, 20, 6, 6), 1, True, False),       # rows of 6
     ("float32", (2, 8, 12, 12), 2, True, False),      # rows of 6
     ("float32", (2, 8, 16, 12), 1, True, False),      # rows of 12
     ("float32", (8, 64, 16, 16), 1, False, False),    # a pointer off 16 bytes
     ("float16", (8, 64, 16, 16), 1, True, False),
     ("float32", (0, 64, 16, 16), 1, True, False),     # no images
     ("float32", (8, 64, 16, 16), 3, True, False)],
    ids=["resnet_s1_16", "resnet_s1_8", "resnet_s1_bf16", "resnet_s2_32", "resnet_s2_bf16",
         "rows_8", "s2_rows_4", "rows_6", "s2_rows_6", "rows_12", "misaligned", "fp16",
         "no_images", "stride3"],
)
def test_tc_route_rule(dtype, shape, stride, aligned, want):
    assert K.tc_route(getattr(torch, dtype), shape, stride, aligned) is want


@pytest.mark.parametrize("stride,want", [
    (1, [(0, 0), (1, 0), (2, 0), (0, 1), (1, 1), (2, 1), (0, 2), (1, 2), (2, 2)]),
    (2, [(0, 1), (1, 1), (2, 1), (3, 1), (4, 1), (5, 1), (0, 2), (1, 2), (2, 2)]),
])
def test_tap_geometry(stride, want):
    """Stride 1: tap (ky, kx) reads plane kx from row ky (1 + the shift ky -
    1; row 0 is the zero row above the image). Stride 2 (pads (0, 1)): plane
    (ky % 2, kx) from row 1 + ky // 2, the last tap row reading past the
    plane's end (the bottom pad)."""
    assert K.tap_geometry(stride) == want


@pytest.mark.parametrize("stride", [1, 2])
def test_tap_planes_plain(stride):
    """Plane (py, kx) row 1 + y, column x holds x[s y + py, s x + kx - p],
    zero outside the image; row 0 is zeros."""
    x = torch.arange(2 * 3 * 8 * 8, dtype=torch.float32).reshape(2, 3, 8, 8) + 1
    planes = K.tap_planes_plain(x, stride)
    ho = wo = 8 // stride
    assert planes.shape == (2, 3 * stride, 3, ho + 1, wo)
    assert not planes[:, :, :, 0].any()
    pad = K.PADS[stride][0]
    for u in range(3 * stride):
        py, kx = divmod(u, 3)
        for y in range(ho):
            for xo in range(wo):
                h, w = stride * y + py, stride * xo + kx - pad
                want = x[:, :, h, w] if 0 <= h < 8 and 0 <= w < 8 else torch.zeros(2, 3)
                assert torch.equal(planes[:, u, :, 1 + y, xo], want), (u, y, xo)


def test_split2_bf16_plain_pieces():
    rng = np.random.default_rng(5)
    v = torch.from_numpy((rng.standard_normal(4096) * 10.0 ** rng.integers(-8, 8, 4096))
                         .astype(np.float32))
    h, lo = K.split2_bf16_plain(v)
    assert h.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(h, v.bfloat16()) and torch.equal(lo, (v - h.float()).bfloat16())
    # h + l keeps 16 significant bits: the rest is at most 2^-16 of |v|.
    rest = (v - h.float() - lo.float()).abs()
    assert bool((rest <= 2.0**-16 * v.abs()).all())


@pytest.mark.parametrize("stride,b,side,c,k,bb", TC_CASES)
def test_tc_plain_matches_fp32_plain(stride, b, side, c, k, bb):
    """fp32 within TC_LIMIT; bf16 inputs within 1e-6 (one exact piece)."""
    x, g = _inputs(7, b, side, c, k, stride)
    xt, gt = _nchw(x), _nchw(g)
    got = K.conv3x3_wgrad_tc_plain(xt, gt, stride)
    assert got.dtype == torch.float32 and got.shape == (k, c, 3, 3)
    _within(got, K.conv3x3_wgrad_plain(xt, gt, stride), TC_LIMIT)
    xb, gb = xt.bfloat16(), gt.bfloat16()
    _within(K.conv3x3_wgrad_tc_plain(xb, gb, stride), K.conv3x3_wgrad_plain(xb, gb, stride), 1e-6)


@pytest.mark.parametrize("stride,b,side,c,k,bb", TC_CASES)
def test_tc_plain_matches_pallas_kernel_interpret(stride, b, side, c, k, bb):
    """The tensor-core route's arithmetic against _wgrad_kernel_s1 / _s2 in
    interpret mode, within TC_LIMIT x max|JAX|."""
    import jax.numpy as jnp

    from cs744_pytorch_distributed_tutorial_tpu.ops.fused_conv import (
        conv3x3_wgrad as jax_wgrad,
    )

    x, g = _inputs(8, b, side, c, k, stride)
    want = jax_wgrad(jnp.asarray(x), jnp.asarray(g), stride=stride, block_batch=bb,
                     interpret=True)
    want = torch.from_numpy(np.asarray(want).transpose(3, 2, 0, 1).copy())
    _within(K.conv3x3_wgrad_tc_plain(_nchw(x), _nchw(g), stride), want, TC_LIMIT)


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
def test_tc_kernel_matches_plain_on_card():
    """Each call on its rule's route (shown by its launches), and every
    call the rule gives the tensor cores also on the FFMA route: fp32 within
    1e-4 x max|plain| on both routes (chip_smoke.py's WGRAD_RTOL), the
    tensor-core route within a quarter of it (two-piece products); bf16 on
    the tensor cores within 1e-5 (one exact piece); ResNet-18's routed and
    stride-2 shapes at batch 32, ragged ones (6 x 6 images and 4 x 4
    outputs on FFMA, C and K odd); two tensor-core runs bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(3)
    cases = [(1, (32, 128, 16, 16), 128), (1, (32, 256, 8, 8), 256),
             (2, (32, 64, 32, 32), 128), (2, (32, 128, 16, 16), 256),
             (1, (3, 3, 8, 8), 10), (2, (3, 3, 8, 8), 10), (1, (2, 9, 12, 12), 6),
             (1, (5, 20, 6, 6), 7), (2, (5, 20, 6, 6), 7)]
    real = K.tc_route
    for stride, shape, k in cases:
        b, _, h, w = shape
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=gen, device=dev).to(dtype)
            g = torch.randn((b, k, h // stride, w // stride), generator=gen, device=dev).to(dtype)
            want = K.conv3x3_wgrad_plain(x, g, stride)
            top = float(want.abs().max())
            rule = "tc" if real(dtype, shape, stride) else "ffma"
            assert rule == ("tc" if (w // stride) % 8 == 0 else "ffma")
            for route in ([rule, "ffma"] if rule == "tc" else [rule]):
                K.reset_launch_count()
                K.tc_route = (lambda *a, r=route, **kw: r == "tc") if route != rule else real
                try:
                    got = K.conv3x3_wgrad(x, g, stride)
                finally:
                    K.tc_route = real
                torch.cuda.synchronize()
                assert K.launch_count() == K.launch_count(stride, dtype, route) == 1
                limit = 1e-4 if route == "ffma" else (2.5e-5 if dtype == torch.float32 else 1e-5)
                err = float((got - want).abs().max())
                assert err <= limit * top, (route, dtype, stride, shape, k, err / top)
                if route == "tc":
                    assert torch.equal(got, K.conv3x3_wgrad(x, g, stride))


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
