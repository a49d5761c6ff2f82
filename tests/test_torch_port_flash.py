"""The port's flash attention against the JAX package's.

The same numpy inputs go through the Pallas kernels in interpret mode
(``ops/flash_attention.py``: ``flash_forward_lse``, ``flash_dq``,
``flash_dkv`` and the ``flash_attention`` custom VJP) and the port's CPU
path (the kernels' plain versions and the autograd Function). Tolerances
are the JAX package's own (``tests/test_flash_attention.py``): 2e-5 on
the forward, 1e-4 on the gradients, 2e-2 in bf16. The JAX package is
imported inside the tests that use it, so the ``cuda``-marked test also
runs on a machine with a card and no JAX.
"""

import importlib

import numpy as np
import pytest
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.ops import flash_attention as F

# (B, T, H, D, Pallas block): the JAX test's shape and odd T; the Pallas
# kernels need a block that divides T.
SHAPES = [(2, 64, 2, 16, 16), (2, 24, 2, 16, 8), (1, 40, 3, 16, 8)]


def _jax_flash():
    return importlib.import_module("cs744_pytorch_distributed_tutorial_tpu.ops.flash_attention")


def _inputs(seed, shape, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,t,h,d,blk", SHAPES)
def test_forward_lse_matches_pallas_interpret(b, t, h, d, blk, causal):
    import jax.numpy as jnp

    J = _jax_flash()
    q, k, v = _inputs(0, (b, t, h, d), 3)
    want_o, want_lse = J.flash_forward_lse(*map(jnp.asarray, (q, k, v)), causal=causal,
                                           block_q=blk, block_k=blk, interpret=True)
    F.reset_launch_count()
    out, lse = F.flash_forward_lse(_t(q), _t(k), _t(v), causal)
    assert F.launch_count() == 0  # CPU tensors take the plain version
    assert out.shape == (b, t, h, d) and lse.shape == (b * h, t, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_o), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,t,h,d,blk", SHAPES)
def test_dq_dkv_match_pallas_interpret(b, t, h, d, blk, causal):
    """Given the same lse and delta (the JAX package's), dq and dk/dv at
    1e-4; delta itself at 2e-5."""
    import jax.numpy as jnp

    J = _jax_flash()
    q, k, v, do = _inputs(1, (b, t, h, d))
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o, lse = J.flash_forward_lse(jq, jk, jv, causal=causal, block_q=blk, block_k=blk,
                                 interpret=True)
    delta = J.flash_delta(o, jdo)
    want_dq = J.flash_dq(jq, jk, jv, jdo, lse, delta, causal, blk, blk, True)
    want_dk, want_dv = J.flash_dkv(jq, jk, jv, jdo, lse, delta, causal, blk, blk, True)
    np.testing.assert_allclose(F.flash_delta(_t(o), _t(do)).numpy(), np.asarray(delta),
                               rtol=2e-5, atol=2e-5)
    args = (_t(q), _t(k), _t(v), _t(do), _t(lse), _t(delta), causal)
    dq = F.flash_dq(*args)
    dk, dv = F.flash_dkv(*args)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,t,h,d,blk", SHAPES)
def test_function_gradients_match_jax_grad(b, t, h, d, blk):
    import jax
    import jax.numpy as jnp

    J = _jax_flash()
    q, k, v, w = _inputs(2, (b, t, h, d))

    def loss(q, k, v):
        return (J.flash_attention(q, k, v, True, blk, blk, True) * jnp.asarray(w)).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    (F.flash_attention(tq, tk, tv, True) * _t(w)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_bfloat16_matches_pallas_interpret():
    """bf16 inputs: out and the three gradients at 2e-2 (the JAX test's
    bf16 tolerance)."""
    import jax
    import jax.numpy as jnp

    J = _jax_flash()
    q, k, v, w = _inputs(3, (2, 64, 2, 16))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))

    def loss(q, k, v):
        out = J.flash_attention(q, k, v, True, 32, 32, True)
        return (out.astype(jnp.float32) * jnp.asarray(w)).sum(), out

    (_, want_o), want_g = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(jq, jk, jv)
    tq, tk, tv = (_t(a).bfloat16().requires_grad_() for a in (q, k, v))
    out = F.flash_attention(tq, tk, tv, True)
    (out.float() * _t(w)).sum().backward()
    assert out.dtype == torch.bfloat16 and tq.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().detach().numpy(),
                               np.asarray(want_o, np.float32), rtol=2e-2, atol=2e-2)
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want_g):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                                   rtol=2e-2, atol=2e-2)


def test_plain_matches_dense_attention_with_gqa_repeat():
    """The port's two attentions agree (dense is the flash plain
    version's independent reference), through ``repeat_kv``."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.ring_attention import (
        dense_attention,
        repeat_kv,
    )

    q, = _inputs(4, (2, 33, 4, 8), 1)
    k, v = _inputs(5, (2, 33, 2, 8), 2)
    k, v = repeat_kv(_t(k), 2), repeat_kv(_t(v), 2)
    assert k.shape == (2, 33, 4, 8) and torch.equal(k[:, :, 0], k[:, :, 1])
    for causal in (True, False):
        got = F.flash_attention(_t(q), k, v, causal)
        want = dense_attention(_t(q), k, v, causal=causal)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize(
    "shapes,dtypes,match",
    [
        ([(2, 8, 2, 16)] * 2 + [(2, 9, 2, 16)], [torch.float32] * 3, "shape"),
        ([(2, 8, 2, 16)] * 3, [torch.float32, torch.float32, torch.float16], "float32"),
        ([(2, 8, 16)] * 3, [torch.float32] * 3, "B, T, H, D"),
    ],
)
def test_wrappers_check_inputs(shapes, dtypes, match):
    xs = [torch.zeros(s, dtype=dt) for s, dt in zip(shapes, dtypes)]
    with pytest.raises((ValueError, TypeError), match=match):
        F.flash_forward_lse(*xs)


# Shapes for the card: the LM path's head geometry, ragged T and the
# other head dims; (B, T, H, D, causal).
CARD_CASES = [
    (2, 256, 3, 64, True),
    (2, 256, 3, 64, False),
    (1, 200, 3, 64, True),
    (2, 77, 2, 128, True),
    (1, 100, 2, 32, False),
]


@pytest.mark.cuda
def test_flash_kernels_match_plain_on_card():
    """The three CUDA kernels against their plain versions, fp32 and
    bf16, q/k/v read through strides (slices of one [B, T, 3, H, D]
    tensor): max abs err <= 1e-4 * max|plain| in fp32 (TF32 off; sums in
    another order), 2e-2 * max|plain| in bf16; lse within 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    F.reset_launch_count()
    for dtype, rtol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        for b, t, h, d, causal in CARD_CASES:
            qkv = torch.randn((b, t, 3, h, d), generator=gen, device=dev).to(dtype)
            q, k, v = qkv.unbind(2)
            do = torch.randn((b, t, h, d), generator=gen, device=dev).to(dtype)
            out, lse = F.flash_forward_lse(q, k, v, causal)
            want_o, want_lse = F.flash_forward_lse_plain(q, k, v, causal)
            delta = F.flash_delta(want_o, do)
            dq = F.flash_dq(q, k, v, do, want_lse, delta, causal)
            dk, dv = F.flash_dkv(q, k, v, do, want_lse, delta, causal)
            want_dq = F.flash_dq_plain(q, k, v, do, want_lse, delta, causal)
            want_dk, want_dv = F.flash_dkv_plain(q, k, v, do, want_lse, delta, causal)
            torch.cuda.synchronize()
            case = (dtype, b, t, h, d, causal)
            assert float((lse - want_lse).abs().max()) <= 1e-5, case
            for got, want in ((out, want_o), (dq, want_dq), (dk, want_dk), (dv, want_dv)):
                assert got.dtype == dtype and got.shape == want.shape, case
                err = float((got.float() - want.float()).abs().max())
                assert err <= rtol * float(want.float().abs().max()), (case, err)
    n = 2 * len(CARD_CASES)
    assert F.launch_count("fwd") == F.launch_count("dq") == F.launch_count("dkv") == n
    assert F.launch_count("dkv", torch.bfloat16) == len(CARD_CASES)
