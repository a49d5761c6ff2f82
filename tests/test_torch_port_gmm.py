"""The port's fused grouped matmul against the JAX package's Pallas kernel.

The same numpy inputs go through the JAX ``grouped_matmul_fused``
(``_gmm_fused_kernel`` in interpret mode, 8 x 8 tiles) and the port's
(its plain version on CPU tensors), with both activations, fp32 and
bf16, and group sizes that cover an empty group, a group spanning several
row tiles, boundaries off the tile edges, one group, rows past
``sum(group_sizes)`` (they belong to the last group) and the decode case
(M = 2 B rows of top-2 pairs, B <= 16).

Tolerances: fp32 within 1e-5 (rtol and atol; the sums run in another
order). bf16 within one bf16 ulp of the JAX value (2**-7 relative: both
round the fp32 result once) plus 1e-5 x max|JAX| (the fp32 reorder term,
which may move a value across a rounding boundary); the products of bf16
inputs are exact in fp32 on both sides. The ``cuda``-marked test holds
the CUDA kernel against its plain version on the card.
"""

import importlib

import numpy as np
import pytest
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.ops import gmm as G

GROUPS = {
    "empty_and_spanning": (37, [10, 0, 20, 7]),
    "one_group": (13, [13]),
    "rows_past_the_sum": (20, [5, 6, 0]),
    "decode": (10, [2, 0, 3, 1, 0, 4, 0, 0]),
    "decode_b16": (32, [5, 3, 0, 8, 2, 6, 4, 4]),
}
K, N = 24, 20


def _jg():
    return importlib.import_module("cs744_pytorch_distributed_tutorial_tpu.ops.gmm")


def _inputs(m, sizes, seed):
    rng = np.random.default_rng(seed)
    e = len(sizes)
    lhs = rng.standard_normal((m, K)).astype(np.float32)
    rhs = (rng.standard_normal((e, K, N)) / np.sqrt(K)).astype(np.float32)
    bias = rng.standard_normal((e, N)).astype(np.float32)
    return lhs, rhs, bias, np.asarray(sizes, np.int32)


def _jax(lhs, rhs, bias, gs, activation, dtype):
    import jax.numpy as jnp

    jd = getattr(jnp, dtype)
    out = _jg().grouped_matmul_fused(
        jnp.asarray(lhs, jd), jnp.asarray(rhs, jd), jnp.asarray(bias), jnp.asarray(gs),
        activation=activation, block_m=8, block_n=8, interpret=True)
    assert out.dtype == jd
    return np.asarray(out.astype(jnp.float32))


def _check_close(got: np.ndarray, want: np.ndarray, dtype: str) -> None:
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        tol = 2**-7 * np.abs(want) + 1e-5 * np.abs(want).max()
        assert np.all(np.abs(got - want) <= tol), float(np.abs(got - want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ["none", "gelu"])
@pytest.mark.parametrize("case", sorted(GROUPS))
def test_grouped_matmul_fused_matches_jax(case, activation, dtype):
    m, sizes = GROUPS[case]
    lhs, rhs, bias, gs = _inputs(m, sizes, seed=m + len(sizes))
    want = _jax(lhs, rhs, bias, gs, activation, dtype)
    G.reset_launch_count()
    td = getattr(torch, dtype)
    got = G.grouped_matmul_fused(torch.from_numpy(lhs).to(td), torch.from_numpy(rhs).to(td),
                                 torch.from_numpy(bias), torch.from_numpy(gs),
                                 activation=activation)
    assert G.launch_count() == 0  # CPU tensors take the plain version
    assert got.dtype == td and got.shape == (m, N)
    _check_close(got.float().numpy(), want, dtype)


def test_grouped_matmul_fused_out_dtype():
    """``out_dtype`` rounds the fp32 epilogue once to another dtype."""
    import jax.numpy as jnp

    lhs, rhs, bias, gs = _inputs(*GROUPS["empty_and_spanning"], seed=3)
    want = _jg().grouped_matmul_fused(jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(bias),
                                      jnp.asarray(gs), activation="gelu",
                                      out_dtype=jnp.bfloat16, block_m=8, block_n=8,
                                      interpret=True)
    got = G.grouped_matmul_fused(torch.from_numpy(lhs), torch.from_numpy(rhs),
                                 torch.from_numpy(bias), torch.from_numpy(gs).long(),
                                 activation="gelu", out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _check_close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), "bfloat16")


def test_grouped_matmul_fused_plain_is_differentiable_on_cpu():
    lhs, rhs, bias, gs = (torch.from_numpy(a) for a in _inputs(12, [4, 8], seed=4))
    lhs.requires_grad_()
    G.grouped_matmul_fused(lhs, rhs, bias, gs, activation="gelu").sum().backward()
    assert lhs.grad is not None and torch.isfinite(lhs.grad).all()


@pytest.mark.parametrize(
    "change,err",
    [("lhs_3d", ValueError), ("k_mismatch", ValueError), ("group_sizes", ValueError),
     ("bias", ValueError), ("activation", ValueError), ("dtype_mismatch", TypeError),
     ("float_sizes", TypeError), ("too_many_groups", ValueError)],
)
def test_grouped_matmul_fused_rejects(change, err):
    lhs, rhs, bias, gs = torch.zeros(8, 4), torch.zeros(2, 4, 6), torch.zeros(2, 6), \
        torch.tensor([3, 5])
    kw = {"activation": "none"}
    if change == "lhs_3d":
        lhs = lhs[None]
    elif change == "k_mismatch":
        lhs = torch.zeros(8, 5)
    elif change == "group_sizes":
        gs = torch.tensor([8])
    elif change == "bias":
        bias = torch.zeros(2, 5)
    elif change == "activation":
        kw["activation"] = "relu"
    elif change == "dtype_mismatch":
        rhs = rhs.bfloat16()
    elif change == "float_sizes":
        gs = gs.float()
    elif change == "too_many_groups":
        rhs, bias, gs = torch.zeros(65, 4, 6), torch.zeros(65, 6), torch.zeros(65).long()
    with pytest.raises(err):
        G.grouped_matmul_fused(lhs, rhs, bias, gs, **kw)


@pytest.mark.cuda
def test_gmm_fused_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version (fp32 products, TF32 off)
    at the MoE path's prefill and decode shapes and ragged ones (empty
    groups, rows past the sum), both activations, fp32 and bf16 in and
    out: fp32 within 1e-5 x max|plain|, bf16 within one ulp plus 1e-5 x
    max|plain|. The call never synchronises with the host, and the
    backward raises "not yet ported"."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    G.reset_launch_count()
    cases = [(4096, 512, 1024, [600, 420, 512, 0, 700, 380, 900, 584]),
             (32, 1024, 512, [5, 3, 0, 8, 2, 6, 4, 4]),
             (77, 33, 45, [0, 30, 0, 20]), (5, 8, 3, [1]), (100, 64, 70, [10, 20, 0])]
    launches = 0
    for m, k, n, sizes in cases:
        e = len(sizes)
        lhs = torch.randn((m, k), generator=gen, device=dev)
        rhs = torch.randn((e, k, n), generator=gen, device=dev) / k**0.5
        bias = torch.randn((e, n), generator=gen, device=dev)
        gs = torch.tensor(sizes, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            for act in ("none", "gelu"):
                args = (lhs.to(dtype), rhs.to(dtype), bias, gs)
                torch.cuda.set_sync_debug_mode("error")
                try:
                    got = G.grouped_matmul_fused(*args, activation=act)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                want = G.grouped_matmul_fused_plain(*args, activation=act)
                torch.cuda.synchronize()
                launches += 1
                assert got.dtype == dtype and got.shape == (m, n)
                err = (got.float() - want.float()).abs()
                top = float(want.float().abs().max())
                if dtype == torch.float32:
                    assert float(err.max()) <= 1e-5 * top, (m, k, n, act)
                else:
                    tol = 2**-7 * want.float().abs() + 1e-5 * top
                    assert bool((err <= tol).all()), (m, k, n, act)
    assert G.launch_count() == launches
    lhs = torch.randn((8, 16), device=dev, requires_grad=True)
    out = G.grouped_matmul_fused(lhs, torch.randn((2, 16, 4), device=dev), torch.zeros(2, 4,
                                 device=dev), torch.tensor([3, 5], device=dev))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        out.sum().backward()
