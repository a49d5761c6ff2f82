"""The port's grouped matmuls against the JAX package's Pallas kernels.

The same numpy inputs go through the JAX functions (``_gmm_fused_kernel``,
``_gmm_kernel`` and ``_tgmm_kernel`` in interpret mode, 8 x 8 tiles) and
the port's (their plain versions on CPU tensors), with both activations,
fp32 and bf16, and group sizes that cover an empty group, a group
spanning several row tiles, boundaries off the tile edges, one group,
rows past ``sum(group_sizes)`` (they belong to the last group; the last
group's weight and bias gradients are zero when its size is 0, as JAX
zeroes them) and the decode case (M = 2 B rows of top-2 pairs, B <= 16):

- ``grouped_matmul_fused``: the forward, its ``z`` (``_gmm_fused_fwd_impl
  (with_z=True)``), and ``jax.vjp``'s ``dlhs``, ``drhs`` and ``dbias``
  against the port's autograd;
- ``grouped_matmul(impl="pallas")``: forward and ``dlhs``, ``drhs``.

Tolerances: fp32 within 1e-5 (rtol and atol; the sums run in another
order). bf16 within one bf16 ulp of the JAX value (2**-7 relative: both
round the fp32 result once) plus 1e-5 x max|JAX| (the fp32 reorder term,
which may move a value across a rounding boundary); the products of bf16
inputs are exact in fp32 on both sides. ``dbias`` stays fp32 in a bf16
call; it sums ``dh * gelu'(z)`` over ``z`` in bf16, so it is held within
1e-5 x max|JAX| plus one bf16 ulp of the largest ``|dh|`` term summed
into it (a ``z`` whose fp32 sum rounds to the neighbouring bf16 value
moves that term by up to gelu''s slope times one ulp). The ``cuda``-marked
tests hold the CUDA kernels against their plain versions on the card.
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


def _grads_close(got: torch.Tensor, want, dtype: str) -> None:
    assert got.dtype == getattr(torch, dtype), got.dtype
    _check_close(got.float().numpy(), np.asarray(want, np.float32), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ["none", "gelu"])
@pytest.mark.parametrize("case", sorted(GROUPS))
def test_grouped_matmul_fused_grads_match_jax(case, activation, dtype):
    """``jax.vjp`` of the JAX ``grouped_matmul_fused`` (its custom_vjp:
    the fused kernel with ``z``, then ``_gmm_kernel`` for dlhs and
    ``_tgmm_kernel`` for drhs and dbias) against the port's backward."""
    import jax
    import jax.numpy as jnp

    m, sizes = GROUPS[case]
    lhs, rhs, bias, gs = _inputs(m, sizes, seed=m + len(sizes))
    dh = np.random.default_rng(m).standard_normal((m, N)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    fn = lambda a, b, c: _jg().grouped_matmul_fused(  # noqa: E731
        a, b, c, jnp.asarray(gs), activation=activation, block_m=8, block_n=8, interpret=True)
    _, vjp = jax.vjp(fn, jnp.asarray(lhs, jd), jnp.asarray(rhs, jd), jnp.asarray(bias))
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(dh, jd))]
    lt = torch.from_numpy(lhs).to(td).requires_grad_()
    rt = torch.from_numpy(rhs).to(td).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    G.reset_launch_count()
    G.grouped_matmul_fused(lt, rt, bt, torch.from_numpy(gs),
                           activation=activation).backward(torch.from_numpy(dh).to(td))
    assert G.launch_count() == 0
    _grads_close(lt.grad, want[0], dtype)
    _grads_close(rt.grad, want[1], dtype)
    assert bt.grad.dtype == torch.float32
    tol = 1e-5 * np.abs(want[2]).max() + (2**-8 * np.abs(dh).max() if dtype == "bfloat16" else 0)
    np.testing.assert_allclose(bt.grad.numpy(), want[2], rtol=1e-5, atol=tol)
    # JAX gives a group whose size is 0 zero weight and bias gradients.
    for g in np.flatnonzero(gs == 0):
        assert not rt.grad[g].any() and not bt.grad[g].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(GROUPS))
def test_grouped_matmul_fused_z_matches_jax(case, dtype):
    """The pre-activation ``z`` of ``_gmm_fused_fwd_impl(with_z=True)``, in
    the output dtype, against the plain version's; the gelu output beside
    it comes from the unrounded fp32 value."""
    import jax.numpy as jnp

    m, sizes = GROUPS[case]
    lhs, rhs, bias, gs = _inputs(m, sizes, seed=2 * m + len(sizes))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    h, z = _jg()._gmm_fused_fwd_impl(jnp.asarray(lhs, jd), jnp.asarray(rhs, jd),
                                     jnp.asarray(bias), jnp.asarray(gs), "gelu", jnp.dtype(jd),
                                     8, 8, True, with_z=True)
    got_h, got_z = G.grouped_matmul_fused_plain(
        torch.from_numpy(lhs).to(td), torch.from_numpy(rhs).to(td), torch.from_numpy(bias),
        torch.from_numpy(gs), activation="gelu", with_z=True)
    assert got_z.dtype == got_h.dtype == td and got_z.shape == (m, N)
    _check_close(got_z.float().numpy(), np.asarray(z.astype(jnp.float32)), dtype)
    _check_close(got_h.float().numpy(), np.asarray(h.astype(jnp.float32)), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(GROUPS))
def test_grouped_matmul_matches_jax(case, dtype):
    """``grouped_matmul(impl="pallas")`` (``_gmm_kernel``, no epilogue):
    the forward rounded to lhs's dtype, and ``jax.vjp``'s dlhs and drhs."""
    import jax
    import jax.numpy as jnp

    m, sizes = GROUPS[case]
    lhs, rhs, _, gs = _inputs(m, sizes, seed=3 * m + len(sizes))
    dout = np.random.default_rng(m + 1).standard_normal((m, N)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    fn = lambda a, b: _jg().grouped_matmul(  # noqa: E731
        a, b, jnp.asarray(gs), impl="pallas", block_m=8, block_n=8, interpret=True)
    out, vjp = jax.vjp(fn, jnp.asarray(lhs, jd), jnp.asarray(rhs, jd))
    dl, dr = vjp(jnp.asarray(dout, jd))
    lt = torch.from_numpy(lhs).to(td).requires_grad_()
    rt = torch.from_numpy(rhs).to(td).requires_grad_()
    got = G.grouped_matmul(lt, rt, torch.from_numpy(gs))
    got.backward(torch.from_numpy(dout).to(td))
    _grads_close(got.detach(), np.asarray(out.astype(jnp.float32)), dtype)
    _grads_close(lt.grad, np.asarray(dl.astype(jnp.float32)), dtype)
    _grads_close(rt.grad, np.asarray(dr.astype(jnp.float32)), dtype)


def test_tgmm_plain_sums_rows_in_order_and_zeroes_empty_groups():
    """``tgmm_plain`` and ``segment_sum_rows_plain`` against float64 sums
    (within 1e-6 relative); a group of size 0, and the last group's rows
    past the sum when its size is 0, give zeros."""
    rng = np.random.default_rng(9)
    m, sizes = 30, [7, 0, 12, 0]
    lhs = torch.from_numpy(rng.standard_normal((m, 5)).astype(np.float32))
    dout = torch.from_numpy(rng.standard_normal((m, 6)).astype(np.float32))
    gs = torch.tensor(sizes)
    dw, db = G.tgmm_plain(lhs, dout, gs), G.segment_sum_rows_plain(dout, gs)
    assert dw.shape == (4, 5, 6) and db.shape == (4, 6)
    lo = 0
    for g, size in enumerate(sizes):
        want = lhs[lo : lo + size].double().t() @ dout[lo : lo + size].double()
        torch.testing.assert_close(dw[g].double(), want, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(db[g].double(), dout[lo : lo + size].double().sum(0),
                                   rtol=1e-6, atol=1e-6)
        lo += size
    assert not dw[[1, 3]].any() and not db[[1, 3]].any()  # rows 19..29 are past the sum


@pytest.mark.parametrize("grad", [True, False])
@pytest.mark.parametrize("activation", ["gelu", "none"])
def test_z_is_written_only_on_the_differentiated_gelu_path(monkeypatch, activation, grad):
    """The forward asks for ``z`` only for gelu under grad with an input
    that requires grad: a no-grad call (decode, serving) keeps today's
    launch, as the JAX undifferentiated primal emits no ``z``."""
    seen = []
    real = G._fused

    def spy(*args):
        seen.append(args[-1])
        return real(*args)

    monkeypatch.setattr(G, "_fused", spy)
    lhs, rhs, bias, gs = (torch.from_numpy(a) for a in _inputs(12, [4, 8], seed=5))
    rhs.requires_grad_()
    with torch.set_grad_enabled(grad):
        G.grouped_matmul_fused(lhs, rhs, bias, gs, activation=activation)
    assert seen == [grad and activation == "gelu"]


def _e65():
    """8 rows over 65 groups (three of them non-empty), float64 numpy
    inputs, and each row's group."""
    rng = np.random.default_rng(65)
    sizes = np.zeros(65, np.int64)
    sizes[[3, 40, 64]] = [3, 2, 3]
    lhs, rhs, dout = (rng.standard_normal(shape) for shape in ((8, 4), (65, 4, 6), (8, 6)))
    return lhs, rhs, dout, sizes, np.repeat(np.arange(65), sizes)


@pytest.mark.parametrize("name", ["gmm", "tgmm", "segment_sum_rows", "grouped_matmul"])
def test_new_entry_points_state_the_group_limit(name):
    """No limit on the number of groups remains: each entry point computes
    at 65 groups (the old limit plus one) and agrees with a float64 sum
    within 1e-5 (``test_torch_port_gmm_groups.py`` holds them against JAX
    at 65 and 128 groups)."""
    lhs, rhs, dout, sizes, group = _e65()
    t = lambda a: torch.from_numpy(a).float()  # noqa: E731
    gs = torch.from_numpy(sizes)
    if name == "gmm":  # dout @ rhs[g]^T, rhs read transposed
        got = G.gmm(t(dout), t(rhs), gs, trans_rhs=True)
        want = np.einsum("rn,rkn->rk", dout, rhs[group])
    elif name == "tgmm":
        got = G.tgmm(t(lhs), t(dout), gs)
        want = np.zeros((65, 4, 6))
        np.add.at(want, group, lhs[:, :, None] * dout[:, None, :])
    elif name == "segment_sum_rows":
        got = G.segment_sum_rows(t(dout), gs)
        want = np.zeros((65, 6))
        np.add.at(want, group, dout)
    else:
        got = G.grouped_matmul(t(lhs), t(rhs), gs)
        want = np.einsum("rk,rkn->rn", lhs, rhs[group])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "call,err,match",
    [(lambda: G.grouped_matmul(torch.zeros(8, 4), torch.zeros(2, 5, 6), torch.tensor([3, 5]),
                               impl="ragged"), ValueError, "grouped_matmul shapes"),
     (lambda: G.grouped_matmul(torch.zeros(8, 4), torch.zeros(2, 4, 6), torch.tensor([3, 5]),
                               impl="dense"), ValueError, "unknown grouped_matmul impl"),
     (lambda: G.gmm(torch.zeros(8, 4).half(), torch.zeros(2, 6, 4), torch.tensor([3, 5]),
                    trans_rhs=True), TypeError, "fp32 or bf16 lhs under a transposed rhs"),
     (lambda: G.tgmm(torch.zeros(8, 4), torch.zeros(8, 6).half(), torch.tensor([3, 5])),
      TypeError, "fp32 or bf16 lhs and dout"),
     (lambda: G.tgmm(torch.zeros(8, 4), torch.zeros(7, 6), torch.tensor([3, 5])), ValueError,
      "tgmm shapes")],
    ids=["ragged", "unknown_impl", "gmm_dtype", "tgmm_dtype", "tgmm_shapes"],
)
def test_grouped_matmul_rejects(call, err, match):
    with pytest.raises(err, match=match):
        call()


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
    elif change == "too_many_groups":  # more group sizes than rhs has groups
        gs = torch.zeros(65).long()
    with pytest.raises(err):
        G.grouped_matmul_fused(lhs, rhs, bias, gs, **kw)


@pytest.mark.cuda
def test_gmm_fused_kernel_matches_plain_on_card():
    """The CUDA kernels against their plain version (fp32 products, TF32 off)
    at the MoE path's prefill and decode shapes and ragged ones (empty
    groups, rows past the sum), both activations, fp32 and bf16 in and
    out: fp32 within 1e-5 x max|plain|, bf16 within one ulp plus 1e-5 x
    max|plain|. Each call takes the route ``fused_tc_route`` gives it
    (bf16 at rows of 16 bytes: the tensor cores; the rest FFMA), shown by
    its launches. The call never synchronises with the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    G.reset_launch_count()
    cases = [(4096, 512, 1024, [600, 420, 512, 0, 700, 380, 900, 584]),
             (32, 1024, 512, [5, 3, 0, 8, 2, 6, 4, 4]),
             (77, 33, 45, [0, 30, 0, 20]), (5, 8, 3, [1]), (100, 64, 70, [10, 20, 0])]
    launches = {"fused": 0, "fused_tc": 0}
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
                launches["fused_tc" if G.fused_tc_route(dtype, (m, k, n)) else "fused"] += 1
                assert got.dtype == dtype and got.shape == (m, n)
                err = (got.float() - want.float()).abs()
                top = float(want.float().abs().max())
                if dtype == torch.float32:
                    assert float(err.max()) <= 1e-5 * top, (m, k, n, act)
                else:
                    tol = 2**-7 * want.float().abs() + 1e-5 * top
                    assert bool((err <= tol).all()), (m, k, n, act)
    assert launches["fused_tc"] >= 2  # the prefill shape in bf16, both activations
    assert {k: G.launch_count(k) for k in launches} == launches
    assert G.launch_count() == sum(launches.values())


@pytest.mark.cuda
def test_gmm_fused_tc_matches_plain_on_card(monkeypatch):
    """The tensor-core forward (``gmm_fused_tc``) and the FFMA one on the
    same bf16 operands against the plain version, the route forced by
    patching ``fused_tc_route``: the MoE path's prefill calls (w_in with
    gelu, w_out), its decode step (32 rows), its training w_in with ``z``
    (32,768 rows), a ragged case (empty groups, boundaries off the tiles,
    rows past the sum) and the narrowest rows TMA reads; out in bf16 and
    fp32, both activations, ``z`` on the gelu path. bf16 within one ulp
    plus 1e-5 x max|plain|, fp32 within 1e-5 x max|plain|; launches by
    route; no host synchronisation; two tensor-core runs bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    cases = [(4096, 512, 1024, [600, 420, 512, 0, 700, 380, 900, 584], ("gelu",)),
             (4096, 1024, 512, [600, 420, 512, 0, 700, 380, 900, 584], ("none",)),
             (32, 512, 1024, [5, 3, 0, 8, 2, 6, 4, 4], ("gelu", "none")),
             (32768, 512, 1024, [4100, 0, 5000, 3333, 6000, 4444, 5555, 4336], ("gelu",)),
             (1000, 96, 72, [0, 300, 0, 250, 0, 0, 400, 0], ("gelu", "none")),
             (5, 8, 8, [2, 1], ("gelu", "none"))]
    real = G.fused_tc_route
    for m, k, n, sizes, acts in cases:
        e = len(sizes)
        assert real(torch.bfloat16, (m, k, n)) or m < G.FUSED_TC_MIN_ROWS
        lhs = torch.randn((m, k), generator=gen, device=dev).bfloat16()
        rhs = (torch.randn((e, k, n), generator=gen, device=dev) / k**0.5).bfloat16()
        bias = torch.randn((e, n), generator=gen, device=dev)
        gs = torch.tensor(sizes, device=dev)
        for act in acts:
            for out_dtype in (torch.bfloat16, torch.float32):
                with_z = act == "gelu"
                want = G.grouped_matmul_fused_plain(lhs, rhs, bias, gs, activation=act,
                                                    out_dtype=out_dtype, with_z=True)
                for route in ("tc", "ffma"):
                    monkeypatch.setattr(G, "fused_tc_route", lambda *a, r=route, **kw: r == "tc")
                    name = ("fused_z" if with_z else "fused") + ("_tc" if route == "tc" else "")

                    def call():
                        torch.cuda.set_sync_debug_mode("error")
                        try:
                            return G._fused(lhs, rhs, bias, gs, act, out_dtype, with_z)
                        finally:
                            torch.cuda.set_sync_debug_mode("default")

                    G.reset_launch_count()
                    out, z = call()
                    torch.cuda.synchronize()
                    assert G.launch_count() == G.launch_count(name) == 1, (route, name)
                    for got, ref in ((out, want[0]), (z, want[1]) if with_z else (None, None)):
                        if got is not None:
                            _card_within(got, ref, out_dtype, (m, k, n, act, route, out_dtype))
                    if route == "tc":
                        again, _ = call()
                        assert torch.equal(out, again)
                monkeypatch.setattr(G, "fused_tc_route", real)


def _card_within(got, want, dtype, label):
    """fp32 within 1e-5 x max|plain|; bf16 within one ulp of each plain
    value plus 1e-5 x max|plain|."""
    assert got.dtype == want.dtype and got.shape == want.shape, label
    err = (got.float() - want.float()).abs()
    top = float(want.float().abs().max())
    lim = 1e-5 * top if dtype == torch.float32 else 2**-7 * want.float().abs() + 1e-5 * top
    share = float((err / lim).max())
    assert share <= 1.0, (label, share, float(err.max()), top)


@pytest.mark.cuda
def test_gmm_backward_kernels_match_plain_on_card():
    """The backward's kernels against their plain versions on the same
    CUDA tensors, on both routes wherever both apply: ``gmm`` (dlhs: an
    fp32 or bf16 dout under rhs^T read in place, fp32 and bf16 rhs; and as
    stored, grouped_matmul's forward) and ``tgmm`` (drhs, fp32 and bf16
    lhs) take the tensor-core kernels (``gmm_tc``/``tgmm_tc``, an fp32 dout
    in three ``split`` pieces, a bf16 one in one) where ``tc_pieces`` says
    so, and the FFMA kernels otherwise and through the private launchers on
    the same operands; ``colsum`` (dbias); all fp32 outputs within 1e-5 x
    max|plain| (sums in another order; every product is exact); ``z`` of
    the differentiated gelu forward within one ulp in bf16; then a full
    backward through the kernels against the plain versions composed by
    hand from the kernel's ``z`` (a ``z`` one ulp apart would move ``dz``
    by more than a bf16 ulp of a small gradient). Groups include empty
    ones, rows past the sum and boundaries off the tiles; every call's
    launches show its route (the odd shapes take the FFMA kernels), no call
    synchronises with the host, and two runs of tgmm or tgmm_tc are
    bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = [(4096, 512, 1024, [600, 420, 512, 0, 700, 380, 900, 584]),
             (300, 72, 136, [100, 0, 150, 10]), (77, 33, 45, [0, 30, 0, 20]),
             (100, 64, 70, [10, 20, 0]), (5, 8, 3, [1])]

    def quiet(fn, *args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    def via(launches, fn, *args, **kw):
        G.reset_launch_count()
        out = quiet(fn, *args, **kw)
        assert {k: G.launch_count(k) for k in G.KERNELS if G.launch_count(k)} == launches, (
            fn, launches)
        return out

    def ffma_gmm(dout, w, gs):
        out = torch.empty((dout.shape[0], w.shape[1]), device=dev)
        G._gmm_ffma(dout, w, G._sizes(gs), out, True)
        return out

    def ffma_tgmm(a, dout, gs):
        out = torch.empty((gs.shape[0], a.shape[1], dout.shape[1]), device=dev)
        G._tgmm_ffma(a, dout, G._sizes(gs), out)
        return out

    tc_cases = 0
    for m, k, n, sizes in cases:
        e = len(sizes)
        gs = torch.tensor(sizes, device=dev)
        lhs = torch.randn((m, k), generator=gen, device=dev)
        rhs = torch.randn((e, k, n), generator=gen, device=dev) / k**0.5
        bias = torch.randn((e, n), generator=gen, device=dev)
        dout = torch.randn((m, n), generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            a, w = lhs.to(dtype), rhs.to(dtype)
            tc = G.tc_pieces(torch.float32, dtype, (m, n, k)) == 3
            assert tc == (dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0)
            tc_cases += tc
            want = G.grouped_matmul_plain(dout, w, gs, trans_rhs=True)
            _card_within(via({"gmm_tc": 1, "split": 1} if tc else {"gmm": 1}, G.gmm, dout, w, gs,
                             trans_rhs=True), want, torch.float32, ("gmm^T", m, dtype))
            want_t = G.tgmm_plain(a, dout, gs)
            dw = via({"tgmm_tc": 1, "split": 1} if tc else {"tgmm": 1}, G.tgmm, a, dout, gs)
            _card_within(dw, want_t, torch.float32, ("tgmm", m, dtype))
            assert torch.equal(dw, G.tgmm(a, dout, gs))
            if tc:
                # The FFMA route on the same operands, and a bf16 dout in one piece.
                _card_within(via({"gmm": 1}, ffma_gmm, dout, w, gs), want, torch.float32,
                             ("gmm^T ffma", m))
                dw = via({"tgmm": 1}, ffma_tgmm, a, dout, gs)
                _card_within(dw, want_t, torch.float32, ("tgmm ffma", m))
                assert torch.equal(dw, ffma_tgmm(a, dout, gs))
                d16 = dout.bfloat16()
                _card_within(via({"gmm_tc": 1}, G.gmm, d16, w, gs, trans_rhs=True),
                             G.grouped_matmul_plain(d16, w, gs, trans_rhs=True), torch.float32,
                             ("gmm^T bf16 dout", m))
                dw = via({"tgmm_tc": 1}, G.tgmm, a, d16, gs)
                _card_within(dw, G.tgmm_plain(a, d16, gs), torch.float32, ("tgmm bf16 dout", m))
                assert torch.equal(dw, G.tgmm(a, d16, gs))
            _card_within(via({"gmm_tc": 1} if tc else {"gmm": 1}, G.gmm, a, w, gs),
                         G.grouped_matmul_plain(a, w, gs), torch.float32, ("gmm", m, dtype))
            _card_within(via({"colsum": 1}, G.segment_sum_rows, dout, gs),
                         G.segment_sum_rows_plain(dout, gs), torch.float32, ("colsum", m))
            fz = "fused_z_tc" if G.fused_tc_route(dtype, (m, k, n)) else "fused_z"
            _, z = via({fz: 1}, G._fused, a, w, bias, gs, "gelu", None, True)
            _, z_plain = G.grouped_matmul_fused_plain(a, w, bias, gs, activation="gelu",
                                                      with_z=True)
            _card_within(z, z_plain, dtype, ("z", m, dtype))

            lt, rt, bt = (t.clone().requires_grad_() for t in (a, w, bias))
            out = via({fz: 1}, G.grouped_matmul_fused, lt, rt, bt, gs, activation="gelu")
            bwd = {"gmm_tc": 1, "tgmm_tc": 1, "split": 1} if tc else {"gmm": 1, "tgmm": 1}
            via({**bwd, "colsum": 1}, out.backward, dout.to(dtype))
            dz = torch.ops.aten.gelu_backward(dout.to(dtype).float(), z.float(),
                                              approximate="tanh")
            _card_within(lt.grad, G.grouped_matmul_plain(dz, w, gs, trans_rhs=True).to(dtype),
                         dtype, ("dlhs", m, dtype))
            _card_within(rt.grad, G.tgmm_plain(a, dz, gs).to(dtype), dtype, ("drhs", m, dtype))
            _card_within(bt.grad, G.segment_sum_rows_plain(dz, gs), torch.float32,
                         ("dbias", m, dtype))
    torch.cuda.synchronize()
    assert tc_cases == 2  # (4096, 512, 1024) and (300, 72, 136) in bf16
