"""The tensor-core route of the port's grouped matmuls, on the CPU.

``gmm`` and ``tgmm`` send a call to the tensor-core kernels (``gmm_tc``,
``tgmm_tc``) by ``tc_pieces``, a rule of dtypes and shapes, and feed them
an fp32 ``dout`` as three bf16 pieces (``split``). These tests hold what
that rests on, through the plain versions:

- ``split_bf16_plain`` rebuilds its fp32 input bit for bit (normal and
  lognormal-scaled values, zeros, negative values over 40 decades);
- ``grouped_matmul_plain`` and ``tgmm_plain`` summed over the three pieces
  agree with the fp32 plain versions within 1e-5 x max|plain| (each
  piece's product with a bf16 operand is exact; only the order of the sums
  differs), at ragged group sizes with an empty group;
- a bf16 ``dout`` gives exactly the result of the call on its widened
  copy;
- the route rule, case by case, and the autograd backward handing the
  output's bf16 gradient to ``gmm`` and ``tgmm`` unwidened when there is no
  activation;
- the forward's route rule (``fused_tc_route``), and the fused epilogue's
  plain form (``grouped_matmul_fused_plain`` on bf16 operands: bias in
  fp32, ``z`` rounded to the output dtype, gelu on the unrounded value, one
  rounding) against the Pallas ``_gmm_fused_kernel`` in interpret mode,
  both activations and both output dtypes.

The kernels are held against these plain versions on the card
(``tests/test_torch_port_gmm.py``'s ``cuda`` tests and ``chip_smoke.py``).
"""

import importlib

import numpy as np
import pytest
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.ops import gmm as G

GROUPS = {
    "empty_and_spanning": (37, [10, 0, 20, 7]),
    "rows_past_the_sum": (20, [5, 6, 0]),
    "ragged_wide": (300, [100, 0, 150, 10]),
}
K, N = 40, 48


def _values(kind: str, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    shape = (257, 33)
    if kind == "normal":
        x = rng.standard_normal(shape)
    elif kind == "lognormal_scaled":
        x = rng.standard_normal(shape) * np.exp(4.0 * rng.standard_normal(shape))
    elif kind == "zeros":
        x = np.zeros(shape)
        x[::2] = -0.0
    elif kind == "negative":
        x = -np.abs(rng.standard_normal(shape)) * 10.0 ** rng.integers(-20, 20, shape)
    else:  # mixed: every sign and 60 decades, some exact zeros and bf16 values
        x = rng.standard_normal(shape) * 10.0 ** rng.integers(-30, 30, shape)
        x[::7] = 0.0
        x[1::5] = np.asarray(torch.from_numpy(x[1::5].astype(np.float32)).bfloat16().float())
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("kind", ["normal", "lognormal_scaled", "zeros", "negative", "mixed"])
def test_split_bf16_plain_rebuilds_fp32_exactly(kind):
    x = _values(kind, seed=len(kind))
    pieces = G.split_bf16_plain(x)
    assert pieces.shape == (3, *x.shape) and pieces.dtype == torch.bfloat16
    h1, h2, h3 = (p.float() for p in pieces)
    assert torch.equal((h1 + h2) + h3, x)
    # Each piece is the remainder rounded to nearest: the next one is at
    # most half an ulp of it, so the pieces fall off by 2^8 at least.
    assert bool((h2.abs() <= h1.abs() * 2**-8).all()) and bool((h3.abs() <= h2.abs() * 2**-8).all())
    assert torch.equal(G.split_bf16(x), pieces)  # a CPU tensor takes the plain version


def _operands(case: str):
    m, sizes = GROUPS[case]
    rng = np.random.default_rng(m + len(sizes))
    e = len(sizes)
    lhs = torch.from_numpy(rng.standard_normal((m, K)).astype(np.float32)).bfloat16()
    rhs = torch.from_numpy((rng.standard_normal((e, K, N)) / np.sqrt(K)).astype(np.float32))
    dout = torch.from_numpy((rng.standard_normal((m, N))
                             * np.exp(rng.standard_normal((m, N)))).astype(np.float32))
    return lhs, rhs.bfloat16(), dout, torch.tensor(sizes)


def _within(got: torch.Tensor, want: torch.Tensor) -> None:
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err


@pytest.mark.parametrize("case", sorted(GROUPS))
def test_gmm_through_three_pieces_matches_fp32_plain(case):
    """dlhs = dout @ rhs^T with dout split into three bf16 pieces."""
    _, rhs, dout, gs = _operands(case)
    want = G.grouped_matmul_plain(dout, rhs, gs, trans_rhs=True)
    got = sum(G.grouped_matmul_plain(p, rhs, gs, trans_rhs=True) for p in G.split_bf16_plain(dout))
    _within(got, want)


@pytest.mark.parametrize("case", sorted(GROUPS))
def test_tgmm_through_three_pieces_matches_fp32_plain(case):
    """drhs = per group lhs^T @ dout with dout split into three pieces; a
    group of size 0 stays zero."""
    lhs, _, dout, gs = _operands(case)
    want = G.tgmm_plain(lhs, dout, gs)
    got = sum(G.tgmm_plain(lhs, p, gs) for p in G.split_bf16_plain(dout))
    _within(got, want)
    assert not got[gs == 0].any()


@pytest.mark.parametrize("case", sorted(GROUPS))
def test_bf16_dout_equals_the_widened_call(case):
    lhs, rhs, dout, gs = _operands(case)
    d16 = dout.bfloat16()
    for w in (rhs, rhs.float()):
        assert torch.equal(G.gmm(d16, w, gs, trans_rhs=True),
                           G.gmm(d16.float(), w, gs, trans_rhs=True))
    for a in (lhs, lhs.float()):
        assert torch.equal(G.tgmm(a, d16, gs), G.tgmm(a, d16.float(), gs))


@pytest.mark.parametrize(
    "dout,other,shape,aligned,pieces",
    [("float32", "bfloat16", (32768, 1024, 512), True, 3),   # w_in's dlhs: fp32 dz
     ("float32", "bfloat16", (32768, 512, 1024), True, 3),   # w_in's drhs
     ("bfloat16", "bfloat16", (32768, 1024, 512), True, 1),  # w_out's dlhs: bf16 g
     ("bfloat16", "bfloat16", (4096, 512, 1024), True, 1),   # grouped_matmul's bf16 forward
     ("float32", "bfloat16", (5, 8, 8), True, 3),            # the narrowest rows TMA reads
     ("float32", "float32", (32768, 1024, 512), True, 0),    # fp32 operands: FFMA
     ("bfloat16", "float32", (64, 64, 64), True, 0),         # fp32 other: FFMA, dout widened
     ("float32", "bfloat16", (77, 33, 45), True, 0),         # rows not of 16 bytes
     ("float32", "bfloat16", (100, 64, 70), True, 0),
     ("float32", "bfloat16", (64, 64, 64), False, 0),        # a pointer off 16 bytes
     ("float32", "bfloat16", (0, 64, 64), True, 0),          # no rows
     ("float16", "bfloat16", (64, 64, 64), True, 0)],
    ids=["w_in_dlhs", "w_in_drhs", "w_out_bf16", "forward_bf16", "narrow", "fp32", "fp32_other",
         "odd_77x33x45", "odd_100x64x70", "misaligned", "no_rows", "fp16"],
)
def test_route_rule(dout, other, shape, aligned, pieces):
    assert G.tc_pieces(getattr(torch, dout), getattr(torch, other), shape, aligned) == pieces


def test_split_argument_is_checked():
    _, rhs, dout, gs = _operands("rows_past_the_sum")
    split = G.split_bf16(dout)
    assert torch.equal(G.gmm(dout, rhs, gs, trans_rhs=True, split=split),
                       G.gmm(dout, rhs, gs, trans_rhs=True))
    with pytest.raises(ValueError, match="split must be split_bf16"):
        G.gmm(dout, rhs, gs, trans_rhs=True, split=split[:, 1:])
    with pytest.raises(ValueError, match="split must be split_bf16"):
        G.tgmm(dout.bfloat16(), dout.bfloat16(), gs, split=split)


@pytest.mark.parametrize("activation,want", [("none", torch.bfloat16), ("gelu", torch.float32)])
def test_backward_hands_the_gradient_over_in_its_dtype(monkeypatch, activation, want):
    """Without an activation the output's bf16 gradient goes to gmm and
    tgmm as it is (one piece on the card); the gelu path's dz is fp32. The
    bias gradient always sums an fp32 dz."""
    seen = {}
    for name, pos in (("gmm", 0), ("tgmm", 1), ("segment_sum_rows", 0)):
        real = getattr(G, name)

        def spy(*args, _real=real, _name=name, _pos=pos, **kw):
            seen[_name] = args[_pos].dtype
            return _real(*args, **kw)

        monkeypatch.setattr(G, name, spy)
    lhs, rhs, dout, gs = _operands("empty_and_spanning")
    bias = torch.zeros(rhs.shape[0], N, requires_grad=True)
    lt, rt = lhs.clone().requires_grad_(), rhs.clone().requires_grad_()
    G.grouped_matmul_fused(lt, rt, bias, gs, activation=activation).backward(dout.bfloat16())
    assert seen == {"gmm": want, "tgmm": want, "segment_sum_rows": torch.float32}
    assert lt.grad.dtype == rt.grad.dtype == torch.bfloat16


@pytest.mark.parametrize(
    "dtype,shape,aligned,want",
    [("bfloat16", (4096, 512, 1024), True, True),    # prefill w_in
     ("bfloat16", (4096, 1024, 512), True, True),    # prefill w_out
     ("bfloat16", (32768, 512, 1024), True, True),   # training w_in (with z)
     ("bfloat16", (1000, 96, 72), True, True),       # ragged rows, narrow widths
     ("bfloat16", (5, 8, 8), True, True),            # the narrowest rows TMA reads
     ("float32", (4096, 512, 1024), True, False),    # fp32 operands: FFMA
     ("bfloat16", (1000, 100, 70), True, False),     # rows not of 16 bytes
     ("bfloat16", (77, 33, 45), True, False),
     ("bfloat16", (64, 64, 64), False, False),       # a pointer off 16 bytes
     ("bfloat16", (0, 64, 64), True, False),         # no rows
     ("float16", (64, 64, 64), True, False)],
    ids=["prefill_w_in", "prefill_w_out", "train_w_in", "ragged_96x72", "narrow", "fp32",
         "odd_100x70", "odd_33x45", "misaligned", "no_rows", "fp16"],
)
def test_fused_route_rule(dtype, shape, aligned, want):
    assert G.fused_tc_route(getattr(torch, dtype), shape, aligned) is want


@pytest.mark.parametrize("rows", [1, 16, 32, 64, 65, 4096])
def test_fused_route_row_threshold(rows):
    """Rows below FUSED_TC_MIN_ROWS take the FFMA kernel, the rest the
    tensor cores (bf16, widths of the MoE path's decode step)."""
    assert G.fused_tc_route(torch.bfloat16, (rows, 512, 1024)) is (rows >= G.FUSED_TC_MIN_ROWS)


FUSED_GROUPS = {
    "empty_and_spanning": (37, [10, 0, 20, 7]),
    "rows_past_the_sum": (20, [5, 6, 0]),
    "decode": (32, [5, 3, 0, 8, 2, 6, 4, 4]),
}


@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("activation", ["none", "gelu"])
@pytest.mark.parametrize("case", sorted(FUSED_GROUPS))
def test_fused_epilogue_plain_matches_pallas_interpret(case, activation, out_dtype):
    """bf16 lhs and rhs (the tensor-core route's operands) through
    ``_gmm_fused_fwd_impl`` (``_gmm_fused_kernel``, interpret mode) and the
    plain version: out and, on the gelu path, z in ``out_dtype``. bf16
    within one ulp plus 1e-5 x max|JAX| (both round the fp32 value once;
    the sums run in another order), fp32 within 1e-5 x max|JAX|."""
    import jax.numpy as jnp

    jg = importlib.import_module("cs744_pytorch_distributed_tutorial_tpu.ops.gmm")
    m, sizes = FUSED_GROUPS[case]
    rng = np.random.default_rng(m * len(sizes))
    e = len(sizes)
    lhs = rng.standard_normal((m, K)).astype(np.float32)
    rhs = (rng.standard_normal((e, K, N)) / np.sqrt(K)).astype(np.float32)
    bias = rng.standard_normal((e, N)).astype(np.float32)
    gs = np.asarray(sizes, np.int32)
    jd = jnp.dtype(getattr(jnp, out_dtype))
    with_z = activation == "gelu"
    res = jg._gmm_fused_fwd_impl(jnp.asarray(lhs, jnp.bfloat16), jnp.asarray(rhs, jnp.bfloat16),
                                 jnp.asarray(bias), jnp.asarray(gs), activation, jd, 8, 8, True,
                                 with_z=with_z)
    got = G.grouped_matmul_fused_plain(
        torch.from_numpy(lhs).bfloat16(), torch.from_numpy(rhs).bfloat16(),
        torch.from_numpy(bias), torch.from_numpy(gs), activation=activation,
        out_dtype=getattr(torch, out_dtype), with_z=with_z)
    got = got if with_z else (got,)
    assert (res[1] is not None) == with_z
    for t, w in zip(got, res):
        assert t.dtype == getattr(torch, out_dtype) and t.shape == (m, N)
        w = np.asarray(w.astype(jnp.float32))
        err = np.abs(t.float().numpy() - w)
        tol = 1e-5 * np.abs(w).max() + (2**-7 * np.abs(w) if out_dtype == "bfloat16" else 0)
        assert np.all(err <= tol), float(err.max())
