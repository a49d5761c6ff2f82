"""The port's grouped matmuls past 64 groups, and their ragged path,
against the JAX package's.

The same numpy inputs, at E = 65 and E = 128 groups with empty groups
(every seventh, and the first), go through the JAX functions (the Pallas
kernels in interpret mode, 64 x 8 tiles; ``lax.ragged_dot``) and the
port's (their plain versions on CPU tensors):

- ``grouped_matmul_fused`` (gelu): the forward, its ``z`` and
  ``jax.vjp``'s dlhs, drhs and dbias against the port's autograd, which
  runs ``gmm`` (rhs read transposed), ``tgmm`` and ``segment_sum_rows``;
- ``gmm``, ``tgmm`` and ``segment_sum_rows`` called alone against
  ``_gmm_fwd_impl``, ``_tgmm_impl`` and ``_segment_sum_rows``;
- ``grouped_matmul(impl="pallas")`` and ``grouped_matmul(impl="ragged")``
  (``lax.ragged_dot``: rows past ``sum(group_sizes)`` are zeros) with
  their ``jax.vjp`` gradients, fp32 and bf16;
- ``MoEFFN(gmm_impl="ragged")`` against the JAX ``MoEFFN`` with the same
  option, and with 72 experts;
- ``lm_cli --moe-dispatch dropless --moe-gmm-impl ragged --moe-experts
  72`` trains on the CPU.

Tolerances are ``test_torch_port_gmm.py``'s: fp32 within 1e-5 (rtol and
atol; the sums run in another order); bf16 within one bf16 ulp of the
JAX value plus 1e-5 x max|JAX|; ``dbias`` within 1e-5 rtol and 1e-5 x
max|JAX|. ``MoEFFN`` is held within 2e-5 in fp32 (``test_torch_port_moe.py``).
"""

import json

import numpy as np
import pytest
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch import lm_cli
from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import lm_params_from_jax
from cs744_pytorch_distributed_tutorial_tpu_torch.models.moe import MoEFFN
from cs744_pytorch_distributed_tutorial_tpu_torch.ops import gmm as G

K, N = 16, 24
BM, BN = 64, 8  # the JAX kernels' tiles in interpret mode
EXPERTS = (65, 128)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sizes(e: int, m: int, seed: int) -> np.ndarray:
    """A draw of ``m`` routes over ``e`` groups, the first and every
    seventh empty; the sizes sum to ``m``."""
    rng = np.random.default_rng(seed)
    weights = np.ones(e)
    weights[::7] = 0.0
    return rng.multinomial(m, weights / weights.sum()).astype(np.int32)


def _inputs(e: int, seed: int, m: int = 300):
    rng = np.random.default_rng(seed)
    lhs = rng.standard_normal((m, K)).astype(np.float32)
    rhs = (rng.standard_normal((e, K, N)) / np.sqrt(K)).astype(np.float32)
    bias = rng.standard_normal((e, N)).astype(np.float32)
    return lhs, rhs, bias, _sizes(e, m, seed)


def _jg():
    from cs744_pytorch_distributed_tutorial_tpu.ops import gmm as JG

    return JG


def _close(got: torch.Tensor, want, dtype: str = "float32") -> None:
    got, want = got.detach().float().numpy(), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        tol = 2**-7 * np.abs(want) + 1e-5 * np.abs(want).max()
        assert np.all(np.abs(got - want) <= tol), float(np.abs(got - want).max())


@pytest.mark.parametrize("e", EXPERTS)
def test_fused_forward_z_and_grads_match_jax(e):
    import jax
    import jax.numpy as jnp

    lhs, rhs, bias, gs = _inputs(e, seed=e)
    assert (gs == 0).sum() >= e // 7
    m = lhs.shape[0]
    dh = np.random.default_rng(e + 1).standard_normal((m, N)).astype(np.float32)
    fn = lambda a, b, c: _jg().grouped_matmul_fused(  # noqa: E731
        a, b, c, jnp.asarray(gs), activation="gelu", block_m=BM, block_n=BN, interpret=True)
    out, vjp = jax.vjp(fn, jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(bias))
    want = vjp(jnp.asarray(dh))
    _, want_z = _jg()._gmm_fused_fwd_impl(jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(bias),
                                          jnp.asarray(gs), "gelu", jnp.dtype(jnp.float32), BM,
                                          BN, True, with_z=True)
    lt, rt, bt = (torch.from_numpy(a).requires_grad_() for a in (lhs, rhs, bias))
    G.reset_launch_count()
    got = G.grouped_matmul_fused(lt, rt, bt, torch.from_numpy(gs), activation="gelu")
    got.backward(torch.from_numpy(dh))
    assert G.launch_count() == 0  # CPU tensors take the plain versions
    _close(got, out)
    _, got_z = G.grouped_matmul_fused_plain(torch.from_numpy(lhs), torch.from_numpy(rhs),
                                            torch.from_numpy(bias), torch.from_numpy(gs),
                                            activation="gelu", with_z=True)
    _close(got_z, want_z)
    _close(lt.grad, want[0])
    _close(rt.grad, want[1])
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(want[2]), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(want[2])).max())
    empty = np.flatnonzero(gs == 0)
    assert not rt.grad[empty].any() and not bt.grad[empty].any()


@pytest.mark.parametrize("e", EXPERTS)
def test_gmm_tgmm_and_segment_sum_alone_match_jax(e):
    import jax.numpy as jnp

    lhs, rhs, _, gs = _inputs(e, seed=2 * e)
    dout = np.random.default_rng(e).standard_normal((lhs.shape[0], N)).astype(np.float32)
    jg, jgs = _jg(), jnp.asarray(gs)
    want_gmm = jg._gmm_fwd_impl(jnp.asarray(lhs), jnp.asarray(rhs), jgs, BM, BN, True)
    want_tgmm = jg._tgmm_impl(jnp.asarray(lhs), jnp.asarray(dout), jgs, e, BM, BN, True)
    want_db = jg._segment_sum_rows(jnp.asarray(dout), jgs, e, BM, BN, True)
    tgs = torch.from_numpy(gs)
    _close(G.gmm(torch.from_numpy(lhs), torch.from_numpy(rhs), tgs), want_gmm)
    # rhs^T read in place: dout [M, N] against rhs [E, K, N] gives [M, K].
    want_t = jg._gmm_fwd_impl(jnp.asarray(dout), jnp.swapaxes(jnp.asarray(rhs), 1, 2), jgs, BM,
                              BN, True)
    _close(G.gmm(torch.from_numpy(dout), torch.from_numpy(rhs), tgs, trans_rhs=True), want_t)
    _close(G.tgmm(torch.from_numpy(lhs), torch.from_numpy(dout), tgs), want_tgmm)
    _close(G.segment_sum_rows(torch.from_numpy(dout), tgs), want_db)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["pallas", "ragged"])
@pytest.mark.parametrize("e", EXPERTS)
def test_grouped_matmul_matches_jax(e, impl, dtype):
    """``grouped_matmul`` forward and ``jax.vjp``'s dlhs and drhs, the
    Pallas path and ``lax.ragged_dot``; for ragged, rows past the sum
    (the last 20 rows here) come back zero on both sides."""
    import jax
    import jax.numpy as jnp

    lhs, rhs, _, gs = _inputs(e, seed=3 * e)
    if impl == "ragged":
        gs = _sizes(e, lhs.shape[0] - 20, seed=3 * e)
    dout = np.random.default_rng(e + 2).standard_normal((lhs.shape[0], N)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    kw = dict(block_m=BM, block_n=BN, interpret=True) if impl == "pallas" else {}
    fn = lambda a, b: _jg().grouped_matmul(a, b, jnp.asarray(gs), impl=impl, **kw)  # noqa: E731
    out, vjp = jax.vjp(fn, jnp.asarray(lhs, jd), jnp.asarray(rhs, jd))
    dl, dr = vjp(jnp.asarray(dout, jd))
    lt = torch.from_numpy(lhs).to(td).requires_grad_()
    rt = torch.from_numpy(rhs).to(td).requires_grad_()
    got = G.grouped_matmul(lt, rt, torch.from_numpy(gs), impl=impl)
    got.backward(torch.from_numpy(dout).to(td))
    assert got.dtype == lt.grad.dtype == rt.grad.dtype == td
    for a, b in ((got, out), (lt.grad, dl), (rt.grad, dr)):
        _close(a, np.asarray(b.astype(jnp.float32)), dtype)
    if impl == "ragged":
        assert not got[-20:].any()


def _jax_moe(num_experts: int, x: np.ndarray):
    import jax
    import jax.numpy as jnp

    from cs744_pytorch_distributed_tutorial_tpu.models.moe import MoEFFN as JaxMoE

    layer = JaxMoE(num_experts=num_experts, d_ff=32, top_k=2, dispatch_impl="dropless",
                   gmm_impl="ragged", dtype=jnp.float32)
    params = layer.init(jax.random.key(0), jnp.zeros((1, 4, x.shape[-1])))["params"]
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: (jnp.asarray(0.1 * rng.standard_normal(v.shape), v.dtype)
                         if path[-1].key in ("b_in", "b_out") else v), params)
    y, mut = layer.apply({"params": params}, jnp.asarray(x), mutable=["losses", "metrics"])
    return params, np.asarray(y), float(mut["losses"]["moe_aux"][0])


@pytest.mark.parametrize("num_experts", [4, 72])
def test_moe_ffn_ragged_matches_jax(num_experts):
    """The dropless MoE on the ragged path: each product rounded to the
    compute dtype, then the bias and the gelu (JAX's unfused order), fp32
    within 2e-5; the aux loss within 1e-6."""
    d = 16
    x = np.random.default_rng(2).standard_normal((2, 12, d)).astype(np.float32)
    params, want, aux = _jax_moe(num_experts, x)
    layer = MoEFFN(d, num_experts, 32, top_k=2, dispatch_impl="dropless", gmm_impl="ragged")
    layer.load_state_dict(lm_params_from_jax(params))
    G.reset_launch_count()
    got = layer(torch.from_numpy(x), torch.float32)
    assert G.launch_count() == 0
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-5, atol=2e-5)
    assert float(layer.aux_loss.detach()) == pytest.approx(aux, rel=1e-6)
    got.square().mean().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in layer.parameters())


def test_lm_cli_trains_ragged_past_64_experts(capsys):
    argv = ["--num-layers", "2", "--d-model", "32", "--num-heads", "4", "--d-ff", "64",
            "--vocab-size", "128", "--max-seq-len", "32", "--seq-len", "16", "--use-rope",
            "--moe-experts", "72", "--moe-dispatch", "dropless", "--moe-gmm-impl", "ragged",
            "--global-batch-size", "4", "--steps", "3", "--num-seqs", "24", "--eval-frac", "0.2",
            "--json", "--device", "cpu"]
    assert lm_cli.main(argv) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["steps_run"] == 3 and summary["finite"]
    assert summary["moe"]["moe_drop"] == [0.0, 0.0, 0.0]
