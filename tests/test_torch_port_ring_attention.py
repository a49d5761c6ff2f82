"""The port's sequence-parallel attention (``parallel/ring_attention.py``)
against the JAX package's, function by function.

The port's hop functions run for every position of a ring of n = 4 in
one process (``simulate_*``: the blocks handed on in the order a ring
delivers them, no process group); the JAX functions run under
``shard_map`` on 4 of the 8 host devices, their Pallas kernels in
interpret mode, as ``tests/test_ring_attention.py`` runs them. fp32 at
that file's sizes (B 2, T 32, H 8, D 16), the same inputs from a numpy
seed: the output and the gradients of q, k and v (``jax.vjp`` on one
cotangent) at rtol 1e-5, atol 1e-6. Cases: causal and not, multi-head,
GQA at kv width (8 heads over 4 KV heads, which divide over the axis)
and ragged GQA (8 over 2: Ulysses's grouped plan). The grouped plan and
its exchange width equal JAX's over a table of (h, hkv, n); the ring
flash's hops are n - 1 forward and n backward. A ``cuda`` twin holds the
hop functions on the kernels against their plain versions on the card.
"""

import numpy as np
import pytest
import torch

B, T, H, D, N = 2, 32, 8, 16, 4
TOL = dict(rtol=1e-5, atol=1e-6)
KV_CASES = {"mha": H, "gqa_kv4": 4, "gqa_kv2_ragged": 2}


def _inputs(hkv: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, T, hkv, D)).astype(np.float32) for _ in range(2))
    g = rng.standard_normal((B, T, H, D)).astype(np.float32)
    return q, k, v, g


def _jax(mesh4, fn, q, k, v, g):
    """JAX's output and (dq, dk, dv) of the shard_mapped ``fn``."""
    import jax
    from jax.sharding import PartitionSpec as P

    mapped = jax.shard_map(lambda a, b, c: fn(a, b, c, "data", N), mesh=mesh4,
                           in_specs=(P(None, "data"),) * 3, out_specs=P(None, "data"),
                           check_vma=False)

    @jax.jit
    def run(q, k, v, g):
        out, vjp = jax.vjp(mapped, q, k, v)
        return out, vjp(g)

    out, grads = run(q, k, v, g)
    return np.asarray(out), [np.asarray(x) for x in grads]


def _port(fn, q, k, v, g):
    """The port's output and (dq, dk, dv) through autograd."""
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fn(qt, kt, vt)
    grads = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(g))
    return out.detach().numpy(), [x.numpy() for x in grads]


def _check(got, want, what):
    np.testing.assert_allclose(got[0], want[0], **TOL, err_msg=f"{what} out")
    for name, a, b in zip(("dq", "dk", "dv"), got[1], want[1]):
        np.testing.assert_allclose(a, b, **TOL, err_msg=f"{what} {name}")


@pytest.mark.parametrize("kv", ["mha", "gqa_kv2_ragged"])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_jax(mesh4, causal, kv):
    from cs744_pytorch_distributed_tutorial_tpu.parallel.ring_attention import ring_attention
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import ring_attention as R

    q, k, v, g = _inputs(KV_CASES[kv])
    want = _jax(mesh4, lambda a, b, c, ax, n: ring_attention(a, b, c, ax, n, causal=causal),
                q, k, v, g)
    got = _port(lambda a, b, c: R.simulate_ring_attention(a, b, c, N, causal), q, k, v, g)
    _check(got, want, f"ring causal={causal} {kv}")


@pytest.mark.parametrize("kv", ["mha", "gqa_kv2_ragged"])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_flash_matches_jax(mesh4, causal, kv):
    from cs744_pytorch_distributed_tutorial_tpu.parallel.ring_attention import (
        ring_flash_attention,
    )
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import ring_attention as R

    q, k, v, g = _inputs(KV_CASES[kv], seed=1)
    want = _jax(mesh4, lambda a, b, c, ax, n: ring_flash_attention(a, b, c, ax, n, causal, True),
                q, k, v, g)
    out, _, grads = R.simulate_ring_flash(*(torch.from_numpy(x) for x in (q, k, v)), N, causal,
                                          g=torch.from_numpy(g))
    _check((out.numpy(), [x.numpy() for x in grads]), want, f"ring_flash causal={causal} {kv}")


@pytest.mark.parametrize("kv", list(KV_CASES))
@pytest.mark.parametrize("inner,causal", [("dense", True), ("flash", True), ("flash", False)])
def test_ulysses_matches_jax(mesh4, inner, causal, kv):
    from cs744_pytorch_distributed_tutorial_tpu.parallel.ring_attention import ulysses_attention
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import ring_attention as R

    q, k, v, g = _inputs(KV_CASES[kv], seed=2)
    want = _jax(mesh4, lambda a, b, c, ax, n: ulysses_attention(
        a, b, c, ax, n, causal=causal, inner=inner, flash_interpret=True), q, k, v, g)
    got = _port(lambda a, b, c: R.simulate_ulysses(a, b, c, N, causal, inner), q, k, v, g)
    _check(got, want, f"ulysses {inner} causal={causal} {kv}")


PLANS = [(h, hkv, n) for h, hkv, n in [(8, 2, 4), (8, 1, 4), (12, 3, 4), (12, 4, 3), (16, 4, 8),
                                        (16, 2, 8), (6, 3, 2), (8, 8, 4), (24, 6, 4)]]


def test_grouped_kv_plan_and_exchange_width_equal_jax():
    from cs744_pytorch_distributed_tutorial_tpu.parallel import ring_attention as J
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import ring_attention as R

    for h, hkv, n in PLANS:
        for a, b in zip(R.grouped_kv_plan(h, hkv, n), J.grouped_kv_plan(h, hkv, n)):
            np.testing.assert_array_equal(a, b, err_msg=str((h, hkv, n)))
        assert R.ulysses_kv_exchange_width(h, hkv, n) == J.ulysses_kv_exchange_width(h, hkv, n)


def test_ring_flash_hops_and_masked_hops_launch_nothing(monkeypatch):
    """n - 1 hops forward and n backward; under the causal mask the
    later blocks call no kernel function: n(n+1)/2 of each, n^2 without
    the mask."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import flash_attention as A
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import collectives as C
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import ring_attention as R

    q, k, v, g = (torch.from_numpy(x) for x in _inputs(2, seed=3))
    for causal, hops_each in ((True, N * (N + 1) // 2), (False, N * N)):
        calls = {"fwd": 0, "dq": 0, "dkv": 0}
        for name, fn in (("fwd", "flash_forward_lse"), ("dq", "flash_dq"), ("dkv", "flash_dkv")):
            real = getattr(A, fn)

            def counted(*a, _real=real, _name=name, **kw):
                calls[_name] += 1
                return _real(*a, **kw)

            monkeypatch.setattr(A, fn, counted)
        C.hops.clear()
        R.simulate_ring_flash(q, k, v, N, causal)
        assert C.hops["seq"] == N - 1
        C.hops.clear()
        R.simulate_ring_flash(q, k, v, N, causal, g=g)
        assert C.hops["seq"] == (N - 1) + N
        assert calls == {"fwd": 2 * hops_each, "dq": hops_each, "dkv": hops_each}
        monkeypatch.undo()


def test_sequence_parallel_guards():
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import ring_attention as R

    q = torch.zeros(1, 8, 3, 4)
    with pytest.raises(ValueError, match="divisible"):
        R.simulate_ulysses(q, q, q, 4)
    with pytest.raises(ValueError, match="not a multiple of kv heads"):
        R.simulate_ring_attention(torch.zeros(1, 8, 4, 4), torch.zeros(1, 8, 3, 4),
                                  torch.zeros(1, 8, 3, 4), 4)
    with pytest.raises(ValueError, match="unknown inner"):
        R.simulate_ulysses(torch.zeros(1, 8, 4, 4), torch.zeros(1, 8, 4, 4),
                           torch.zeros(1, 8, 4, 4), 4, inner="sparse")


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_ring_flash_hops_on_card_match_plain(causal):
    """The hop functions on the tensor-core kernels (bf16, D 64) against the
    same hops on the plain versions, and the launches by route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import flash_attention as A
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import ring_attention as R

    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, g = (torch.randn(2, 256, 4, 64, generator=gen, device="cuda").bfloat16()
                  for _ in range(4))
    A.reset_launch_count()
    out, lse, grads = R.simulate_ring_flash(q, k, v, N, causal, g=g)
    torch.cuda.synchronize()
    each = N * (N + 1) // 2 if causal else N * N
    for kernel in A.KERNELS:
        assert A.launch_count(kernel, route="tc") == each
        assert A.launch_count(kernel, route="ffma") == 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(A, "flash_forward_lse", A.flash_forward_lse_plain)
        mp.setattr(A, "flash_dq", A.flash_dq_plain)
        mp.setattr(A, "flash_dkv", A.flash_dkv_plain)
        want = R.simulate_ring_flash(q, k, v, N, causal, g=g)
    for got, ref in zip((out, *grads), (want[0], *want[2])):
        scale = float(ref.float().abs().max())
        assert float((got.float() - ref.float()).abs().max()) <= 2e-2 * scale
