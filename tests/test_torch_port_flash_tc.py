"""The tensor-core route of the port's flash attention.

``flash_forward_lse``, ``flash_dq`` and ``flash_dkv`` send a call on CUDA
tensors to the tensor-core kernels (``csrc/flash_attention_tc.cu``) when
``tc_route`` holds, a rule of dtypes, shapes, strides and alignment, and
to the FFMA kernels otherwise. On the CPU these tests hold:

- the route rule, case by case, and the forward's route over q, k and v;
- the strides the wrappers hand the kernels (views read in place; a
  dimension of size 1 gets a stride TMA takes);
- the CPU wrappers and the autograd backward taking the plain versions,
  with no launch on either route;
- the plain versions, the kernels' yardstick on the card, against the JAX
  package's Pallas kernels in interpret mode in bf16 at the head dims the
  tensor-core kernels take (2e-2, the JAX test's bf16 tolerance; the
  forward's lse within 1e-5), over several key blocks so that the
  forward's running max rescales;
- the build's digest covering the headers a source includes.

The ``cuda``-marked tests hold the kernels against the plain versions on
the card (2e-2 x max|plain|, as ``chip_smoke.py``'s ``FLASH_TOL``, and the
forward's lse within 1e-5, its ``FLASH_LSE_TOL``: both form the same exact
products; the order of the fp32 sums differs, and with it the bf16
rounding of a p, ds or output that lands near a tie), two runs bitwise
equal, and the same inputs on the FFMA route within the same limit.
"""

import importlib

import numpy as np
import pytest
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.ops import _build
from cs744_pytorch_distributed_tutorial_tpu_torch.ops import flash_attention as F

BF16_TOL = 2e-2  # x max|plain|
LSE_TOL = 1e-5  # the forward's lse, absolute


def _strided(shape, strides, offset=0):
    """A bf16 view of the given shape and strides on a fresh buffer."""
    size = offset + 1 + sum((n - 1) * s for n, s in zip(shape, strides))
    return torch.zeros(size, dtype=torch.bfloat16).as_strided(shape, strides, offset)


def _route_case(name):
    b, t, h = 2, 8, 3
    if name == "fp32":
        x = torch.zeros((b, t, h, 64))
        return x.dtype, x.shape, [x.stride()] * 4, True
    if name.startswith("d"):
        x = torch.zeros((b, t, h, int(name[1:])), dtype=torch.bfloat16)
        return x.dtype, x.shape, [x.stride()] * 4, True
    if name == "qkv_views":  # q, k, v slices of one [B, T, 3, H, D] tensor
        q, k, v = torch.zeros((b, t, 3, h, 64), dtype=torch.bfloat16).unbind(2)
        do = torch.zeros((b, t, h, 64), dtype=torch.bfloat16)
        return q.dtype, q.shape, [x.stride() for x in (q, k, v, do)], True
    if name == "stride_not_16_bytes":  # rows of 68 elements: (b, t, h) strides of 136 bytes
        x = torch.zeros((b, t, h, 68), dtype=torch.bfloat16)[..., :64]
        return x.dtype, x.shape, [x.stride()] * 4, True
    if name == "last_dim_strided":
        x = torch.zeros((b, t, 64, h), dtype=torch.bfloat16).transpose(2, 3)
        return x.dtype, x.shape, [x.stride()] * 4, True
    if name == "misaligned":
        x = torch.zeros((b, t, h, 64), dtype=torch.bfloat16)
        return x.dtype, x.shape, [x.stride()] * 4, False
    if name == "misaligned_pointer":
        x = _strided((b, t, h, 64), (t * h * 64, h * 64, 64, 1), offset=1)
        return x.dtype, x.shape, [x.stride()] * 4, F._aligned(x)
    if name == "size_one_dims_odd_strides":  # B = H = 1: their strides are never used
        x = _strided((1, t, 1, 64), (3, 64, 5, 1))
        return x.dtype, x.shape, [x.stride()] * 4, True
    raise KeyError(name)


@pytest.mark.parametrize("name,want", [
    ("d64", True), ("d128", True), ("d32", False), ("d80", False), ("fp32", False),
    ("qkv_views", True), ("stride_not_16_bytes", False), ("last_dim_strided", False),
    ("misaligned", False), ("misaligned_pointer", False), ("size_one_dims_odd_strides", True),
])
def test_tc_route(name, want):
    dtype, shape, strides, aligned = _route_case(name)
    assert F.tc_route(dtype, tuple(shape), strides, aligned) is want


def _forward_inputs(name):
    """q, k, v for a forward route case (CPU tensors)."""
    b, t, h = 2, 8, 3
    if name == "fp32":
        return tuple(torch.zeros((b, t, h, 64)) for _ in range(3))
    if name.startswith("d"):
        return tuple(torch.zeros((b, t, h, int(name[1:])), dtype=torch.bfloat16)
                     for _ in range(3))
    if name == "qkv_views":
        return torch.zeros((b, t, 3, h, 64), dtype=torch.bfloat16).unbind(2)
    if name == "v_stride_not_16_bytes":
        q, k = (torch.zeros((b, t, h, 64), dtype=torch.bfloat16) for _ in range(2))
        return q, k, torch.zeros((b, t, h, 68), dtype=torch.bfloat16)[..., :64]
    if name == "k_misaligned_pointer":
        q, v = (torch.zeros((b, t, h, 64), dtype=torch.bfloat16) for _ in range(2))
        return q, _strided((b, t, h, 64), (t * h * 64, h * 64, 64, 1), offset=1), v
    raise KeyError(name)


@pytest.mark.parametrize("name,want", [
    ("d64", "tc"), ("d128", "tc"), ("d32", "ffma"), ("fp32", "ffma"), ("qkv_views", "tc"),
    ("v_stride_not_16_bytes", "ffma"), ("k_misaligned_pointer", "ffma"),
])
def test_forward_route(name, want):
    """The forward's launch route: the rule over q, k and v (any one of
    them that TMA cannot read sends the call to the FFMA kernel)."""
    assert F._route(*_forward_inputs(name)) == want


def test_cuda_args_read_views_in_place():
    """The (b, t, h) strides the kernels get: a view's own, D for a
    dimension of size 1, then the contiguous outputs'."""
    b, t, h, d = 2, 8, 3, 64
    q, k, v = torch.zeros((b, t, 3, h, d), dtype=torch.bfloat16).unbind(2)
    do = _strided((1, t, 1, d), (7, d, 5, 1))
    xs, strides = F._cuda_args(q[:1, :, :1], k[:1, :, :1], v[:1, :, :1], do)
    assert all(x.data_ptr() == y.data_ptr() for x, y in zip(xs, (q, k, v, do)))
    view = [d, 3 * h * d, d]  # sb (size 1: D), st, sh (size 1: D)
    assert list(strides) == view * 3 + [d, d, d] + [t * d, d, d]
    _, strides = F._cuda_args(q, k, v, q)
    assert list(strides[:3]) == [t * 3 * h * d, 3 * h * d, d]


def test_cpu_wrappers_and_backward_take_plain_versions():
    """bf16 CPU tensors at a head dim the tensor-core kernels take: the
    wrappers return the plain versions' results, and neither route counts
    a launch, through the wrappers or the autograd backward."""
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((1, 40, 2, 64)).astype(np.float32))
                   .bfloat16() for _ in range(4))
    _, lse = F.flash_forward_lse_plain(q, k, v, True)
    delta = F.flash_delta(F.flash_forward_lse_plain(q, k, v, True)[0], do)
    F.reset_launch_count()
    assert torch.equal(F.flash_dq(q, k, v, do, lse, delta, True),
                       F.flash_dq_plain(q, k, v, do, lse, delta, True))
    for got, want in zip(F.flash_dkv(q, k, v, do, lse, delta, True),
                         F.flash_dkv_plain(q, k, v, do, lse, delta, True)):
        assert torch.equal(got, want)
    tq, tk, tv = (x.clone().requires_grad_() for x in (q, k, v))
    (F.flash_attention(tq, tk, tv, True).float() * do.float()).sum().backward()
    assert tq.grad.dtype == torch.bfloat16 and torch.isfinite(tq.grad.float()).all()
    assert F.launch_count() == 0
    assert F.launch_count(route="tc") == F.launch_count(route="ffma") == 0


@pytest.mark.parametrize("d", [64, 128])
def test_cpu_forward_takes_plain_version(d):
    """bf16 CPU tensors at a head dim the tensor-core forward takes: the
    wrapper returns the plain forward's out and lse bit for bit, and no
    route counts a launch."""
    rng = np.random.default_rng(d + 1)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 40, 2, d)).astype(np.float32))
               .bfloat16() for _ in range(3))
    F.reset_launch_count()
    for causal in (True, False):
        out, lse = F.flash_forward_lse(q, k, v, causal)
        want_out, want_lse = F.flash_forward_lse_plain(q, k, v, causal)
        assert out.dtype == torch.bfloat16 and lse.shape == (4, 40, 1)
        assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    assert F.launch_count("fwd") == F.launch_count() == 0


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_plain_forward_bf16_matches_pallas_interpret_at_tc_head_dims(d, causal):
    """The plain forward the tensor-core forward is held to on the card, in
    bf16 at head_dim 64 and 128, against the Pallas forward in interpret
    mode over three key blocks (blk 16 at T 48, so that its running max
    rescales the sums): out within 2e-2, lse within 1e-5."""
    J = importlib.import_module("cs744_pytorch_distributed_tutorial_tpu.ops.flash_attention")
    import jax.numpy as jnp

    b, t, h, blk = 2, 48, 2, 16
    rng = np.random.default_rng(10 * d + causal)
    q, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3))
    o, lse = J.flash_forward_lse(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                                 causal=causal, block_q=blk, block_k=blk, interpret=True)
    out, tlse = F.flash_forward_lse_plain(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)),
                                          causal)
    assert out.dtype == torch.bfloat16 and tlse.shape == (b * h, t, 1)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(o, np.float32), rtol=BF16_TOL,
                               atol=BF16_TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(lse, np.float32), rtol=0, atol=LSE_TOL)


@pytest.mark.parametrize("d", [64, 128])
def test_plain_bf16_matches_pallas_interpret_at_tc_head_dims(d):
    """The plain versions the kernels are held to on the card, in bf16 at
    head_dim 64 and 128, against the Pallas dq and dk/dv kernels in
    interpret mode given the same lse and delta: 2e-2."""
    import jax.numpy as jnp

    J = importlib.import_module("cs744_pytorch_distributed_tutorial_tpu.ops.flash_attention")
    b, t, h, blk = 1, 48, 2, 16
    rng = np.random.default_rng(d)
    q, k, v, do = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(4))
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    o, lse = J.flash_forward_lse(jq, jk, jv, causal=True, block_q=blk, block_k=blk,
                                 interpret=True)
    delta = J.flash_delta(o, jdo)
    want_dq = J.flash_dq(jq, jk, jv, jdo, lse, delta, True, blk, blk, True)
    want_dk, want_dv = J.flash_dkv(jq, jk, jv, jdo, lse, delta, True, blk, blk, True)
    tq, tk, tv, tdo = (torch.from_numpy(x).bfloat16() for x in (q, k, v, do))
    tlse, tdelta = (torch.from_numpy(np.array(x, np.float32)) for x in (lse, delta))
    dq = F.flash_dq_plain(tq, tk, tv, tdo, tlse, tdelta, True)
    dk, dv = F.flash_dkv_plain(tq, tk, tv, tdo, tlse, tdelta, True)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=BF16_TOL, atol=BF16_TOL)


def test_build_digest_covers_included_headers(tmp_path):
    """A source's digest changes when a header it includes (directly or
    through another header) changes, and not for a header it does not."""
    src = tmp_path / "k.cu"
    src.write_text('#include "a.cuh"\n#include <cuda.h>\nint f() { return A; }\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n#define A B\n')
    (tmp_path / "b.cuh").write_text("#define B 1\n")
    (tmp_path / "other.cuh").write_text("#define C 1\n")
    first = _build.source_digest(src)
    assert _build.source_digest(src) == first
    (tmp_path / "other.cuh").write_text("#define C 2\n")
    assert _build.source_digest(src) == first
    (tmp_path / "b.cuh").write_text("#define B 2\n")
    second = _build.source_digest(src)
    assert second != first
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n#define A (B + 1)\n')
    assert _build.source_digest(src) not in (first, second)


# The card: chip_smoke.py's FLASH_CASES (the LM path's shape first), a
# non-causal head_dim 128 case; (B, T, H, D, causal).
CARD_CASES = [
    (16, 1024, 12, 64, True),
    (4, 512, 12, 64, False),
    (1, 200, 3, 64, True),
    (2, 77, 2, 128, True),
    (1, 200, 3, 128, False),
]


def _card_inputs(case, seed):
    b, t, h, d, _ = case
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((b, t, 3, h, d), generator=gen, device=dev).bfloat16()
    q, k, v = qkv.unbind(2)  # read in place through their strides
    do = torch.randn((b, t, h, d), generator=gen, device=dev).bfloat16()
    return q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
def test_tc_kernels_match_plain_on_card(case, monkeypatch):
    """The forward, dq and dk/dv on the tensor cores against the plain
    versions within 2e-2 x max|plain| (the forward's lse within 1e-5); a
    second run bitwise equal; the same inputs on the FFMA route (tc_route
    patched to refuse) within the same limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    causal = case[-1]
    q, k, v, do = _card_inputs(case, seed=sum(case[:4]))
    out, lse = F.flash_forward_lse_plain(q, k, v, causal)
    delta = F.flash_delta(out, do)
    args = (q, k, v, do, lse, delta, causal)

    def run():
        return (*F.flash_forward_lse(q, k, v, causal), F.flash_dq(*args), *F.flash_dkv(*args))

    F.reset_launch_count()
    got, again = run(), run()
    want = (out, lse, F.flash_dq_plain(*args), *F.flash_dkv_plain(*args))
    torch.cuda.synchronize()
    assert F.launch_count("fwd", route="tc") == 2
    assert F.launch_count("dq", route="tc") == F.launch_count("dkv", route="tc") == 2
    assert F.launch_count(route="ffma") == 0
    monkeypatch.setattr(F, "tc_route", lambda *a, **kw: False)
    ffma = run()
    torch.cuda.synchronize()
    assert F.launch_count("fwd", route="ffma") == 1
    assert F.launch_count("dq", route="ffma") == F.launch_count("dkv", route="ffma") == 1
    for name, g, a, f, w in zip(("out", "lse", "dq", "dk", "dv"), got, again, ffma, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, a), name
        limit = LSE_TOL if name == "lse" else BF16_TOL * float(w.float().abs().max())
        for route, x in (("tc", g), ("ffma", f)):
            err = float((x.float() - w.float()).abs().max())
            assert err <= limit, (name, route, err, limit)


@pytest.mark.cuda
def test_tc_route_refuses_or_launches_on_card():
    """fp32 and head_dim 32 take the FFMA kernels; a bf16 call that
    tc_route accepts launches the tensor-core kernels (never the FFMA
    ones), the forward's as the backward's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    for dtype, d, route in ((torch.float32, 64, "ffma"), (torch.bfloat16, 32, "ffma"),
                            (torch.bfloat16, 128, "tc")):
        q, k, v, do = (x.to(dtype) for x in _card_inputs((1, 70, 2, d, True), seed=d))
        out, lse = F.flash_forward_lse_plain(q, k, v, True)
        delta = F.flash_delta(out, do)
        F.reset_launch_count()
        F.flash_forward_lse(q, k, v, True)
        F.flash_dq(q, k, v, do, lse, delta, True)
        F.flash_dkv(q, k, v, do, lse, delta, True)
        torch.cuda.synchronize()
        assert F.launch_count(route=route) == 3 and F.launch_count() == 3, (dtype, d)
        assert F.launch_count("fwd", route=route) == 1, (dtype, d)


def test_ptxas_report_names_kernels_and_spills(monkeypatch):
    """The build's ptxas report, read back per kernel: the mangled name's
    kernel and template arguments, registers and spills."""
    log = (
        "ptxas info    : Compiling entry function '_ZN54_GLOBAL__N__6cbe1a89_21_flash_attention_"
        "tc_cu_734241b419flash_dkv_tc_kernelILi64EEEv14CUtensorMap_stS1_S1_S1_NS_6ParamsE' for "
        "'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers, 80 bytes smem\n"
        "ptxas info    : Compiling entry function '_ZN39_GLOBAL__N__dee20549_9_gmm_tc_cu_gmm_tc13"
        "gmm_tc_kernelILi3ELb0EEEv14CUtensorMap_stS1_PKiPfiiii' for 'sm_90a'\n"
        "    32 bytes stack frame, 32 bytes spill stores, 24 bytes spill loads\n"
        "ptxas info    : Used 146 registers, used 1 barriers, 304 bytes smem\n"
    )
    monkeypatch.setitem(_build.build_log, "k.cu", log)
    assert _build.ptxas_report("k.cu") == {
        "flash_dkv_tc_kernel<64>": {"registers": 168, "spill_stores": 0, "spill_loads": 0},
        "gmm_tc_kernel<3, 0>": {"registers": 146, "spill_stores": 32, "spill_loads": 24},
    }
    assert _build.ptxas_report("not_built.cu") == {}
