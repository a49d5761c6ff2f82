"""The port's decode attention against the JAX package's.

The same numpy inputs go through the JAX functions (the Pallas
paged-attention kernel in interpret mode, as ``tests/test_paged_attention.py``
runs it) and the port's (the kernel's plain version on CPU tensors):
``paged_attention`` at the JAX test's own tolerances, 2e-5 in fp32 and
for int8 pools, 2e-2 in bf16 (online softmax against the gather path)
and for int8 pools under a bf16 query;
``decode_attention``, ``paged_decode_attention`` and
``decode_attention_quant`` at 1e-6 (the same einsums, summed in another
order). Page tables are shuffled, depths run from 0 to full, GQA groups
are 1 and 2. ``paged_attention_split_plain`` (the CUDA kernels'
arithmetic: per-span partials, the merge in span order) is held to the
Pallas kernel at the same tolerances, for all four variants, at spans
that do and do not divide the page, with depth 0 and depths on and
beside a span boundary, and to the gather path at groups 1 and 16, head
dims 32 and 128 and a narrowed table. The ``cuda``-marked tests hold
the CUDA kernels against the plain version on the card. JAX is imported
inside the tests that use it.
"""

import importlib

import numpy as np
import pytest
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.ops import paged_attention as P
from cs744_pytorch_distributed_tutorial_tpu_torch.ops.quant import (
    decode_attention_quant,
    paged_decode_attention_quant,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.ring_attention import (
    decode_attention,
    gather_pages,
    paged_decode_attention,
)

B, D = 3, 16


def _jax(module):
    return importlib.import_module(f"cs744_pytorch_distributed_tutorial_tpu.{module}")


def _layout(num_pages, page_size, ppr, seed):
    """Distinct shuffled pages a slot; depths 0, mid and full."""
    rng = np.random.default_rng(seed)
    table = (1 + rng.permutation(num_pages - 1)[: B * ppr]).reshape(B, ppr).astype(np.int32)
    pos = np.asarray([0, page_size * (ppr - 1) - 3, ppr * page_size - 1], np.int32)
    return table, pos


def _float_case(seed, hq, hkv, num_pages=17, page_size=4, ppr=4):
    rng = np.random.default_rng(seed)
    shape = (num_pages, page_size, hkv, D)
    kp, vp = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    q = rng.standard_normal((B, 1, hq, D)).astype(np.float32)
    table, pos = _layout(num_pages, page_size, ppr, seed)
    return q, kp, vp, table, pos


def _int8_case(seed, hq, hkv, num_pages=17, page_size=4, ppr=4):
    rng = np.random.default_rng(seed)
    shape = (num_pages, page_size, hkv, D)
    kp, vp = (rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2))
    ks, vs = (rng.uniform(0.5 / 127, 1.5 / 127, shape[:3]).astype(np.float32) for _ in range(2))
    q = rng.standard_normal((B, 1, hq, D)).astype(np.float32)
    table, pos = _layout(num_pages, page_size, ppr, seed)
    return q, kp, vp, ks, vs, table, pos


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("hq,hkv", [(2, 2), (4, 2)], ids=["group1", "group2"])
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_paged_attention_matches_pallas_interpret(dtype, tol, hq, hkv):
    import jax.numpy as jnp

    q, kp, vp, table, pos = _float_case(0, hq, hkv)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = _jax("ops.paged_attention").paged_attention(
        *(jnp.asarray(a).astype(jd) for a in (q, kp, vp)), jnp.asarray(table),
        jnp.asarray(pos), interpret=True)
    P.reset_launch_count()
    qt, kt, vt, tt, pt = _t(q, kp, vp, table, pos)
    got = P.paged_attention(qt.to(td), kt.to(td), vt.to(td), tt, pt)
    assert P.launch_count() == 0  # CPU tensors take the plain version
    assert got.dtype == td and got.shape == (B, 1, hq, D)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("hq,hkv", [(2, 2), (4, 2)], ids=["group1", "group2"])
def test_paged_attention_int8_matches_pallas_interpret(hq, hkv):
    import jax.numpy as jnp

    q, kp, vp, ks, vs, table, pos = _int8_case(1, hq, hkv)
    want = _jax("ops.paged_attention").paged_attention(
        *map(jnp.asarray, (q, kp, vp, table, pos)), key_scale_pages=jnp.asarray(ks),
        value_scale_pages=jnp.asarray(vs), interpret=True)
    qt, kt, vt, kst, vst, tt, pt = _t(q, kp, vp, ks, vs, table, pos)
    got = P.paged_attention(qt, kt, vt, tt, pt, key_scale_pages=kst, value_scale_pages=vst)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_paged_attention_int8_bf16_query_matches_pallas_interpret():
    """int8 pools under a bf16 query, as serving in bf16 runs them: the
    output in q's dtype, within 2e-2 of the Pallas kernel's."""
    import jax.numpy as jnp

    q, kp, vp, ks, vs, table, pos = _int8_case(6, 4, 2)
    want = _jax("ops.paged_attention").paged_attention(
        jnp.asarray(q).astype(jnp.bfloat16), *map(jnp.asarray, (kp, vp, table, pos)),
        key_scale_pages=jnp.asarray(ks), value_scale_pages=jnp.asarray(vs), interpret=True)
    qt, kt, vt, kst, vst, tt, pt = _t(q, kp, vp, ks, vs, table, pos)
    got = P.paged_attention(qt.bfloat16(), kt, vt, tt, pt, key_scale_pages=kst,
                            value_scale_pages=vst)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_pages_per_slot_narrows_the_table():
    """Live pages within the first 2: narrowing the table (and writing
    NaN into every page past it) changes nothing, as in JAX."""
    import jax.numpy as jnp

    q, kp, vp, table, _ = _float_case(2, 4, 2)
    pos = np.asarray([0, 5, 7], np.int32)
    kp[table[:, 2:]] = np.nan
    want = _jax("ops.paged_attention").paged_attention(
        *map(jnp.asarray, (q, kp, vp, table, pos)), interpret=True, pages_per_slot=2)
    got = P.paged_attention(*_t(q, kp, vp, table, pos), pages_per_slot=2)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_decode_functions_match_jax():
    """decode_attention (chunk of 3 rows at a scalar position and one row
    at [B] positions), gather_pages, paged_decode_attention and the int8
    variants, at 1e-6."""
    import jax.numpy as jnp

    R = _jax("parallel.ring_attention")
    Q = _jax("ops.quant")
    rng = np.random.default_rng(3)
    hq, hkv, L = 4, 2, 12
    q3 = rng.standard_normal((B, 3, hq, D)).astype(np.float32)
    ck, cv = (rng.standard_normal((B, L, hkv, D)).astype(np.float32) for _ in range(2))
    for q, pos in ((q3, 5), (q3[:, :1], np.asarray([0, 6, 11], np.int32))):
        want = R.decode_attention(*map(jnp.asarray, (q, ck, cv)), jnp.asarray(pos))
        got = decode_attention(*_t(q, ck, cv), torch.as_tensor(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    q, kp, vp, table, pos = _float_case(4, hq, hkv)
    np.testing.assert_array_equal(gather_pages(*_t(kp, table)).numpy(),
                                  np.asarray(R.gather_pages(jnp.asarray(kp), jnp.asarray(table))))
    want = R.paged_decode_attention(*map(jnp.asarray, (q, kp, vp, table, pos)))
    got = paged_decode_attention(*_t(q, kp, vp, table, pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)

    q, kp, vp, ks, vs, table, pos = _int8_case(5, hq, hkv)
    want = Q.paged_decode_attention_quant(*map(jnp.asarray, (q, kp, vp, ks, vs, table, pos)))
    got = paged_decode_attention_quant(*_t(q, kp, vp, ks, vs, table, pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    ckq = rng.integers(-127, 128, (B, L, hkv, D)).astype(np.int8)
    cvq = rng.integers(-127, 128, (B, L, hkv, D)).astype(np.int8)
    cks, cvs = (rng.uniform(0.005, 0.01, (B, L, hkv)).astype(np.float32) for _ in range(2))
    want = Q.decode_attention_quant(*map(jnp.asarray, (q3, ckq, cvq, cks, cvs)), 4)
    got = decode_attention_quant(*_t(q3, ckq, cvq, cks, cvs), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    "kw,match",
    [
        (dict(t=2), "one token"),
        (dict(hkv=3), "multiple"),
        (dict(scales="k"), "both scale pools"),
        (dict(table_rows=2), "page_table"),
    ],
)
def test_paged_attention_checks_inputs(kw, match):
    hkv = kw.get("hkv", 2)
    q = torch.zeros(B, kw.get("t", 1), 4, D)
    kp = torch.zeros(9, 4, hkv, D)
    table = torch.zeros(kw.get("table_rows", B), 2, dtype=torch.int32)
    pos = torch.zeros(B, dtype=torch.int32)
    scales = {"key_scale_pages": torch.ones(9, 4, hkv)} if kw.get("scales") else {}
    with pytest.raises(ValueError, match=match):
        P.paged_attention(q, kp, kp, table, pos, **scales)


# (pool dtype, q dtype, tolerance) of the four variants, as the Pallas
# tests above hold them.
SPLIT_VARIANTS = {"float32": ("float32", "float32", 2e-5),
                  "bfloat16": ("bfloat16", "bfloat16", 2e-2),
                  "int8": ("int8", "float32", 2e-5), "int8_bf16q": ("int8", "bfloat16", 2e-2)}


@pytest.mark.parametrize("span", [3, 4, 5], ids=["span3", "span4", "span5"])
@pytest.mark.parametrize("variant", sorted(SPLIT_VARIANTS))
def test_split_plain_matches_pallas_interpret(variant, span):
    """Depths 0, ``span`` (the first key of the second span) and
    ``2 span - 1`` (the last of the second); page 4, so spans of 3 and 5
    straddle pages. NaN in every page a slot does not hold live on the
    port's side only: the split version never reads them into a sum."""
    import jax.numpy as jnp

    pool, q_dtype, tol = SPLIT_VARIANTS[variant]
    if pool == "int8":
        q, kp, vp, ks, vs, table, _ = _int8_case(7, 4, 2)
    else:
        q, kp, vp, table, _ = _float_case(7, 4, 2)
        ks = vs = None
    pos = np.asarray([0, span, 2 * span - 1], np.int32)
    jd = getattr(jnp, q_dtype)
    scales = {} if ks is None else dict(key_scale_pages=jnp.asarray(ks),
                                        value_scale_pages=jnp.asarray(vs))
    jk, jv = (jnp.asarray(a) if pool == "int8" else jnp.asarray(a).astype(jd) for a in (kp, vp))
    want = _jax("ops.paged_attention").paged_attention(
        jnp.asarray(q).astype(jd), jk, jv, jnp.asarray(table), jnp.asarray(pos), interpret=True,
        **scales)
    live = np.arange(table.shape[1])[None, :] <= (pos // kp.shape[1])[:, None]
    dead = table[~live]
    qt, kt, vt, tt, pt = _t(q, kp, vp, table, pos)
    kw = {}
    if ks is None:
        kt, vt = kt.to(getattr(torch, pool)), vt.to(getattr(torch, pool))
        kt[dead], vt[dead] = float("nan"), float("nan")
    else:
        kst, vst = _t(ks, vs)
        kst[dead], vst[dead] = float("nan"), float("nan")
        kw = dict(key_scale_pages=kst, value_scale_pages=vst)
    got = P.paged_attention_split_plain(qt.to(getattr(torch, q_dtype)), kt, vt, tt, pt,
                                        span=span, **kw)
    assert got.dtype == getattr(torch, q_dtype) and got.shape == (B, 1, 4, D)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# (Hq, Hkv, D, page_size, pages a slot, pages_per_slot, span): groups 1 and
# 16, head dims 32 and 128, a narrowed table, spans over and within pages.
SPLIT_GATHER_CASES = [(2, 2, 32, 4, 4, None, 3), (16, 1, 32, 5, 3, None, 4),
                      (4, 2, 128, 3, 6, 4, 5), (6, 3, 16, 4, 5, 3, 64)]


@pytest.mark.parametrize("case", SPLIT_GATHER_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_split_plain_matches_gather_path(case, dtype, tol):
    hq, hkv, d, ps, ppr, narrow, span = case
    rng = np.random.default_rng(8)
    num_pages = B * ppr + 1
    td = getattr(torch, dtype)
    kp, vp = (torch.from_numpy(rng.standard_normal((num_pages, ps, hkv, d)).astype(np.float32))
              .to(td) for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((B, 1, hq, d)).astype(np.float32)).to(td)
    table = torch.from_numpy((1 + rng.permutation(num_pages - 1)).reshape(B, ppr).astype(np.int32))
    cap = (narrow or ppr) * ps
    pos = torch.tensor([0, span, cap + 3], dtype=torch.int32)  # the last past the table: clipped
    want = P.paged_attention_plain(q, kp, vp, table, pos.clamp(max=cap - 1),
                                   pages_per_slot=narrow)
    got = P.paged_attention_split_plain(q, kp, vp, table, pos, pages_per_slot=narrow, span=span)
    assert got.dtype == td
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), rtol=tol, atol=tol)


# The card: the serving shape (16 slots, 12 query heads over 4 KV heads,
# D 64, page 16, ragged depths up to 511), fp32, bf16 and int8, and a
# ragged one (page 8, group 1, D 128, a slot at depth 0); (B, Hq, Hkv, D,
# page_size, pages a slot).
CARD_CASES = [(16, 12, 4, 64, 16, 32), (5, 2, 2, 128, 8, 7), (3, 16, 1, 32, 5, 3)]
# (pool dtype, q dtype, max abs err): int8 pages with a bf16 q are what
# serving in bf16 runs; its output is bf16.
CARD_VARIANTS = [(torch.float32, torch.float32, 2e-5), (torch.bfloat16, torch.bfloat16, 2e-2),
                 (torch.int8, torch.float32, 2e-5), (torch.int8, torch.bfloat16, 2e-2)]


@pytest.mark.cuda
def test_paged_attention_kernel_matches_plain_on_card():
    """The CUDA kernels against the gather path on the card: max abs err
    <= 2e-5 for fp32 outputs, 2e-2 for bf16 ones (the CPU tests'
    tolerances against the Pallas kernel), with NaN written into every
    page a slot does not hold live (the kernel never reads them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    P.reset_launch_count()
    for b, hq, hkv, d, ps, ppr in CARD_CASES:
        num_pages = b * ppr + 1
        table = (1 + torch.randperm(num_pages - 1, generator=gen, device=dev)).view(b, ppr)
        table = table.to(torch.int32)
        pos = torch.randint(0, ppr * ps, (b,), generator=gen, device=dev).to(torch.int32)
        pos[0] = 0
        live = torch.arange(ppr, device=dev)[None, :] <= (pos // ps)[:, None]
        dead = table[~live].long()
        for dtype, q_dtype, tol in CARD_VARIANTS:
            shape = (num_pages, ps, hkv, d)
            q = torch.randn((b, 1, hq, d), generator=gen, device=dev).to(q_dtype)
            if dtype == torch.int8:
                kp, vp = (torch.randint(-127, 128, shape, generator=gen, device=dev).to(dtype)
                          for _ in range(2))
                ks, vs = (torch.rand(shape[:3], generator=gen, device=dev) / 127 + 0.5 / 127
                          for _ in range(2))
                ks[dead], vs[dead] = float("nan"), float("nan")
                kw = dict(key_scale_pages=ks, value_scale_pages=vs)
            else:
                kp, vp = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                          for _ in range(2))
                kw = {}
            want = P.paged_attention_plain(q, kp.clone().index_fill_(0, dead, 0),
                                           vp.clone().index_fill_(0, dead, 0), table, pos,
                                           **{k: v.nan_to_num(1.0) for k, v in kw.items()})
            if dtype != torch.int8:
                kp.index_fill_(0, dead, float("nan"))
                vp.index_fill_(0, dead, float("nan"))
            got = P.paged_attention(q, kp, vp, table, pos, **kw)
            torch.cuda.synchronize()
            assert got.dtype == want.dtype and got.shape == want.shape
            err = float((got.float() - want.float()).abs().max())
            assert err <= tol, (b, hq, hkv, d, ps, dtype, q_dtype, err)
    # two launches a call: the spans, then the merge
    assert P.launch_count() == 2 * len(CARD_VARIANTS) * len(CARD_CASES)
    assert P.launch_count("int8") == 4 * len(CARD_CASES)


# Edge cases of the key spans: (B, Hq, Hkv, D, page_size, pages a slot,
# pos, pages_per_slot). Depth 0 everywhere; depths on and beside the span
# boundaries 64 and 128; a page of 24 (no divisor of the 64-key span); a
# table narrowed to 5 of its 8 pages; groups 1 and 16; D 32 and 128.
SPAN_EDGE_CASES = [
    (4, 12, 4, 64, 16, 32, [0, 0, 0, 0], None),
    (6, 12, 4, 64, 16, 32, [63, 64, 65, 127, 128, 129], None),
    (3, 4, 2, 64, 24, 8, [47, 100, 191], None),
    (3, 6, 2, 64, 16, 8, [10, 70, 79], 5),
    (3, 2, 2, 32, 8, 20, [5, 64, 159], None),
    (2, 16, 1, 128, 16, 10, [0, 159], None),
]


@pytest.mark.cuda
def test_paged_kernel_edge_cases_on_card():
    """The CUDA kernels against the gather path at the edge cases, every
    variant, NaN in every page a slot does not hold live; two calls
    bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    P.reset_launch_count()
    for b, hq, hkv, d, ps, ppr, pos, narrow in SPAN_EDGE_CASES:
        num_pages = b * ppr + 1
        table = (1 + torch.randperm(num_pages - 1, generator=gen, device=dev)).view(b, ppr)
        table = table.to(torch.int32)
        pos = torch.tensor(pos, dtype=torch.int32, device=dev)
        live = torch.arange(ppr, device=dev)[None, :] <= (pos // ps)[:, None]
        dead = table[~live].long()
        for dtype, q_dtype, tol in CARD_VARIANTS:
            shape = (num_pages, ps, hkv, d)
            q = torch.randn((b, 1, hq, d), generator=gen, device=dev).to(q_dtype)
            if dtype == torch.int8:
                kp, vp = (torch.randint(-127, 128, shape, generator=gen, device=dev).to(dtype)
                          for _ in range(2))
                ks, vs = (torch.rand(shape[:3], generator=gen, device=dev) / 127 + 0.5 / 127
                          for _ in range(2))
                want = P.paged_attention_plain(q, kp, vp, table, pos, key_scale_pages=ks,
                                               value_scale_pages=vs, pages_per_slot=narrow)
                ks[dead], vs[dead] = float("nan"), float("nan")
                kw = dict(key_scale_pages=ks, value_scale_pages=vs)
            else:
                kp, vp = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                          for _ in range(2))
                want = P.paged_attention_plain(q, kp, vp, table, pos, pages_per_slot=narrow)
                kp[dead], vp[dead] = float("nan"), float("nan")
                kw = {}
            got = P.paged_attention(q, kp, vp, table, pos, pages_per_slot=narrow, **kw)
            again = P.paged_attention(q, kp, vp, table, pos, pages_per_slot=narrow, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, again)
            err = float((got.float() - want.float()).abs().max())
            assert got.dtype == want.dtype and err <= tol, (b, hq, d, ps, pos, dtype, err)
    assert P.launch_count() == 4 * len(CARD_VARIANTS) * len(SPAN_EDGE_CASES)


@pytest.mark.cuda
def test_paged_attention_rejects_misaligned_pools_on_card():
    """The kernel copies pool rows 16 bytes at a time: a pool that does
    not start on 16 bytes raises, with no launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    q = torch.randn(1, 1, 2, 32, device="cuda")
    vp = torch.randn(3, 4, 2, 32, device="cuda")
    kp = torch.empty(vp.numel() + 1, device="cuda")[1:].view(vp.shape).copy_(vp)
    table = torch.tensor([[1, 2]], dtype=torch.int32, device="cuda")
    pos = torch.tensor([5], dtype=torch.int32, device="cuda")
    P.reset_launch_count()
    with pytest.raises(ValueError, match="aligned"):
        P.paged_attention(q, kp, vp, table, pos)
    assert P.launch_count() == 0
