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
are 1 and 2. The ``cuda``-marked test holds the CUDA kernel against its
plain version on the card. JAX is imported inside the tests that use it.
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
    """The CUDA kernel against the gather path on the card: max abs err
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
    assert P.launch_count() == len(CARD_VARIANTS) * len(CARD_CASES)
    assert P.launch_count("int8") == 2 * len(CARD_CASES)
