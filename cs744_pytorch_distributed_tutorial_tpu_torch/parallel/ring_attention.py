"""Single-device attention on [B, T, H, D]: the plain softmax reference,
the GQA head repeat, and the decode steps against a KV cache (dense or
paged).

Ported from the JAX package's ``parallel/ring_attention.py``
(``dense_attention``, ``repeat_kv``, ``decode_attention``,
``decode_mask``, ``gather_pages`` and ``paged_decode_attention``). The
ring and Ulysses variants, which move K/V between devices, are not
ported yet.
"""

from __future__ import annotations

import torch

# Additive mask value: large-negative instead of -inf so exp() underflows
# to exactly 0.0 without NaNs in fully-masked rows.
_MASK = -1e30


def dense_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
) -> torch.Tensor:
    """Plain softmax attention on [B, T, H, D]: fp32 scores (the products
    of the inputs, summed in fp32) times ``D**-0.5``, masked with
    ``_MASK``, an fp32 softmax, and the probabilities cast to ``v.dtype``
    before the product with ``v``. Returns ``v.dtype``."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        keep = torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, _MASK)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(v.dtype)


def repeat_kv(x: torch.Tensor, rep: int) -> torch.Tensor:
    """Widen [B, T, Hkv, D] KV heads to the query head count (the GQA
    repeat; identity when rep == 1)."""
    return x.repeat_interleave(rep, dim=2) if rep > 1 else x


def decode_mask(cache_len: int, t: int, pos, device=None) -> torch.Tensor:
    """Key visibility for decode steps, broadcastable against [B, Hkv,
    group, t, L] scores: key ``k`` is visible to query row ``i`` iff
    ``k <= pos + i``. A scalar ``pos`` gives a [1, 1, 1, t, L] mask, a
    [B] tensor a per-slot [B, 1, 1, t, L] one."""
    k_pos = torch.arange(cache_len, device=device)
    rows = torch.arange(t, device=device)
    if not torch.is_tensor(pos) or pos.dim() == 0:
        return (k_pos[None, :] <= (rows + pos)[:, None])[None, None, None]
    if pos.dim() != 1:
        raise ValueError(f"pos must be a scalar or [B] vector, got shape {tuple(pos.shape)}")
    q_pos = pos[:, None] + rows  # [B, t]
    return (k_pos[None, None, :] <= q_pos[:, :, None])[:, None, None]


def decode_attention(q: torch.Tensor, cached_k: torch.Tensor, cached_v: torch.Tensor,
                     pos) -> torch.Tensor:
    """Decode step(s) of ``q`` [B, t, Hq, D] (row i at position pos + i)
    against a [B, L, Hkv, D] cache; ``pos`` a scalar or a [B] tensor.
    Query head h reads KV head h // (Hq / Hkv): the cache is never widened.
    fp32 scores times ``D**-0.5``, ``_MASK`` past each row's position, an
    fp32 softmax, the probabilities cast to the cache dtype before the
    product with V. Returns the cache dtype."""
    b, t, hq, d = q.shape
    hkv = cached_k.shape[2]
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    qg = q.reshape(b, t, hkv, hq // hkv, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), cached_k.float()) * d**-0.5
    scores = scores.masked_fill(~decode_mask(cached_k.shape[1], t, pos, q.device), _MASK)
    probs = torch.softmax(scores, dim=-1).to(cached_v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.float(), cached_v.float())
    return out.reshape(b, t, hq, d).to(cached_v.dtype)


def gather_pages(pages: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """Each slot's contiguous view of a [num_pages, page_size, ...] pool
    through its ``page_table`` [B, P] row: [B, P*page_size, ...], token
    position i of slot b at row i (the dense cache's layout)."""
    b, p = page_table.shape
    g = pages[page_table.long()]  # [B, P, page_size, ...]
    return g.reshape(b, p * pages.shape[1], *pages.shape[2:])


def paged_decode_attention(q: torch.Tensor, key_pages: torch.Tensor, value_pages: torch.Tensor,
                           page_table: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``decode_attention`` against paged [num_pages, page_size, Hkv, D]
    pools: gather each slot's pages, then the dense decode step. The
    plain version of ``ops/paged_attention.py::paged_attention``; its
    reads scale with page capacity, not with the live tokens."""
    return decode_attention(q, gather_pages(key_pages, page_table),
                            gather_pages(value_pages, page_table), pos)
