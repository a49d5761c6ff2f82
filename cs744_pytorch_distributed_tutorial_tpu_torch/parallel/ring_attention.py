"""Single-device attention on [B, T, H, D]: the plain softmax reference
and the GQA head repeat.

Ported from the JAX package's ``parallel/ring_attention.py``
(``dense_attention`` and ``repeat_kv``). The ring and Ulysses variants,
which move K/V between devices, are not ported yet.
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
