"""Decoder-only transformer LM (train mode), ported from the JAX
package's ``models/transformer.py``.

Same blocks, parameter layout and numerics as the flax model at a
sequence and tensor axis of size 1: separate q/k/v/attn_out projections
(optional biases), causal attention, RoPE (rotate-half, base 10000) or a
learned position table, GQA through ``repeat_kv``, LayerNorm or RMSNorm
(eps 1e-6, flax's default),
a gelu (tanh approximation, flax's default) or swiglu MLP whose output
bias is a separate parameter added after the residual sum, and fp32
logits from an untied ``lm_head`` or the tied embedding.

``dtype`` is the compute dtype, as flax's ``dtype=`` on every module:
parameters stay fp32 and each module casts them and its input to
``dtype`` explicitly (no autocast). Norms take their statistics and
normalise in fp32 and return ``dtype``; RoPE rotates in fp32; attention
scores and softmax are fp32 (``dense``) or fp32 inside the kernels
(``flash``); the logits are cast to fp32.

``attention_impl``: ``dense`` (``parallel/ring_attention.py``) or
``flash`` (the CUDA kernels of ``ops/flash_attention.py``; their plain
version on CPU tensors). With no sequence axis, ``ring``/``ulysses`` run
dense and ``ring_flash``/``ulysses_flash`` run flash, as the JAX model
does at a sequence axis of size 1.

Options of later slices (MoE, sequence/tensor axes, decode and paged
modes, int8 weights or KV cache, remat, scan_layers, dropout) raise
``NotImplementedError``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from cs744_pytorch_distributed_tutorial_tpu_torch.config import resolve_dtype
from cs744_pytorch_distributed_tutorial_tpu_torch.models.vgg import _lecun_normal_
from cs744_pytorch_distributed_tutorial_tpu_torch.ops.flash_attention import (
    flash_attention,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.ring_attention import (
    dense_attention,
    repeat_kv,
)

ATTENTION_IMPLS = ("dense", "flash", "ring", "ring_flash", "ulysses", "ulysses_flash")
FLASH_IMPLS = ("flash", "ring_flash", "ulysses_flash")
NORM_IMPLS = ("layernorm", "rmsnorm")
MLP_IMPLS = ("gelu", "swiglu")
ROPE_BASE = 10000.0  # the JAX model's rope_base default
NORM_EPS = 1e-6  # the JAX model's norm_eps default (flax's)


def apply_rope(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rotary position embedding on [B, T, H, D] (D even): dimension i
    pairs with i + D/2, rotated by ``positions * ROPE_BASE**(-i/(D/2))``,
    in fp32, cast back to ``x.dtype``."""
    d = x.shape[-1]
    if d % 2:
        raise ValueError(f"RoPE needs an even head_dim, got {d}")
    half = d // 2
    freqs = ROPE_BASE ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    angles = positions.to(torch.float32)[:, None] * freqs  # [T, half]
    sin = torch.sin(angles)[None, :, None, :]
    cos = torch.cos(angles)[None, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def _dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)``: input, kernel and bias in ``dtype``."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class Norm(nn.Module):
    """flax ``nn.LayerNorm``/``nn.RMSNorm``: statistics and scaling in
    fp32, the result in the compute dtype."""

    def __init__(self, features: int, kind: str = "layernorm"):
        super().__init__()
        if kind not in NORM_IMPLS:
            raise ValueError(f"unknown norm {kind!r}; choose from {NORM_IMPLS}")
        self.kind = kind
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features)) if kind == "layernorm" else None

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        xf = x.float()
        if self.kind == "layernorm":
            y = F.layer_norm(xf, xf.shape[-1:], self.weight, self.bias, NORM_EPS)
        else:
            y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + NORM_EPS) * self.weight
        return y.to(dtype)


class Attention(nn.Module):
    """Multi-head causal self-attention over [B, T, d_model]."""

    def __init__(self, d_model: int, num_heads: int, *, num_kv_heads: int | None = None,
                 impl: str = "dense", rope: bool = False, attn_bias: bool = False):
        super().__init__()
        if impl not in ATTENTION_IMPLS:
            raise ValueError(f"unknown attention impl {impl!r}; choose from {ATTENTION_IMPLS}")
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} not divisible by num_heads {num_heads}")
        kv = num_heads if num_kv_heads is None else num_kv_heads
        if kv < 1 or num_heads % kv:
            raise ValueError(f"num_kv_heads {kv} must be >= 1 and divide num_heads {num_heads}")
        self.num_heads, self.kv_heads = num_heads, kv
        self.head_dim = d_model // num_heads
        self.impl, self.rope = impl, rope
        hd = self.head_dim
        self.q = nn.Linear(d_model, num_heads * hd, bias=attn_bias)
        self.k = nn.Linear(d_model, kv * hd, bias=attn_bias)
        self.v = nn.Linear(d_model, kv * hd, bias=attn_bias)
        self.attn_out = nn.Linear(num_heads * hd, d_model, bias=attn_bias)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        b, t, d_model = x.shape
        hd = self.head_dim
        q = _dense(self.q, x, dtype).reshape(b, t, self.num_heads, hd)
        k = _dense(self.k, x, dtype).reshape(b, t, self.kv_heads, hd)
        v = _dense(self.v, x, dtype).reshape(b, t, self.kv_heads, hd)
        if self.rope:
            positions = torch.arange(t, device=x.device)
            q = apply_rope(q, positions)
            k = apply_rope(k, positions)
        rep = self.num_heads // self.kv_heads
        k, v = repeat_kv(k, rep), repeat_kv(v, rep)
        if self.impl in FLASH_IMPLS:
            out = flash_attention(q, k, v, causal=True)
        else:
            out = dense_attention(q, k, v, causal=True)
        out = out.reshape(b, t, self.num_heads * hd).to(dtype)
        return _dense(self.attn_out, out, dtype)


class Block(nn.Module):
    def __init__(self, d_model: int, num_heads: int, d_ff: int, *, norm: str = "layernorm",
                 mlp: str = "gelu", **attn_kw):
        super().__init__()
        if mlp not in MLP_IMPLS:
            raise ValueError(f"unknown mlp {mlp!r}; choose from {MLP_IMPLS}")
        self.mlp = mlp
        self.ln1 = Norm(d_model, norm)
        self.attn = Attention(d_model, num_heads, **attn_kw)
        self.ln2 = Norm(d_model, norm)
        self.mlp_in = nn.Linear(d_model, d_ff)
        self.mlp_gate = nn.Linear(d_model, d_ff, bias=False) if mlp == "swiglu" else None
        self.mlp_out = nn.Linear(d_ff, d_model, bias=False)
        self.mlp_out_bias = nn.Parameter(torch.zeros(d_model))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = x + self.attn(self.ln1(x, dtype), dtype)
        h = self.ln2(x, dtype)
        up = _dense(self.mlp_in, h, dtype)
        if self.mlp == "swiglu":
            h = F.silu(_dense(self.mlp_gate, h, dtype)) * up
        else:
            h = F.gelu(up, approximate="tanh")
        h = _dense(self.mlp_out, h, dtype)
        return x + h + self.mlp_out_bias.to(dtype)


# Options of the JAX model that later slices port: name -> the value
# that means "off".
_NOT_YET_PORTED = {
    "num_experts": 0, "seq_axis_size": 1, "tensor_axis_size": 1, "remat": False,
    "scan_layers": False, "dropout_rate": 0.0, "quant_dense": False,
    "quant_kv_cache": False,
}


class TransformerLM(nn.Module):
    """GPT-style causal LM: ``forward(tokens [B, T]) -> fp32 logits
    [B, T, vocab]``. Parameters are drawn from ``generator`` with the
    flax defaults' distributions: lecun-normal (truncated) kernels, zero
    biases, embeddings N(0, 1/d_model), unit norm scales."""

    def __init__(self, vocab_size: int = 1024, num_layers: int = 4, num_heads: int = 8,
                 d_model: int = 256, d_ff: int = 1024, max_seq_len: int = 2048,
                 dtype: torch.dtype | str = torch.float32, attention_impl: str = "ring",
                 tie_embeddings: bool = False, use_rope: bool = False,
                 num_kv_heads: int | None = None, norm: str = "layernorm", mlp: str = "gelu",
                 attn_bias: bool = False, generator: torch.Generator | None = None,
                 **later):
        super().__init__()
        for name, value in later.items():
            if name not in _NOT_YET_PORTED:
                raise TypeError(f"TransformerLM got an unexpected option {name!r}")
            if value != _NOT_YET_PORTED[name]:
                raise NotImplementedError(f"{name}={value!r} is not yet ported")
        self.dtype = resolve_dtype(dtype) if isinstance(dtype, str) else dtype
        self.use_rope, self.tie_embeddings = use_rope, tie_embeddings
        self.max_seq_len = max_seq_len
        self.tok_embed = nn.Embedding(vocab_size, d_model)
        self.pos_embed = None if use_rope else nn.Embedding(max_seq_len, d_model)
        self.blocks = nn.ModuleList(
            Block(d_model, num_heads, d_ff, norm=norm, mlp=mlp, num_kv_heads=num_kv_heads,
                  impl=attention_impl, rope=use_rope, attn_bias=attn_bias)
            for _ in range(num_layers)
        )
        self.ln_f = Norm(d_model, norm)
        self.lm_head = None if tie_embeddings else nn.Linear(d_model, vocab_size, bias=False)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                _lecun_normal_(m.weight, m.in_features, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 1.0 / math.sqrt(m.embedding_dim), generator=generator)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype
        t = tokens.shape[1]
        if t > self.max_seq_len:
            raise ValueError(f"sequence of {t} tokens exceeds max_seq_len {self.max_seq_len}")
        x = F.embedding(tokens, self.tok_embed.weight).to(dtype)
        if self.pos_embed is not None:
            positions = torch.arange(t, device=tokens.device)
            x = x + F.embedding(positions, self.pos_embed.weight).to(dtype)
        for block in self.blocks:
            x = block(x, dtype)
        x = self.ln_f(x, dtype)
        head = self.tok_embed.weight if self.tie_embeddings else self.lm_head.weight
        return F.linear(x, head.to(dtype)).float()
