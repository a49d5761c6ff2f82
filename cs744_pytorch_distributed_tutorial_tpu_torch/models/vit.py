"""Vision Transformer for the CIFAR trainer's registry, ported from the
JAX package's ``models/vit.py``.

The JAX construction, for NCHW inputs: a conv patch embedding (kernel
and stride ``patch_size``), its grid flattened row-major over (h, w) into
tokens (an NCHW ``Conv2d`` then ``flatten(2).transpose(1, 2)``: the order
of the JAX model's NHWC reshape); a zero-initialised class token
prepended; learned position embeddings drawn at std 0.02; dropout on
them (``pos_drop``); pre-LN ``models/transformer.py::Block``s with
``causal=False``; ``ln_f`` (eps 1e-6); a linear ``head`` on the class
token, with fp32 logits. No BatchNorm: the trainer's buffers are empty
for this family.

``dtype`` is the compute dtype, as the JAX ``dtype=``: parameters stay
fp32 and every module casts them and its input to ``dtype`` explicitly
(norm statistics and attention softmax in fp32), so the trainer runs
the family without autocast. ``attention_impl`` is ``dense`` (the
model's default) or ``flash`` (``ops/flash_attention.py``'s kernels, not
causal; their plain versions on CPU tensors). ``image_size`` fixes the
number of tokens the position table holds (flax learns it from the first
input); a ``patch_size`` that does not divide it raises ``ValueError``,
as the JAX model does.

Dropout (``dropout_rate``, the JAX model's): on the position embeddings
and on each block's sublayer outputs, active only when ``forward`` gets
a ``dropout`` key (seed, step, microbatch[, rank]). The blocks key their
masks by (key, layer, site) with layer in [0, num_layers) and site 0 or
1 (``models/transformer.py::dropout_mask``); ``pos_drop`` takes (key,
-1, 0), which no block site takes.

Parameters are drawn from ``generator`` with flax's defaults:
lecun-normal (truncated) kernels with fan_in p * p * 3 for the patch
embedding, zero biases, unit norm scales.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from cs744_pytorch_distributed_tutorial_tpu_torch.config import resolve_dtype
from cs744_pytorch_distributed_tutorial_tpu_torch.models.transformer import (
    Block,
    Norm,
    _dense,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.models.transformer import dropout as _dropout
from cs744_pytorch_distributed_tutorial_tpu_torch.models.vgg import _lecun_normal_

VIT_ATTENTION = ("dense", "flash")
POS_STD = 0.02  # the JAX model's pos_embed initializer
POS_DROP_LAYER = -1  # pos_drop's layer in the dropout key: no block's


class ViT(nn.Module):
    def __init__(self, num_classes: int = 10, patch_size: int = 4, d_model: int = 192,
                 num_layers: int = 6, num_heads: int = 3, d_ff: int = 768,
                 dtype: torch.dtype | str = torch.float32, attention_impl: str = "dense",
                 dropout_rate: float = 0.0, image_size: int = 32,
                 generator: torch.Generator | None = None):
        super().__init__()
        if attention_impl not in VIT_ATTENTION:
            raise ValueError(f"unknown attention_impl {attention_impl!r}; choose from "
                             f"{VIT_ATTENTION}")
        if image_size % patch_size:
            raise ValueError(f"image {image_size}x{image_size} not divisible by patch_size "
                             f"{patch_size}")
        self.dtype = resolve_dtype(dtype) if isinstance(dtype, str) else dtype
        self.patch_size, self.d_model, self.num_heads = patch_size, d_model, num_heads
        self.image_size, self.dropout_rate = image_size, dropout_rate
        n = (image_size // patch_size) ** 2
        self.patch_embed = nn.Conv2d(3, d_model, patch_size, stride=patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d_model))
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, d_model))
        self.blocks = nn.ModuleList(
            Block(d_model, num_heads, d_ff, impl=attention_impl, causal=False,
                  dropout_rate=dropout_rate)
            for _ in range(num_layers))
        self.ln_f = Norm(d_model)
        self.head = nn.Linear(d_model, num_classes)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        p = self.patch_size
        _lecun_normal_(self.patch_embed.weight, p * p * 3, generator)
        self.patch_embed.bias.zero_()
        self.cls_token.zero_()
        self.pos_embed.normal_(0.0, POS_STD, generator=generator)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                _lecun_normal_(m.weight, m.in_features, generator)
                if m.bias is not None:
                    m.bias.zero_()

    def forward(self, x: torch.Tensor, dropout: tuple[int, ...] | None = None) -> torch.Tensor:
        """fp32 logits [B, num_classes] of images [B, 3, H, W]; ``dropout``,
        a key (seed, step, microbatch[, rank]), turns dropout on (the JAX
        ``train=True``)."""
        b, _, h, w = x.shape
        if (h, w) != (self.image_size, self.image_size):
            raise ValueError(f"image {h}x{w} is not the model's {self.image_size}x"
                             f"{self.image_size} (patch_size {self.patch_size})")
        dtype = self.dtype
        conv = self.patch_embed
        x = F.conv2d(x.to(dtype), conv.weight.to(dtype), conv.bias.to(dtype), stride=conv.stride)
        x = x.flatten(2).transpose(1, 2)  # [B, n, d], row-major over (h, w)
        cls = self.cls_token.to(dtype).expand(b, 1, self.d_model)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dtype)
        drop = dropout is not None and self.dropout_rate > 0.0
        if drop:
            x = _dropout(x, self.dropout_rate, (*dropout, POS_DROP_LAYER, 0))
        for i, block in enumerate(self.blocks):
            x = block(x, dtype, drop_key=(*dropout, i) if drop else None)
        x = self.ln_f(x, dtype)
        return _dense(self.head, x[:, 0], dtype).float()


def vit_tiny(**kw: Any) -> ViT:
    """ViT-Ti/4 sized for 32x32 inputs (192 wide, 6 deep, 3 heads)."""
    return ViT(**kw)


def vit_small(**kw: Any) -> ViT:
    """ViT-S/4: 384 wide, 8 deep, 6 heads."""
    kw.setdefault("d_model", 384)
    kw.setdefault("num_layers", 8)
    kw.setdefault("num_heads", 6)
    kw.setdefault("d_ff", 1536)
    return ViT(**kw)


def vit_wide_p8(**kw: Any) -> ViT:
    """ViT/8 for 32x32 inputs: patch 8 gives 17 tokens (the class token
    included), 384 wide at 3 heads, so head_dim is 128; per-sample FLOPs
    within 1 % of vit_tiny's."""
    kw.setdefault("patch_size", 8)
    kw.setdefault("d_model", 384)
    kw.setdefault("num_layers", 6)
    kw.setdefault("num_heads", 3)
    kw.setdefault("d_ff", 1536)
    return ViT(**kw)
