"""Decoder-only transformer LM (train mode), ported from the JAX
package's ``models/transformer.py``.

Same blocks, parameter layout and numerics as the flax model at a
sequence and tensor axis of size 1: separate q/k/v/attn_out projections
(optional biases), causal attention, RoPE (rotate-half, base
``rope_base``, 10000 by default) or a learned position table, GQA
through ``repeat_kv``, LayerNorm or RMSNorm (eps ``norm_eps``, 1e-6 by
default, flax's),
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

Inference, the JAX model's ``mode``s: ``prefill`` (the causal pass over a
prompt, writing its K/V rows to a dense cache), ``decode`` (t tokens at
position ``decode_pos``, attending over the cache) and ``paged_decode``
(one token a slot at per-slot positions [B], its K/V scattered into page
pools through ``page_table``; attention by the ``gather`` reference or
the ``kernel`` of ``ops/paged_attention.py``). The flax ``cache`` and
``pages`` collections become explicit ``KVCache`` objects, one a layer
(``init_cache``, ``init_pages``), updated in place. ``quant_dense``
routes the ``quant_modules`` projections to ``ops/quant.py::
QuantLinear`` (int8 weights, the int8 matmul kernel); ``quant_kv_cache``
stores K/V rows int8 with fp32 row scales.

``num_experts > 0`` replaces each block's dense MLP with
``models/moe.py::MoEFFN`` (``moe_dispatch`` ``scatter``, ``einsum`` or
``dropless``; the block adds its output to the residual, with no
``mlp_out_bias``), in every mode.

Training options, as the JAX model's:

- ``dropout_rate``: residual dropout on the attention sublayer's output
  and on the MLP's (before the residual add), active only when
  ``forward`` gets a ``dropout`` key. Masks come from ``dropout_mask``, a
  pure function of the key (seed, step, microbatch), the layer, the site
  and the element: no generator carries state from one call to the
  next, so a recompute under remat draws the very same mask.
- ``remat``: each block of a ``train``-mode forward with gradients runs
  under ``torch.utils.checkpoint`` (non-reentrant) and is recomputed in
  the backward; ``remat_policy`` ``none`` recomputes everything, ``dots``
  saves the outputs of the matrix products (``mm``, ``addmm``, ``bmm``)
  through a selective-checkpoint policy. The CUDA kernels launch through
  ``ctypes`` inside ``autograd.Function``s, which a dispatch-level policy
  cannot see: under either policy their forwards run again in the
  backward.
- ``scan_layers``: the JAX layer-stacked layout. ``blocks`` is one
  ``Block`` whose parameters carry a leading ``[num_layers]`` axis; each
  layer runs on views of it (``torch.func.functional_call``), in every
  mode. ``stack_block_params`` / ``unstack_block_params`` convert the
  ``state_dict`` between the two layouts. MoE raises ``ValueError``.

Across ranks (the JAX model's ``seq_axis``/``tensor_axis``/
``expert_axis``), on a ``parallel/mesh.py::Mesh`` given as ``mesh``:

- ``seq_axis_size > 1``: this rank holds its ``T / n`` positions of the
  sequence; positions (learned or RoPE) start at ``axis_index(seq) * T /
  n``; attention is ``ring``, ``ring_flash``, ``ulysses`` or
  ``ulysses_flash`` (``parallel/ring_attention.py``, K/V at kv width),
  and ``dense``/``flash`` raise, as JAX's. Only ``train`` mode.
- ``tensor_axis_size > 1`` (Megatron): each rank holds its contiguous
  slice of the query and KV heads and of ``d_ff``; q/k/v, ``mlp_in`` and
  ``mlp_gate`` are column-parallel (``Linear.weight`` split along dim 0),
  ``attn_out`` and ``mlp_out`` row-parallel (dim 1), behind
  ``parallel/tensor.py``'s f/g boundaries, and ``mlp_out_bias`` is added
  after the sum. ``attn_bias`` raises. The decode modes run on this
  rank's heads too (the JAX model's tensor-parallel decode): the dense
  cache and the page pools hold this rank's ``Hkv / T`` KV heads, the
  paged kernel attends over them, and the two sums a layer keep the
  residual stream, and so the logits, the same on every tensor rank.
- ``expert_axis_size > 1`` (the data axis): each rank keeps its ``E / n``
  experts (``models/moe.py``).

The parameters are drawn at the global shapes and then cut to this
rank's slices (``lm_param_specs``: which dimension of which parameter
each axis splits), so every layout holds slices of the same global
model.
"""

from __future__ import annotations

import dataclasses
import math
import re

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from cs744_pytorch_distributed_tutorial_tpu_torch.config import resolve_dtype
from cs744_pytorch_distributed_tutorial_tpu_torch.models.moe import MoEFFN
from cs744_pytorch_distributed_tutorial_tpu_torch.models.vgg import _lecun_normal_
from cs744_pytorch_distributed_tutorial_tpu_torch.ops.flash_attention import (
    flash_attention,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_plain,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.ops.quant import (
    QUANT_MODULES,
    QuantLinear,
    decode_attention_quant,
    quantize_kv,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SEQ_AXIS,
    TENSOR_AXIS,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.ring_attention import (
    decode_attention,
    dense_attention,
    repeat_kv,
    ring_attention,
    ring_flash_attention,
    ulysses_attention,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.tensor import (
    copy_to_tp_region,
    reduce_from_tp_region,
)

ATTENTION_IMPLS = ("dense", "flash", "ring", "ring_flash", "ulysses", "ulysses_flash")
FLASH_IMPLS = ("flash", "ring_flash", "ulysses_flash")
SEQ_IMPLS = ("ring", "ring_flash", "ulysses", "ulysses_flash")
NORM_IMPLS = ("layernorm", "rmsnorm")
MLP_IMPLS = ("gelu", "swiglu")
ROPE_BASE = 10000.0  # the JAX model's rope_base default
NORM_EPS = 1e-6  # the JAX model's norm_eps default (flax's)
MODES = ("train", "prefill", "decode", "paged_decode")
PAGED_IMPLS = ("gather", "kernel")
REMAT_POLICIES = ("none", "dots")
# The aten matrix products a ``dots`` remat saves (F.linear and the MoE
# capacity path's batched products dispatch to these).
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten.bmm.default)
_M64 = (1 << 64) - 1


def resolve_remat_policy(name: str | None):
    """A policy name -> the ``context_fn`` of ``torch.utils.checkpoint``:
    ``none`` (or None) recomputes everything in the backward (None, the
    default context); ``dots`` saves the matrix products' outputs and
    recomputes the rest."""
    if name in (None, "none"):
        return None
    if name == "dots":
        return lambda: create_selective_checkpoint_contexts(list(_DOTS))
    raise ValueError(f"unknown remat_policy {name!r}; choose from {REMAT_POLICIES}")


def _key_seed(key: tuple[int, ...]) -> int:
    """A 63-bit seed from a tuple of integers (splitmix64 folded over
    them): different keys give unrelated seeds."""
    h = 0x9E3779B97F4A7C15
    for v in key:
        h = (h ^ (int(v) & _M64)) * 0xBF58476D1CE4E5B9 & _M64
        h = (h ^ (h >> 31)) * 0x94D049BB133111EB & _M64
        h ^= h >> 29
    return h >> 1


def dropout_mask(key: tuple[int, ...], shape: torch.Size, rate: float,
                 device: torch.device) -> torch.Tensor:
    """The keep mask (bool, ``shape``) of dropout at ``rate`` for ``key``
    (seed, step, microbatch, layer, site): element e is kept when the e-th
    uniform of a generator seeded from the key alone is at least
    ``rate``. The generator is made afresh from the key at each call (on
    a card it is Philox, counter-based: the element's index is its
    counter), so the mask is a pure function of the key and the element;
    a recompute draws it again bit for bit."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_key_seed(key))
    return torch.rand(shape, generator=gen, device=device) >= rate


def dropout(x: torch.Tensor, rate: float, key: tuple[int, ...]) -> torch.Tensor:
    """flax ``nn.Dropout``: kept elements scaled by 1 / (1 - rate), the
    others zero; rate 1 zeroes everything."""
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = dropout_mask(key, x.shape, rate, x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


@dataclasses.dataclass
class KVCache:
    """One layer's keys and values: the rows [B, L, Hkv, D] of a dense
    cache (modes ``prefill``/``decode``) or a page pool [num_pages,
    page_size, Hkv, D] (``paged_decode``). Under ``quant_kv_cache`` the
    rows are int8 with fp32 scales [.., Hkv] (``ops/quant.py::
    quantize_kv``), else in the compute dtype."""

    key: torch.Tensor
    value: torch.Tensor
    key_scale: torch.Tensor | None = None
    value_scale: torch.Tensor | None = None

    def put(self, index, k: torch.Tensor, v: torch.Tensor) -> None:
        """Write K/V rows [..., Hkv, D] at ``index`` (over the first two
        dimensions) in place, quantizing them for an int8 cache."""
        if self.key_scale is None:
            self.key[index] = k
            self.value[index] = v
            return
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        self.key[index], self.key_scale[index] = kq, ks
        self.value[index], self.value_scale[index] = vq, vs


def _positions(t: int, pos, device) -> torch.Tensor:
    """Positions of a block's t tokens: ``pos + arange(t)``, [t] for a
    scalar ``pos`` (0 when None), [B, t] for per-slot depths [B]."""
    rows = torch.arange(t, device=device)
    if pos is None:
        return rows
    if torch.is_tensor(pos) and pos.dim() == 1:
        return pos.to(device=device, dtype=torch.long)[:, None] + rows
    return rows + pos


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               base: float = ROPE_BASE) -> torch.Tensor:
    """Rotary position embedding on [B, T, H, D] (D even): dimension i
    pairs with i + D/2, rotated by ``positions * base**(-i/(D/2))``,
    in fp32, cast back to ``x.dtype``. ``positions`` is [T], shared by
    the batch, or [B, T] (per-slot depths)."""
    d = x.shape[-1]
    if d % 2:
        raise ValueError(f"RoPE needs an even head_dim, got {d}")
    half = d // 2
    freqs = base ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    angles = positions.to(torch.float32)[..., None] * freqs  # [(B,) T, half]
    sin = torch.sin(angles)[..., None, :]
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def _linear(in_features: int, out_features: int, bias: bool, quant: bool) -> nn.Module:
    """``nn.Linear``, or ``QuantLinear`` for a quantized projection."""
    return (QuantLinear if quant else nn.Linear)(in_features, out_features, bias=bias)


def _dense(layer: nn.Module, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)``: input, kernel and bias in ``dtype``
    (the JAX ``QuantDense`` for a ``QuantLinear``)."""
    if isinstance(layer, QuantLinear):
        return layer(x, dtype)
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class Norm(nn.Module):
    """flax ``nn.LayerNorm``/``nn.RMSNorm`` (epsilon ``eps``): statistics
    and scaling in fp32, the result in the compute dtype."""

    def __init__(self, features: int, kind: str = "layernorm", eps: float = NORM_EPS):
        super().__init__()
        if kind not in NORM_IMPLS:
            raise ValueError(f"unknown norm {kind!r}; choose from {NORM_IMPLS}")
        self.kind, self.eps = kind, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features)) if kind == "layernorm" else None

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        xf = x.float()
        if self.kind == "layernorm":
            y = F.layer_norm(xf, xf.shape[-1:], self.weight, self.bias, self.eps)
        else:
            y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + self.eps) * self.weight
        return y.to(dtype)


class Attention(nn.Module):
    """Multi-head self-attention over [B, T, d_model]: causal (the LM's),
    or with ``causal=False`` every position attending to every one (the
    ViT's encoder blocks), in ``train`` mode on an unsharded sequence
    only."""

    def __init__(self, d_model: int, num_heads: int, *, num_kv_heads: int | None = None,
                 impl: str = "dense", rope: bool = False, attn_bias: bool = False,
                 quant_modules: tuple = (), seq_size: int = 1, tensor_size: int = 1,
                 mesh=None, causal: bool = True, rope_base: float = ROPE_BASE):
        super().__init__()
        if not causal and seq_size > 1:
            raise ValueError(
                f"causal=False runs on an unsharded sequence only (seq axis of size {seq_size}): "
                "the ring and Ulysses paths of the port are causal")
        if impl not in ATTENTION_IMPLS:
            raise ValueError(f"unknown attention impl {impl!r}; choose from {ATTENTION_IMPLS}")
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} not divisible by num_heads {num_heads}")
        if tensor_size > 1 and num_heads % tensor_size:
            raise ValueError(f"num_heads {num_heads} not divisible by tensor axis {tensor_size}")
        kv = num_heads if num_kv_heads is None else num_kv_heads
        if kv < 1 or num_heads % kv:
            raise ValueError(f"num_kv_heads {kv} must be >= 1 and divide num_heads {num_heads}")
        if tensor_size > 1 and kv % tensor_size:
            raise ValueError(f"num_kv_heads {kv} not divisible by tensor axis {tensor_size}")
        if attn_bias and tensor_size > 1:
            raise ValueError(
                "attn_bias does not compose with a tensor axis (the row-parallel attn_out bias "
                f"would be summed {tensor_size}x by the sublayer psum)")
        if seq_size > 1 and impl not in SEQ_IMPLS:
            raise ValueError(
                f"impl={impl!r} cannot run on a sequence-sharded axis (no communication to see "
                "the full sequence); use 'ring', 'ulysses', or 'ulysses_flash', or set "
                "seq_axis=None")
        self.num_heads, self.kv_heads = num_heads, kv
        # This rank's heads: all of them, or its slice of the tensor axis.
        self.heads_local, self.kv_local = num_heads // tensor_size, kv // tensor_size
        self.seq_size, self.tensor_size, self.mesh = seq_size, tensor_size, mesh
        self.head_dim = d_model // num_heads
        self.impl, self.rope, self.causal, self.rope_base = impl, rope, causal, rope_base
        hd = self.head_dim
        self.q = _linear(d_model, num_heads * hd, attn_bias, "q" in quant_modules)
        self.k = _linear(d_model, kv * hd, attn_bias, "k" in quant_modules)
        self.v = _linear(d_model, kv * hd, attn_bias, "v" in quant_modules)
        self.attn_out = _linear(num_heads * hd, d_model, attn_bias, "attn_out" in quant_modules)

    def forward(self, x: torch.Tensor, dtype: torch.dtype, mode: str = "train", pos=None,
                kv: KVCache | None = None, page_table: torch.Tensor | None = None,
                paged_impl: str = "gather") -> torch.Tensor:
        b, t, d_model = x.shape
        if not self.causal and (mode != "train" or kv is not None):
            raise ValueError(
                f"causal=False attention has no decode modes and no KV cache (mode={mode!r}): "
                "a cached row sees only the rows before it")
        hd = self.head_dim
        tp = self.tensor_size > 1
        if tp:
            x = copy_to_tp_region(x, self.mesh, TENSOR_AXIS)
        q = _dense(self.q, x, dtype).reshape(b, t, self.heads_local, hd)
        k = _dense(self.k, x, dtype).reshape(b, t, self.kv_local, hd)
        v = _dense(self.v, x, dtype).reshape(b, t, self.kv_local, hd)
        if self.rope:
            # Global positions: the cache position when decoding, this
            # rank's offset on a sequence-sharded axis.
            if mode in ("decode", "paged_decode"):
                offset = pos
            else:
                offset = self.mesh.axis_index(SEQ_AXIS) * t if self.seq_size > 1 else None
            positions = _positions(t, offset, x.device)
            q = apply_rope(q, positions, self.rope_base)
            k = apply_rope(k, positions, self.rope_base)
        if mode == "decode":
            # t tokens at positions pos..pos+t-1 over the whole cache, each
            # row masked to its own prefix; the cache stays at KV width.
            kv.put((slice(None), slice(pos, pos + t)), k, v)
            if kv.key_scale is None:
                out = decode_attention(q, kv.key, kv.value, pos)
            else:
                out = decode_attention_quant(q, kv.key, kv.value, kv.key_scale,
                                             kv.value_scale, pos)
        elif mode == "paged_decode":
            # The new token's K/V go to (page_table[b, pos // page_size],
            # pos % page_size); parked slots all write trash page 0.
            page_size = kv.key.shape[1]
            slot_page = page_table.gather(1, (pos // page_size).long()[:, None])[:, 0].long()
            kv.put((slot_page, (pos % page_size).long()), k[:, 0], v[:, 0])
            attend = paged_attention if paged_impl == "kernel" else paged_attention_plain
            out = attend(q, kv.key, kv.value, page_table, pos,
                         key_scale_pages=kv.key_scale, value_scale_pages=kv.value_scale)
        else:
            if mode == "prefill":
                # The prompt's rows go to the cache; attention is the causal
                # pass over the fresh full-precision k/v.
                kv.put((slice(None), slice(0, t)), k, v)
            if self.seq_size > 1:
                # K/V go between the ranks at kv width.
                out = self._sequence_parallel(q, k, v)
            else:
                rep = self.heads_local // self.kv_local
                k, v = repeat_kv(k, rep), repeat_kv(v, rep)
                if self.impl in FLASH_IMPLS:
                    out = flash_attention(q, k, v, causal=self.causal)
                else:
                    out = dense_attention(q, k, v, causal=self.causal)
        out = out.reshape(b, t, self.heads_local * hd).to(dtype)
        out = _dense(self.attn_out, out, dtype)
        return reduce_from_tp_region(out, self.mesh, TENSOR_AXIS) if tp else out

    def _sequence_parallel(self, q, k, v):
        mesh = self.mesh
        if self.impl == "ring":
            return ring_attention(q, k, v, mesh, SEQ_AXIS, causal=True)
        if self.impl == "ring_flash":
            return ring_flash_attention(q, k, v, mesh, SEQ_AXIS, causal=True)
        return ulysses_attention(q, k, v, mesh, SEQ_AXIS, causal=True,
                                 inner="flash" if self.impl == "ulysses_flash" else "dense")


class Block(nn.Module):
    def __init__(self, d_model: int, num_heads: int, d_ff: int, *, norm: str = "layernorm",
                 mlp: str = "gelu", quant_modules: tuple = (), moe: dict | None = None,
                 dropout_rate: float = 0.0, norm_eps: float = NORM_EPS, **attn_kw):
        super().__init__()
        tensor_size = attn_kw.get("tensor_size", 1)
        # The MoE path does not split d_ff over the tensor axis (the experts
        # compute replicated), so only the dense FFN must divide.
        if tensor_size > 1 and moe is None and d_ff % tensor_size:
            raise ValueError(f"d_ff {d_ff} not divisible by tensor axis {tensor_size}")
        if mlp not in MLP_IMPLS:
            raise ValueError(f"unknown mlp {mlp!r}; choose from {MLP_IMPLS}")
        if moe is not None and mlp != "gelu":
            raise ValueError(
                f"mlp={mlp!r} does not compose with MoE (num_experts={moe['num_experts']}): "
                "the routed MoEFFN replaces the dense MLP; drop --mlp swiglu or the experts")
        self.mlp, self.dropout_rate = mlp, dropout_rate
        self.tensor_size, self.mesh = tensor_size, attn_kw.get("mesh")
        self.ln1 = Norm(d_model, norm, norm_eps)
        self.attn = Attention(d_model, num_heads, quant_modules=quant_modules, **attn_kw)
        self.ln2 = Norm(d_model, norm, norm_eps)
        if moe is not None:
            self.moe = MoEFFN(d_model, d_ff=d_ff, **moe, mesh=self.mesh)
            return
        self.moe = None
        self.mlp_in = _linear(d_model, d_ff, True, "mlp_in" in quant_modules)
        self.mlp_gate = (_linear(d_model, d_ff, False, "mlp_gate" in quant_modules)
                         if mlp == "swiglu" else None)
        self.mlp_out = _linear(d_ff, d_model, False, "mlp_out" in quant_modules)
        self.mlp_out_bias = nn.Parameter(torch.zeros(d_model))

    def forward(self, x: torch.Tensor, dtype: torch.dtype, drop_key: tuple | None = None,
                **attn_kw) -> torch.Tensor:
        """``drop_key`` (seed, step, microbatch, layer) turns dropout on:
        site 0 on the attention output, site 1 on the MLP output."""
        drop = drop_key is not None and self.dropout_rate > 0.0
        a = self.attn(self.ln1(x, dtype), dtype, **attn_kw)
        if drop:
            a = dropout(a, self.dropout_rate, (*drop_key, 0))
        x = x + a
        h = self.ln2(x, dtype)
        if self.moe is not None:
            return x + self.moe(h, dtype)
        tp = self.tensor_size > 1
        if tp:  # column-parallel in, row-parallel out
            h = copy_to_tp_region(h, self.mesh, TENSOR_AXIS)
        up = _dense(self.mlp_in, h, dtype)
        if self.mlp == "swiglu":
            h = F.silu(_dense(self.mlp_gate, h, dtype)) * up
        else:
            h = F.gelu(up, approximate="tanh")
        h = _dense(self.mlp_out, h, dtype)
        if drop:  # on the partial sums: the masks are the same on every tensor rank
            h = dropout(h, self.dropout_rate, (*drop_key, 1))
        if tp:
            h = reduce_from_tp_region(h, self.mesh, TENSOR_AXIS)
        return x + h + self.mlp_out_bias.to(dtype)


def _modules_outside_moe(module: nn.Module):
    """``module.modules()`` in the same order, but an ``MoEFFN`` is yielded
    without its insides: it inits and casts its own parameters."""
    yield module
    if not isinstance(module, MoEFFN):
        for child in module.children():
            yield from _modules_outside_moe(child)


def lm_param_specs(shapes: dict, tensor_axis: str | None = TENSOR_AXIS,
                   expert_axis: str | None = None) -> dict[str, tuple]:
    """Which dimension of each parameter an axis splits (the JAX
    ``lm_param_specs`` on the port's names): ``shapes`` maps a
    ``state_dict`` name to its tensor; the result maps it to a
    tuple of one axis name or None a dimension. ``Linear.weight`` is
    ``[out, in]`` where a flax kernel is ``[in, out]``: column-parallel
    q/k/v/``mlp_gate``/``mlp_in`` split dim 0 (and ``mlp_in``'s bias),
    row-parallel ``attn_out``/``mlp_out`` dim 1; the MoE experts
    (``moe.{w_in,b_in,w_out,b_out}``) split their expert dim over
    ``expert_axis``. The stacked (``scan_layers``) layout shifts every
    dim by one; everything else is replicated."""
    specs = {}
    for name, value in shapes.items():
        parts = name.split(".")
        module, leaf = (parts[-2] if len(parts) > 1 else ""), parts[-1]
        off = 1 if parts[0] == "blocks" and not parts[1].isdigit() else 0
        spec = [None] * value.dim()
        if module == "moe" and leaf in _EXPERT_LEAVES:
            if expert_axis is not None:
                spec[off] = expert_axis
        elif tensor_axis is not None and leaf in ("weight", "bias"):
            if module in ("q", "k", "v", "mlp_gate", "mlp_in"):
                spec[off] = tensor_axis
            elif module in ("attn_out", "mlp_out") and leaf == "weight":
                spec[off + 1] = tensor_axis
        specs[name] = tuple(spec)
    return specs


_EXPERT_LEAVES = ("w_in", "b_in", "w_out", "b_out")


def shard_tensor(x: torch.Tensor, spec: tuple, coords: dict, sizes: dict) -> torch.Tensor:
    """This rank's slice of a global tensor: each dimension ``spec``
    names an axis of is cut into that axis's size and the slice at this
    rank's coordinate kept."""
    for dim, axis in enumerate(spec):
        if axis is not None and sizes[axis] > 1:
            n = x.shape[dim] // sizes[axis]
            x = x.narrow(dim, coords[axis] * n, n)
    return x


def _stack_blocks(blocks: nn.ModuleList) -> "Block":
    """The first of ``blocks`` with each parameter replaced by the stack
    of all the blocks' ([num_layers, ...])."""
    stacked = blocks[0]
    for name, _ in list(stacked.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        value = torch.stack([b.get_parameter(name).detach() for b in blocks])
        setattr(stacked.get_submodule(owner), leaf, nn.Parameter(value))
    return stacked


_UNROLLED_KEY = re.compile(r"blocks\.(\d+)\.(.+)")


def is_stacked(state_dict) -> bool:
    """Whether an LM ``state_dict`` is in the ``scan_layers`` layout."""
    return any(k.startswith("blocks.") and not _UNROLLED_KEY.fullmatch(k) for k in state_dict)


def stack_block_params(state_dict, num_layers: int | None = None) -> dict:
    """The unrolled ``state_dict`` layout (``blocks.0.*`` ..
    ``blocks.{L-1}.*``) -> the ``scan_layers`` one (``blocks.*``, each a
    stack with a leading [L] axis), the other entries as they are. The
    JAX ``stack_block_params`` on the port's names, with its checks: the
    block indices must run 0..L-1 and match an explicit ``num_layers``."""
    per_layer: dict[int, dict] = {}
    rest = {}
    for key, value in state_dict.items():
        m = _UNROLLED_KEY.fullmatch(key)
        if m:
            per_layer.setdefault(int(m.group(1)), {})[m.group(2)] = value
        else:
            rest[key] = value
    present = sorted(per_layer)
    if present != list(range(len(present))):
        raise ValueError(f"non-contiguous block indices in params: {present}")
    if num_layers is None:
        num_layers = len(present)
    elif num_layers != len(present):
        raise ValueError(f"num_layers={num_layers} but params carry {len(present)} block_* "
                         "subtrees — stacking would silently drop layers")
    for name in per_layer[0] if present else ():
        rest[f"blocks.{name}"] = torch.stack([per_layer[i][name] for i in range(num_layers)])
    return rest


def unstack_block_params(state_dict) -> dict:
    """The ``scan_layers`` ``state_dict`` -> the unrolled layout (the JAX
    ``unstack_block_params``); layer i's tensors are views of the stacks."""
    rest = {k: v for k, v in state_dict.items() if not k.startswith("blocks.")}
    stacked = {k[len("blocks."):]: v for k, v in state_dict.items() if k.startswith("blocks.")}
    n = next(iter(stacked.values())).shape[0]
    for i in range(n):
        for name, value in stacked.items():
            rest[f"blocks.{i}.{name}"] = value[i]
    return rest


class TransformerLM(nn.Module):
    """GPT-style causal LM: ``forward(tokens [B, T]) -> fp32 logits
    [B, T, vocab]``. Parameters are drawn from ``generator`` with the
    flax defaults' distributions: lecun-normal (truncated) kernels, zero
    biases, embeddings N(0, 1/d_model), unit norm scales; a
    ``QuantLinear`` is built zero with scale 1 and filled by
    ``ops/quant.py::quantize_lm_params``. With ``scan_layers`` the blocks
    are drawn as the unrolled model's, then stacked."""

    def __init__(self, vocab_size: int = 1024, num_layers: int = 4, num_heads: int = 8,
                 d_model: int = 256, d_ff: int = 1024, max_seq_len: int = 2048,
                 dtype: torch.dtype | str = torch.float32, attention_impl: str = "ring",
                 tie_embeddings: bool = False, use_rope: bool = False,
                 num_kv_heads: int | None = None, norm: str = "layernorm", mlp: str = "gelu",
                 attn_bias: bool = False, quant_dense: bool = False,
                 quant_modules: tuple = tuple(sorted(QUANT_MODULES)),
                 quant_kv_cache: bool = False, num_experts: int = 0, moe_top_k: int = 2,
                 moe_capacity_factor: float = 1.25, moe_num_groups: int = 1,
                 moe_dispatch: str = "scatter", moe_gmm_impl: str = "auto",
                 remat: bool = False, remat_policy: str = "none", scan_layers: bool = False,
                 dropout_rate: float = 0.0, generator: torch.Generator | None = None,
                 seq_axis_size: int = 1, tensor_axis_size: int = 1, expert_axis_size: int = 1,
                 mesh=None, norm_eps: float = NORM_EPS, rope_base: float = ROPE_BASE):
        super().__init__()
        sizes = {SEQ_AXIS: seq_axis_size, TENSOR_AXIS: tensor_axis_size,
                 DATA_AXIS: expert_axis_size}
        unknown = set(quant_modules) - QUANT_MODULES
        if unknown:
            raise ValueError(f"unknown quant modules {sorted(unknown)}")
        if scan_layers and num_experts > 0:
            raise ValueError(
                f"scan_layers does not compose with MoE (num_experts={num_experts}): stacking "
                "would change the sown aux-loss reduction (each layer's term must be summed, "
                "not stacked); run routed blocks unrolled or in the pipeline engine")
        self.remat, self.scan_layers, self.num_layers = remat, scan_layers, num_layers
        self.remat_context = resolve_remat_policy(remat_policy) if remat else None
        quant = tuple(quant_modules) if quant_dense else ()
        self.dtype = resolve_dtype(dtype) if isinstance(dtype, str) else dtype
        self.use_rope, self.tie_embeddings = use_rope, tie_embeddings
        self.max_seq_len, self.vocab_size = max_seq_len, vocab_size
        self.quant_kv_cache = quant_kv_cache
        self.tok_embed = nn.Embedding(vocab_size, d_model)
        self.pos_embed = None if use_rope else nn.Embedding(max_seq_len, d_model)
        self.mesh, self.seq_size, self.tensor_size = mesh, seq_axis_size, tensor_axis_size
        moe = None
        if num_experts > 0:
            moe = dict(num_experts=num_experts, top_k=moe_top_k,
                       capacity_factor=moe_capacity_factor, num_groups=moe_num_groups,
                       dispatch_impl=moe_dispatch, gmm_impl=moe_gmm_impl,
                       expert_axis=DATA_AXIS if expert_axis_size > 1 else None,
                       expert_axis_size=expert_axis_size)
        self.blocks = nn.ModuleList(
            Block(d_model, num_heads, d_ff, norm=norm, mlp=mlp, num_kv_heads=num_kv_heads,
                  impl=attention_impl, rope=use_rope, attn_bias=attn_bias, quant_modules=quant,
                  moe=moe, dropout_rate=dropout_rate, seq_size=seq_axis_size,
                  tensor_size=tensor_axis_size, mesh=mesh, norm_eps=norm_eps,
                  rope_base=rope_base)
            for _ in range(num_layers)
        )
        self.ln_f = Norm(d_model, norm, norm_eps)
        self.lm_head = (None if tie_embeddings
                        else _linear(d_model, vocab_size, False, "lm_head" in quant))
        self.reset_parameters(generator)
        if scan_layers:
            self.blocks = _stack_blocks(self.blocks)
        self.param_specs = lm_param_specs(
            dict(self.named_parameters()), TENSOR_AXIS if tensor_axis_size > 1 else None,
            DATA_AXIS if expert_axis_size > 1 else None)
        if any(n > 1 for n in sizes.values()):
            if mesh is None:
                raise ValueError(f"axes {sizes} need a parallel.mesh.Mesh (mesh=)")
            self._shard(mesh.coords, sizes)

    @torch.no_grad()
    def _shard(self, coords: dict, sizes: dict) -> None:
        """Cut every split parameter (drawn at its global shape) to this
        rank's slice."""
        for name, p in list(self.named_parameters()):
            spec = self.param_specs[name]
            if any(a is not None for a in spec):
                owner, _, leaf = name.rpartition(".")
                local = shard_tensor(p.detach(), spec, coords, sizes).clone()
                setattr(self.get_submodule(owner), leaf, nn.Parameter(local))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for m in _modules_outside_moe(self):
            if isinstance(m, MoEFFN):
                m.reset_parameters(generator)
            elif isinstance(m, nn.Linear):
                _lecun_normal_(m.weight, m.in_features, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 1.0 / math.sqrt(m.embedding_dim), generator=generator)

    @torch.no_grad()
    def cast_for_decode_(self) -> "TransformerLM":
        """Hold every float weight that ``forward`` casts to the compute
        dtype already in it (projection weights and biases, embeddings,
        ``mlp_out_bias``, the expert kernels ``w_in``/``w_out``); norm
        parameters stay fp32, as their statistics, and so do an MoE
        layer's router (a bf16 router flips top-k choices) and its
        ``b_in``/``b_out`` (the kernel adds an fp32 bias). The logits do
        not change; a decode step then reads each weight once instead of
        casting it anew. The model no longer trains. Returns self."""
        for m in _modules_outside_moe(self):
            if isinstance(m, MoEFFN):
                m.cast_for_decode_(self.dtype)
            elif isinstance(m, (nn.Linear, nn.Embedding)):
                m.to(self.dtype)
            elif isinstance(m, QuantLinear) and m.bias is not None:
                m.bias = m.bias.to(self.dtype)
            elif isinstance(m, Block) and m.moe is None:
                m.mlp_out_bias.data = m.mlp_out_bias.data.to(self.dtype)
        return self

    def _kv(self, n0: int, n1: int, device) -> list[KVCache]:
        """A ``KVCache`` a layer of [n0, n1, kv_local, D] rows: this rank's
        KV heads (all of them without a tensor axis). Under ``scan_layers``
        each tensor is one contiguous stack [num_layers, n0, n1, ...] and a
        layer's cache holds views of its slice, as the JAX stacked
        collections; the views are contiguous too."""
        attn = (self.blocks if self.scan_layers else self.blocks[0]).attn
        shape = (n0, n1, attn.kv_local, attn.head_dim)
        device = self.tok_embed.weight.device if device is None else device
        dtype = torch.int8 if self.quant_kv_cache else self.dtype

        def alloc(shape, dtype, fill):  # a tensor a layer, or layer views of one stack
            if self.scan_layers:
                stack = torch.full((self.num_layers, *shape), fill, dtype=dtype, device=device)
                return list(stack.unbind(0))
            return [torch.full(shape, fill, dtype=dtype, device=device)
                    for _ in range(self.num_layers)]

        keys, values = alloc(shape, dtype, 0), alloc(shape, dtype, 0)
        if not self.quant_kv_cache:
            return [KVCache(k, v) for k, v in zip(keys, values)]
        scales = alloc(shape[:3], torch.float32, 1), alloc(shape[:3], torch.float32, 1)
        return [KVCache(*t) for t in zip(keys, values, *scales)]

    def init_cache(self, batch: int, length: int | None = None, device=None) -> list[KVCache]:
        """A dense cache a layer for modes ``prefill``/``decode``: [batch,
        length (default max_seq_len), Hkv, D] rows (this rank's Hkv / T
        under a tensor axis), zero (scales one)."""
        return self._kv(batch, self.max_seq_len if length is None else length, device)

    def init_pages(self, num_pages: int, page_size: int, device=None) -> list[KVCache]:
        """Page pools a layer for mode ``paged_decode``: [num_pages,
        page_size, Hkv, D] (this rank's Hkv / T under a tensor axis), zero
        (scales one), each allocated whole, so the paged kernel reads it
        in place."""
        return self._kv(num_pages, page_size, device)

    def _layers(self):
        """Layer i's block as a callable ``(x, dtype, **kw)``: the
        unrolled model's ``blocks[i]``, or the stacked block run on layer
        i's views of its parameters."""
        if not self.scan_layers:
            return list(self.blocks)
        names = [name for name, _ in self.blocks.named_parameters()]
        views = zip(*(p.unbind(0) for _, p in self.blocks.named_parameters()))

        def layer(params):
            return lambda x, dtype, **kw: torch.func.functional_call(
                self.blocks, params, (x, dtype), kw)

        return [layer(dict(zip(names, v))) for v in views]

    def forward(self, tokens: torch.Tensor, mode: str = "train", *, decode_pos=None,
                page_table: torch.Tensor | None = None, cache: list[KVCache] | None = None,
                paged_attention_impl: str = "gather",
                dropout: tuple[int, ...] | None = None) -> torch.Tensor:
        """fp32 logits [B, T, vocab]. ``prefill`` writes the prompt's K/V to
        ``cache`` (``init_cache``); ``decode`` takes T tokens at position
        ``decode_pos`` (an int) over ``cache``; ``paged_decode`` one token a
        slot at depths ``decode_pos`` [B] over the pools in ``cache``
        (``init_pages``) through ``page_table`` [B, P]. ``dropout``, a key
        (seed, step, microbatch), turns the blocks' dropout on (the JAX
        ``deterministic=False``); without it the forward is
        deterministic."""
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; choose from {MODES}")
        dtype = self.dtype
        t = tokens.shape[1]
        attn_kw = {}
        if mode != "train":
            if cache is None or len(cache) != self.num_layers:
                raise ValueError(f"mode={mode!r} needs a cache of one KVCache a layer")
            if (mode == "paged_decode") != (page_table is not None):
                raise ValueError("page_table goes with mode='paged_decode', and it needs one")
            if (mode in ("decode", "paged_decode")) != (decode_pos is not None):
                raise ValueError(f"decode_pos goes with the decode modes, got mode={mode!r}")
            if mode == "paged_decode" and t != 1:
                raise ValueError(f"paged decode steps one token at a time, got t={t}")
            if paged_attention_impl not in PAGED_IMPLS:
                raise ValueError(f"paged_attention_impl must be one of {PAGED_IMPLS}, "
                                 f"got {paged_attention_impl!r}")
            attn_kw = dict(mode=mode, pos=decode_pos, page_table=page_table,
                           paged_impl=paged_attention_impl)
        if mode == "decode" and decode_pos + t > cache[0].key.shape[1]:
            raise ValueError(f"decode at {decode_pos} + {t} tokens overruns the cache")
        if mode in ("train", "prefill") and t > self.max_seq_len:
            raise ValueError(f"sequence of {t} tokens exceeds max_seq_len {self.max_seq_len}")
        if mode != "train" and self.seq_size > 1:
            raise ValueError(f"cached prefill/decode requires an unsharded sequence axis; got "
                             f"seq_axis='seq' (size {self.seq_size})")
        x = F.embedding(tokens, self.tok_embed.weight).to(dtype)
        if self.pos_embed is not None:
            # A sequence-sharded block starts at this rank's offset.
            offset = (self.mesh.axis_index(SEQ_AXIS) * t if self.seq_size > 1 else decode_pos)
            positions = _positions(t, offset, tokens.device)
            x = x + F.embedding(positions, self.pos_embed.weight).to(dtype)
        # Remat in train mode only, and only where a backward will follow.
        remat = self.remat and mode == "train" and torch.is_grad_enabled()
        for i, block in enumerate(self._layers()):
            kw = dict(attn_kw, kv=cache[i] if cache is not None else None,
                      drop_key=None if dropout is None else (*dropout, i))
            if remat:
                ctx = {} if self.remat_context is None else {"context_fn": self.remat_context}
                x = checkpoint(block, x, dtype, use_reentrant=False, **ctx, **kw)
            else:
                x = block(x, dtype, **kw)
        x = self.ln_f(x, dtype)
        if self.tie_embeddings:
            return F.linear(x, self.tok_embed.weight.to(dtype)).float()
        return _dense(self.lm_head, x, dtype).float()
