"""Weight-only int8 for the decode path: the int8 weight-matmul kernel,
its wrapper and plain version, the ``QuantLinear`` module, the int8 KV
cache's decode attention, and the conversion of a ``TransformerLM``
``state_dict``.

Port of the JAX package's ``ops/quant.py``. Symmetric
per-output-channel quantization: ``q = round(w / s)`` with
``s = max|w| / 127`` per column of a [K, N] kernel, clipped to
[-127, 127]; an all-zero column gets scale 1. ``torch.round`` rounds
half to even, as ``jnp.round`` does, so the codes are the JAX package's
bit for bit.

``int8_matmul(x [..., K], q int8 [K, N], scale [N])`` is
``x @ widen(q)`` summed in fp32, then times the per-channel scale, cast
to x's dtype. Two kernels replace the TPU kernel ``ops/quant.py::
_kernel``; both read the weight as int8 and widen it in shared memory
(half the bytes of a bf16 weight, a quarter of fp32):
``csrc/int8_matmul_tc.cu`` on the tensor cores (bf16 wgmma on TMA-fed
tiles) and ``csrc/int8_matmul.cu`` on the FP32 units (FFMA). A call on
CUDA tensors takes the tensor cores when ``tc_route`` holds, a fixed
rule of dtype, shape and alignment, and the FFMA kernel otherwise. The
wrapper launches its route's kernel for CUDA tensors (or raises) and
takes the plain version for CPU tensors only; each launch adds one to
``launch_count(dtype, route)``.

``quantize_chunked``/``dequantize_chunked`` are the int8 gradient
wire's codes (``parallel/sync.py``): the same max-abs/127 scheme per
chunk of a flat buffer, in plain tensor ops on either device, as the
JAX package computes them outside any kernel.
"""

from __future__ import annotations

import collections
import ctypes
from collections.abc import Mapping

import torch
from torch import nn

from cs744_pytorch_distributed_tutorial_tpu_torch.ops._build import load_library
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.ring_attention import (
    _MASK,
    decode_mask,
    gather_pages,
)

SOURCE = "int8_matmul.cu"
TC_SOURCE = "int8_matmul_tc.cu"
SOURCES = (SOURCE, TC_SOURCE)
ROUTES = ("ffma", "tc")
# The fewest rows of x that take the tensor cores. A prompt pass (2,048
# rows) and serving's prefills (64 rows and up) take them; a decode step
# (16 rows) takes them too only where chip_smoke.py's paired runs showed
# the tensor-core kernel no slower than the FFMA kernel there (PERF.md,
# int8 row).
TC_MIN_ROWS = 1

# Every TransformerLM projection whose weight can quantize (embeddings
# and norms stay float), and the JAX decode default: the head only.
QUANT_MODULES = frozenset({"q", "k", "v", "attn_out", "mlp_in", "mlp_gate", "mlp_out", "lm_head"})
QUANT_HEAD_ONLY = ("lm_head",)

_DTYPES = (torch.float32, torch.bfloat16)
_launches: collections.Counter = collections.Counter()  # (x dtype, route) -> count
_kernel_fns = None  # {route: C entry point}, set up once


def launch_count(dtype: torch.dtype | None = None, route: str | None = None) -> int:
    """Kernel launches since the last ``reset_launch_count()``: all of
    them, or those on activations of one dtype and/or of one route
    (``ffma``, ``tc``)."""
    return sum(n for (d, r), n in _launches.items()
               if (dtype is None or d == dtype) and (route is None or r == route))


def reset_launch_count() -> None:
    _launches.clear()


def load_kernel():
    """Build (first call) and load the kernels of ``SOURCES``; returns
    their C entry points by route."""
    global _kernel_fns
    if _kernel_fns is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fns = {  # x, q, scale, out, M, K, N, (bf16,) stream
            "ffma": (load_library(SOURCE).int8_matmul, [p, p, p, p, i64, i64, i64, i64, p]),
            "tc": (load_library(TC_SOURCE).int8_matmul_tc, [p, p, p, p, i64, i64, i64, p]),
        }
        for fn, argtypes in fns.values():
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _kernel_fns = {route: fn for route, (fn, _) in fns.items()}
    return _kernel_fns


def tc_route(x_dtype: torch.dtype, m: int, k: int, n: int, aligned: bool = True) -> bool:
    """Whether an ``int8_matmul`` call on CUDA tensors takes the
    tensor-core kernel: x ``[m, k]`` (contiguous) of ``x_dtype``, q ``[k,
    n]``, ``aligned`` whether x and q start on 16 bytes. True for bf16 x
    with k a positive multiple of 8 and n of 16 (the 16-byte rows TMA
    reads of x and q) and at least ``TC_MIN_ROWS`` rows."""
    return (x_dtype == torch.bfloat16 and aligned and m >= TC_MIN_ROWS and k > 0
            and k % 8 == 0 and n % 16 == 0)


def quantize_int8(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[K, N] kernel -> (q int8 [K, N], scale fp32 [N]), q * scale ~= w."""
    if w.dim() != 2:
        raise ValueError(f"quantize_int8 expects a [K, N] kernel, got shape {tuple(w.shape)}")
    w32 = w.float()
    amax = w32.abs().amax(dim=0)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w32 / scale[None, :]), -127, 127).to(torch.int8)
    return q, scale


def quantize_chunked(x: torch.Tensor, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat buffer of a multiple of ``chunk`` elements -> (q int8 [m,
    chunk], scale fp32 [m]) with ``dequantize_chunked(q, scale) ~= x``:
    max-abs/127 a chunk, scale 1 for an all-zero chunk, round half to
    even, clip to [-127, 127]."""
    if x.dim() != 1 or x.numel() % chunk:
        raise ValueError(
            f"quantize_chunked expects a flat buffer sized a multiple of {chunk}, "
            f"got shape {tuple(x.shape)}"
        )
    x2 = x.float().reshape(-1, chunk)
    amax = x2.abs().amax(dim=1)
    scale = torch.where(amax > 0, true_div(amax, 127.0), torch.ones_like(amax))
    q = torch.clamp(torch.round(x2 / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded once on either device: PyTorch's CUDA kernels
    multiply by the reciprocal of a Python-number divisor, so the
    divisor goes in as a tensor."""
    return x / x.new_full((), d)


def dequantize_chunked(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``[m, chunk]`` int8 codes and ``[m]`` fp32 scales -> flat fp32."""
    return (q.float() * scale[:, None]).reshape(-1)


def int8_matmul_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the JAX ``int8_matmul_ref``):
    ``x @ q`` with the products of x's values and the widened codes summed
    in fp32, times ``scale``, cast to x's dtype."""
    acc = x.float() @ q.float()
    return (acc * scale.float()).to(x.dtype)


def _check(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> None:
    if q.dim() != 2 or q.dtype != torch.int8:
        raise ValueError(f"expected q int8 [K, N], got {q.dtype} {tuple(q.shape)}")
    if scale.shape != (q.shape[1],):
        raise ValueError(f"expected scale [{q.shape[1]}], got {tuple(scale.shape)}")
    if x.shape[-1] != q.shape[0]:
        raise ValueError(f"x K dim {x.shape[-1]} != q K dim {q.shape[0]}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if len({x.device, q.device, scale.device}) != 1:
        raise ValueError(f"inputs on several devices: {x.device}, {q.device}, {scale.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"int8_matmul: unsupported device {x.device}")


def int8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x [..., K] @ dequant(q [K, N], scale [N]) -> [..., N]`` in x's
    dtype, reading the weight as int8 on the card. Any M, K and N."""
    _check(x, q, scale)
    if x.device.type == "cpu":
        return int8_matmul_plain(x, q, scale)
    *lead, k = x.shape
    n = q.shape[1]
    x2 = x.reshape(-1, k).contiguous()
    q, scale = q.contiguous(), scale.float().contiguous()
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m and n:
        aligned = x2.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0
        route = "tc" if tc_route(x.dtype, m, k, n, aligned) else "ffma"
        stream = torch.cuda.current_stream(x.device).cuda_stream
        args = [x2.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), m, k, n]
        if route == "ffma":
            args.append(int(x.dtype == torch.bfloat16))
        err = load_kernel()[route](*args, stream)
        _launches[(x.dtype, route)] += 1
        if err:
            raise RuntimeError(f"int8_matmul launch failed ({route}): CUDA error {err}")
    return out.reshape(*lead, n)


class QuantLinear(nn.Module):
    """``nn.Linear`` with an int8 weight: ``qweight`` int8 [in, out] (the
    JAX ``qkernel`` layout), ``scale`` fp32 [out] and an optional fp32
    ``bias``, all buffers (decode only: nothing here trains). Filled by
    ``quantize_lm_params``; built zero with scale 1."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("qweight", torch.zeros(in_features, out_features, dtype=torch.int8))
        self.register_buffer("scale", torch.ones(out_features))
        self.register_buffer("bias", torch.zeros(out_features) if bias else None)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """The JAX ``QuantDense(dtype=dtype)``: ``int8_matmul`` on x in
        ``dtype``, then the bias in ``dtype``."""
        y = int8_matmul(x.to(dtype), self.qweight, self.scale)
        return y if self.bias is None else y + self.bias.to(dtype)


def resolve_quant_modules(scope: str) -> tuple[str, ...]:
    """The int8-decode scope name -> module names: ``head`` is the head
    only, ``all`` every projection."""
    if scope == "head":
        return QUANT_HEAD_ONLY
    if scope == "all":
        return tuple(sorted(QUANT_MODULES))
    raise ValueError(f"unknown int8-decode scope {scope!r}; choose 'head' or 'all'")


def quantize_lm_params(state_dict: Mapping[str, torch.Tensor],
                       modules=QUANT_MODULES) -> dict[str, torch.Tensor]:
    """A ``TransformerLM`` ``state_dict`` -> the one a ``quant_dense``
    model with the same ``quant_modules`` loads: each listed projection's
    ``weight`` [out, in] becomes ``qweight`` [in, out] int8 and ``scale``
    [out] (``quantize_int8`` of the transposed weight, as the JAX kernel
    [K, N]); everything else passes through. With tied embeddings there
    is no ``lm_head``: the head stays the float embedding."""
    modules = frozenset(modules)
    unknown = modules - QUANT_MODULES
    if unknown:
        raise ValueError(f"unknown quant modules {sorted(unknown)}")
    out: dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        prefix, _, name = key.rpartition(".")
        if name == "weight" and prefix.rpartition(".")[2] in modules:
            out[f"{prefix}.qweight"], out[f"{prefix}.scale"] = quantize_int8(value.detach().t())
        else:
            out[key] = value
    return out


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(..., head) row quantization of K or V rows [..., H, D] ->
    (q int8 [..., H, D], scale fp32 [..., H]), q * scale ~= x."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def decode_attention_quant(q: torch.Tensor, cached_k: torch.Tensor, cached_v: torch.Tensor,
                           k_scale: torch.Tensor, v_scale: torch.Tensor, pos) -> torch.Tensor:
    """``decode_attention`` over an int8 cache [B, L, Hkv, D] with row
    scales [B, L, Hkv]: q and the codes in fp32, ``k_scale`` on the scores
    after the dot, ``v_scale`` folded into the probabilities before the
    product with V. Returns q's dtype."""
    b, t, hq, d = q.shape
    hkv = cached_k.shape[2]
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    qg = q.reshape(b, t, hkv, hq // hkv, d).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, cached_k.float()) * d**-0.5
    scores = scores * k_scale.transpose(1, 2)[:, :, None, None, :]
    scores = scores.masked_fill(~decode_mask(cached_k.shape[1], t, pos, q.device), _MASK)
    probs = torch.softmax(scores, dim=-1)
    pv = probs * v_scale.transpose(1, 2)[:, :, None, None, :]
    out = torch.einsum("bhgqk,bkhd->bqhgd", pv, cached_v.float())
    return out.reshape(b, t, hq, d).to(q.dtype)


def paged_decode_attention_quant(q, key_pages, value_pages, key_scale_pages, value_scale_pages,
                                 page_table, pos) -> torch.Tensor:
    """``decode_attention_quant`` against int8 pools [num_pages,
    page_size, Hkv, D] with scale pools [num_pages, page_size, Hkv]:
    gather the four pools, then the int8 decode step (the plain version
    of the int8 variant of ``ops/paged_attention.py::paged_attention``)."""
    return decode_attention_quant(
        q, gather_pages(key_pages, page_table), gather_pages(value_pages, page_table),
        gather_pages(key_scale_pages, page_table), gather_pages(value_scale_pages, page_table),
        pos,
    )
