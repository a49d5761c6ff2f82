"""Paged-attention decode: the CUDA kernel of the serving engine's decode
step, its wrapper and its plain version.

Port of the JAX package's ``ops/paged_attention.py::paged_attention``
(the Pallas kernel ``_decode_kernel``), with its signature and checks.
One decode step of ``q`` [B, 1, Hq, D] against per-layer pools
[num_pages, page_size, Hkv, D] through ``page_table`` [B, P] and the
slots' depths ``pos`` [B]; Hq a multiple of Hkv (GQA). With
``key_scale_pages``/``value_scale_pages`` [num_pages, page_size, Hkv] the
pools are int8 and dequantized inside (k_scale on the scores after the
dot, v_scale folded into the probabilities), the output in q's dtype;
float pools give the pool dtype. ``pages_per_slot`` narrows the table to
its first N pages. Page indices must lie in [0, num_pages): the kernel
clamps one outside into the pool, the plain version's gather raises.

``csrc/paged_attention.cu`` holds the kernels (its source note says how
they are laid out). They read each slot's live rows only, straight from
the pools, in fp32: each block takes one span of ``SPAN`` keys of a slot
and KV head, gathered by 16-byte ``cp.async`` (so the pools must be
16-byte aligned), and a second kernel of the same call merges the spans'
partial softmaxes in span order (deterministic; an fp32 workspace
[B, Hq, S, D + 2] from the caching allocator).
``paged_attention_split_plain`` is that arithmetic in plain PyTorch. The
plain version is the gather path
(``parallel/ring_attention.py::paged_decode_attention`` and
``ops/quant.py::paged_decode_attention_quant``), which reads every page
of the table; the kernels agree with it to within the softmax's rounding.

The wrapper takes the kernels for CUDA tensors (or raises) and the plain
version for CPU tensors only. Each kernel launch on the card (two a call:
the spans, then the merge) adds one to ``launch_count(variant)``, the
variant being the pools' dtype name (``float32``, ``bfloat16`` or
``int8``), and reports its cost to ``ops/_cost.py``
(``paged_attention_cost``) while a counter is open.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.ops import _cost
from cs744_pytorch_distributed_tutorial_tpu_torch.ops._build import load_library
from cs744_pytorch_distributed_tutorial_tpu_torch.ops.quant import paged_decode_attention_quant
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.ring_attention import (
    gather_pages,
    paged_decode_attention,
)

SOURCE = "paged_attention.cu"
HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 16  # query heads a KV head (the kernels' register budget)
SPAN = 64  # keys a block (the kernel's kSpan)

_KV_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_launches: collections.Counter = collections.Counter()  # variant -> count
_kernel_fn = None  # the loaded C entry point, set up once


def launch_count(variant: str | None = None) -> int:
    """Kernel launches since the last ``reset_launch_count()``: all of
    them, or those of one variant (``float32``, ``bfloat16``, ``int8``)."""
    return sum(_launches.values()) if variant is None else _launches[variant]


def reset_launch_count() -> None:
    _launches.clear()


def load_kernel():
    """Build (first call) and load the kernels; returns their C entry
    point."""
    global _kernel_fn
    if _kernel_fn is None:
        lib = load_library(SOURCE)
        fn = lib.paged_attention_split
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [p] * 9 + [i64] * 11 + [p, ctypes.POINTER(i64)]
        fn.restype = ctypes.c_int
        _kernel_fn = fn
    return _kernel_fn


def paged_attention_plain(q, key_pages, value_pages, page_table, pos, *, key_scale_pages=None,
                          value_scale_pages=None, pages_per_slot=None) -> torch.Tensor:
    """The kernel's function by the gather path, over the same arguments."""
    if pages_per_slot is not None:
        page_table = page_table[:, :pages_per_slot]
    if key_scale_pages is not None:
        return paged_decode_attention_quant(q, key_pages, value_pages, key_scale_pages,
                                            value_scale_pages, page_table, pos)
    return paged_decode_attention(q, key_pages, value_pages, page_table, pos)


def paged_attention_split_plain(q, key_pages, value_pages, page_table, pos, *,
                                key_scale_pages=None, value_scale_pages=None,
                                pages_per_slot=None, span: int = SPAN) -> torch.Tensor:
    """The kernels' arithmetic in plain PyTorch: the live keys cut
    into spans of ``span``; per span its max m_s, p = exp(s - m_s)
    (rounded to the pool dtype for float pools, times v_scale for int8
    ones), l_s = sum p and acc_s = p @ v in fp32; then the spans merged in
    order, acc = sum_s exp(m_s - m) acc_s over l likewise, rounded once to
    the output dtype. Keys past ``pos`` (and dead pages) are masked out,
    never read into a sum."""
    if pages_per_slot is not None:
        page_table = page_table[:, :pages_per_slot]
    quant = key_scale_pages is not None
    b, _, hq, d = q.shape
    hkv = key_pages.shape[2]
    g = hq // hkv
    cap = page_table.shape[1] * key_pages.shape[1]
    n_split = -(-cap // span)
    live = torch.arange(n_split * span, device=q.device)[None] <= pos.long()[:, None]  # [B, K]
    live = live & (torch.arange(n_split * span, device=q.device)[None] < cap)

    def keys(pages):  # [B, n_split * span, Hkv, ...] in fp32, 0 where not live
        rows = gather_pages(pages, page_table).float()
        rows = torch.cat([rows, rows.new_zeros(b, n_split * span - cap, *rows.shape[2:])], 1)
        mask = live.view(b, -1, *([1] * (rows.dim() - 2)))
        return torch.where(mask, rows, torch.zeros((), device=rows.device))

    k, v = keys(key_pages), keys(value_pages)
    qf = q.float().view(b, hkv, g, d)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k) * d**-0.5
    if quant:
        s = s * keys(key_scale_pages).permute(0, 2, 1)[:, :, None]
    s = s.masked_fill(~live[:, None, None], float("-inf")).view(b, hkv, g, n_split, span)
    m = s.amax(-1, keepdim=True)  # [b, h, g, S, 1]; -inf for a span with no live key
    p = torch.exp(s - torch.where(torch.isfinite(m), m, torch.zeros((), device=m.device)))
    l = p.sum(-1)
    if quant:
        pv = p * keys(value_scale_pages).permute(0, 2, 1).reshape(b, hkv, 1, n_split, span)
    else:
        pv = p.to(key_pages.dtype).float()
    acc = torch.einsum("bhgsk,bskhd->bhgsd", pv, v.view(b, n_split, span, hkv, d))
    m = m[..., 0]
    m_all = m.amax(-1, keepdim=True)
    w = torch.exp(m - m_all)  # 0 for a span with no live key
    l_all, acc_all = torch.zeros_like(l[..., 0]), torch.zeros_like(acc[..., 0, :])
    for i in range(n_split):  # in span order, as the merge kernel sums
        l_all = l_all + w[..., i] * l[..., i]
        acc_all = acc_all + w[..., i, None] * acc[..., i, :]
    out_dtype = q.dtype if quant else key_pages.dtype
    return (acc_all / l_all[..., None]).to(out_dtype).view(b, 1, hq, d)


def paged_attention_cost(q: torch.Tensor, key_pages: torch.Tensor, page_table: torch.Tensor,
                         pos: torch.Tensor, *, quant: bool,
                         pages_per_slot: int | None = None) -> tuple[float, float]:
    """(FLOPs, bytes) of one call: each slot's live K and V rows (depth +
    1, at most its table's capacity) read once with their fp32 scales for
    int8 pools, q read and the output written once (q's dtype), the table
    and the depths read once (int32); FLOPs 4 a live row, query head and
    head dim (q k and p v, 2 a multiply-add). ``PERF.md``'s bound for the
    kernel counts the same. Reads ``pos`` (a sync on the card)."""
    b, _, hq, d = q.shape
    page_size, hkv = key_pages.shape[1], key_pages.shape[2]
    n_pages = page_table.shape[1] if pages_per_slot is None else min(pages_per_slot,
                                                                     page_table.shape[1])
    rows = float((pos.long() + 1).clamp(max=n_pages * page_size).sum())
    nbytes = (2.0 * rows * hkv * d * key_pages.element_size() + (8.0 * rows * hkv if quant else 0.0)
              + 2.0 * q.numel() * q.element_size() + 4.0 * (page_table.numel() + b))
    return 4.0 * rows * hq * d, nbytes


def _check(q, key_pages, value_pages, page_table, pos, ks, vs) -> None:
    b, t, hq, d = q.shape
    if t != 1:
        raise ValueError(f"paged decode steps one token at a time, got t={t}")
    if key_pages.dim() != 4 or value_pages.shape != key_pages.shape or key_pages.shape[3] != d:
        raise ValueError(
            f"pools must be [num_pages, page_size, Hkv, {d}], got {tuple(key_pages.shape)} "
            f"and {tuple(value_pages.shape)}"
        )
    hkv = key_pages.shape[2]
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    if (ks is None) != (vs is None):
        raise ValueError("pass both scale pools or neither")
    if ks is not None and (ks.shape != key_pages.shape[:3] or vs.shape != ks.shape):
        raise ValueError(f"scale pools must be {tuple(key_pages.shape[:3])}")
    if page_table.dim() != 2 or page_table.shape[0] != b or pos.shape != (b,):
        raise ValueError(
            f"expected page_table [{b}, P] and pos [{b}], got {tuple(page_table.shape)} "
            f"and {tuple(pos.shape)}"
        )
    devices = {x.device for x in (q, key_pages, value_pages, page_table, pos, ks, vs)
               if x is not None}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"paged attention: unsupported device {q.device}")


def paged_attention(q: torch.Tensor, key_pages: torch.Tensor, value_pages: torch.Tensor,
                    page_table: torch.Tensor, pos: torch.Tensor, *,
                    key_scale_pages: torch.Tensor | None = None,
                    value_scale_pages: torch.Tensor | None = None,
                    pages_per_slot: int | None = None) -> torch.Tensor:
    """One decode step of ``q`` [B, 1, Hq, D] against the paged pools,
    reading only each slot's live rows on the card."""
    ks, vs = key_scale_pages, value_scale_pages
    _check(q, key_pages, value_pages, page_table, pos, ks, vs)
    if q.device.type == "cpu":
        return paged_attention_plain(q, key_pages, value_pages, page_table, pos,
                                     key_scale_pages=ks, value_scale_pages=vs,
                                     pages_per_slot=pages_per_slot)
    b, _, hq, d = q.shape
    num_pages, page_size, hkv, _ = key_pages.shape
    quant = ks is not None
    kv_dtype = key_pages.dtype
    if quant != (kv_dtype == torch.int8) or value_pages.dtype != kv_dtype:
        raise TypeError(f"int8 pools go with scale pools, float pools without; got "
                        f"{kv_dtype}/{value_pages.dtype} pools, scales {quant}")
    if kv_dtype not in _KV_KIND or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"unsupported dtypes: q {q.dtype}, pools {kv_dtype}")
    if not quant and q.dtype != kv_dtype:
        raise TypeError(f"q ({q.dtype}) and float pools ({kv_dtype}) must share a dtype")
    if d not in HEAD_DIMS or hq // hkv > MAX_GROUP:
        raise ValueError(f"paged attention kernel takes head_dim in {HEAD_DIMS} and at most "
                         f"{MAX_GROUP} query heads a KV head, got D {d}, group {hq // hkv}")
    n_pages = page_table.shape[1] if pages_per_slot is None else min(pages_per_slot,
                                                                     page_table.shape[1])
    if n_pages < 1 or b > 65535:
        raise ValueError(f"paged attention: {n_pages} pages a slot, {b} slots")
    q = q.contiguous()
    key_pages, value_pages = key_pages.contiguous(), value_pages.contiguous()
    table = page_table.to(torch.int32).contiguous()
    pos32 = pos.to(torch.int32).contiguous()
    if quant:
        ks, vs = ks.float().contiguous(), vs.float().contiguous()
    out = torch.empty(q.shape, dtype=q.dtype if quant else kv_dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    pointers = [q.data_ptr(), key_pages.data_ptr(), value_pages.data_ptr(),
                ks.data_ptr() if quant else None, vs.data_ptr() if quant else None,
                table.data_ptr(), pos32.data_ptr(), out.data_ptr()]
    sizes = [b, hkv, hq // hkv, d, page_size, num_pages, table.shape[1], n_pages,
             _KV_KIND[kv_dtype], int(q.dtype == torch.bfloat16)]
    if (key_pages.data_ptr() | value_pages.data_ptr()) % 16:
        raise ValueError("paged attention: the kernel copies pool rows 16 bytes at a time and "
                         "needs 16-byte aligned pools")
    n_split = -(-n_pages * page_size // SPAN)
    ws = torch.empty(b * hq * n_split * (d + 2), dtype=torch.float32, device=q.device)
    launches = ctypes.c_int64(0)
    err = load_kernel()(*pointers, ws.data_ptr(), *sizes, SPAN, stream, ctypes.byref(launches))
    _launches[str(kv_dtype).removeprefix("torch.")] += launches.value
    if err:
        raise RuntimeError(f"paged attention launch failed: CUDA error {err}")
    if _cost.active():
        _cost.add(*paged_attention_cost(q, key_pages, table, pos32, quant=quant,
                                        pages_per_slot=n_pages),
                  operands=[t for t in (q, key_pages, value_pages, ks, vs, table, pos32, out, ws)
                            if t is not None])
    return out
