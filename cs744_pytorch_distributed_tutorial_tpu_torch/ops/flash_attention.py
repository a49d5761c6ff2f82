"""Flash attention: the three CUDA kernels (forward with its logsumexp,
dq, and dk/dv), their wrappers, their plain PyTorch versions, and the
autograd Function that joins them.

Port of the JAX package's Pallas kernels ``ops/flash_attention.py::
_kernel`` (reached through ``flash_forward_lse`` and the forward of the
``flash_attention`` custom VJP), ``_dq_kernel`` (``flash_dq``) and
``_dkv_kernel`` (``flash_dkv``). On [B, T, H, D], per (batch, head), with
``s = (q . k) * D**-0.5`` masked to -1e30 above the diagonal when causal:

    out = softmax(s) @ v,  lse = logsumexp(s)           (forward)
    p = exp(s - lse),  ds = p * (do . v - delta)
    dq = scale * ds @ k,  dk = scale * ds^T @ q,  dv = p^T @ do

with ``delta = rowsum(do * out)`` (``flash_delta``, plain PyTorch on
every device: the JAX package computes it outside Pallas too). All sums
are fp32; in bf16, ``p`` is rounded to bf16 before its products with
``v`` and ``do``, and ``ds`` before its products with ``k`` and ``q``, as
the TPU kernels do. The plain versions round at the same places. ``lse``
and ``delta`` are ``[B*H, T, 1]`` fp32, the JAX package's layout.

``csrc/flash_attention.cu`` holds the FFMA kernels (its source note says
how they are laid out): the forward, dq and dk/dv for fp32 inputs, head_dim
32 and strides the tensor-core kernels do not take; they read q, k, v and do
in place through their strides and take head_dim 32, 64 or 128.
``csrc/flash_attention_tc.cu`` holds all three on the tensor cores for bf16
(``flash_fwd_tc_kernel``, ``flash_dq_tc_kernel``, ``flash_dkv_tc_kernel``:
wgmma on tiles that TMA brings into shared memory, the same products as the
TPU kernels in another order of the fp32 sums). ``flash_forward_lse``,
``flash_dq`` and ``flash_dkv`` choose their kernel by ``tc_route``, a fixed
rule of dtypes, shapes, strides and alignment: the tensor-core kernels for
bf16 inputs with head_dim 64 or 128 (not 32), a contiguous last dimension,
(b, t, h) strides that are positive multiples of 16 bytes and 16-byte-aligned
pointers; the FFMA kernels otherwise. Both are built with nvcc on first use
(``ops/_build.py``) and launched through ``ctypes`` on PyTorch's current
stream.

The wrappers take the kernel for CUDA tensors and the plain version for
CPU tensors; for a CUDA tensor they launch their route's kernel or raise,
with no fallback. Each launch adds one to ``launch_count(kernel, dtype,
route)``: ``launch_count("dq")`` counts the dq launches of both routes,
``launch_count("dq", route="tc")`` those on the tensor cores and
``route="ffma"`` the others.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.ops import _cost
from cs744_pytorch_distributed_tutorial_tpu_torch.ops._build import load_library

SOURCE = "flash_attention.cu"
TC_SOURCE = "flash_attention_tc.cu"
SOURCES = (SOURCE, TC_SOURCE)
KERNELS = ("fwd", "dq", "dkv")
ROUTES = ("ffma", "tc")
HEAD_DIMS = (32, 64, 128)
TC_HEAD_DIMS = (64, 128)

_NEG = -1e30
_DTYPES = (torch.float32, torch.bfloat16)
_launches: collections.Counter = collections.Counter()  # (kernel, dtype, route) -> count
_kernel_fns = None  # {kernel: C entry point}, set up once


def launch_count(kernel: str | None = None, dtype: torch.dtype | None = None,
                 route: str | None = None) -> int:
    """Kernel launches since the last ``reset_launch_count()``: all of
    them, or those of one kernel (``fwd``, ``dq``, ``dkv``), dtype and/or
    route (``ffma``, ``tc``)."""
    return sum(
        n for (k, d, r), n in _launches.items()
        if (kernel is None or k == kernel) and (dtype is None or d == dtype)
        and (route is None or r == route)
    )


def reset_launch_count() -> None:
    _launches.clear()


def load_kernel():
    """Build (first call) and load the kernels of ``SOURCES``; returns
    their C entry points by kernel and route: ``fwd``, ``dq``, ``dkv``
    (FFMA), ``fwd_tc``, ``dq_tc`` and ``dkv_tc``."""
    global _kernel_fns
    if _kernel_fns is None:
        lib, tc = load_library(SOURCE), load_library(TC_SOURCE)
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        tail = [p, i64, i64, i64, i64, i64]  # strides, B, T, H, D, causal
        fns = {
            "fwd": (lib.flash_fwd, [p] * 5 + tail + [i64, p]),  # ..., bf16, stream
            "dq": (lib.flash_dq, [p] * 7 + tail + [i64, p]),
            "dkv": (lib.flash_dkv, [p] * 8 + tail + [i64, p]),
            "fwd_tc": (tc.flash_fwd_tc, [p] * 5 + tail + [p]),
            "dq_tc": (tc.flash_dq_tc, [p] * 7 + tail + [p]),
            "dkv_tc": (tc.flash_dkv_tc, [p] * 8 + tail + [p]),
        }
        for fn, argtypes in fns.values():
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _kernel_fns = {name: fn for name, (fn, _) in fns.items()}
    return _kernel_fns


# ------------------------------------------------------------ plain versions
def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype``'s precision, kept in fp32."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """[B, H, Tq, Tk] fp32 scaled scores, masked above the diagonal."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * q.shape[-1] ** -0.5
    if causal:
        keep = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, _NEG)
    return s


def _rows(x: torch.Tensor, b: int, h: int, t: int) -> torch.Tensor:
    """[B*H, T, 1] row statistics -> [B, H, T, 1] fp32."""
    return x.float().reshape(b, h, t, 1)


def flash_forward_lse_plain(q, k, v, causal: bool = False):
    """``(out [B,T,H,D] in v.dtype, lse [B*H,T,1] fp32)`` over the whole
    row at once: p = exp(s - rowmax), rounded to v.dtype before p @ v,
    out = (p @ v) / rowsum(p)."""
    b, t, h, _ = q.shape
    s = _scores(q, k, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", _round(p, v.dtype), v.float())
    out = (acc / l).to(v.dtype).transpose(1, 2).contiguous()
    return out, (m + torch.log(l)).reshape(b * h, t, 1)


def flash_dq_plain(q, k, v, do, lse, delta, causal: bool):
    """dq [B,T,H,D] in q.dtype given the final ``lse``/``delta``."""
    b, t, h, d = q.shape
    p = torch.exp(_scores(q, k, causal) - _rows(lse, b, h, t))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - _rows(delta, b, h, t))
    dq = torch.einsum("bhqk,bkhd->bqhd", _round(ds, k.dtype), k.float()) * d**-0.5
    return dq.to(q.dtype).contiguous()


def flash_dkv_plain(q, k, v, do, lse, delta, causal: bool):
    """(dk in k.dtype, dv in v.dtype) [B,T,H,D] given the final
    ``lse``/``delta``."""
    b, t, h, d = q.shape
    p = torch.exp(_scores(q, k, causal) - _rows(lse, b, h, t))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - _rows(delta, b, h, t))
    dv = torch.einsum("bhqk,bqhd->bkhd", _round(p, do.dtype), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", _round(ds, q.dtype), q.float()) * d**-0.5
    return dk.to(k.dtype).contiguous(), dv.to(v.dtype).contiguous()


def flash_delta(out: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(do * out) as [B*H, T, 1] fp32, plain PyTorch on
    every device (O(T*D), no [T, T] shape). On the CPU the row sums
    accumulate one element at a time by fused multiply-add, the order of
    the plain dq's and dk/dv's ``do . v`` products (and of XLA's): where a
    row attends to one key only, ``out`` is that key's value and ``dp -
    delta`` is then exactly 0, as in JAX."""
    b, t, h, d = out.shape
    g, out = g.float(), out.float()
    if out.device.type == "cpu":
        delta = torch.zeros((b, t, h), dtype=torch.float32)
        for i in range(d):
            delta = torch.addcmul(delta, g[..., i], out[..., i])
    else:
        delta = (g * out).sum(dim=-1)  # [B, T, H]
    return delta.permute(0, 2, 1).reshape(b * h, t, 1)


# --------------------------------------------------------------- route rule
def tc_route(dtype: torch.dtype, shape: tuple[int, int, int, int],
             strides: list[tuple[int, ...]], aligned: bool = True) -> bool:
    """Whether a ``flash_forward_lse``/``flash_dq``/``flash_dkv`` call on
    CUDA tensors takes the tensor-core kernels: ``dtype`` and ``shape``
    [B, T, H, D] are the
    inputs', ``strides`` each input's four strides (in elements) and
    ``aligned`` whether every input starts on 16 bytes. True for bf16 with
    D in ``TC_HEAD_DIMS``, the last dimension contiguous, and every (b, t,
    h) stride a positive multiple of 8 elements (16 bytes), the rows TMA
    reads; the stride of a dimension of size 1 is never used and does not
    count."""
    if dtype != torch.bfloat16 or shape[-1] not in TC_HEAD_DIMS or not aligned:
        return False
    for st in strides:
        if st[3] != 1:
            return False
        if any(n > 1 and (s <= 0 or s % 8) for n, s in zip(shape[:3], st[:3])):
            return False
    return True


def _aligned(*xs: torch.Tensor) -> bool:
    return all(x.data_ptr() % 16 == 0 for x in xs)


# ------------------------------------------------------------------ wrappers
def _check(*xs: torch.Tensor) -> None:
    q = xs[0]
    if q.dim() != 4:
        raise ValueError(f"expected [B, T, H, D] tensors, got shape {tuple(q.shape)}")
    for x in xs:
        if x.shape != q.shape:
            raise ValueError(
                f"q, k, v (and do) must share one [B, T, H, D] shape, got "
                f"{[tuple(y.shape) for y in xs]}"
            )
        if x.dtype not in _DTYPES or x.dtype != q.dtype:
            raise TypeError(
                f"inputs must all be float32 or all bfloat16, got {[y.dtype for y in xs]}"
            )
        if x.device != q.device:
            raise ValueError(f"inputs on several devices: {[str(y.device) for y in xs]}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention: unsupported device {q.device}")


def _cuda_args(*xs: torch.Tensor):
    """Tensors with a contiguous last dimension and the (b, t, h) strides
    of each, then of the contiguous outputs; a dimension of size 1 gets
    stride D (never used, and a multiple of 16 bytes, as TMA asks)."""
    xs = tuple(x if x.stride(-1) == 1 else x.contiguous() for x in xs)
    b, t, h, d = xs[0].shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash attention kernels take head_dim in {HEAD_DIMS}, got {d}")
    if b * h >= 2**31 or -(-t // 64) > 65535:  # the launch grid: (B*H, T/64 tiles)
        raise ValueError(f"flash attention: shape {tuple(xs[0].shape)} too large")
    strides = [s if n > 1 else d for x in xs for n, s in zip(x.shape[:3], x.stride()[:3])]
    strides += [t * h * d, h * d, d]
    return xs, (ctypes.c_int64 * len(strides))(*strides)


def _rowstat(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """An lse or delta [B*H, T, 1] as the kernels read it: [B*H, T] fp32
    contiguous, on q's device."""
    b, t, h, _ = q.shape
    if x.numel() != b * h * t or x.device != q.device:
        raise ValueError(
            f"row statistic of shape {tuple(x.shape)} on {x.device}, expected "
            f"[{b * h}, {t}, 1] on {q.device}"
        )
    return x.reshape(b * h, t).float().contiguous()


def _launch(kernel: str, operands: list, q: torch.Tensor, strides, causal: bool,
            route: str) -> None:
    b, t, h, d = q.shape
    fn_args, operands = _cost.pointers(operands)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if route == "tc":
        err = load_kernel()[f"{kernel}_tc"](*fn_args, strides, b, t, h, d, int(causal), stream)
    else:
        err = load_kernel()[kernel](*fn_args, strides, b, t, h, d, int(causal),
                                    int(q.dtype == torch.bfloat16), stream)
    _launches[(kernel, q.dtype, route)] += 1
    # Products: the scores and P V (fwd); + dP and dQ (dq); + dV and dK
    # (dkv): 2 FLOPs a multiply-add each, half under the causal mask.
    # Bytes: q, k, v (+ do) read and the outputs written once, with the
    # fp32 row statistics.
    n, rows = b * t * h * d, b * h * t
    products = {"fwd": 2, "dq": 3, "dkv": 4}[kernel]
    tensors, stats = {"fwd": (4, 1), "dq": (5, 2), "dkv": (6, 2)}[kernel]
    _cost.add(2.0 * products * b * h * t * t * d * (0.5 if causal else 1.0),
              tensors * n * q.element_size() + 4.0 * stats * rows, operands)
    if err:
        raise RuntimeError(f"flash attention {kernel} ({route}) launch failed: CUDA error {err}")


def _route(*xs: torch.Tensor) -> str:
    q = xs[0]
    return "tc" if tc_route(q.dtype, tuple(q.shape), [x.stride() for x in xs],
                            _aligned(*xs)) else "ffma"


def flash_forward_lse(q, k, v, causal: bool = False):
    """``(out [B,T,H,D] in v.dtype, lse [B*H,T,1] fp32)``."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_forward_lse_plain(q, k, v, causal)
    route = _route(q, k, v)
    (q, k, v), strides = _cuda_args(q, k, v)
    b, t, h, _ = q.shape
    out = torch.empty(q.shape, dtype=v.dtype, device=q.device)
    lse = torch.empty((b * h, t), dtype=torch.float32, device=q.device)
    _launch("fwd", [q, k, v, out, lse], q, strides, causal, route)
    return out, lse.unsqueeze(-1)


def flash_dq(q, k, v, do, lse, delta, causal: bool):
    """dq [B,T,H,D] in q.dtype, given the final ``lse``/``delta`` [B*H,T,1]."""
    _check(q, k, v, do)
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, do, lse, delta, causal)
    route = _route(q, k, v, do)
    (q, k, v, do), strides = _cuda_args(q, k, v, do)
    lse, delta = _rowstat(lse, q), _rowstat(delta, q)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch("dq", [q, k, v, do, lse, delta, dq], q, strides, causal, route)
    return dq


def flash_dkv(q, k, v, do, lse, delta, causal: bool):
    """(dk, dv) [B,T,H,D], given the final ``lse``/``delta`` [B*H,T,1]."""
    _check(q, k, v, do)
    if q.device.type == "cpu":
        return flash_dkv_plain(q, k, v, do, lse, delta, causal)
    route = _route(q, k, v, do)
    (q, k, v, do), strides = _cuda_args(q, k, v, do)
    lse, delta = _rowstat(lse, q), _rowstat(delta, q)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    _launch("dkv", [q, k, v, do, lse, delta, dk, dv], q, strides, causal, route)
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward kernel; backward delta -> dq kernel -> dk/dv kernel, as the
    JAX package's ``_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, lse = flash_forward_lse(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        delta = flash_delta(out, g)
        dq = flash_dq(q, k, v, g, lse, delta, ctx.causal)
        dk, dv = flash_dkv(q, k, v, g, lse, delta, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Attention on [B, T, H, D] without a [T, T] matrix on the card;
    differentiable, with the backward in the dq and dk/dv kernels."""
    return _FlashAttention.apply(q, k, v, causal)
