"""Grouped matrix products, the compute core of dropless MoE: the CUDA
kernels' wrappers, their plain PyTorch versions, and the autograd
Functions that join them.

Port of the JAX package's ``ops/gmm.py``: its Pallas path
(``impl="pallas"``)::

    grouped_matmul_fused:  out[r] = act(lhs[r] @ rhs[g(r)] + bias[g(r)])
    grouped_matmul:        out[r] = lhs[r] @ rhs[g(r)]

with lhs [M, K], rhs [E, K, N] (one dtype, fp32 or bf16), bias [E, N]
(cast to fp32), group_sizes an integer [E] tensor on lhs's device and
rows in contiguous groups (group e holds the next ``group_sizes[e]``
rows; rows from ``sum(group_sizes)`` to M belong to the last group, as
the TPU wrapper's padding does). The products are summed in fp32; the
fused form adds the bias and applies the gelu (tanh form,
``jax.nn.gelu``'s default) in fp32 and rounds once to ``out_dtype``
(default lhs's dtype), as the TPU kernel ``_gmm_fused_kernel`` does.
``grouped_matmul`` rounds its fp32 result to lhs's dtype. Any number of
groups E >= 1 is taken: the kernels find each row's group from
``group_sizes`` in device memory, with no table of all the groups. Its ragged
path (``impl="ragged"``, XLA's ``lax.ragged_dot``) is ``ragged_dot``, a
plain PyTorch product with no kernel behind it (see there).

The backward is the JAX ``_gmm_bwd_core``, with its rounding points:
``dout`` cast to fp32 (on the gelu path ``dz = dout * gelu'(z)`` in fp32,
from the pre-activation ``z`` stored in the output dtype by the forward;
without an activation a bf16 ``dout`` goes to ``gmm`` and ``tgmm`` as it
is, and they widen it, exactly);
``dlhs = gmm(dz, rhs^T)`` in fp32 rounded to lhs's dtype; ``drhs =
tgmm(lhs, dz)`` (per group ``lhs^T @ dz``) in fp32 rounded to rhs's
dtype; ``dbias`` the per-group column sums of ``dz`` in fp32; a group
whose size is not positive gets a zero ``drhs`` and ``dbias``;
``group_sizes`` no gradient.

``csrc/gmm.cu`` holds the FFMA kernels (its source note says how they are
laid out): ``gmm_fused`` (with the optional ``z`` output), ``gmm``, ``tgmm``
and ``colsum`` (the bias gradient: tgmm's function on an all-ones lhs
column, not materialised). ``csrc/gmm_tc.cu`` holds the tensor-core
kernels: ``gmm_fused_tc`` (the forward and its ``z``, with the FFMA
kernel's epilogue), ``gmm_tc`` and ``tgmm_tc`` (wgmma on bf16 tiles fed
by TMA) and ``split``, which cuts an fp32 ``dout`` into three bf16
pieces whose sum is exactly ``dout``, so each piece's product with a
bf16 operand is exact in fp32. ``gmm`` and ``tgmm`` choose their kernel by ``tc_pieces``, a
fixed rule of dtypes and shapes: the tensor-core kernels when the operand
that is not ``dout`` is bf16 and every row TMA reads is a multiple of 16
bytes from a 16-byte-aligned pointer (``dout`` in 1 piece if bf16, 3 if
fp32), the FFMA kernels otherwise; the forward chooses by
``fused_tc_route``: the tensor cores for bf16 lhs and rhs under the same
row rule and at least ``FUSED_TC_MIN_ROWS`` rows, the FFMA ``gmm_fused``
otherwise. The kernels are built with nvcc on first use
(``ops/_build.py``) and launched through ``ctypes`` on
PyTorch's current stream; they read group_sizes on the device, so a call
never synchronises with the host. Every wrapper takes the kernel for CUDA
tensors and the plain version for CPU tensors; for a CUDA tensor it
launches or raises, with no fallback. Each launch adds one to
``launch_count(kernel, dtype)``, kernel one of ``KERNELS`` (``fused``
and ``fused_z`` are the FFMA forward without and with the ``z`` output,
``fused_tc`` and ``fused_z_tc`` the tensor-core one; ``gmm``/``tgmm``
the FFMA route of the backward, ``gmm_tc``/``tgmm_tc``/``split`` the
tensor-core one) and dtype lhs's (``split``'s: its input's). The forward
writes ``z`` only on the gelu path of a call made with grad enabled on an
input that requires grad; a no-grad call (prefill, decode, serving,
eval) does not.
"""

from __future__ import annotations

import collections
import ctypes

import torch
import torch.nn.functional as F

from cs744_pytorch_distributed_tutorial_tpu_torch.ops import _cost
from cs744_pytorch_distributed_tutorial_tpu_torch.ops._build import load_library

SOURCE = "gmm.cu"
TC_SOURCE = "gmm_tc.cu"
SOURCES = (SOURCE, TC_SOURCE)
KERNELS = ("fused", "fused_z", "fused_tc", "fused_z_tc", "gmm", "tgmm", "colsum", "gmm_tc",
           "tgmm_tc", "split")
ACTIVATIONS = ("none", "gelu")
IMPLS = ("pallas", "ragged")
# The fewest rows of a forward that take the tensor cores. A prefill (4,096
# routed rows at batch 16) and a training step (32,768) do, and so does a
# decode step (32 rows over 8 experts): chip_smoke.py's paired runs of both
# routes found the 128-row tensor-core tile no slower there than the FFMA
# kernel's 8 x 32 tile (PERF.md, gmm_fused row).
FUSED_TC_MIN_ROWS = 1

_DTYPES = (torch.float32, torch.bfloat16)
_launches: collections.Counter = collections.Counter()  # (kernel, lhs dtype) -> count
_kernel_fns = None  # {kernel: C entry point}, set up once


def launch_count(kernel: str | None = None, dtype: torch.dtype | None = None) -> int:
    """Kernel launches since the last ``reset_launch_count()``: all of
    them, or those of one kernel of ``KERNELS`` and/or lhs dtype."""
    return sum(
        n for (k, d), n in _launches.items()
        if (kernel is None or k == kernel) and (dtype is None or d == dtype)
    )


def reset_launch_count() -> None:
    _launches.clear()


def bind(lib: ctypes.CDLL, tc: ctypes.CDLL) -> dict:
    """The C entry points of a build of ``gmm.cu`` (``lib``) and of
    ``gmm_tc.cu`` (``tc``) by kernel name (``fused`` for ``gmm_fused``),
    their argument types set."""
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    # lhs, rhs, bias, group_sizes, out, z, M, K, N, E, gelu, in_bf16, out_bf16, stream
    lib.gmm_fused.argtypes = [p, p, p, p, p, p, i64, i64, i64, i64, i64, i64, i64, p]
    # lhs, rhs, group_sizes, out, M, K, N, E, lhs_bf16, rhs_bf16, trans_rhs, stream
    lib.gmm.argtypes = [p, p, p, p, i64, i64, i64, i64, i64, i64, i64, p]
    # lhs, dout, group_sizes, out, M, K, N, E, lhs_bf16, stream
    lib.tgmm.argtypes = [p, p, p, p, i64, i64, i64, i64, i64, p]
    # dout, group_sizes, out, M, N, E, stream
    lib.colsum.argtypes = [p, p, p, i64, i64, i64, p]
    # a, rhs, group_sizes, out, M, K, N, E, pieces, rhs_mn_major, stream
    tc.gmm_tc.argtypes = [p, p, p, p, i64, i64, i64, i64, i64, i64, p]
    # lhs, b, group_sizes, out, M, K, N, E, pieces, stream
    tc.tgmm_tc.argtypes = [p, p, p, p, i64, i64, i64, i64, i64, p]
    # x, out, n, stream
    tc.split_bf16.argtypes = [p, p, i64, p]
    # lhs, rhs, bias, group_sizes, out, z, M, K, N, E, gelu, out_bf16, stream
    tc.gmm_fused_tc.argtypes = [p, p, p, p, p, p, i64, i64, i64, i64, i64, i64, p]
    fns = {"fused": lib.gmm_fused, "gmm": lib.gmm, "tgmm": lib.tgmm, "colsum": lib.colsum,
           "fused_tc": tc.gmm_fused_tc, "gmm_tc": tc.gmm_tc, "tgmm_tc": tc.tgmm_tc,
           "split": tc.split_bf16}
    for fn in fns.values():
        fn.restype = ctypes.c_int
    return fns


def load_kernel():
    """Build (first call) and load the kernels of ``SOURCES``; returns
    their C entry points by kernel name (``bind``)."""
    global _kernel_fns
    if _kernel_fns is None:
        _kernel_fns = bind(load_library(SOURCE), load_library(TC_SOURCE))
    return _kernel_fns


# ------------------------------------------------------------ plain versions
def _bounds(group_sizes: torch.Tensor, m: int) -> list[int]:
    """The E + 1 row offsets of the groups, read on the host: clamped to
    M, the last group running to M."""
    ends = torch.cumsum(group_sizes.long(), 0).clamp(max=m)
    ends[-1] = m
    return [0] + ends.tolist()


def grouped_matmul_fused_plain(lhs: torch.Tensor, rhs: torch.Tensor, bias: torch.Tensor,
                               group_sizes: torch.Tensor, *, activation: str = "none",
                               out_dtype: torch.dtype | None = None, with_z: bool = False):
    """The forward kernel's function in plain PyTorch: a loop over the
    groups, each an fp32 matrix product plus the fp32 bias (and gelu),
    rounded once to ``out_dtype``. With ``with_z`` returns ``(out, z)``,
    z the pre-activation rounded to ``out_dtype``."""
    m, n = lhs.shape[0], rhs.shape[2]
    out = torch.empty((m, n), dtype=out_dtype or lhs.dtype, device=lhs.device)
    z = torch.empty_like(out) if with_z else None
    bounds = _bounds(group_sizes, m)
    for g in range(rhs.shape[0]):
        lo, hi = bounds[g], bounds[g + 1]
        if hi <= lo:
            continue
        val = lhs[lo:hi].float() @ rhs[g].float() + bias[g].float()
        if with_z:
            z[lo:hi] = val.to(z.dtype)
        if activation == "gelu":
            val = F.gelu(val, approximate="tanh")
        out[lo:hi] = val.to(out.dtype)
    return (out, z) if with_z else out


def grouped_matmul_plain(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor, *,
                         trans_rhs: bool = False) -> torch.Tensor:
    """``gmm``'s function: ``lhs[r] @ rhs[g(r)]`` [M, N] in fp32 (with
    ``trans_rhs``, rhs is [E, N, K] and its transpose is taken), a loop
    over the groups."""
    m = lhs.shape[0]
    n = rhs.shape[1] if trans_rhs else rhs.shape[2]
    out = torch.empty((m, n), dtype=torch.float32, device=lhs.device)
    bounds = _bounds(group_sizes, m)
    for g in range(rhs.shape[0]):
        lo, hi = bounds[g], bounds[g + 1]
        if hi > lo:
            w = rhs[g].float()
            out[lo:hi] = lhs[lo:hi].float() @ (w.t() if trans_rhs else w)
    return out


def tgmm_plain(lhs: torch.Tensor, dout: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """``tgmm``'s function: per group, ``lhs[rows]^T @ dout[rows]`` [E, K,
    N] in fp32, zero for a group whose size is not positive. Each sum runs
    over the group's rows in order: step i adds every group's i-th row's
    outer product at once (a zero row where a group has fewer rows)."""
    m, k = lhs.shape
    e, n = group_sizes.shape[0], dout.shape[1]
    out = torch.zeros((e, k, n), dtype=torch.float32, device=lhs.device)
    bounds, sizes = _bounds(group_sizes, m), group_sizes.tolist()
    live = [g for g in range(e) if sizes[g] > 0 and bounds[g + 1] > bounds[g]]
    steps = max((bounds[g + 1] - bounds[g] for g in live), default=0)
    if not steps:
        return out
    # rows[i, g]: group g's i-th row, or M (a zero row) past its end.
    rows = torch.full((steps, e), m, dtype=torch.long)
    for g in live:
        rows[: bounds[g + 1] - bounds[g], g] = torch.arange(bounds[g], bounds[g + 1])
    rows = rows.to(lhs.device)
    lhs_z = torch.cat([lhs.float(), lhs.new_zeros((1, k), dtype=torch.float32)])
    dout_z = torch.cat([dout.float(), dout.new_zeros((1, n), dtype=torch.float32)])
    for i in range(steps):
        out.addcmul_(lhs_z[rows[i]][:, :, None], dout_z[rows[i]][:, None, :])
    return out


def segment_sum_rows_plain(dout: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """``colsum``'s function, the bias gradient: per group the column sums
    of ``dout`` [E, N] in fp32, as ``tgmm_plain`` on an all-ones [M, 1]
    lhs (the JAX ``_segment_sum_rows``)."""
    ones = torch.ones((dout.shape[0], 1), dtype=torch.float32, device=dout.device)
    return tgmm_plain(ones, dout, group_sizes)[:, 0]


def split_bf16_plain(x: torch.Tensor) -> torch.Tensor:
    """``split``'s function: the three bf16 pieces [3, *x.shape] of an
    fp32 ``x``, each rounded to nearest from the running remainder (h1 =
    bf16(x), h2 = bf16(x - h1), h3 = bf16(x - h1 - h2)). Each remainder is
    exact in fp32 and h1 + h2 + h3 == x (bits below bf16's subnormals
    aside), so a piece's product with a bf16 value is exact in fp32."""
    h1 = x.to(torch.bfloat16)
    r = x - h1.float()
    h2 = r.to(torch.bfloat16)
    return torch.stack([h1, h2, (r - h2.float()).to(torch.bfloat16)])


# --------------------------------------------------------------- route rule
def tc_pieces(dout_dtype: torch.dtype, other_dtype: torch.dtype, shape: tuple[int, int, int],
              aligned: bool = True) -> int:
    """The kernel a ``gmm``/``tgmm`` call on CUDA tensors takes: the number
    of bf16 pieces of ``dout`` the tensor-core kernels read (1 for a bf16
    ``dout``, 3 for an fp32 one), or 0 for the FFMA kernels. ``dout`` is
    the operand the backward differentiates by (``gmm``'s lhs, ``tgmm``'s
    dout; the forward's bf16 lhs counts as one piece), ``other`` the
    operand beside it; ``shape`` is (rows, k, n) with k and n the lengths
    of the rows TMA reads, and ``aligned`` whether those tensors start on
    16 bytes. The tensor-core kernels take the call when ``other`` is bf16,
    rows > 0, and k and n are positive multiples of 8 (rows of 16 bytes)."""
    rows, k, n = shape
    if (other_dtype != torch.bfloat16 or dout_dtype not in _DTYPES or not aligned or rows <= 0
            or k <= 0 or n <= 0 or k % 8 or n % 8):
        return 0
    return 1 if dout_dtype == torch.bfloat16 else 3


def fused_tc_route(dtype: torch.dtype, shape: tuple[int, int, int], aligned: bool = True) -> bool:
    """Whether a forward (``grouped_matmul_fused``) on CUDA tensors takes
    the tensor-core kernel ``gmm_fused_tc``: lhs and rhs of ``dtype``,
    ``shape`` (M, K, N), ``aligned`` whether lhs and rhs start on 16 bytes.
    True for bf16 with K and N positive multiples of 8 (the 16-byte rows TMA
    reads of lhs [M, K] and rhs [E, K, N]) and M at least
    ``FUSED_TC_MIN_ROWS``; fp32 operands and odd widths take the FFMA
    ``gmm_fused``. The output dtype (bf16 or fp32) and ``z`` do not
    matter."""
    m, k, n = shape
    return (dtype == torch.bfloat16 and aligned and m > 0 and m >= FUSED_TC_MIN_ROWS and k > 0
            and n > 0 and k % 8 == 0 and n % 8 == 0)


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


# ------------------------------------------------------------------ wrappers
def _check_groups(group_sizes: torch.Tensor, num_groups: int | None,
                  *tensors: torch.Tensor) -> None:
    """group_sizes [E] integers (E = num_groups when given), E >= 1, on one
    device with ``tensors``."""
    if group_sizes.dim() != 1 or num_groups not in (None, group_sizes.shape[0]):
        raise ValueError(f"group_sizes {tuple(group_sizes.shape)} != [num_groups {num_groups}]")
    if group_sizes.dtype.is_floating_point or group_sizes.dtype == torch.bool:
        raise TypeError(f"group_sizes must be integers, got {group_sizes.dtype}")
    if group_sizes.shape[0] < 1:
        raise ValueError("grouped_matmul needs at least one group")
    devices = {t.device for t in (group_sizes, *tensors)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    if group_sizes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"grouped_matmul: unsupported device {group_sizes.device}")


def _check_operands(lhs: torch.Tensor, rhs: torch.Tensor) -> None:
    """The JAX ``_check_gmm_shapes`` checks, plus what the kernels take."""
    if lhs.dim() != 2 or rhs.dim() != 3 or lhs.shape[1] != rhs.shape[1]:
        raise ValueError(f"grouped_matmul shapes: lhs {tuple(lhs.shape)}, rhs {tuple(rhs.shape)}")
    if lhs.dtype not in _DTYPES or rhs.dtype != lhs.dtype:
        raise TypeError(f"lhs and rhs must both be float32 or both bfloat16, got "
                        f"{lhs.dtype} and {rhs.dtype}")


def _check(lhs, rhs, bias, group_sizes, activation, out_dtype) -> None:
    _check_operands(lhs, rhs)
    if bias.shape != (rhs.shape[0], rhs.shape[2]):
        raise ValueError(f"bias {tuple(bias.shape)} != [groups, N] {(rhs.shape[0], rhs.shape[2])}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    if (out_dtype or lhs.dtype) not in _DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    _check_groups(group_sizes, rhs.shape[0], lhs, rhs, bias)


def _launch(kernel: str, name: str, lhs_dtype: torch.dtype, device, *args,
            cost: tuple[float, float]) -> None:
    """``cost``: the call's (FLOPs of its products, bytes read and
    written once), for ``_cost``."""
    stream = torch.cuda.current_stream(device).cuda_stream
    err = load_kernel()[kernel](*args, stream)
    _launches[(name, lhs_dtype)] += 1
    _cost.add(*cost)
    if err:
        raise RuntimeError(f"gmm {name} launch failed: CUDA error {err}")


def _nbytes(*tensors: torch.Tensor) -> float:
    return float(sum(t.numel() * t.element_size() for t in tensors))


def _sizes(group_sizes: torch.Tensor) -> torch.Tensor:
    return group_sizes.to(torch.int32).contiguous()


def _fused(lhs, rhs, bias, group_sizes, activation, out_dtype, with_z):
    """``(out, z or None)`` of the forward kernel, or of its plain version
    for CPU tensors; bias is fp32."""
    out_dtype = out_dtype or lhs.dtype
    if lhs.device.type == "cpu":
        res = grouped_matmul_fused_plain(lhs, rhs, bias, group_sizes, activation=activation,
                                         out_dtype=out_dtype, with_z=with_z)
        return res if with_z else (res, None)
    (m, k), (e, _, n) = lhs.shape, rhs.shape
    lhs, rhs, bias, gs = lhs.contiguous(), rhs.contiguous(), bias.contiguous(), _sizes(group_sizes)
    out = torch.empty((m, n), dtype=out_dtype, device=lhs.device)
    z = torch.empty_like(out) if with_z else None
    if not (m and n):
        return out, z
    name = "fused_z" if with_z else "fused"
    ptrs = (lhs.data_ptr(), rhs.data_ptr(), bias.data_ptr(), gs.data_ptr(), out.data_ptr(),
            z.data_ptr() if with_z else None, m, k, n, e, int(activation == "gelu"))
    out_bf16 = int(out_dtype == torch.bfloat16)
    cost = (2.0 * m * k * n, _nbytes(lhs, rhs, bias, gs) + (1 + with_z) * _nbytes(out))
    if fused_tc_route(lhs.dtype, (m, k, n), _aligned(lhs, rhs)):
        _launch("fused_tc", name + "_tc", lhs.dtype, lhs.device, *ptrs, out_bf16, cost=cost)
    else:
        _launch("fused", name, lhs.dtype, lhs.device, *ptrs, int(lhs.dtype == torch.bfloat16),
                out_bf16, cost=cost)
    return out, z


def gmm(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor, *,
        trans_rhs: bool = False, split: torch.Tensor | None = None) -> torch.Tensor:
    """``lhs[r] @ rhs[g(r)]`` [M, N] in fp32 (the TPU ``_gmm_kernel``):
    lhs and rhs of one dtype as stored, or with ``trans_rhs`` an fp32 or
    bf16 lhs [M, K] (widened exactly) against rhs [E, N, K] (fp32 or bf16)
    read transposed in place (the backward's ``dlhs = dout @ rhs^T``).
    ``split`` may hold ``split_bf16(lhs)``, made once for a backward whose
    ``tgmm`` reads the same pieces."""
    e = rhs.shape[0]
    k = rhs.shape[2] if trans_rhs else rhs.shape[1]
    n = rhs.shape[1] if trans_rhs else rhs.shape[2]
    if lhs.dim() != 2 or rhs.dim() != 3 or lhs.shape[1] != k:
        raise ValueError(f"gmm shapes: lhs {tuple(lhs.shape)}, rhs {tuple(rhs.shape)}, "
                         f"trans_rhs={trans_rhs}")
    if lhs.dtype not in _DTYPES or rhs.dtype not in _DTYPES or (
            not trans_rhs and lhs.dtype != rhs.dtype):
        raise TypeError(f"gmm takes an fp32 or bf16 lhs under a transposed rhs, or lhs and rhs "
                        f"of one dtype; got {lhs.dtype} and {rhs.dtype}, trans_rhs={trans_rhs}")
    _check_groups(group_sizes, e, lhs, rhs)
    _check_split(split, lhs)
    if lhs.device.type == "cpu":
        return grouped_matmul_plain(lhs, rhs, group_sizes, trans_rhs=trans_rhs)
    lhs, rhs, gs = lhs.contiguous(), rhs.contiguous(), _sizes(group_sizes)
    m = lhs.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=lhs.device)
    if not (m and n):
        return out
    pieces = tc_pieces(lhs.dtype, rhs.dtype, (m, k, n), _aligned(lhs, rhs))
    if pieces:
        a = lhs if pieces == 1 else (split if split is not None else split_bf16(lhs))
        _launch("gmm_tc", "gmm_tc", lhs.dtype, lhs.device, a.data_ptr(), rhs.data_ptr(),
                gs.data_ptr(), out.data_ptr(), m, k, n, e, pieces, int(not trans_rhs),
                cost=(2.0 * m * k * n, _nbytes(lhs, rhs, gs, out)))
    else:
        _gmm_ffma(lhs.float() if trans_rhs else lhs, rhs, gs, out, trans_rhs)
    return out


def _gmm_ffma(lhs, rhs, gs, out, trans_rhs: bool) -> None:
    """The FFMA ``gmm`` kernel into ``out`` (contiguous CUDA tensors, gs
    int32; under ``trans_rhs`` an fp32 lhs)."""
    (m, k), e, n = lhs.shape, rhs.shape[0], out.shape[1]
    _launch("gmm", "gmm", lhs.dtype, lhs.device, lhs.data_ptr(), rhs.data_ptr(), gs.data_ptr(),
            out.data_ptr(), m, k, n, e, int(lhs.dtype == torch.bfloat16),
            int(rhs.dtype == torch.bfloat16), int(trans_rhs),
            cost=(2.0 * m * k * n, _nbytes(lhs, rhs, gs, out)))


def tgmm(lhs: torch.Tensor, dout: torch.Tensor, group_sizes: torch.Tensor, *,
         split: torch.Tensor | None = None) -> torch.Tensor:
    """Per group ``lhs[rows]^T @ dout[rows]`` [E, K, N] in fp32 (the TPU
    ``_tgmm_kernel``; rhs's gradient), lhs [M, K] and dout [M, N] each
    fp32 or bf16 (widened exactly); zero for a group whose size is not
    positive. ``split`` may hold ``split_bf16(dout)``."""
    if lhs.dim() != 2 or dout.dim() != 2 or lhs.shape[0] != dout.shape[0]:
        raise ValueError(f"tgmm shapes: lhs {tuple(lhs.shape)}, dout {tuple(dout.shape)}")
    if lhs.dtype not in _DTYPES or dout.dtype not in _DTYPES:
        raise TypeError(f"tgmm takes an fp32 or bf16 lhs and dout, got {lhs.dtype} and "
                        f"{dout.dtype}")
    _check_groups(group_sizes, None, lhs, dout)
    _check_split(split, dout)
    if lhs.device.type == "cpu":
        return tgmm_plain(lhs, dout, group_sizes)
    lhs, dout, gs = lhs.contiguous(), dout.contiguous(), _sizes(group_sizes)
    (m, k), n, e = lhs.shape, dout.shape[1], group_sizes.shape[0]
    out = torch.empty((e, k, n), dtype=torch.float32, device=lhs.device)
    if not (k and n):
        return out
    pieces = tc_pieces(dout.dtype, lhs.dtype, (m, k, n), _aligned(lhs, dout))
    if pieces:
        b = dout if pieces == 1 else (split if split is not None else split_bf16(dout))
        _launch("tgmm_tc", "tgmm_tc", lhs.dtype, lhs.device, lhs.data_ptr(), b.data_ptr(),
                gs.data_ptr(), out.data_ptr(), m, k, n, e, pieces,
                cost=(2.0 * m * k * n, _nbytes(lhs, dout, gs, out)))
    else:
        _tgmm_ffma(lhs, dout.float(), gs, out)
    return out


def _tgmm_ffma(lhs, dout, gs, out) -> None:
    """The FFMA ``tgmm`` kernel into ``out`` (contiguous CUDA tensors, an
    fp32 dout, gs int32)."""
    (m, k), n, e = lhs.shape, dout.shape[1], gs.shape[0]
    _launch("tgmm", "tgmm", lhs.dtype, lhs.device, lhs.data_ptr(), dout.data_ptr(),
            gs.data_ptr(), out.data_ptr(), m, k, n, e, int(lhs.dtype == torch.bfloat16),
            cost=(2.0 * m * k * n, _nbytes(lhs, dout, gs, out)))


def split_bf16(x: torch.Tensor) -> torch.Tensor:
    """The three bf16 pieces [3, *x.shape] of an fp32 ``x`` (see
    ``split_bf16_plain``): the ``split`` kernel for a CUDA tensor, the plain
    version for a CPU one."""
    if x.dtype != torch.float32:
        raise TypeError(f"split_bf16 takes an fp32 tensor, got {x.dtype}")
    if x.device.type == "cpu":
        return split_bf16_plain(x)
    x = x.contiguous()
    out = torch.empty((3, *x.shape), dtype=torch.bfloat16, device=x.device)
    if x.numel():
        _launch("split", "split", x.dtype, x.device, x.data_ptr(), out.data_ptr(), x.numel(),
                cost=(0.0, _nbytes(x, out)))
    return out


def _check_split(split: torch.Tensor | None, dout: torch.Tensor) -> None:
    if split is not None and (split.shape != (3, *dout.shape) or split.dtype != torch.bfloat16
                              or dout.dtype != torch.float32 or split.device != dout.device):
        raise ValueError(f"split must be split_bf16 of the fp32 {tuple(dout.shape)} operand, got "
                         f"{tuple(split.shape)} {split.dtype}")


def segment_sum_rows(dout: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """Per group the column sums of ``dout`` [M, N] fp32, [E, N] in fp32
    (the bias gradient; the TPU package's ``_segment_sum_rows``, a
    ``_tgmm_kernel`` on an all-ones lhs); zero for a group whose size is
    not positive."""
    if dout.dim() != 2 or dout.dtype != torch.float32:
        raise ValueError(f"segment_sum_rows takes an fp32 dout [M, N], got "
                         f"{tuple(dout.shape)} {dout.dtype}")
    _check_groups(group_sizes, None, dout)
    if dout.device.type == "cpu":
        return segment_sum_rows_plain(dout, group_sizes)
    dout, gs = dout.contiguous(), _sizes(group_sizes)
    (m, n), e = dout.shape, group_sizes.shape[0]
    out = torch.empty((e, n), dtype=torch.float32, device=dout.device)
    if n:
        _launch("colsum", "colsum", dout.dtype, dout.device, dout.data_ptr(), gs.data_ptr(),
                out.data_ptr(), m, n, e, cost=(0.0, _nbytes(dout, gs, out)))
    return out


# ------------------------------------------------------------------ autograd
def _backward(needs, lhs, rhs, group_sizes, dz, with_bias: bool):
    """The JAX ``_gmm_bwd_core`` on ``dz`` (fp32; or bf16 as the output's
    gradient came, which ``gmm`` and ``tgmm`` widen exactly): (dlhs,
    drhs[, dbias]), None where no gradient is needed. An fp32 ``dz`` that
    both take in three pieces is split once."""
    m, k, n = lhs.shape[0], rhs.shape[1], rhs.shape[2]
    split = None
    if dz.device.type == "cuda" and needs[0] and needs[1] and (
            tc_pieces(dz.dtype, rhs.dtype, (m, n, k)) == tc_pieces(dz.dtype, lhs.dtype, (m, k, n))
            == 3):
        split = split_bf16(dz)
    dlhs = gmm(dz, rhs, group_sizes, trans_rhs=True, split=split).to(lhs.dtype) if needs[0] \
        else None
    drhs = tgmm(lhs, dz, group_sizes, split=split).to(rhs.dtype) if needs[1] else None
    if not with_bias:
        return dlhs, drhs
    return dlhs, drhs, segment_sum_rows(dz.float(), group_sizes) if needs[2] else None


class _GroupedMatmulFused(torch.autograd.Function):
    """The forward kernel (writing ``z`` on the differentiated gelu path)
    and the backward ``gmm``/``tgmm``/``colsum`` kernels; their plain
    versions for CPU tensors."""

    @staticmethod
    def forward(ctx, lhs, rhs, bias, group_sizes, activation, out_dtype, grad_mode):
        # needs_input_grad reads requires_grad, not the grad mode the call
        # was made in (a no-grad decode step still sees parameters).
        with_z = activation == "gelu" and grad_mode and any(ctx.needs_input_grad[:3])
        out, z = _fused(lhs, rhs, bias, group_sizes, activation, out_dtype, with_z)
        ctx.save_for_backward(lhs, rhs, group_sizes, z)
        ctx.activation = activation
        return out

    @staticmethod
    def backward(ctx, g):
        lhs, rhs, group_sizes, z = ctx.saved_tensors
        dz = g
        if ctx.activation == "gelu":
            # jax.nn.gelu's tanh form differentiated at z as stored (the
            # output dtype), in fp32.
            dz = torch.ops.aten.gelu_backward(g.float(), z.float(), approximate="tanh")
        grads = _backward(ctx.needs_input_grad, lhs, rhs, group_sizes, dz, with_bias=True)
        return (*grads, None, None, None, None)


class _GroupedMatmul(torch.autograd.Function):
    """``gmm`` forward in fp32; its backward ``gmm``/``tgmm``."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes):
        ctx.save_for_backward(lhs, rhs, group_sizes)
        return gmm(lhs, rhs, group_sizes)

    @staticmethod
    def backward(ctx, g):
        lhs, rhs, group_sizes = ctx.saved_tensors
        grads = _backward(ctx.needs_input_grad, lhs, rhs, group_sizes, g, with_bias=False)
        return (*grads, None)


def grouped_matmul_fused(lhs: torch.Tensor, rhs: torch.Tensor, bias: torch.Tensor,
                         group_sizes: torch.Tensor, *, activation: str = "none",
                         out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``act(lhs[r] @ rhs[g(r)] + bias[g(r)])`` [M, N] in ``out_dtype``
    (default lhs's dtype), through the CUDA kernels for CUDA tensors and
    the plain versions for CPU tensors; differentiable in lhs, rhs and
    bias."""
    _check(lhs, rhs, bias, group_sizes, activation, out_dtype)
    return _GroupedMatmulFused.apply(lhs, rhs, bias.float(), group_sizes, activation, out_dtype,
                                     torch.is_grad_enabled())


def ragged_dot(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """XLA's ``lax.ragged_dot`` (the JAX ``grouped_matmul(impl="ragged")``)
    in plain PyTorch: ``lhs[r] @ rhs[g(r)]`` [M, N], each group's product
    summed in fp32 and rounded to lhs's dtype, so a bias or a gelu after it
    sees the rounded value, as on JAX's CPU path. Unlike ``impl="pallas"``,
    the rows from ``sum(group_sizes)`` to M are zeros (ragged_dot's), and
    a group running past M is cut there. Differentiable in lhs and rhs
    through autograd.

    A loop over the groups, whose row offsets it reads on the host: on a
    card each call synchronises with the host once. XLA computes
    ragged_dot with no Pallas kernel, and so this is no port of one: rows
    11-13's kernels stay behind ``impl="pallas"``."""
    _check_operands(lhs, rhs)
    _check_groups(group_sizes, rhs.shape[0], lhs, rhs)
    m, n = lhs.shape[0], rhs.shape[2]
    ends = torch.cumsum(group_sizes.long(), 0).clamp(0, m).tolist()
    parts, lo = [], 0
    for g, end in enumerate(ends):
        if end > lo:
            parts.append((lhs[lo:end].float() @ rhs[g].float()).to(lhs.dtype))
            lo = end
    if lo < m:
        parts.append(lhs.new_zeros((m - lo, n)))
    return torch.cat(parts) if parts else lhs.new_zeros((0, n))


def grouped_matmul(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor, *,
                   impl: str = "pallas") -> torch.Tensor:
    """``lhs[r] @ rhs[g(r)]`` [M, N] summed in fp32 and rounded to lhs's
    dtype (the JAX ``grouped_matmul``), differentiable in lhs and rhs:
    ``impl="pallas"`` through the CUDA kernels (their plain versions for
    CPU tensors), ``impl="ragged"`` through ``ragged_dot``."""
    if impl not in IMPLS:
        raise ValueError(f"unknown grouped_matmul impl {impl!r}")
    if impl == "ragged":
        return ragged_dot(lhs, rhs, group_sizes)
    _check_operands(lhs, rhs)
    _check_groups(group_sizes, rhs.shape[0], lhs, rhs)
    return _GroupedMatmul.apply(lhs, rhs, group_sizes).to(lhs.dtype)
