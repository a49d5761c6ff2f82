"""Grouped matrix products, the compute core of dropless MoE: the CUDA
kernels' wrappers, their plain PyTorch versions, and the autograd
Functions that join them.

Port of the JAX package's ``ops/gmm.py``, with its Pallas path
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
``grouped_matmul`` rounds its fp32 result to lhs's dtype.

The backward is the JAX ``_gmm_bwd_core``, with its rounding points:
``dout`` cast to fp32 (on the gelu path ``dz = dout * gelu'(z)`` in fp32,
from the pre-activation ``z`` stored in the output dtype by the forward);
``dlhs = gmm(dz, rhs^T)`` in fp32 rounded to lhs's dtype; ``drhs =
tgmm(lhs, dz)`` (per group ``lhs^T @ dz``) in fp32 rounded to rhs's
dtype; ``dbias`` the per-group column sums of ``dz`` in fp32; a group
whose size is not positive gets a zero ``drhs`` and ``dbias``;
``group_sizes`` no gradient.

``csrc/gmm.cu`` holds the kernels (its source note says how they are laid
out): ``gmm_fused`` (with the optional ``z`` output), ``gmm``, ``tgmm``
and ``colsum`` (the bias gradient: tgmm's function on an all-ones lhs
column, not materialised). They are built with nvcc on first use
(``ops/_build.py``) and launched through ``ctypes`` on PyTorch's current
stream; they read group_sizes on the device, so a call never
synchronises with the host. Every wrapper takes the kernel for CUDA
tensors and the plain version for CPU tensors; for a CUDA tensor it
launches or raises, with no fallback. Each launch adds one to
``launch_count(kernel, dtype)``, kernel one of ``KERNELS`` (``fused``
and ``fused_z`` are the forward without and with the ``z`` output) and
dtype lhs's. The forward writes ``z`` only on the gelu path of a call
made with grad enabled on an input that requires grad; a no-grad call
(prefill, decode, serving, eval) does not.
"""

from __future__ import annotations

import collections
import ctypes

import torch
import torch.nn.functional as F

from cs744_pytorch_distributed_tutorial_tpu_torch.ops._build import load_library

SOURCE = "gmm.cu"
KERNELS = ("fused", "fused_z", "gmm", "tgmm", "colsum")
ACTIVATIONS = ("none", "gelu")
IMPLS = ("pallas", "ragged")
MAX_GROUPS = 64  # the kernels keep the group offsets in shared memory

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


def load_kernel():
    """Build (first call) and load the kernels; returns their C entry
    points ``{"fused": gmm_fused, "gmm": gmm, "tgmm": tgmm, "colsum":
    colsum}``."""
    global _kernel_fns
    if _kernel_fns is None:
        lib = load_library(SOURCE)
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        # lhs, rhs, bias, group_sizes, out, z, M, K, N, E, gelu, in_bf16, out_bf16, stream
        lib.gmm_fused.argtypes = [p, p, p, p, p, p, i64, i64, i64, i64, i64, i64, i64, p]
        # lhs, rhs, group_sizes, out, M, K, N, E, lhs_bf16, rhs_bf16, trans_rhs, stream
        lib.gmm.argtypes = [p, p, p, p, i64, i64, i64, i64, i64, i64, i64, p]
        # lhs, dout, group_sizes, out, M, K, N, E, lhs_bf16, stream
        lib.tgmm.argtypes = [p, p, p, p, i64, i64, i64, i64, i64, p]
        # dout, group_sizes, out, M, N, E, stream
        lib.colsum.argtypes = [p, p, p, i64, i64, i64, p]
        fns = {"fused": lib.gmm_fused, "gmm": lib.gmm, "tgmm": lib.tgmm, "colsum": lib.colsum}
        for fn in fns.values():
            fn.restype = ctypes.c_int
        _kernel_fns = fns
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


# ------------------------------------------------------------------ wrappers
def _check_groups(group_sizes: torch.Tensor, num_groups: int | None,
                  *tensors: torch.Tensor) -> None:
    """group_sizes [E] integers (E = num_groups when given), 1 <= E <=
    MAX_GROUPS, on one device with ``tensors``."""
    if group_sizes.dim() != 1 or num_groups not in (None, group_sizes.shape[0]):
        raise ValueError(f"group_sizes {tuple(group_sizes.shape)} != [num_groups {num_groups}]")
    if group_sizes.dtype.is_floating_point or group_sizes.dtype == torch.bool:
        raise TypeError(f"group_sizes must be integers, got {group_sizes.dtype}")
    num_groups = group_sizes.shape[0]
    if not 1 <= num_groups <= MAX_GROUPS:
        raise ValueError(f"grouped_matmul takes 1 to {MAX_GROUPS} groups, got {num_groups} "
                         "(the CUDA kernels keep the group offsets in shared memory)")
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


def _launch(kernel: str, name: str, lhs_dtype: torch.dtype, device, *args) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    err = load_kernel()[kernel](*args, stream)
    _launches[(name, lhs_dtype)] += 1
    if err:
        raise RuntimeError(f"gmm {name} launch failed: CUDA error {err}")


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
    if m and n:
        _launch("fused", "fused_z" if with_z else "fused", lhs.dtype, lhs.device,
                lhs.data_ptr(), rhs.data_ptr(), bias.data_ptr(), gs.data_ptr(),
                out.data_ptr(), z.data_ptr() if with_z else None, m, k, n, e,
                int(activation == "gelu"), int(lhs.dtype == torch.bfloat16),
                int(out_dtype == torch.bfloat16))
    return out, z


def gmm(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor, *,
        trans_rhs: bool = False) -> torch.Tensor:
    """``lhs[r] @ rhs[g(r)]`` [M, N] in fp32 (the TPU ``_gmm_kernel``):
    lhs and rhs of one dtype as stored, or with ``trans_rhs`` an fp32 lhs
    [M, K] against rhs [E, N, K] (fp32 or bf16) read transposed in place
    (the backward's ``dlhs = dout @ rhs^T``)."""
    e = rhs.shape[0]
    k = rhs.shape[2] if trans_rhs else rhs.shape[1]
    n = rhs.shape[1] if trans_rhs else rhs.shape[2]
    if lhs.dim() != 2 or rhs.dim() != 3 or lhs.shape[1] != k:
        raise ValueError(f"gmm shapes: lhs {tuple(lhs.shape)}, rhs {tuple(rhs.shape)}, "
                         f"trans_rhs={trans_rhs}")
    if lhs.dtype not in _DTYPES or rhs.dtype not in _DTYPES or (
            lhs.dtype != (torch.float32 if trans_rhs else rhs.dtype)):
        raise TypeError(f"gmm takes an fp32 lhs under a transposed rhs, or lhs and rhs of one "
                        f"dtype; got {lhs.dtype} and {rhs.dtype}, trans_rhs={trans_rhs}")
    _check_groups(group_sizes, e, lhs, rhs)
    if lhs.device.type == "cpu":
        return grouped_matmul_plain(lhs, rhs, group_sizes, trans_rhs=trans_rhs)
    lhs, rhs, gs = lhs.contiguous(), rhs.contiguous(), _sizes(group_sizes)
    m = lhs.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=lhs.device)
    if m and n:
        _launch("gmm", "gmm", lhs.dtype, lhs.device, lhs.data_ptr(), rhs.data_ptr(),
                gs.data_ptr(), out.data_ptr(), m, k, n, e,
                int(lhs.dtype == torch.bfloat16), int(rhs.dtype == torch.bfloat16),
                int(trans_rhs))
    return out


def tgmm(lhs: torch.Tensor, dout: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """Per group ``lhs[rows]^T @ dout[rows]`` [E, K, N] in fp32 (the TPU
    ``_tgmm_kernel``; rhs's gradient), lhs [M, K] fp32 or bf16, dout [M,
    N] fp32; zero for a group whose size is not positive."""
    if lhs.dim() != 2 or dout.dim() != 2 or lhs.shape[0] != dout.shape[0]:
        raise ValueError(f"tgmm shapes: lhs {tuple(lhs.shape)}, dout {tuple(dout.shape)}")
    if lhs.dtype not in _DTYPES or dout.dtype != torch.float32:
        raise TypeError(f"tgmm takes an fp32 or bf16 lhs and an fp32 dout, got {lhs.dtype} "
                        f"and {dout.dtype}")
    _check_groups(group_sizes, None, lhs, dout)
    if lhs.device.type == "cpu":
        return tgmm_plain(lhs, dout, group_sizes)
    lhs, dout, gs = lhs.contiguous(), dout.contiguous(), _sizes(group_sizes)
    (m, k), n, e = lhs.shape, dout.shape[1], group_sizes.shape[0]
    out = torch.empty((e, k, n), dtype=torch.float32, device=lhs.device)
    if k and n:
        _launch("tgmm", "tgmm", lhs.dtype, lhs.device, lhs.data_ptr(), dout.data_ptr(),
                gs.data_ptr(), out.data_ptr(), m, k, n, e,
                int(lhs.dtype == torch.bfloat16))
    return out


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
                out.data_ptr(), m, n, e)
    return out


# ------------------------------------------------------------------ autograd
def _backward(needs, lhs, rhs, group_sizes, dz, with_bias: bool):
    """The JAX ``_gmm_bwd_core`` on an fp32 ``dz``: (dlhs, drhs[, dbias]),
    None where no gradient is needed."""
    dlhs = gmm(dz, rhs, group_sizes, trans_rhs=True).to(lhs.dtype) if needs[0] else None
    drhs = tgmm(lhs, dz, group_sizes).to(rhs.dtype) if needs[1] else None
    if not with_bias:
        return dlhs, drhs
    return dlhs, drhs, segment_sum_rows(dz, group_sizes) if needs[2] else None


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
        dz = g.float()
        if ctx.activation == "gelu":
            # jax.nn.gelu's tanh form differentiated at z as stored (the
            # output dtype), in fp32.
            dz = torch.ops.aten.gelu_backward(dz, z.float(), approximate="tanh")
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
        grads = _backward(ctx.needs_input_grad, lhs, rhs, group_sizes, g.float(),
                          with_bias=False)
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


def grouped_matmul(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor, *,
                   impl: str = "pallas") -> torch.Tensor:
    """``lhs[r] @ rhs[g(r)]`` [M, N] summed in fp32 and rounded to lhs's
    dtype (the JAX ``grouped_matmul(impl="pallas")``), differentiable in
    lhs and rhs. ``impl="ragged"`` (``lax.ragged_dot``) is not ported."""
    if impl not in IMPLS:
        raise ValueError(f"unknown grouped_matmul impl {impl!r}")
    if impl == "ragged":
        raise NotImplementedError("grouped_matmul impl='ragged' (lax.ragged_dot) is not yet "
                                  "ported; impl='pallas' takes the CUDA kernels")
    _check_operands(lhs, rhs)
    _check_groups(group_sizes, rhs.shape[0], lhs, rhs)
    return _GroupedMatmul.apply(lhs, rhs, group_sizes).to(lhs.dtype)
