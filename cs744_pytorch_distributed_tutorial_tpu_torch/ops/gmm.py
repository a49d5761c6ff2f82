"""Grouped matrix product with a fused per-group bias (and gelu), the
compute core of dropless MoE: the CUDA kernel's wrapper, its plain
PyTorch version, and the forward-only autograd Function around them.

Port of the forward of the JAX package's ``ops/gmm.py::
grouped_matmul_fused``::

    out[r] = act(lhs[r] @ rhs[g(r)] + bias[g(r)])

with lhs [M, K], rhs [E, K, N] (one dtype, fp32 or bf16), bias [E, N]
(cast to fp32), group_sizes an integer [E] tensor on lhs's device and
rows in contiguous groups (group e holds the next ``group_sizes[e]``
rows; rows from ``sum(group_sizes)`` to M belong to the last group, as
the TPU wrapper's padding does). The products are summed in fp32, the
bias is added and the gelu (tanh form, ``jax.nn.gelu``'s default)
applied in fp32, and the result is rounded once to ``out_dtype``
(default lhs's dtype), as the TPU kernel ``_gmm_fused_kernel`` does.

``csrc/gmm.cu`` holds the kernel (its source note says how it is laid
out), built with nvcc on first use (``ops/_build.py``) and launched
through ``ctypes`` on PyTorch's current stream. It reads group_sizes on
the device: a call never synchronises with the host. The wrapper takes
the kernel for CUDA tensors and the plain version for CPU tensors; for a
CUDA tensor it launches or raises, with no fallback. Each launch adds
one to ``launch_count(dtype)``.

The backward (the TPU kernels ``_gmm_kernel`` and ``_tgmm_kernel``, and
the ``with_z`` pre-activation output) is not ported yet: on CUDA the
backward raises ``NotImplementedError``. On the CPU the plain version is
differentiable by autograd.
"""

from __future__ import annotations

import collections
import ctypes

import torch
import torch.nn.functional as F

from cs744_pytorch_distributed_tutorial_tpu_torch.ops._build import load_library

SOURCE = "gmm.cu"
ACTIVATIONS = ("none", "gelu")
MAX_GROUPS = 64  # the kernel keeps the group offsets in shared memory

_DTYPES = (torch.float32, torch.bfloat16)
_launches: collections.Counter = collections.Counter()  # lhs dtype -> count
_kernel_fn = None


def launch_count(dtype: torch.dtype | None = None) -> int:
    """Kernel launches since the last ``reset_launch_count()``: all of
    them, or those on lhs of one dtype."""
    return sum(n for d, n in _launches.items() if dtype is None or d == dtype)


def reset_launch_count() -> None:
    _launches.clear()


def load_kernel():
    """Build (first call) and load the kernel; returns its C entry point."""
    global _kernel_fn
    if _kernel_fn is None:
        fn = load_library(SOURCE).gmm_fused
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        # lhs, rhs, bias, group_sizes, out, M, K, N, E, gelu, in_bf16, out_bf16, stream
        fn.argtypes = [p, p, p, p, p, i64, i64, i64, i64, i64, i64, i64, p]
        fn.restype = ctypes.c_int
        _kernel_fn = fn
    return _kernel_fn


def grouped_matmul_fused_plain(lhs: torch.Tensor, rhs: torch.Tensor, bias: torch.Tensor,
                               group_sizes: torch.Tensor, *, activation: str = "none",
                               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: a loop over the groups
    with their row offsets read on the host, each an fp32 matrix product
    plus the fp32 bias (and gelu), rounded once to ``out_dtype``."""
    m, n = lhs.shape[0], rhs.shape[2]
    out = torch.empty((m, n), dtype=out_dtype or lhs.dtype, device=lhs.device)
    ends = torch.cumsum(group_sizes.long(), 0).clamp(max=m)
    ends[-1] = m  # rows past the sum belong to the last group
    bounds = [0] + ends.tolist()
    for g in range(rhs.shape[0]):
        lo, hi = bounds[g], bounds[g + 1]
        if hi <= lo:
            continue
        val = lhs[lo:hi].float() @ rhs[g].float() + bias[g].float()
        if activation == "gelu":
            val = F.gelu(val, approximate="tanh")
        out[lo:hi] = val.to(out.dtype)
    return out


def _check(lhs, rhs, bias, group_sizes, activation, out_dtype) -> None:
    """The JAX ``_check_gmm_shapes`` and ``grouped_matmul_fused`` checks,
    plus what the kernel takes."""
    if lhs.dim() != 2 or rhs.dim() != 3 or lhs.shape[1] != rhs.shape[1]:
        raise ValueError(f"grouped_matmul shapes: lhs {tuple(lhs.shape)}, rhs {tuple(rhs.shape)}")
    if group_sizes.shape != (rhs.shape[0],):
        raise ValueError(f"group_sizes {tuple(group_sizes.shape)} != [num_groups {rhs.shape[0]}]")
    if bias.shape != (rhs.shape[0], rhs.shape[2]):
        raise ValueError(f"bias {tuple(bias.shape)} != [groups, N] {(rhs.shape[0], rhs.shape[2])}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    if lhs.dtype not in _DTYPES or rhs.dtype != lhs.dtype:
        raise TypeError(f"lhs and rhs must both be float32 or both bfloat16, got "
                        f"{lhs.dtype} and {rhs.dtype}")
    if (out_dtype or lhs.dtype) not in _DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if group_sizes.dtype.is_floating_point or group_sizes.dtype == torch.bool:
        raise TypeError(f"group_sizes must be integers, got {group_sizes.dtype}")
    if not 1 <= rhs.shape[0] <= MAX_GROUPS:
        raise ValueError(f"grouped_matmul takes 1 to {MAX_GROUPS} groups, got {rhs.shape[0]}")
    devices = {t.device for t in (lhs, rhs, bias, group_sizes)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    if lhs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"grouped_matmul_fused: unsupported device {lhs.device}")


class _GroupedMatmulFused(torch.autograd.Function):
    """The kernel's forward on CUDA tensors (checked by the caller); the
    backward is not ported yet."""

    @staticmethod
    def forward(ctx, lhs, rhs, bias, group_sizes, activation, out_dtype):
        m, k = lhs.shape
        e, _, n = rhs.shape
        out_dtype = out_dtype or lhs.dtype
        lhs, rhs = lhs.contiguous(), rhs.contiguous()
        bias = bias.float().contiguous()
        gs = group_sizes.to(torch.int32).contiguous()
        out = torch.empty((m, n), dtype=out_dtype, device=lhs.device)
        if m and n:
            stream = torch.cuda.current_stream(lhs.device).cuda_stream
            err = load_kernel()(lhs.data_ptr(), rhs.data_ptr(), bias.data_ptr(), gs.data_ptr(),
                                out.data_ptr(), m, k, n, e, int(activation == "gelu"),
                                int(lhs.dtype == torch.bfloat16),
                                int(out_dtype == torch.bfloat16), stream)
            _launches[lhs.dtype] += 1
            if err:
                raise RuntimeError(f"gmm_fused launch failed: CUDA error {err}")
        return out

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "grouped_matmul_fused backward (the TPU kernels _gmm_kernel and _tgmm_kernel, "
            "and the with_z output) is not yet ported"
        )


def grouped_matmul_fused(lhs: torch.Tensor, rhs: torch.Tensor, bias: torch.Tensor,
                         group_sizes: torch.Tensor, *, activation: str = "none",
                         out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``act(lhs[r] @ rhs[g(r)] + bias[g(r)])`` [M, N] in ``out_dtype``
    (default lhs's dtype), through the CUDA kernel for CUDA tensors and
    the plain version for CPU tensors."""
    _check(lhs, rhs, bias, group_sizes, activation, out_dtype)
    if lhs.device.type == "cpu":
        return grouped_matmul_fused_plain(lhs, rhs, bias, group_sizes, activation=activation,
                                          out_dtype=out_dtype)
    return _GroupedMatmulFused.apply(lhs, rhs, bias, group_sizes, activation, out_dtype)
