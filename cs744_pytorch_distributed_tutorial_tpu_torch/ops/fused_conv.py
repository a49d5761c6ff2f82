"""3x3 conv weight gradient: the CUDA kernel, its wrapper, its plain
PyTorch version, and the conv whose backward uses it.

Port of the JAX package's Pallas kernels ``ops/fused_conv.py::
_wgrad_kernel_s1`` and ``_wgrad_kernel_s2`` (reached through
``conv3x3_wgrad`` and the ``conv3x3`` custom VJP). For a 3x3 SAME conv,
NCHW here where the JAX package is NHWC:

    dW[k, c, ky, kx] = sum_{b,y,x} X[b, c, s*y+ky-p, s*x+kx-p] * G[b, k, y, x]

with p = 1 at stride 1 and p = 0 at stride 2: flax ``padding="SAME"`` on
a stride-2 3x3 conv over even H, W pads (0, 1), not (1, 1).

``csrc/fused_conv.cu`` is the kernel, one source for both strides:
bound by operations at ResNet-18's shapes, fp32 FFMA over register
tiles, the im2col gathered into shared memory only, M split over the
grid and summed in a fixed order (its source note says more). It is
built with nvcc on first use (``ops/_build.py``) and launched through
``ctypes`` on PyTorch's current stream.

``conv3x3_wgrad`` takes the kernel for CUDA tensors and the plain
version for CPU tensors; for a CUDA tensor it launches or raises, with
no fallback. Each launch adds one to ``launch_count()``.

``conv3x3`` leaves its forward and its data gradient to the library
convolution, as the JAX package leaves both to XLA; its weight gradient
is ``conv3x3_wgrad``.
"""

from __future__ import annotations

import collections
import ctypes

import torch
import torch.nn.functional as F

from cs744_pytorch_distributed_tutorial_tpu_torch.ops._build import load_library

SOURCE = "fused_conv.cu"

# SAME padding (top/left, bottom/right) of a 3x3 conv over even H, W.
PADS = {1: (1, 1), 2: (0, 1)}

_DTYPES = (torch.float32, torch.bfloat16)
_launches: collections.Counter = collections.Counter()  # (stride, dtype) -> count
_kernel_fns = None  # (splits query, launch) C entry points, set up once


def launch_count(stride: int | None = None, dtype: torch.dtype | None = None) -> int:
    """Kernel launches since the last ``reset_launch_count()``, all of them
    or those of one stride and/or input dtype."""
    return sum(
        n for (s, d), n in _launches.items()
        if (stride is None or s == stride) and (dtype is None or d == dtype)
    )


def reset_launch_count() -> None:
    _launches.clear()


def load_kernel():
    """Build (first call) and load the kernel; returns its C entry points
    ``(conv3x3_wgrad_splits, conv3x3_wgrad)``."""
    global _kernel_fns
    if _kernel_fns is None:
        lib = load_library(SOURCE)
        splits = lib.conv3x3_wgrad_splits
        splits.argtypes = [ctypes.c_int64] * 6
        splits.restype = ctypes.c_int64
        fn = lib.conv3x3_wgrad
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _kernel_fns = (splits, fn)
    return _kernel_fns


def conv3x3_wgrad_plain(x: torch.Tensor, g: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """The kernel's function in plain PyTorch: pad, ``unfold`` (columns
    in (c, ky, kx) order), one fp32 contraction with g over (b, y, x)."""
    x, g = x.float(), g.float()
    b, c = x.shape[:2]
    k = g.shape[1]
    lo, hi = PADS[stride]
    cols = F.unfold(F.pad(x, (lo, hi, lo, hi)), 3, stride=stride)  # [B, 9C, L]
    dw = torch.einsum("bkl,bnl->kn", g.reshape(b, k, -1), cols)
    return dw.reshape(k, c, 3, 3)


def _check(x: torch.Tensor, g: torch.Tensor, stride: int) -> None:
    if stride not in (1, 2):
        raise ValueError(f"stride {stride} unsupported (1 or 2)")
    if x.dim() != 4 or g.dim() != 4:
        raise ValueError(f"x and g must be 4-D NCHW, got {tuple(x.shape)} and {tuple(g.shape)}")
    b, _, h, w = x.shape
    gb, _, ho, wo = g.shape
    if gb != b or ho != h // stride or wo != w // stride:
        raise ValueError(
            f"cotangent shape {tuple(g.shape)} inconsistent with input "
            f"{tuple(x.shape)} at stride {stride} (expected [{b}, K, "
            f"{h // stride}, {w // stride}])"
        )
    if stride == 2 and (h % 2 or w % 2):
        raise ValueError("stride-2 wgrad needs even H, W")
    if x.dtype not in _DTYPES or g.dtype != x.dtype:
        raise TypeError(
            f"x and g must both be float32 or both bfloat16, got {x.dtype} and {g.dtype}"
        )
    if x.device != g.device:
        raise ValueError(f"x is on {x.device}, g is on {g.device}")


def conv3x3_wgrad(x: torch.Tensor, g: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Weight gradient of a 3x3 SAME conv (NCHW, no bias): returns
    ``dW [K, C, 3, 3]`` (OIHW) in fp32. ``x`` is the conv input
    [B, C, H, W], ``g`` the output cotangent [B, K, H/stride, W/stride]."""
    _check(x, g, stride)
    if x.device.type == "cpu":
        return conv3x3_wgrad_plain(x, g, stride)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_wgrad: unsupported device {x.device}")
    b, c, h, w = x.shape
    k = g.shape[1]
    if max(b * (h // stride) * (w // stride), x[0].numel(), g[0].numel()) >= 2**31:
        raise ValueError(f"conv3x3_wgrad: shape {tuple(x.shape)} exceeds 32-bit indexing")
    splits_fn, kernel = load_kernel()
    x, g = x.contiguous(), g.contiguous()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = splits_fn(b, c, k, h // stride, w // stride, sms)
    out = torch.empty((k, c, 3, 3), dtype=torch.float32, device=x.device)
    work = (
        torch.empty((splits, k, 9 * c), dtype=torch.float32, device=x.device)
        if splits > 1 else None
    )
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = kernel(
        x.data_ptr(), g.data_ptr(), out.data_ptr(),
        work.data_ptr() if work is not None else None,
        b, c, h, w, k, stride, int(x.dtype == torch.bfloat16), splits, stream,
    )
    _launches[(stride, x.dtype)] += 1
    if err:
        raise RuntimeError(f"conv3x3_wgrad launch failed: CUDA error {err}")
    return out


class _Conv3x3(torch.autograd.Function):
    """SAME padding: symmetric at stride 1, the conv's own; the stride-2
    (0, 1) padded explicitly, and dx cropped back out of the padded
    shape's data gradient."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
        # Under autocast the conv runs in the autocast dtype, both operands
        # cast to it, as the JAX package's FastConv3x3 casts x and its
        # kernel to the model's dtype.
        if torch.is_autocast_enabled(x.device.type):
            dtype = torch.get_autocast_dtype(x.device.type)
            x, w = x.to(dtype), w.to(dtype)
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        lo, hi = PADS[stride]
        if lo == hi:
            return F.conv2d(x, w, stride=stride, padding=lo)
        return F.conv2d(F.pad(x, (lo, hi, lo, hi)), w, stride=stride)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g: torch.Tensor):
        x, w = ctx.saved_tensors
        stride = ctx.stride
        g = g.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            lo, hi = PADS[stride]
            h, wd = x.shape[2:]
            if lo == hi:
                dx = torch.nn.grad.conv2d_input(x.shape, w, g, stride=stride, padding=lo)
            else:
                shape = (*x.shape[:2], h + lo + hi, wd + lo + hi)
                dx = torch.nn.grad.conv2d_input(shape, w, g, stride=stride)
                dx = dx[:, :, lo : lo + h, lo : lo + wd]
        if ctx.needs_input_grad[1]:
            # In the dtype the conv ran in, as the JAX rule's
            # dw.astype(w.dtype); autograd widens it to the parameter's.
            dw = conv3x3_wgrad(x, g, stride).to(w.dtype)
        return dx, dw, None


def conv3x3(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """3x3 SAME conv (NCHW, OIHW weight, no bias) whose weight gradient
    is ``conv3x3_wgrad``; forward and data gradient are the library's."""
    if stride not in PADS:
        raise ValueError(f"stride {stride} unsupported (1 or 2)")
    return _Conv3x3.apply(x, w, stride)
