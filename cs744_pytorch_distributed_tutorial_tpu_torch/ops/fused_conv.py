"""3x3 conv weight gradient: the CUDA kernel, its wrapper, its plain
PyTorch version, and the conv whose backward uses it.

Port of the JAX package's Pallas kernels ``ops/fused_conv.py::
_wgrad_kernel_s1`` and ``_wgrad_kernel_s2`` (reached through
``conv3x3_wgrad`` and the ``conv3x3`` custom VJP). For a 3x3 SAME conv,
NCHW here where the JAX package is NHWC:

    dW[k, c, ky, kx] = sum_{b,y,x} X[b, c, s*y+ky-p, s*x+kx-p] * G[b, k, y, x]

with p = 1 at stride 1 and p = 0 at stride 2: flax ``padding="SAME"`` on
a stride-2 3x3 conv over even H, W pads (0, 1), not (1, 1).

Two kernels, each one source for both strides, M split over the grid
and the slices summed in a fixed order (their source notes say more):

- ``csrc/fused_conv_tc.cu``, the tensor cores: wgmma on bf16 tiles that
  TMA reads from g (NCHW) and from x's tap planes, which a pre-pass
  writes (``tap_planes_plain``: one plane of the output grid per kx, and
  per row parity at stride 2, with a zero row on top), so a tap is a box
  at a whole-row offset and TMA's zero fill past the plane is the bottom
  padding. fp32 inputs go as two bf16 pieces each, v = h + l, and three
  products h h + h l + l h (``conv3x3_wgrad_tc_plain`` is that arithmetic
  in plain PyTorch); bf16 inputs are one exact piece.
- ``csrc/fused_conv.cu``, fp32 FFMA over register tiles, the im2col
  gathered into shared memory only.

``tc_route``, a fixed rule of dtype, shape, stride and alignment, picks
one for a call on CUDA tensors. They are built with nvcc on first use
(``ops/_build.py``) and launched through ``ctypes`` on PyTorch's current
stream.

``conv3x3_wgrad`` takes its route's kernel for CUDA tensors and the
plain version for CPU tensors; for a CUDA tensor it launches or raises,
with no fallback. Each launch adds one to ``launch_count(stride, dtype,
route)``.

``conv3x3`` leaves its forward and its data gradient to the library
convolution, as the JAX package leaves both to XLA; its weight gradient
is ``conv3x3_wgrad``.
"""

from __future__ import annotations

import collections
import ctypes

import torch
import torch.nn.functional as F

from cs744_pytorch_distributed_tutorial_tpu_torch.ops import _cost
from cs744_pytorch_distributed_tutorial_tpu_torch.ops._build import load_library

SOURCE = "fused_conv.cu"
TC_SOURCE = "fused_conv_tc.cu"
SOURCES = (SOURCE, TC_SOURCE)
ROUTES = ("ffma", "tc")

# SAME padding (top/left, bottom/right) of a 3x3 conv over even H, W.
PADS = {1: (1, 1), 2: (0, 1)}

_DTYPES = (torch.float32, torch.bfloat16)
_launches: collections.Counter = collections.Counter()  # (stride, dtype, route) -> count
_kernel_fns = None  # {route: (splits query, launch)} C entry points, set up once


def launch_count(stride: int | None = None, dtype: torch.dtype | None = None,
                 route: str | None = None) -> int:
    """Kernel launches since the last ``reset_launch_count()``, all of them
    or those of one stride, input dtype and/or route (``ffma``, ``tc``)."""
    return sum(
        n for (s, d, r), n in _launches.items()
        if (stride is None or s == stride) and (dtype is None or d == dtype)
        and (route is None or r == route)
    )


def reset_launch_count() -> None:
    _launches.clear()


def load_kernel():
    """Build (first call) and load the kernels of ``SOURCES``; returns their
    C entry points by route, ``{route: (splits query, launch)}``."""
    global _kernel_fns
    if _kernel_fns is None:
        ffma, tc = load_library(SOURCE), load_library(TC_SOURCE)
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fns = {  # x, g, out, work, (xp, gp,) B, C, H, W, K, stride, bf16, splits, stream
            "ffma": (ffma.conv3x3_wgrad_splits, ffma.conv3x3_wgrad, [p] * 4 + [i64] * 8 + [p]),
            "tc": (tc.conv3x3_wgrad_tc_splits, tc.conv3x3_wgrad_tc, [p] * 6 + [i64] * 8 + [p]),
        }
        for splits, fn, argtypes in fns.values():
            splits.argtypes, splits.restype = [i64] * 6, i64
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _kernel_fns = {route: (splits, fn) for route, (splits, fn, _) in fns.items()}
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


def split2_bf16_plain(v: torch.Tensor) -> torch.Tensor:
    """The two bf16 pieces [2, *v.shape] of an fp32 ``v`` that the
    tensor-core route multiplies: h = bf16(v), l = bf16(v - h), each
    rounded to nearest (v - h is exact in fp32). h + l carries 16
    significant bits of v; the rest (about 2^-17 |v|) is dropped."""
    h = v.to(torch.bfloat16)
    return torch.stack([h, (v - h.float()).to(torch.bfloat16)])


def tap_planes_plain(x: torch.Tensor, stride: int) -> torch.Tensor:
    """The tensor-core kernel's B operand as its pre-pass writes it: x [B,
    C, H, W] as planes [B, planes, C, Ho + 1, Wo] of the output grid, one
    for each kx (and each row parity py at stride 2: plane 3 py + kx), with
    plane[1 + y, x] = x[s y + py, s x + kx - p] (p = 1 at stride 1, 0 at
    stride 2), zero where that column or row lies outside the image, and
    row 0 zeros. A tap's shift is then a whole number of rows."""
    b, c, h, w = x.shape
    ho, wo = h // stride, w // stride
    cols = F.pad(x, (PADS[stride][0], 1))  # column s x + kx of this is x's s x + kx - p
    planes = [cols[:, :, py : py + stride * ho : stride, kx : kx + stride * wo : stride]
              for py in range(stride) for kx in range(3)]
    return F.pad(torch.stack(planes, dim=1), (0, 0, 1, 0))


def tap_geometry(stride: int) -> list[tuple[int, int]]:
    """For each tap (ky, kx) in row-major order, where the tensor-core
    kernel reads it in ``tap_planes_plain``'s planes: (plane, first row),
    the plane kx (stride 1) or 3 (ky % 2) + kx (stride 2), the first row 1
    + the tap's row shift (ky - 1 at stride 1, ky // 2 at stride 2)."""
    return [(kx if stride == 1 else 3 * (ky % 2) + kx, 1 + (ky - 1 if stride == 1 else ky // 2))
            for ky in range(3) for kx in range(3)]


def conv3x3_wgrad_tc_plain(x: torch.Tensor, g: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """The tensor-core route's arithmetic in plain PyTorch: fp32 x and g
    as two bf16 pieces each (``split2_bf16_plain``) and the three products
    h_g h_x + h_g l_x + l_g h_x summed in fp32 (bf16 inputs: one exact
    piece, one product), each tap read from ``tap_planes_plain``'s planes
    at the rows ``tap_geometry`` gives (zero past the plane's end). Returns
    dW [K, C, 3, 3] fp32; it differs from ``conv3x3_wgrad_plain`` only by
    the dropped l_g l_x and the pieces' rounding (about 2^-16 of each
    product)."""
    b, c, h, w = x.shape
    k, ho, wo = g.shape[1], h // stride, w // stride
    planes = F.pad(tap_planes_plain(x, stride), (0, 0, 0, 1))  # a zero row past the end
    if x.dtype == torch.float32:
        xs, gs = split2_bf16_plain(planes), split2_bf16_plain(g)
        pairs = [(0, 0), (0, 1), (1, 0)]  # (piece of g, piece of x)
    else:
        xs, gs, pairs = planes[None], g[None], [(0, 0)]
    gs = gs.reshape(len(gs), b, k, ho * wo).float()
    dw = torch.zeros((k, c, 9), dtype=torch.float32, device=x.device)
    for tap, (plane, row) in enumerate(tap_geometry(stride)):
        src = xs[:, :, plane, :, row : row + ho].reshape(len(xs), b, c, ho * wo).float()
        for pg, px in pairs:
            dw[:, :, tap] += torch.einsum("bkj,bcj->kc", gs[pg], src[px])
    return dw.reshape(k, c, 3, 3)


def tc_route(dtype: torch.dtype, shape: tuple[int, int, int, int], stride: int,
             aligned: bool = True) -> bool:
    """Whether a ``conv3x3_wgrad`` call on CUDA tensors takes the
    tensor-core kernel: x of ``dtype`` and ``shape`` (B, C, H, W), the
    ``stride``, ``aligned`` whether x and g start on 16 bytes. True for fp32
    or bf16 at stride 1 or 2 when an output row Wo is a multiple of 8
    elements (every box TMA reads of g and of the tap planes then starts
    and steps on 16 bytes); 6 x 6 images, 4 x 4 outputs and the like take
    the FFMA kernel."""
    b, c, h, w = shape
    if dtype not in _DTYPES or stride not in PADS or not aligned or min(shape) <= 0:
        return False
    return h % stride == 0 and w % stride == 0 and (w // stride) % 8 == 0


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
    ho, wo = h // stride, w // stride
    if max(b * ho * wo, x[0].numel(), g[0].numel()) >= 2**31:
        raise ValueError(f"conv3x3_wgrad: shape {tuple(x.shape)} exceeds 32-bit indexing")
    x, g = x.contiguous(), g.contiguous()
    route = "tc" if tc_route(x.dtype, (b, c, h, w), stride,
                             x.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0) else "ffma"
    splits_fn, kernel = load_kernel()[route]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = splits_fn(b, c, k, ho, wo, sms)
    out = torch.empty((k, c, 3, 3), dtype=torch.float32, device=x.device)
    bf16 = x.dtype == torch.bfloat16
    args = [x.data_ptr(), g.data_ptr(), out.data_ptr()]
    if route == "tc":
        # Scratch: the slices' partials, x's tap planes (in bf16 pieces: two
        # for fp32, one for bf16) and g's two pieces for fp32 (bf16 g is
        # read in place).
        work = torch.empty((splits, 9, k, c), dtype=torch.float32, device=x.device)
        pieces, nplanes = (1 if bf16 else 2), (3 if stride == 1 else 6)
        xp = torch.empty((pieces, b, nplanes, c, (ho + 1) * wo), dtype=torch.bfloat16,
                         device=x.device)
        gp = None if bf16 else torch.empty((2, *g.shape), dtype=torch.bfloat16, device=x.device)
        args += [work.data_ptr(), xp.data_ptr(), gp.data_ptr() if gp is not None else None]
    else:
        work = (torch.empty((splits, k, 9 * c), dtype=torch.float32, device=x.device)
                if splits > 1 else None)
        args.append(work.data_ptr() if work is not None else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = kernel(*args, b, c, h, w, k, stride, int(bf16), splits, stream)
    _launches[(stride, x.dtype, route)] += 1
    # The 9 taps' products over every output pixel; x and g read once, the
    # fp32 [K, C, 3, 3] result written once.
    _cost.add(2.0 * b * ho * wo * c * k * 9,
              x.numel() * x.element_size() + g.numel() * g.element_size() + 36.0 * k * c)
    if err:
        raise RuntimeError(f"conv3x3_wgrad {route} launch failed: CUDA error {err}")
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
