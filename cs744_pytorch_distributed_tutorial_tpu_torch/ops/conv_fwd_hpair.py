"""3x3 stride-1 SAME conv forward in the H-pair-packed form: the CUDA
kernel, its wrapper, its plain PyTorch version, and the probe's entry
point.

Port of the TPU probe ``benchmarks/probe_fwd_hpair.py::_fwd_kernel``
(reached through its ``conv3x3_fwd_hpair``). On NHWC ``x [B, H, W, C]``
and a packed weight ``w_packed [12C, 2C]``, for each pair m of output
rows (2m, 2m+1):

    lhs[(b, m, w), (r, dx, c)] = x[b, 2m - 1 + r, w + dx - 1, c]
                                 (zero outside the image; r 0-3, dx 0-2)
    out[b, 2m, w, :]     = (lhs @ w_packed)[(b, m, w), 0:C]
    out[b, 2m + 1, w, :] = (lhs @ w_packed)[(b, m, w), C:2C]

with fp32 sums, rounded once to ``x.dtype``. ``pack_weights`` places an
HWIO 3x3 weight into ``w_packed`` so that the result is the SAME conv
with it (the even row never reads r = 3, the odd row never r = 0: those
blocks are zero); the function holds for any ``w_packed``.

The kernel (``csrc/conv_fwd_hpair.cu``) is an implicit GEMM on the
tensor cores: TMA reads each tap's 128 lhs rows straight from x, whose
zero fill outside the tensor is the SAME padding, against w_packed held
whole in shared memory; its source note says more. It covers bf16, C 64
and W 8-128 (powers of two) at any B and even H (``kernel_refusal``).
Built with nvcc on first use (``ops/_build.py``) and launched through
``ctypes`` on PyTorch's current stream.

``conv3x3_fwd_hpair`` launches the kernel for CUDA tensors (or raises
``ValueError`` naming what it does not cover) and takes the plain
version for CPU tensors. Each launch adds one to ``launch_count()``.

The probe (``main``), its twin of the JAX probe's ``main()``::

    python -m cs744_pytorch_distributed_tutorial_tpu_torch.ops.conv_fwd_hpair [--device cpu]

On the card: x [4096, 32, 32, 64] bf16, the numerics check against the
library's conv (error over max|conv| below 5e-2), then the kernel's time
and cuDNN's bf16 ``F.conv2d`` on the same x seen as a channels-last NCHW
view, each beside its bound, and the card's name and power limit. On the
CPU: the plain version at [16, 32, 32, 64], the numerics check only. No
block-batch sweep: that knob was the TPU's VMEM budget.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

from cs744_pytorch_distributed_tutorial_tpu_torch.ops import _cost
from cs744_pytorch_distributed_tutorial_tpu_torch.ops._build import load_library

SOURCE = "conv_fwd_hpair.cu"
SOURCES = (SOURCE,)

# What the kernel covers: bf16, C = 64 (a tap's K block is one 128-byte
# row), W a power of two from 8 to 128 (a tile's 128 lhs rows are whole
# row pairs), even H, any B.
KERNEL_C = 64
KERNEL_WIDTHS = (8, 16, 32, 64, 128)

# The probe's shapes (benchmarks/probe_fwd_hpair.py:132) and its check.
PROBE_SHAPE = (4096, 32, 32, 64)
PROBE_CPU_BATCH = 16
PROBE_SEED, PROBE_WARMUP, PROBE_REPS = 0, 3, 20  # timed calls a side on the card
PROBE_REL_LIMIT = 5e-2  # max|out - conv| / max|conv|
# The kernel, its plain version and the TPU kernel agree (``agreement``)
# within 2 bf16 ulps + 1e-5 x max|reference| an element, at most 0.1 % of
# elements differing: each gap is a near-tie of the final bf16 rounding
# after fp32 sums in another order (about 0.013 % of elements between the
# plain version and the TPU kernel in interpret mode).
AGREE_ULPS, AGREE_ZERO_TOL, AGREE_DIFFERING = 2, 1e-5, 1e-3
# Peaks of one H100 SXM (NVIDIA's data sheet, dense): the probe's bounds.
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

_launches = 0
_kernel_fn = None  # the C entry point, set up once


def launch_count() -> int:
    """Kernel launches since the last ``reset_launch_count()``."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def load_kernel():
    """Build (first call) and load ``SOURCE``; returns its C entry point."""
    global _kernel_fn
    if _kernel_fn is None:
        lib = load_library(SOURCE)
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fn = lib.conv3x3_fwd_hpair  # x, w_packed, out, B, H, W, C, grid, stream
        fn.argtypes, fn.restype = [p] * 3 + [i64] * 5 + [p], ctypes.c_int
        _kernel_fn = fn
    return _kernel_fn


def pack_weights(w) -> torch.Tensor:
    """HWIO ``[3, 3, C, K]`` (numpy or tensor) -> ``[12C, 2K]`` bf16: rows
    by tap (r 0-3, dx 0-2, c); columns 0:K the even output row (ky = r,
    r < 3), K:2K the odd (ky = r - 1, r >= 1); the other blocks zero. Bit
    for bit the JAX probe's ``pack_weights`` (fp32 rounded to nearest
    bf16). On the tensor's device, or the CPU for numpy."""
    w = torch.as_tensor(np.asarray(w, np.float32)) if not torch.is_tensor(w) else w.float()
    kh, kw, c, k = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"pack_weights: expected HWIO [3, 3, C, K], got {tuple(w.shape)}")
    wp = w.new_zeros((4, 3, c, 2 * k))
    wp[:3, :, :, :k] = w
    wp[1:, :, :, k:] = w
    return wp.reshape(12 * c, 2 * k).to(torch.bfloat16)


def hwio_to_oihw(w: torch.Tensor) -> torch.Tensor:
    """HWIO ``[3, 3, C, K]`` -> OIHW ``[K, C, 3, 3]``, the layout of
    ``F.conv2d``'s weight (the library comparison)."""
    return w.permute(3, 2, 0, 1)


def conv3x3_fwd_hpair_plain(x: torch.Tensor, w_packed: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: x padded by one row and
    column each side in fp32, the 12 taps ``xp[:, r + 2m, dx + w]``
    stacked along channels, one fp32 product with ``w_packed``, rounded to
    ``x.dtype``, and the two column halves interleaved as rows 2m, 2m+1."""
    b, h, w, c = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))  # [B, H + 2, W + 2, C]
    taps = [xp[:, r : r + h : 2, dx : dx + w] for r in range(4) for dx in range(3)]
    lhs = torch.cat(taps, dim=-1).reshape(-1, 12 * c)
    out = (lhs @ w_packed.float()).to(x.dtype)  # [(b, m, w), 2C]
    return out.reshape(b, h // 2, w, 2, c).transpose(2, 3).reshape(b, h, w, c)


def kernel_refusal(dtype: torch.dtype, shape: tuple[int, ...]) -> str | None:
    """Why the kernel does not take x of ``dtype`` and NHWC ``shape``
    (with a ``[12C, 2C]`` bf16 ``w_packed``), or None if it does."""
    b, h, w, c = shape
    if dtype != torch.bfloat16:
        return f"x is {dtype}; the kernel takes bfloat16"
    if c != KERNEL_C:
        return f"C = {c}; the kernel takes C = {KERNEL_C}"
    if w not in KERNEL_WIDTHS:
        return f"W = {w}; the kernel takes W in {KERNEL_WIDTHS}"
    if b * h >= 2**31:
        return f"B x H = {b * h} exceeds 32-bit indexing"
    return None


def _check(x: torch.Tensor, w_packed: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC [B, H, W, C], got {tuple(x.shape)}")
    b, h, w, c = x.shape
    if h % 2:
        raise ValueError(f"x {tuple(x.shape)}: H = {h} must be even (output rows come in pairs)")
    if tuple(w_packed.shape) != (12 * c, 2 * c):
        raise ValueError(f"w_packed {tuple(w_packed.shape)} does not match x {tuple(x.shape)}: "
                         f"expected [{12 * c}, {2 * c}]")
    if not x.is_floating_point() or w_packed.dtype != torch.bfloat16:
        raise ValueError(f"x must be floating and w_packed bfloat16, got {x.dtype} and "
                         f"{w_packed.dtype}")
    if x.device != w_packed.device:
        raise ValueError(f"x is on {x.device}, w_packed on {w_packed.device}")


def conv3x3_fwd_hpair(x: torch.Tensor, w_packed: torch.Tensor) -> torch.Tensor:
    """``unpack(im2col_4x3(x) @ w_packed)``: x NHWC ``[B, H, W, C]`` (H
    even), ``w_packed [12C, 2C]`` bf16; returns ``[B, H, W, C]`` in
    ``x.dtype``. With ``w_packed = pack_weights(w)``, the 3x3 SAME conv
    of x with w."""
    global _launches
    _check(x, w_packed)
    if x.device.type == "cpu":
        return conv3x3_fwd_hpair_plain(x, w_packed)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_fwd_hpair: unsupported device {x.device}")
    refusal = kernel_refusal(x.dtype, tuple(x.shape))
    if refusal:
        raise ValueError(f"conv3x3_fwd_hpair: x {tuple(x.shape)} {x.dtype}: {refusal}")
    b, h, w, c = x.shape
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if b == 0:
        return out
    x, w_packed = x.contiguous(), w_packed.contiguous()
    if x.data_ptr() % 16 or w_packed.data_ptr() % 16:
        raise ValueError("conv3x3_fwd_hpair: x and w_packed must start on 16 bytes")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = load_kernel()(x.data_ptr(), w_packed.data_ptr(), out.data_ptr(), b, h, w, c, sms,
                        stream)
    _launches += 1
    # The packed product (12C x 2C a pixel pair, zero blocks included); x
    # read once, w_packed once, out written once.
    _cost.add(2.0 * b * (h // 2) * w * 12 * c * 2 * c,
              2.0 * x.numel() + 2.0 * out.numel() + 2.0 * w_packed.numel(),
              operands=[x, w_packed, out])
    if err:
        raise RuntimeError(f"conv3x3_fwd_hpair launch failed: CUDA error {err}")
    return out


def agreement(got: torch.Tensor, want: torch.Tensor) -> dict:
    """How far ``got`` lies from ``want`` (bf16 results, compared in fp32):
    ``share``, the largest ``|got - want|`` over its limit, AGREE_ULPS bf16
    ulps of the larger magnitude plus AGREE_ZERO_TOL x max|want| (the
    second term for results near zero, where the fp32 sums cancel);
    ``differing``, the share of elements not equal; ``ok`` when share <= 1
    and differing <= AGREE_DIFFERING."""
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs())
    # A bf16 ulp of mag in [2^(e-1), 2^e) is 2^(e-8); none at zero.
    ulp = torch.where(mag > 0, torch.exp2((torch.frexp(mag).exponent - 8).float()), 0.0)
    limit = AGREE_ULPS * ulp + AGREE_ZERO_TOL * float(w.abs().max())
    diff = (g - w).abs()
    share = float((diff / limit.clamp_min(torch.finfo(torch.float32).tiny)).max())
    differing = float((diff != 0).sum()) / max(diff.numel(), 1)
    return {"share": share, "differing": differing, "max_abs_err": float(diff.max()),
            "ok": share <= 1.0 and differing <= AGREE_DIFFERING}


def bounds_ms(shape: tuple[int, int, int, int]) -> dict[str, float]:
    """The least times on one H100 SXM at ``shape`` (bf16): the kernel's
    (its packed product's operations against the bytes of x, out and
    w_packed) and a 3x3 conv's (9/12 of those operations against x, out
    and the 3 x 3 x C x C weight)."""
    b, h, w, c = shape
    packed_flops = 2.0 * b * (h // 2) * w * 12 * c * 2 * c
    conv_flops = 2.0 * b * h * w * 9 * c * c
    act_bytes = 2.0 * 2 * b * h * w * c
    kernel = (packed_flops / BF16_FLOPS, (act_bytes + 2.0 * 24 * c * c) / HBM_BYTES_PER_S)
    conv = (conv_flops / BF16_FLOPS, (act_bytes + 2.0 * 9 * c * c) / HBM_BYTES_PER_S)
    return {"bound_ms": 1e3 * max(kernel), "library_bound_ms": 1e3 * max(conv),
            "bound_by": "operations" if kernel[0] >= kernel[1] else "bytes",
            "library_bound_by": "operations" if conv[0] >= conv[1] else "bytes"}


def _median_ms(fn, reps: int, warmup: int) -> float:
    """Median of ``reps`` calls of ``fn``, each fenced by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main(argv: list[str] | None = None) -> int:
    """The probe: the numerics check against the library's conv, then (on
    the card) the kernel's and cuDNN's times. Prints a JSON summary last."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("conv_fwd_hpair: no CUDA device (pass --device cpu for the "
                           "plain version's numerics check)")
    dev = torch.device("cuda", torch.cuda.current_device()) if on_card else torch.device("cpu")
    b, h, w, c = PROBE_SHAPE if on_card else (PROBE_CPU_BATCH, *PROBE_SHAPE[1:])
    gen = torch.Generator(device=dev).manual_seed(PROBE_SEED)
    x = torch.randn((b, h, w, c), generator=gen, device=dev).to(torch.bfloat16)
    wk = torch.randn((3, 3, c, c), generator=gen, device=dev) * 0.1
    wp = pack_weights(wk)
    w_oihw = hwio_to_oihw(wk).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    x_nchw = x.permute(0, 3, 1, 2)  # a channels-last view of x, no copy

    def library():  # cuDNN's bf16 conv, its NHWC output seen as NHWC again
        return F.conv2d(x_nchw, w_oihw, padding=1).permute(0, 2, 3, 1)

    # The card's reference is the library's bf16 conv; the CPU's the same
    # conv in fp32 on the bf16 values, rounded once.
    ref = library() if on_card else F.conv2d(
        x_nchw.float(), w_oihw.float(), padding=1).permute(0, 2, 3, 1).to(torch.bfloat16)
    calls = 1
    got = conv3x3_fwd_hpair(x, wp)
    err = float((got.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max()) or 1.0
    print(f"max abs err: {err:.4f} (rel {err / scale:.5f})")
    if not err / scale < PROBE_REL_LIMIT:
        raise RuntimeError(f"conv_fwd_hpair: numerics mismatch (rel {err / scale} >= "
                           f"{PROBE_REL_LIMIT})")
    summary = {"probe": "conv3x3_fwd_hpair", "device": str(dev), "shape": [b, h, w, c],
               "max_abs_err": err, "rel_err": err / scale, **bounds_ms((b, h, w, c))}
    if not on_card:
        print("CPU: the plain version, numerics only, no timing")
    else:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True, timeout=60).stdout.strip().splitlines()[0]
        kernel_ms = _median_ms(lambda: conv3x3_fwd_hpair(x, wp), PROBE_REPS, PROBE_WARMUP)
        calls += PROBE_REPS + PROBE_WARMUP
        library_ms = _median_ms(library, PROBE_REPS, PROBE_WARMUP)
        print(f"card: {card}")
        print(f"hpair fwd (CUDA kernel): {kernel_ms:7.3f} ms (bound {summary['bound_ms']:.4f} ms, "
              f"{summary['bound_by']}: {100 * summary['bound_ms'] / kernel_ms:.1f} %)")
        print(f"cuDNN bf16 conv2d:       {library_ms:7.3f} ms (bound "
              f"{summary['library_bound_ms']:.4f} ms, {summary['library_bound_by']}: "
              f"{100 * summary['library_bound_ms'] / library_ms:.1f} %)")
        summary.update(card=card, kernel_ms=kernel_ms, library_ms=library_ms)
    summary["calls"] = calls  # of conv3x3_fwd_hpair (kernel launches on the card)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
