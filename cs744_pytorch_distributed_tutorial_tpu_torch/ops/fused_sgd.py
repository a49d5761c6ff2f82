"""Fused SGD(momentum, weight decay): the CUDA kernel, its wrapper and
its plain PyTorch version.

Port of the JAX package's Pallas kernel (``ops/fused_sgd.py::_kernel``,
reached through ``_update_leaf`` and ``FusedSGD.apply``). One pass per
parameter tensor over device memory, torch-SGD semantics in fp32:

    g' = g + wd * p
    m' = mu * m + g'
    p' = p - lr * m'

``csrc/fused_sgd.cu`` is the kernel: bound by memory bandwidth (20 bytes
an element), float4 loads and stores, p and m updated in place. It is
built with nvcc on first use (``ops/_build.py``) and launched through
``ctypes`` on PyTorch's current stream, once per parameter tensor.

``fused_sgd_`` takes the kernel for CUDA tensors and the plain version
for CPU tensors; for a CUDA tensor it launches or raises, with no
fallback. Each launch adds one to ``launch_count()``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.ops._build import load_library

SOURCE = "fused_sgd.cu"

_launches = 0
_kernel_fn = None  # the loaded C entry point, set up once


def launch_count() -> int:
    """Kernel launches since the last ``reset_launch_count()``."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def load_kernel():
    """Build (first call) and load the kernel; returns its C entry point."""
    global _kernel_fn
    if _kernel_fn is None:
        fn = load_library(SOURCE).fused_sgd_f32
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _kernel_fn = fn
    return _kernel_fn


def fused_sgd_plain(
    p: torch.Tensor, m: torch.Tensor, g: torch.Tensor, *, lr: float, mu: float, wd: float
) -> None:
    """The kernel's arithmetic in plain PyTorch, in place, rounding after
    every multiply and add as the kernel does."""
    ge = g + p * wd
    m.mul_(mu).add_(ge)
    p.sub_(m * lr)


def _check(p: torch.Tensor, m: torch.Tensor, g: torch.Tensor) -> None:
    for name, t in (("p", p), ("m", m), ("g", g)):
        if t.dtype != torch.float32:
            raise TypeError(f"fused_sgd_: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"fused_sgd_: {name} must be contiguous")
        if t.shape != p.shape:
            raise ValueError(
                f"fused_sgd_: {name} has shape {tuple(t.shape)}, p has {tuple(p.shape)}"
            )
        if t.device != p.device:
            raise ValueError(
                f"fused_sgd_: {name} is on {t.device}, p is on {p.device}"
            )


@torch.no_grad()
def fused_sgd_(
    p: torch.Tensor, m: torch.Tensor, g: torch.Tensor, *, lr: float, mu: float, wd: float
) -> None:
    """Update ``p`` and ``m`` in place from ``g``."""
    global _launches
    _check(p, m, g)
    if p.device.type == "cpu":
        fused_sgd_plain(p, m, g, lr=lr, mu=mu, wd=wd)
        return
    if p.device.type != "cuda":
        raise ValueError(f"fused_sgd_: unsupported device {p.device}")
    kernel = load_kernel()
    stream = torch.cuda.current_stream(p.device).cuda_stream
    err = kernel(p.data_ptr(), m.data_ptr(), g.data_ptr(), p.numel(), lr, mu, wd, stream)
    _launches += 1
    if err:
        raise RuntimeError(f"fused_sgd_f32 launch failed: CUDA error {err}")


class FusedSGD:
    """Optimizer with torch-SGD semantics backed by the fused kernel.

    Replaces the plain update when ``TrainConfig.fused_optimizer`` is set.
    State is one momentum tensor per parameter.
    """

    def __init__(self, learning_rate: float, momentum: float, weight_decay: float):
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.weight_decay = weight_decay

    def init(self, params: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        return [torch.zeros_like(p, dtype=torch.float32) for p in params]

    def apply(
        self,
        params: Sequence[torch.Tensor],
        momentum: Sequence[torch.Tensor],
        grads: Sequence[torch.Tensor],
    ) -> None:
        for p, m, g in zip(params, momentum, grads, strict=True):
            fused_sgd_(
                p.data, m, g,
                lr=self.learning_rate, mu=self.momentum, wd=self.weight_decay,
            )
