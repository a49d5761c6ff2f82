"""Fused SGD(momentum, weight decay): the CUDA kernel, its wrapper and
its plain PyTorch version.

Port of the JAX package's Pallas kernel (``ops/fused_sgd.py::_kernel``,
reached through ``_update_leaf`` and ``FusedSGD.apply``). One pass over
device memory for a whole list of parameter tensors, torch-SGD
semantics in fp32:

    g' = g + wd * p
    m' = mu * m + g'
    p' = p - lr * m'

``csrc/fused_sgd.cu`` is the kernel: bound by memory bandwidth (20 bytes
an element), one launch for a list of up to 64 tensors and 640 chunks
of 32K elements (ResNet-18's and VGG-11's whole update is one launch;
its source note says how a longer list is split), float4 loads where a
tensor's three pointers are 16-byte aligned, p and m updated in place,
bitwise equal to the plain version. It is built with nvcc on first use
(``ops/_build.py``) and launched through ``ctypes`` on PyTorch's
current stream: one call of its C entry point a list, which packs the
list into the launches' parameters itself and reports how many
launches it made.

``fused_sgd_multi_`` takes the kernel for CUDA tensors and the plain
version, tensor by tensor, for CPU tensors; for CUDA tensors it launches
or raises, with no fallback. Each kernel launch adds one to
``launch_count()``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.ops import _cost
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
        lib = load_library(SOURCE)
        fn = lib.fused_sgd_multi_f32
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
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


def _check(name: str, t: torch.Tensor, shape: torch.Size, device: torch.device) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"fused_sgd: {name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"fused_sgd: {name} must be contiguous")
    if t.shape != shape:
        raise ValueError(f"fused_sgd: {name} has shape {tuple(t.shape)}, its p has "
                         f"{tuple(shape)}")
    if t.device != device:
        raise ValueError(f"fused_sgd: {name} is on {t.device}, the list's first p on {device}")


def _rows(params, moms, grads) -> np.ndarray:
    """The list's (p, m, g, numel) rows for the C entry point, every
    tensor checked on every call: float32, contiguous, p's shape, the
    first p's device."""
    dev = params[0].device
    f32, index = torch.float32, (dev.index if dev.type == "cuda" else -1)  # as get_device()
    rows = []
    for i, (p, m, g) in enumerate(zip(params, moms, grads)):
        shape = p.shape
        for t in (p, m, g):
            if not (t.dtype is f32 and t.is_contiguous() and t.shape == shape
                    and t.get_device() == index):
                for name, u in (("p", p), ("m", m), ("g", g)):
                    _check(f"{name}[{i}]", u, shape, dev)
                raise ValueError(f"fused_sgd: tensor {i} of the list is not on {dev}")
        rows.append((p.data_ptr(), m.data_ptr(), g.data_ptr(), p.numel()))
    return np.array(rows, np.int64)


@torch.no_grad()
def fused_sgd_multi_(
    params: Sequence[torch.Tensor], moms: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
    *, lr: float, mu: float, wd: float,
) -> None:
    """Update every ``params[i]`` and ``moms[i]`` in place from
    ``grads[i]``: one C call for the list on the card."""
    global _launches
    params, moms, grads = list(params), list(moms), list(grads)
    if not (len(params) == len(moms) == len(grads)):
        raise ValueError(f"fused_sgd: {len(params)} params, {len(moms)} momenta, "
                         f"{len(grads)} gradients")
    if not params:
        return
    dev = params[0].device
    if dev.type == "cpu":
        for i, (p, m, g) in enumerate(zip(params, moms, grads)):
            for name, t in (("p", p), ("m", m), ("g", g)):
                _check(f"{name}[{i}]", t, p.shape, dev)
        for p, m, g in zip(params, moms, grads):
            fused_sgd_plain(p, m, g, lr=lr, mu=mu, wd=wd)
        return
    if dev.type != "cuda":
        raise ValueError(f"fused_sgd: unsupported device {dev}")
    table = _rows(params, moms, grads)
    kernel = load_kernel()
    launches = ctypes.c_int64(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = kernel(table.ctypes.data, len(params), lr, mu, wd, stream, ctypes.byref(launches))
    _launches += launches.value
    # p, m and g read and p, m written, fp32; no matrix product.
    _cost.add(0.0, 20.0 * sum(p.numel() for p in params))
    if err:
        raise RuntimeError(f"fused_sgd_multi_f32 launch failed: CUDA error {err}")


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
        fused_sgd_multi_(params, momentum, grads, lr=self.learning_rate, mu=self.momentum,
                         wd=self.weight_decay)
