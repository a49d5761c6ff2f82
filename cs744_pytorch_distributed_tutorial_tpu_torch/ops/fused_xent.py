"""Fused softmax cross-entropy: the forward and backward CUDA kernels,
their wrappers and plain PyTorch versions, and the autograd Function that
joins them.

Port of the JAX package's ``ops/fused_xent.py``: ``fused_cross_entropy
(logits [N, V], labels [N]) -> [N]`` is the per-row ``logsumexp(x) -
x[label]`` in fp32 whatever the logits' dtype (optax's
``softmax_cross_entropy_with_integer_labels``). A label outside [0, V)
picks no column, so its loss is the row's logsumexp, as the TPU kernel's
masked sum gives. The forward saves the row logsumexp ``lse [N]``; the
backward is ``(exp(x - lse) - onehot(label)) * g`` rounded once to the
logits' dtype. Neither pass writes a log-softmax of shape [N, V].

``csrc/fused_xent.cu`` holds the kernels (``_kernel`` and ``_bwd_kernel``
of the TPU package; its source note says how they are laid out), built
with nvcc on first use (``ops/_build.py``) and launched through
``ctypes`` on PyTorch's current stream. The wrappers take the kernel for
CUDA tensors and the plain version for CPU tensors; for a CUDA tensor
they launch or raise, with no fallback. Each launch adds one to
``launch_count(kernel, dtype)``.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.ops import _cost
from cs744_pytorch_distributed_tutorial_tpu_torch.ops._build import load_library

SOURCE = "fused_xent.cu"
KERNELS = ("fwd", "bwd")

_DTYPES = (torch.float32, torch.bfloat16)
_launches: collections.Counter = collections.Counter()  # (kernel, dtype) -> count
_kernel_fns = None  # {kernel: C entry point}, set up once


def launch_count(kernel: str | None = None, dtype: torch.dtype | None = None) -> int:
    """Kernel launches since the last ``reset_launch_count()``: all of
    them, or those of one kernel (``fwd``, ``bwd``) and/or logits dtype."""
    return sum(
        n for (k, d), n in _launches.items()
        if (kernel is None or k == kernel) and (dtype is None or d == dtype)
    )


def reset_launch_count() -> None:
    _launches.clear()


def load_kernel():
    """Build (first call) and load the kernels; returns their C entry
    points ``{"fwd": fused_xent_fwd, "bwd": fused_xent_bwd}``."""
    global _kernel_fns
    if _kernel_fns is None:
        lib = load_library(SOURCE)
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.fused_xent_fwd.argtypes = [p, p, p, p, i64, i64, i64, p]
        lib.fused_xent_bwd.argtypes = [p, p, p, p, p, i64, i64, i64, p]
        lib.fused_xent_fwd.restype = lib.fused_xent_bwd.restype = ctypes.c_int
        _kernel_fns = {"fwd": lib.fused_xent_fwd, "bwd": lib.fused_xent_bwd}
    return _kernel_fns


# ------------------------------------------------------------ plain versions
def _label_mask(labels: torch.Tensor, v: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(labels in range [N] bool, labels clamped into [0, V) [N, 1])."""
    labels = labels.long()
    return (labels >= 0) & (labels < v), labels.clamp(0, v - 1)[:, None]


def fused_xent_fwd_plain(logits: torch.Tensor, labels: torch.Tensor):
    """``(loss [N], lse [N])`` in fp32: logsumexp over the row minus the
    label's logit (0 for a label outside [0, V))."""
    x = logits.float()
    lse = torch.logsumexp(x, dim=-1)
    valid, idx = _label_mask(labels, x.shape[1])
    picked = torch.where(valid, x.gather(1, idx)[:, 0], 0.0)
    return lse - picked, lse


def fused_xent_bwd_plain(logits: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor,
                         g: torch.Tensor) -> torch.Tensor:
    """``(exp(x - lse) - onehot(label)) * g`` [N, V] in the logits' dtype."""
    x = logits.float()
    valid, idx = _label_mask(labels, x.shape[1])
    onehot = torch.zeros_like(x).scatter_(1, idx, valid.float()[:, None])
    d = (torch.exp(x - lse.float()[:, None]) - onehot) * g.float()[:, None]
    return d.to(logits.dtype)


def fp32_grad_limit(want: torch.Tensor, labels: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """How far each entry of an fp32 gradient may lie from the plain
    version's ``want`` [N, V]: 2^-20 (8 ulp) of the entry, for the two
    sides' expf of the same input (at most 2 ulp off each) and the
    product's rounding; plus 2^-22 * g at the label's column, where
    ``p - 1`` cancels and a few ulp of ``p`` (each at most 2^-24) are no
    longer small beside the result. Each entry is held at its own scale:
    most entries lie far below the row's largest."""
    lim = want.float().abs() * 2.0**-20
    valid, idx = _label_mask(labels, want.shape[1])
    lim.scatter_add_(1, idx, (valid.float() * g.float() * 2.0**-22)[:, None])
    return lim.clamp_min_(torch.finfo(torch.float32).tiny)


# ------------------------------------------------------------------ wrappers
def _check(logits: torch.Tensor, labels: torch.Tensor) -> None:
    if logits.dim() != 2:
        raise ValueError(f"expected logits [N, V], got shape {tuple(logits.shape)}")
    if labels.shape != (logits.shape[0],):
        raise ValueError(f"expected labels [{logits.shape[0]}], got {tuple(labels.shape)}")
    if logits.dtype not in _DTYPES:
        raise TypeError(f"logits must be float32 or bfloat16, got {logits.dtype}")
    if labels.dtype.is_floating_point or labels.dtype.is_complex or labels.dtype == torch.bool:
        raise TypeError(f"labels must be integers, got {labels.dtype}")
    if logits.device != labels.device:
        raise ValueError(f"inputs on several devices: {logits.device}, {labels.device}")
    if logits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_cross_entropy: unsupported device {logits.device}")
    if logits.shape[1] == 0:
        raise ValueError("fused_cross_entropy needs V >= 1")


def _launch(kernel: str, operands: list, logits: torch.Tensor) -> None:
    n, v = logits.shape
    args, operands = _cost.pointers(operands)
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    err = load_kernel()[kernel](*args, n, v, int(logits.dtype == torch.bfloat16), stream)
    _launches[(kernel, logits.dtype)] += 1
    # The logits read once (and, backward, their gradient written once),
    # the int64 labels and two fp32 row vectors; no matrix product.
    passes = 1 if kernel == "fwd" else 2
    _cost.add(0.0, passes * n * v * logits.element_size() + 16.0 * n, operands)
    if err:
        raise RuntimeError(f"fused_xent {kernel} launch failed: CUDA error {err}")


def fused_xent_fwd(logits: torch.Tensor, labels: torch.Tensor):
    """``(loss [N], lse [N])`` fp32 for logits [N, V] fp32/bf16 and
    integer labels [N]."""
    _check(logits, labels)
    if logits.device.type == "cpu":
        return fused_xent_fwd_plain(logits, labels)
    logits, labels = logits.contiguous(), labels.long().contiguous()
    n = logits.shape[0]
    loss = torch.empty(n, dtype=torch.float32, device=logits.device)
    lse = torch.empty(n, dtype=torch.float32, device=logits.device)
    if n:
        _launch("fwd", [logits, labels, loss, lse], logits)
    return loss, lse


def fused_xent_bwd(logits: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor,
                   g: torch.Tensor) -> torch.Tensor:
    """d logits [N, V] in the logits' dtype, given the forward's ``lse``
    [N] and the incoming gradient ``g`` [N] of the per-row loss."""
    _check(logits, labels)
    n = logits.shape[0]
    for name, t in (("lse", lse), ("g", g)):
        if t.shape != (n,) or t.device != logits.device:
            raise ValueError(f"{name} of shape {tuple(t.shape)} on {t.device}, expected "
                             f"[{n}] on {logits.device}")
    if logits.device.type == "cpu":
        return fused_xent_bwd_plain(logits, labels, lse, g)
    logits, labels = logits.contiguous(), labels.long().contiguous()
    lse, g = lse.float().contiguous(), g.float().contiguous()
    d = torch.empty_like(logits)
    if n:
        _launch("bwd", [logits, labels, lse, g, d], logits)
    return d


class _FusedCrossEntropy(torch.autograd.Function):
    """Forward kernel (saves ``lse``); backward kernel with the incoming
    ``g``, as the JAX package's custom VJP."""

    @staticmethod
    def forward(ctx, logits, labels):
        loss, lse = fused_xent_fwd(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        return fused_xent_bwd(logits, labels, lse, g), None


def fused_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row softmax cross-entropy ``[N, V], [N] -> [N]`` fp32,
    differentiable in the logits."""
    _check(logits, labels)
    return _FusedCrossEntropy.apply(logits, labels)
