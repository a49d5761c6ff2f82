"""Augmentation on the device: crop / flip / normalize.

The reference augments per sample on the host with torchvision:
``RandomCrop(32, padding=4)``, ``RandomHorizontalFlip``, ``ToTensor``,
``Normalize(mean=[125.3,123.0,113.9]/255, std=[63.0,62.1,66.7]/255)``
(``master/part1/part1.py:66-77``). Here, as in the JAX package, the host
ships raw uint8 NHWC batches and the transform runs on the device.
Inputs are NHWC uint8 (the JAX package's layout); outputs are NCHW
float32, the layout ``nn.Conv2d`` takes.

The crop offsets and flips come from a ``torch.Generator``; its bits
differ from ``jax.random``'s, so the two packages agree on the transform,
not on which crop a given image gets.
"""

from __future__ import annotations

import numpy as np
import torch

# The reference's exact normalization constants (master/part1/part1.py:66-67).
CIFAR10_MEAN = np.array([125.3, 123.0, 113.9], dtype=np.float32) / 255.0
CIFAR10_STD = np.array([63.0, 62.1, 66.7], dtype=np.float32) / 255.0

_PAD = 4  # RandomCrop(32, padding=4) — master/part1/part1.py:70


def normalize(images: torch.Tensor) -> torch.Tensor:
    """NHWC uint8 [0,255] -> normalized NCHW float32 (ToTensor + Normalize)."""
    mean = torch.as_tensor(CIFAR10_MEAN, device=images.device)
    std = torch.as_tensor(CIFAR10_STD, device=images.device)
    x = images.to(torch.float32) / 255.0
    return ((x - mean) / std).permute(0, 3, 1, 2).contiguous()


def crop_flip_params(
    generator: torch.Generator, n: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-image (row offset, column offset, flip) drawn from ``generator``
    (a CPU generator: n small integers per step, moved with the batch)."""
    off_h = torch.randint(0, 2 * _PAD + 1, (n,), generator=generator)
    off_w = torch.randint(0, 2 * _PAD + 1, (n,), generator=generator)
    flip = torch.randint(0, 2, (n,), generator=generator).bool()
    return off_h, off_w, flip


def crop_flip(
    images: torch.Tensor,
    off_h: torch.Tensor,
    off_w: torch.Tensor,
    flip: torch.Tensor,
) -> torch.Tensor:
    """RandomCrop(pad 4) + HFlip of an NHWC batch at the given offsets, as
    one gather from the zero-padded batch."""
    n, h, w, _ = images.shape
    dev = images.device
    padded = torch.nn.functional.pad(images, (0, 0, _PAD, _PAD, _PAD, _PAD))
    ar_h = torch.arange(h, device=dev)
    ar_w = torch.arange(w, device=dev)
    rows = off_h.to(dev)[:, None] + ar_h[None, :]  # [n, h]
    col_idx = torch.where(flip.to(dev)[:, None], w - 1 - ar_w[None, :], ar_w[None, :])
    cols = off_w.to(dev)[:, None] + col_idx  # [n, w]
    batch = torch.arange(n, device=dev)[:, None, None]
    return padded[batch, rows[:, :, None], cols[:, None, :]]


def augment_train_batch(generator: torch.Generator, images: torch.Tensor) -> torch.Tensor:
    """Train-time transform: crop + flip on raw uint8, then normalize."""
    return normalize(crop_flip(images, *crop_flip_params(generator, images.shape[0])))


def eval_batch(images: torch.Tensor) -> torch.Tensor:
    """Eval-time transform: normalize only (transform_test)."""
    return normalize(images)
