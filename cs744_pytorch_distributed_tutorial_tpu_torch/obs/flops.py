"""Analytic FLOP models and MFU against the card's peak.

Port of the JAX package's ``obs/flops.py``, with the standard MFU
accounting: FLOPs = 2 x MACs; training = 3 x the forward (the backward
is dgrad + wgrad), the 6N rule for transformers; bandwidth-bound ops
(BatchNorm, activations, pooling, augmentation) left out. MFU is model
FLOP/s over the card's peak dense BF16 rate.

The peaks are the card's own, from NVIDIA's data sheets, keyed on
``torch.cuda.get_device_name``: an H100 SXM (HBM3) at 989 TFLOP/s dense
BF16 and 3.35 TB/s, an H100 PCIe at 756 TFLOP/s and 2.0 TB/s. Any other
name gives None, so an MFU is never computed against a made-up peak.
"""

from __future__ import annotations

__all__ = [
    "card_peaks",
    "mfu",
    "peak_flops_per_card",
    "resnet18_cifar_train_flops_per_sample",
    "transformer_train_flops_per_token",
]


def card_peaks(device_name: str) -> tuple[float, float] | None:
    """(dense BF16 FLOP/s, memory bytes/s) of a card by its name, or None."""
    if "H100" not in device_name:
        return None
    if "PCIe" in device_name:
        return 756e12, 2.0e12
    if "HBM3" in device_name:  # the SXM part: "NVIDIA H100 80GB HBM3"
        return 989e12, 3.35e12
    return None


def peak_flops_per_card(device_name: str) -> float | None:
    peaks = card_peaks(device_name)
    return None if peaks is None else peaks[0]


def resnet18_cifar_train_flops_per_sample() -> float:
    """Model FLOPs of one ResNet-18/CIFAR training step a sample: the
    convs, the stage-entry 1x1 projections and the FC head (3x3 stem at
    32x32, stages (2, 2, 2, 2) at 64/128/256/512 channels, strides
    1/2/2/2)."""

    def conv(hw: int, cin: int, cout: int, k: int = 3) -> float:
        return 2.0 * hw * hw * cin * cout * k * k

    f = conv(32, 3, 64)  # stem
    cin = 64
    for cout, hw in ((64, 32), (128, 16), (256, 8), (512, 4)):
        f += conv(hw, cin, cout) + conv(hw, cout, cout)  # block 0
        if cin != cout:  # stage-entry projection shortcut
            f += conv(hw, cin, cout, k=1)
        f += 2 * conv(hw, cout, cout)  # block 1
        cin = cout
    f += 2.0 * 512 * 10  # FC head
    return 3.0 * f


def transformer_train_flops_per_token(n_params: int | float) -> float:
    """The 6N rule: 2N forward and 4N backward FLOPs a parameter a token,
    attention scores left out."""
    return 6.0 * float(n_params)


def mfu(achieved_flops_per_sec: float, device_name: str) -> float | None:
    """Model FLOPs utilization in [0, 1], or None for a card without a
    known peak (the CPU included)."""
    peak = peak_flops_per_card(device_name)
    return None if peak is None else achieved_flops_per_sec / peak
