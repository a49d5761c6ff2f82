"""VGG for 32x32 inputs, NCHW, as ``nn.Module``s.

Capability parity with the reference's ``master/part1/model.py``: a
config-table-driven stack of Conv(3x3, pad 1, bias) + BatchNorm + ReLU
per entry and MaxPool(2,2) at ``'M'`` (``model.py:11-27``), flattened
into a single Linear head (``model.py:30-46``). The module names are the
reference ``_VGG``'s (``layers.N.*``, ``fc1.*``), so its ``state_dict``
loads as it is.

BatchNorm uses eps 1e-5 and torch momentum 0.1, which is flax's 0.9;
``sync_bn`` takes the world's batch statistics (``batchnorm.py``).
One difference from the JAX package stays: torch stores the
Bessel-corrected (n/(n-1)) batch variance in ``running_var``, flax the
biased one — an O(1/n) eval-mode difference the tests pin.

Initialization follows the JAX package (flax defaults): conv and dense
kernels from a fan-in truncated normal (``lecun_normal``), biases zero,
BatchNorm scale one. It draws from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import torch
from torch import nn

from cs744_pytorch_distributed_tutorial_tpu_torch.models.batchnorm import batch_norm

# Layer tables: channel count = conv(3x3)+BN+ReLU block, 'M' = 2x2 maxpool.
# The reference's _cfg layouts (model.py:3-8).
VGG_CFGS: dict[str, tuple] = {
    "vgg11": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "vgg13": (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "vgg16": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
              512, 512, 512, "M"),
    "vgg19": (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"),
}

# flax's truncated_normal stddev correction for truncation at +-2 sigma.
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    w.mul_(math.sqrt(1.0 / fan_in) / _TRUNC_STD)


def feature_map_size(cfg: Sequence[Any], image_size: int) -> tuple[int, int]:
    """(channels, spatial side) of the map the head flattens."""
    channels = [e for e in cfg if e != "M"][-1]
    side = image_size // 2 ** sum(1 for e in cfg if e == "M")
    return int(channels), side


class VGG(nn.Module):
    """VGG-{11,13,16,19} (or any conv table) for NCHW inputs."""

    def __init__(
        self,
        cfg: Sequence[Any],
        num_classes: int = 10,
        image_size: int = 32,
        generator: torch.Generator | None = None,
        sync_bn: bool = False,
    ):
        super().__init__()
        self.cfg = tuple(cfg)
        layers: list[nn.Module] = []
        c_in = 3
        for entry in self.cfg:
            if entry == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [
                    nn.Conv2d(c_in, int(entry), 3, padding=1, bias=True),
                    batch_norm(int(entry), sync_bn),
                    nn.ReLU(inplace=True),
                ]
                c_in = int(entry)
        self.layers = nn.Sequential(*layers)
        channels, side = feature_map_size(self.cfg, image_size)
        if side < 1:
            raise ValueError(f"image_size {image_size} too small for {len(cfg)} layers")
        self.fc1 = nn.Linear(channels * side * side, num_classes)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                _lecun_normal_(m.weight, m.in_channels * 9, generator)
                m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
            elif isinstance(m, nn.Linear):
                _lecun_normal_(m.weight, m.in_features, generator)
                m.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.layers(x)
        return self.fc1(torch.flatten(x, 1)).float()


def vgg11(**kw: Any) -> VGG:
    """The reference's sole export (``model.py:49-50``)."""
    return VGG(VGG_CFGS["vgg11"], **kw)


def vgg13(**kw: Any) -> VGG:
    return VGG(VGG_CFGS["vgg13"], **kw)


def vgg16(**kw: Any) -> VGG:
    return VGG(VGG_CFGS["vgg16"], **kw)


def vgg19(**kw: Any) -> VGG:
    return VGG(VGG_CFGS["vgg19"], **kw)
