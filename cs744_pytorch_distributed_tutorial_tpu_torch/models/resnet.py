"""ResNet-{18,34,50}, NCHW, as ``nn.Module``s.

The JAX package's ``models/resnet.py``: "v1.5" residual networks (the
stride on the block's 3x3 conv), BatchNorm after every conv, the last
BatchNorm gamma of every block initialised to zero, two stems:

- ``cifar_stem=True``: one 3x3 conv, no max-pool (the CIFAR adaptation);
- ``cifar_stem=False``: the ImageNet 7x7/stride-2 conv + 3x3/stride-2
  max-pool.

Every conv pads as flax ``padding="SAME"`` does, which is asymmetric
where the stride does not divide evenly: a stride-2 3x3 conv over even
H, W pads (0, 1), so it is padded explicitly with ``F.pad`` and runs
with ``padding=0``. A stride-2 1x1 conv pads nothing.

``fast_conv`` routes a BasicBlock's 3x3 conv to ``FastConv3x3`` (weight
gradient from the CUDA kernel, ``ops/fused_conv.py``) under the JAX
package's rule (``BasicBlock._conv3``): stride 1 and 128 <= in and out
channels <= 256. On CIFAR ResNet-18 that is the six stride-1 convs of
stages 2 and 3; the bottleneck block accepts the flag and routes none.

Module names follow the flax tree (``conv0``/``bn0`` for the stem,
``blocks.N.convJ``/``bnJ``, ``fc``), so ``models/convert.py`` maps the
two with a table. BatchNorm uses eps 1e-5 and torch momentum 0.1 (flax
0.9); ``sync_bn`` takes the world's batch statistics
(``batchnorm.py``). Initialisation follows flax's defaults, as ``vgg.py`` does: conv
and dense kernels from a fan-in truncated normal, dense bias zero,
BatchNorm scale one (zero for each block's last), drawn from an
explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cs744_pytorch_distributed_tutorial_tpu_torch.models.batchnorm import batch_norm
from cs744_pytorch_distributed_tutorial_tpu_torch.models.vgg import _lecun_normal_
from cs744_pytorch_distributed_tutorial_tpu_torch.ops.fused_conv import conv3x3


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """flax/XLA SAME padding (low, high) of one spatial dimension."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """Bias-free square conv with flax SAME padding, asymmetric where it
    must be; symmetric padding stays the conv's own."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int = 1):
        super().__init__(in_channels, out_channels, kernel, stride=stride, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        (t, b), (l, r) = same_pads(x.shape[2], k, s), same_pads(x.shape[3], k, s)
        if t == b and l == r:
            return F.conv2d(x, self.weight, stride=s, padding=(t, l))
        return F.conv2d(F.pad(x, (l, r, t, b)), self.weight, stride=s)


class FastConv3x3(nn.Module):
    """3x3 SAME conv whose weight gradient runs the CUDA wgrad kernel
    (``ops/fused_conv.py::conv3x3``). Its parameter has ``nn.Conv2d``'s
    name and shape (``weight`` [K, C, 3, 3]), so state dicts do not care
    which of the two produced them."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 3, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv3x3(x, self.weight, self.stride)


def _conv3(cin: int, cout: int, stride: int, fast_conv: bool,
           min_ch: int = 128, max_ch: int = 256) -> nn.Module:
    """The JAX ``BasicBlock._conv3`` routing: FastConv3x3 where the
    kernel was measured to win, the library conv elsewhere."""
    if (fast_conv and stride == 1
            and min_ch <= cin <= max_ch and min_ch <= cout <= max_ch):
        return FastConv3x3(cin, cout, stride)
    return SameConv2d(cin, cout, 3, stride)


class BasicBlock(nn.Module):
    """Two 3x3 convs + identity/projection shortcut (ResNet-18/34)."""

    expansion = 1
    last_bn = "bn1"  # zero-initialised gamma

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 fast_conv: bool = False, sync_bn: bool = False):
        super().__init__()
        self.conv0 = _conv3(in_channels, features, stride, fast_conv)
        self.bn0 = batch_norm(features, sync_bn)
        self.conv1 = _conv3(features, features, 1, fast_conv)
        self.bn1 = batch_norm(features, sync_bn)
        self.project = stride != 1 or in_channels != features
        if self.project:
            self.conv2 = SameConv2d(in_channels, features, 1, stride)
            self.bn2 = batch_norm(features, sync_bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn0(self.conv0(x)))
        y = self.bn1(self.conv1(y))
        residual = self.bn2(self.conv2(x)) if self.project else x
        return F.relu(y + residual)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with 4x expansion (ResNet-50). It
    accepts ``fast_conv`` for interface parity and routes nothing, as in
    the JAX package."""

    expansion = 4
    last_bn = "bn2"  # zero-initialised gamma

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 fast_conv: bool = False, sync_bn: bool = False):
        super().__init__()
        out = features * self.expansion
        self.conv0 = SameConv2d(in_channels, features, 1)
        self.bn0 = batch_norm(features, sync_bn)
        self.conv1 = SameConv2d(features, features, 3, stride)
        self.bn1 = batch_norm(features, sync_bn)
        self.conv2 = SameConv2d(features, out, 1)
        self.bn2 = batch_norm(out, sync_bn)
        self.project = stride != 1 or in_channels != out
        if self.project:
            self.conv3 = SameConv2d(in_channels, out, 1, stride)
            self.bn3 = batch_norm(out, sync_bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn0(self.conv0(x)))
        y = F.relu(self.bn1(self.conv1(y)))
        y = self.bn2(self.conv2(y))
        residual = self.bn3(self.conv3(x)) if self.project else x
        return F.relu(y + residual)


BLOCKS = {"basic": BasicBlock, "bottleneck": BottleneckBlock}


class ResNet(nn.Module):
    """``stage_sizes`` blocks per stage of 64, 128, 256, 512 features;
    the first block of every stage after the first has stride 2."""

    def __init__(
        self,
        stage_sizes: Sequence[int],
        block: str = "basic",
        num_classes: int = 10,
        cifar_stem: bool = True,
        fast_conv: bool = False,
        generator: torch.Generator | None = None,
        sync_bn: bool = False,
    ):
        super().__init__()
        self.cifar_stem = cifar_stem
        cls = BLOCKS[block]
        if cifar_stem:
            self.conv0 = SameConv2d(3, 64, 3)
        else:
            self.conv0 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn0 = batch_norm(64, sync_bn)
        blocks: list[nn.Module] = []
        channels = 64
        for stage, n_blocks in enumerate(stage_sizes):
            for b in range(n_blocks):
                stride = 2 if stage > 0 and b == 0 else 1
                features = 64 * 2**stage
                blocks.append(cls(channels, features, stride, fast_conv, sync_bn))
                channels = features * cls.expansion
        self.blocks = nn.ModuleList(blocks)
        self.fc = nn.Linear(channels, num_classes)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, FastConv3x3)):
                _lecun_normal_(m.weight, m.weight[0].numel(), generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
            elif isinstance(m, nn.Linear):
                _lecun_normal_(m.weight, m.in_features, generator)
                m.bias.zero_()
        for blk in self.blocks:
            getattr(blk, blk.last_bn).weight.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn0(self.conv0(x)))
        if not self.cifar_stem:
            x = F.max_pool2d(x, 3, stride=2, padding=1)
        for blk in self.blocks:
            x = blk(x)
        return self.fc(x.mean(dim=(2, 3))).float()


def resnet18(**kw: Any) -> ResNet:
    return ResNet((2, 2, 2, 2), "basic", **kw)


def resnet34(**kw: Any) -> ResNet:
    return ResNet((3, 4, 6, 3), "basic", **kw)


def resnet50(**kw: Any) -> ResNet:
    return ResNet((3, 4, 6, 3), "bottleneck", **kw)
