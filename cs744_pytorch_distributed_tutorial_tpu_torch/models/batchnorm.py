"""SyncBN: BatchNorm whose training statistics are the world's.

The JAX package's ``sync_bn`` is flax ``BatchNorm(axis_name="data")``
(its ``models/vgg.py``, ``models/resnet.py``); this computes flax's
arithmetic, not PyTorch's (``nn.SyncBatchNorm`` takes Welford
statistics and runs a backward of its own):

- the per-channel ``mean(x)`` and ``mean(x * x)`` in fp32, stacked and
  averaged over the world (``collectives.AllReduceMean``, whose
  backward averages the cotangents: the gradient flows through the
  all-reduce), then ``var = max(0, E[x^2] - E[x]^2)`` (flax's
  ``use_fast_variance``);
- ``y = (x - mean) * (rsqrt(var + eps) * weight) + bias``, flax's
  ``_normalize`` order.

The running statistics keep the port's conventions (``vgg.py``): torch
momentum 0.1, and the Bessel-corrected variance, over the global count
of the statistic (world x batch x H x W). In eval mode it is
``nn.BatchNorm2d``. Without a process group the world is this process,
and the arithmetic above still applies (not cuDNN's: they differ by
rounding).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.collectives import AllReduceMean


class SyncBatchNorm2d(nn.BatchNorm2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        x32 = x.float()
        stats = torch.stack([x32.mean(dim=(0, 2, 3)), x32.square().mean(dim=(0, 2, 3))])
        world = 1
        if dist.is_initialized():
            world = dist.get_world_size()
            stats = AllReduceMean.apply(stats)
        mean, mean_sq = stats[0], stats[1]
        var = torch.clamp(mean_sq - mean.square(), min=0.0)
        with torch.no_grad():
            count = world * (x.numel() // x.shape[1])
            m = self.momentum
            self.running_mean.copy_(m * mean + (1 - m) * self.running_mean)
            self.running_var.copy_(m * var * (count / max(count - 1, 1))
                                   + (1 - m) * self.running_var)
            self.num_batches_tracked += 1
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x32 - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


def batch_norm(channels: int, sync_bn: bool = False) -> nn.BatchNorm2d:
    """The models' BatchNorm: eps 1e-5, torch momentum 0.1 (flax 0.9)."""
    cls = SyncBatchNorm2d if sync_bn else nn.BatchNorm2d
    return cls(channels, eps=1e-5, momentum=0.1)
