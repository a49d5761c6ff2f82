from cs744_pytorch_distributed_tutorial_tpu_torch.data.cifar10 import (
    CIFAR10Dataset,
    load_cifar10,
    synthetic_cifar10,
    synthetic_images,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.data.loader import BatchLoader
from cs744_pytorch_distributed_tutorial_tpu_torch.data.sampler import ShardedSampler

__all__ = [
    "BatchLoader",
    "CIFAR10Dataset",
    "ShardedSampler",
    "load_cifar10",
    "synthetic_cifar10",
    "synthetic_images",
]
