from cs744_pytorch_distributed_tutorial_tpu_torch.data.cifar10 import (
    CIFAR10Dataset,
    load_cifar10,
    synthetic_cifar10,
    synthetic_images,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.data.loader import BatchLoader
from cs744_pytorch_distributed_tutorial_tpu_torch.data.native_batcher import gather_rows
from cs744_pytorch_distributed_tutorial_tpu_torch.data.prefetch import PrefetchIterator, prefetch
from cs744_pytorch_distributed_tutorial_tpu_torch.data.sampler import ShardedSampler
from cs744_pytorch_distributed_tutorial_tpu_torch.data.text import (
    BYTE_VOCAB,
    byte_corpus,
    synthetic_tokens,
)

__all__ = [
    "BYTE_VOCAB",
    "BatchLoader",
    "CIFAR10Dataset",
    "PrefetchIterator",
    "ShardedSampler",
    "byte_corpus",
    "gather_rows",
    "load_cifar10",
    "prefetch",
    "synthetic_cifar10",
    "synthetic_images",
    "synthetic_tokens",
]
