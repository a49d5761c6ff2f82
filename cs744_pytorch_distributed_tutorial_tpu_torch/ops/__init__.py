"""Hand-written CUDA kernels (sources in ``csrc/``) with their wrappers
and plain PyTorch versions: ``fused_sgd`` (the SGD update) and
``fused_conv`` (the 3x3 conv weight gradient)."""

from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_conv, fused_sgd

__all__ = ["fused_conv", "fused_sgd"]
