"""Hand-written CUDA kernels (sources in ``csrc/``) with their wrappers
and plain PyTorch versions: ``fused_sgd`` (the SGD update),
``fused_conv`` (the 3x3 conv weight gradient) and ``flash_attention``
(the attention forward, dq and dk/dv)."""

from cs744_pytorch_distributed_tutorial_tpu_torch.ops import (
    flash_attention,
    fused_conv,
    fused_sgd,
)

__all__ = ["flash_attention", "fused_conv", "fused_sgd"]
