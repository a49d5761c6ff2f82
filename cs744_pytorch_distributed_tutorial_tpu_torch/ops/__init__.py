"""Hand-written CUDA kernels (sources in ``csrc/``) with their wrappers
and plain PyTorch versions: ``fused_sgd`` (the SGD update),
``fused_conv`` (the 3x3 conv weight gradient), ``flash_attention``
(the attention forward, dq and dk/dv), ``paged_attention`` (the serving
engine's decode attention) and ``quant`` (the int8 weight matmul)."""

from cs744_pytorch_distributed_tutorial_tpu_torch.ops import (
    flash_attention,
    fused_conv,
    fused_sgd,
    paged_attention,
    quant,
)

__all__ = ["flash_attention", "fused_conv", "fused_sgd", "paged_attention", "quant"]
