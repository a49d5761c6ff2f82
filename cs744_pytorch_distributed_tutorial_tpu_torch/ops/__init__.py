"""Hand-written CUDA kernels (sources in ``csrc/``) with their wrappers
and plain PyTorch versions: ``fused_sgd`` (the SGD update),
``fused_conv`` (the 3x3 conv weight gradient), ``flash_attention``
(the attention forward, dq and dk/dv), ``fused_xent`` (the fused
cross-entropy forward and backward), ``paged_attention`` (the serving
engine's decode attention), ``quant`` (the int8 weight matmul) and
``gmm`` (dropless MoE's grouped matmuls: the forward with a bias and
gelu epilogue, and the backward's ``gmm``, ``tgmm`` and bias column
sums). ``conv_fwd_hpair`` (the H-pair-packed 3x3 conv forward of the
stage-1 probe, and the probe's entry point) is not imported here, so
that ``python -m`` runs it as a fresh module."""

from cs744_pytorch_distributed_tutorial_tpu_torch.ops import (
    flash_attention,
    fused_conv,
    fused_sgd,
    fused_xent,
    gmm,
    paged_attention,
    quant,
)

__all__ = ["flash_attention", "fused_conv", "fused_sgd", "fused_xent", "gmm", "paged_attention",
           "quant"]
