"""Autoregressive generation (``generate.py``). Beam search and
speculative decoding are not ported yet."""

from cs744_pytorch_distributed_tutorial_tpu_torch.infer.generate import (
    make_generator,
    sample_tokens,
)

__all__ = ["make_generator", "sample_tokens"]
