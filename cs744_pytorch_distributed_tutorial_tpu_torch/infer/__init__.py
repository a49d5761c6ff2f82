"""Autoregressive generation (``generate.py``), beam search
(``beam.py``) and speculative decoding (``speculative.py``)."""

from cs744_pytorch_distributed_tutorial_tpu_torch.infer.beam import make_beam_searcher
from cs744_pytorch_distributed_tutorial_tpu_torch.infer.generate import (
    make_generator,
    sample_tokens,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.infer.speculative import (
    make_speculative_generator,
)

__all__ = ["make_beam_searcher", "make_generator", "make_speculative_generator", "sample_tokens"]
