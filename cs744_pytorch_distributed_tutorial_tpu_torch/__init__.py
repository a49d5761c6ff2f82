"""PyTorch/CUDA port of the CS744 data-parallel training framework.

A second package beside the JAX one (``cs744_pytorch_distributed_tutorial_tpu``),
written in PyTorch with ``torch.distributed`` and hand-written Hopper
kernels under ``csrc/``. It imports nothing from the JAX package; the
tests hold each module against its JAX counterpart on the same inputs.

Entry points run on ``cuda`` unless the caller asks for ``device="cpu"``
(``--device cpu`` on the command line); without a GPU and without that
request they raise rather than fall back.
"""

from cs744_pytorch_distributed_tutorial_tpu_torch.config import (
    PART_PRESETS,
    TrainConfig,
    config_for_part,
)

__all__ = ["PART_PRESETS", "TrainConfig", "config_for_part"]
