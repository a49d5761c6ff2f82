from cs744_pytorch_distributed_tutorial_tpu_torch.train.engine import Trainer
from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMConfig, LMTrainer
from cs744_pytorch_distributed_tutorial_tpu_torch.train.state import (
    SGD,
    Optimizer,
    TrainState,
    make_optimizer,
)

__all__ = ["LMConfig", "LMTrainer", "Optimizer", "SGD", "TrainState", "Trainer", "make_optimizer"]
