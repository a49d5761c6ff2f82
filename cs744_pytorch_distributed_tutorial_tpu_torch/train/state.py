"""Train state and the reference optimizer.

Optimizer: SGD lr=0.1, momentum=0.9, weight_decay=1e-4 — the reference's
exact update rule (``master/part1/part1.py:98-99``), with torch-SGD
semantics: decay is added to the gradient BEFORE the momentum update
(g += wd*p; buf = mu*buf + g; p -= lr*buf). Every replica holds the full
parameters and momentum, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.config import TrainConfig
from cs744_pytorch_distributed_tutorial_tpu_torch.ops.fused_sgd import (
    FusedSGD,
    fused_sgd_plain,
)


@dataclasses.dataclass
class TrainState:
    step: int
    params: list[torch.Tensor]  # the model's parameters, updated in place
    momentum: list[torch.Tensor]  # one fp32 buffer per parameter


class SGD(FusedSGD):
    """torch-SGD(momentum, weight decay) at a fixed lr in plain tensor ops,
    on any device (the JAX package's optax chain add_decayed_weights ->
    trace -> scale): the update without the fused kernel."""

    @torch.no_grad()
    def apply(
        self,
        params: Sequence[torch.Tensor],
        momentum: Sequence[torch.Tensor],
        grads: Sequence[torch.Tensor],
    ) -> None:
        for p, m, g in zip(params, momentum, grads, strict=True):
            fused_sgd_plain(
                p, m, g, lr=self.learning_rate, mu=self.momentum, wd=self.weight_decay
            )


def check_optimizer_options(cfg: TrainConfig) -> None:
    """The port runs the reference's recipe only: unclipped SGD(momentum)
    at a fixed lr. Everything else raises."""
    if cfg.optimizer != "sgd":
        if cfg.optimizer in ("adamw", "lion"):
            raise NotImplementedError(f"optimizer {cfg.optimizer!r} is not yet ported")
        raise ValueError(
            f"unknown optimizer {cfg.optimizer!r}; choose from ('sgd', 'adamw', 'lion')"
        )
    if cfg.lr_schedule != "constant":
        if cfg.lr_schedule in ("cosine", "warmup_cosine"):
            raise NotImplementedError(
                f"lr_schedule {cfg.lr_schedule!r} is not yet ported"
            )
        raise ValueError(
            f"unknown lr_schedule {cfg.lr_schedule!r}; choose from "
            "('constant', 'cosine', 'warmup_cosine')"
        )
    if cfg.warmup_steps or cfg.grad_clip_norm is not None:
        raise NotImplementedError(
            f"warmup_steps={cfg.warmup_steps}/grad_clip_norm={cfg.grad_clip_norm} "
            "are not yet ported; the port runs unclipped SGD(momentum) at a "
            "fixed lr"
        )


def make_optimizer(cfg: TrainConfig) -> SGD | FusedSGD:
    check_optimizer_options(cfg)
    cls = FusedSGD if cfg.fused_optimizer else SGD
    return cls(cfg.learning_rate, cfg.momentum, cfg.weight_decay)
