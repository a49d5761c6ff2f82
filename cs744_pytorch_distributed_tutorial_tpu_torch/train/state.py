"""Train state and the reference optimizer.

Optimizer: SGD lr=0.1, momentum=0.9, weight_decay=1e-4 — the reference's
exact update rule (``master/part1/part1.py:98-99``), with torch-SGD
semantics: decay is added to the gradient BEFORE the momentum update
(g += wd*p; buf = mu*buf + g; p -= lr*buf). Every replica holds the full
parameters and momentum, as in the reference.

The LM trainer's optimizers (``make_lm_optimizer``): AdamW with
``optax.adamw`` semantics or the same SGD, at a constant lr or after a
linear warmup from 0 (``make_schedule``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

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
    # The int8 wire's error feedback: one fp32 residual per parameter,
    # this rank's own (empty without compression).
    ef: list[torch.Tensor] = dataclasses.field(default_factory=list)


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


def make_schedule(learning_rate: float, lr_schedule: str = "constant",
                  warmup_steps: int = 0) -> Callable[[int], float]:
    """lr as a function of the update count (0 for the first update): a
    constant, or ``optax.linear_schedule(0, lr, warmup_steps)``. Cosine
    schedules raise "not yet ported"."""
    if lr_schedule in ("cosine", "warmup_cosine"):
        raise NotImplementedError(f"lr_schedule {lr_schedule!r} is not yet ported")
    if lr_schedule != "constant":
        raise ValueError(
            f"unknown lr_schedule {lr_schedule!r}; choose from "
            "('constant', 'cosine', 'warmup_cosine')"
        )
    if not warmup_steps:
        return lambda count: learning_rate

    def warmup(count: int) -> float:
        frac = 1.0 - min(count, warmup_steps) / warmup_steps
        return (0.0 - learning_rate) * frac + learning_rate

    return warmup


class AdamW:
    """``optax.adamw(lr, b1, b2=0.999, eps=1e-8, weight_decay)``:
    bias-corrected Adam moments, then decoupled decay ``lr * wd * p`` on
    every parameter (optax masks none: biases, norms and embeddings decay
    too). ``torch.optim.AdamW`` with one parameter group computes the
    same update; its lr is set from the schedule before each step."""

    def __init__(self, params: Sequence[torch.Tensor], schedule: Callable[[int], float],
                 b1: float, weight_decay: float, b2: float = 0.999, eps: float = 1e-8):
        self.schedule, self.count = schedule, 0
        self.opt = torch.optim.AdamW(list(params), lr=schedule(0), betas=(b1, b2),
                                     eps=eps, weight_decay=weight_decay)

    @torch.no_grad()
    def step(self) -> None:
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(self.count)
        self.opt.step()
        self.count += 1


class ScheduledSGD:
    """``SGD`` (torch-SGD momentum and decay) with its lr from a schedule."""

    def __init__(self, params: Sequence[torch.Tensor], schedule: Callable[[int], float],
                 momentum: float, weight_decay: float):
        self.params, self.schedule, self.count = list(params), schedule, 0
        self.sgd = SGD(schedule(0), momentum, weight_decay)
        self.momentum = self.sgd.init(self.params)

    @torch.no_grad()
    def step(self) -> None:
        self.sgd.learning_rate = self.schedule(self.count)
        self.sgd.apply(self.params, self.momentum, [p.grad for p in self.params])
        self.count += 1


def make_lm_optimizer(cfg, params: Sequence[torch.Tensor]) -> AdamW | ScheduledSGD:
    """The LM config's optimizer over ``params`` (``adamw`` or ``sgd``,
    with ``momentum`` as Adam's b1 or SGD's momentum); ``lion`` raises
    "not yet ported"."""
    schedule = make_schedule(cfg.learning_rate, cfg.lr_schedule, cfg.warmup_steps)
    if cfg.optimizer == "adamw":
        return AdamW(params, schedule, cfg.momentum, cfg.weight_decay)
    if cfg.optimizer == "sgd":
        return ScheduledSGD(params, schedule, cfg.momentum, cfg.weight_decay)
    if cfg.optimizer == "lion":
        raise NotImplementedError("optimizer 'lion' is not yet ported")
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}; choose from ('sgd', 'adamw', 'lion')")
