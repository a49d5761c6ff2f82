"""Train state, the reference optimizer and the optimizer registry.

The reference's recipe is SGD lr=0.1, momentum=0.9, weight_decay=1e-4
(``master/part1/part1.py:98-99``), with torch-SGD semantics: decay is
added to the gradient BEFORE the momentum update (g += wd*p; buf =
mu*buf + g; p -= lr*buf). Every replica holds the full parameters and
momentum, as in the reference; ``parallel/zero.py`` shards them.

The JAX package's registry (its ``train/state.py``) as plain tensor
ops: ``make_schedule`` (constant, linear warmup, cosine, warmup +
cosine), ``make_optimizer`` (``sgd``, ``adamw``, ``lion``, each behind
an optional ``clip_by_global_norm``), and ``make_lm_optimizer`` (the
same, bound to the LM's parameter list). Each rule keeps optax's order
of operations, rounding after every multiply and add, so that one
update on the same inputs is optax's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.config import TrainConfig
from cs744_pytorch_distributed_tutorial_tpu_torch.ops.fused_sgd import (
    FusedSGD,
    fused_sgd_plain,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.mesh import spec_axes

OPTIMIZERS = ("sgd", "adamw", "lion")
LR_SCHEDULES = ("constant", "cosine", "warmup_cosine")
#: optax.adamw's and optax.lion's second-moment decays.
ADAM_B2, LION_B2 = 0.999, 0.99
ADAM_EPS = 1e-8


@dataclasses.dataclass
class TrainState:
    step: int
    # The model's parameters, updated in place; under sync="fsdp", this
    # rank's [chunk] row of each one's flat [world, chunk] layout.
    params: list[torch.Tensor]
    # One fp32 buffer per parameter (SGD's trace, AdamW's and Lion's
    # first moment); under zero1 and fsdp, this rank's [chunk] row.
    momentum: list[torch.Tensor]
    # The int8 wire's error feedback: one fp32 residual per parameter,
    # this rank's own (empty without compression).
    ef: list[torch.Tensor] = dataclasses.field(default_factory=list)


# ------------------------------------------------------------- schedules
_f32 = np.float32  # optax evaluates its schedules in float32


def _linear(init: float, end: float, steps: int) -> Callable[[int], np.float32]:
    """``optax.linear_schedule(init, end, steps)`` in float32."""

    def schedule(count: int) -> np.float32:
        frac = _f32(1) - _f32(min(max(count, 0), steps)) / _f32(steps)
        return _f32(init - end) * frac + _f32(end)

    return schedule


def _cosine(init: float, decay_steps: int) -> Callable[[int], np.float32]:
    """``optax.cosine_decay_schedule(init, decay_steps)`` (alpha 0,
    exponent 1) in float32: the cosine of the float32 argument, rounded
    once."""

    def schedule(count: int) -> np.float32:
        t = _f32(min(count, decay_steps))
        arg = _f32(math.pi) * t / _f32(decay_steps)
        decay = _f32(0.5) * (_f32(1) + _f32(math.cos(float(arg))))
        return _f32(init) * decay

    return schedule


def make_schedule(cfg) -> Callable[[int], float]:
    """The learning rate as a function of the update count (0 for the
    first update), the JAX ``make_schedule``: a constant, or a linear
    warmup from 0 over ``warmup_steps``; ``cosine`` decays to 0 over
    ``total_steps``; with ``warmup_steps`` either cosine schedule is
    ``optax.warmup_cosine_decay_schedule(0, lr, warmup_steps,
    total_steps)``, whose cosine spans ``total_steps - warmup_steps``.
    Values are optax's float32 values, as Python floats."""
    lr, warmup = cfg.learning_rate, cfg.warmup_steps
    if cfg.lr_schedule == "constant":
        if not warmup:
            return lambda count: lr
        ramp = _linear(0.0, lr, warmup)
        return lambda count: float(ramp(count))
    if cfg.lr_schedule not in LR_SCHEDULES:
        raise ValueError(
            f"unknown lr_schedule {cfg.lr_schedule!r}; choose from {LR_SCHEDULES}"
        )
    if not cfg.total_steps:
        raise ValueError(
            f"lr_schedule={cfg.lr_schedule!r} needs total_steps (the decay "
            "horizon); set cfg.total_steps = epochs * steps_per_epoch"
        )
    if not warmup:
        cos = _cosine(lr, cfg.total_steps)
        return lambda count: float(cos(count))
    ramp, cos = _linear(0.0, lr, warmup), _cosine(lr, cfg.total_steps - warmup)
    return lambda count: float(ramp(count) if count < warmup else cos(count - warmup))


# ----------------------------------------------------------------- clip
def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float) -> list[torch.Tensor]:
    """``optax.clip_by_global_norm``: the gradients as they are when their
    global norm (over fp32 squares) is below ``max_norm``, else ``g /
    norm * max_norm``. Chosen on the device, without a host sync. Not
    ``torch.nn.utils.clip_grad_norm_``, whose ``max_norm / (norm + 1e-6)``
    is another function."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.obs.metrics import tree_l2_norm

    return clip_by_norm(grads, tree_l2_norm(grads), max_norm)


def clip_by_global_norm_sharded(grads: Sequence[torch.Tensor], max_norm: float,
                                specs: Sequence[tuple], mesh) -> list[torch.Tensor]:
    """``clip_by_global_norm`` over tensor- or expert-split gradients (the
    JAX ``clip_by_global_norm_sharded``): each gradient's squared sum is
    summed over the axes its spec names (``obs/metrics.py::
    tree_sq_norm``), so the norm is the global gradient's on every rank,
    replicated gradients (the same on every rank after the sync) counted
    once; then optax's choice, ``g / norm * max_norm`` above the bound."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.obs.metrics import tree_l2_norm

    if max_norm <= 0:
        raise ValueError(f"max_norm must be > 0, got {max_norm}")
    return clip_by_norm(grads, tree_l2_norm(grads, [spec_axes(s) for s in specs], mesh),
                        max_norm)


def clip_by_norm(grads: Sequence[torch.Tensor], norm: torch.Tensor,
                 max_norm: float) -> list[torch.Tensor]:
    """``clip_by_global_norm``'s choice for a given global ``norm`` (0-d)."""
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm.to(g.dtype) * max_norm) for g in grads]


# ------------------------------------------------------------ optimizers
class SGD(FusedSGD):
    """torch-SGD(momentum, weight decay) at a fixed lr in plain tensor ops,
    on any device (the JAX package's optax chain add_decayed_weights ->
    trace -> scale): the reference's update without the fused kernel."""

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


class Optimizer:
    """One of the registry's rules behind an optional global-norm clip,
    at ``lr = schedule(count)`` (the JAX ``make_optimizer``'s optax chain):

    - ``sgd``: ``add_decayed_weights -> trace -> scale(-lr)``, the
      reference's update (``fused_sgd_plain``);
    - ``adamw``: ``optax.adamw(lr, b1=momentum, b2=0.999, eps=1e-8,
      weight_decay)``: bias-corrected moments, then decoupled decay
      ``lr * wd * p`` on every parameter (optax masks none);
    - ``lion``: ``optax.lion(lr, b1=momentum, b2=0.99, weight_decay)``:
      ``sign((1 - b1) g + b1 m)``, then ``m = b2 m + (1 - b2) g``, then
      the decoupled decay; ``sign(0) = 0``.

    ``init`` returns the first moments (the trainer's
    ``TrainState.momentum``); AdamW's second moments live here, in
    ``nu``. The lists go through ``torch._foreach_*`` ops: a few
    multi-tensor launches an update on the card."""

    def __init__(self, rule: str, schedule: Callable[[int], float], momentum: float,
                 weight_decay: float, clip_norm: float | None = None):
        if rule not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {rule!r}; choose from {OPTIMIZERS}")
        self.rule, self.schedule, self.clip_norm = rule, schedule, clip_norm
        self.b1, self.weight_decay = momentum, weight_decay
        self.count = 0
        self.nu: list[torch.Tensor] = []

    def init(self, params: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        if self.rule == "adamw":
            self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        return [torch.zeros_like(p, dtype=torch.float32) for p in params]

    @torch.no_grad()
    def apply(self, params: Sequence[torch.Tensor], momentum: Sequence[torch.Tensor],
              grads: Sequence[torch.Tensor]) -> None:
        params, momentum = list(params), list(momentum)
        grads = list(grads)
        if self.clip_norm is not None:
            grads = clip_by_global_norm(grads, self.clip_norm)
        lr = self.schedule(self.count)
        if self.rule == "sgd":
            for p, m, g in zip(params, momentum, grads, strict=True):
                fused_sgd_plain(p, m, g, lr=lr, mu=self.b1, wd=self.weight_decay)
        elif self.rule == "adamw":
            self._adamw(params, momentum, grads, lr)
        else:
            self._lion(params, momentum, grads, lr)
        self.count += 1

    def _decay_and_step(self, params: list, updates: list, lr: float) -> None:
        """``u + wd * p``, then ``p + (-lr) * u``, each rounded."""
        torch._foreach_add_(params, decayed_deltas(params, updates, lr, self.weight_decay))

    def _adamw(self, params: list, mu: list, grads: list, lr: float) -> None:
        updates = adamw_updates(mu, self.nu, grads, self.count + 1, self.b1)
        self._decay_and_step(params, updates, lr)

    def _lion(self, params: list, mu: list, grads: list, lr: float) -> None:
        self._decay_and_step(params, lion_updates(mu, grads, self.b1), lr)


# The rules' arithmetic on lists of tensors, shared by ``Optimizer`` and
# the sharded rules of ``parallel/zero.py`` (which run them on this
# rank's rows): the same multi-tensor ops in the same order, so a rule
# gives the same bits on a whole tensor and on a row that holds it.
def _moment(m: list, x: list, decay: float) -> None:
    """``m = (1 - decay) * x + decay * m`` in place (optax's
    ``update_moment``)."""
    t = torch._foreach_mul(x, 1.0 - decay)
    torch._foreach_mul_(m, decay)
    torch._foreach_add_(m, t)


def adam_bias_corrections(b1: float, count: int) -> tuple[float, float]:
    """optax's ``1 - b ** count`` for both moments at the incremented
    ``count``, in float32."""
    return (float(_f32(1) - _f32(b1) ** count), float(_f32(1) - _f32(ADAM_B2) ** count))


def adamw_updates(mu: list, nu: list, grads: list, count: int, b1: float) -> list:
    """AdamW's moments updated in place and its updates ``mu_hat /
    (sqrt(nu_hat) + eps)`` before the decay, at the incremented ``count``."""
    _moment(mu, grads, b1)
    _moment(nu, torch._foreach_mul(grads, grads), ADAM_B2)
    bc1, bc2 = adam_bias_corrections(b1, count)
    mu_hat = torch._foreach_div(mu, bc1)
    denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
    torch._foreach_add_(denom, ADAM_EPS)
    return torch._foreach_div(mu_hat, denom)


def lion_updates(mu: list, grads: list, b1: float) -> list:
    """Lion's ``sign((1 - b1) g + b1 m)``; then ``m`` moves to ``b2 m +
    (1 - b2) g`` in place."""
    mixed = torch._foreach_mul(grads, 1.0 - b1)
    torch._foreach_add_(mixed, torch._foreach_mul(mu, b1))
    updates = torch._foreach_sign(mixed)
    _moment(mu, grads, LION_B2)
    return updates


def sgd_deltas(params: list, mu: list, grads: list, lr: float, b1: float,
               weight_decay: float) -> list:
    """torch-SGD's step: ``g + wd p``, then the trace ``mu m + that`` in
    place, and the deltas ``-lr m`` (``fused_sgd_plain``'s arithmetic:
    ``p + (-lr m)`` is ``p - lr m``)."""
    g_eff = torch._foreach_add(grads, torch._foreach_mul(params, weight_decay))
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, g_eff)
    return torch._foreach_mul(mu, -lr)


def decayed_deltas(params: list, updates: list, lr: float, weight_decay: float) -> list:
    """``(u + wd * p) * (-lr)`` in place of ``updates``: the parameter
    deltas of the decoupled-decay rules, each operation rounded."""
    torch._foreach_add_(updates, torch._foreach_mul(params, weight_decay))
    torch._foreach_mul_(updates, -lr)
    return updates


def check_recipe(cfg: TrainConfig) -> None:
    """The registry's own checks (the JAX ``make_optimizer``): known
    names, a horizon for the cosine schedules, a positive clip."""
    if cfg.optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}; choose from {OPTIMIZERS}")
    make_schedule(cfg)
    if cfg.grad_clip_norm is not None and cfg.grad_clip_norm <= 0:
        raise ValueError(f"grad_clip_norm must be > 0, got {cfg.grad_clip_norm}")


def is_reference_recipe(cfg) -> bool:
    """Unclipped SGD(momentum) at a fixed lr: what the fused kernel, the
    overlapped schedule and the sharded optimizers hard-code."""
    return (cfg.optimizer == "sgd" and cfg.lr_schedule == "constant"
            and not cfg.warmup_steps and cfg.grad_clip_norm is None)


def make_optimizer(cfg: TrainConfig) -> FusedSGD | Optimizer:
    """The reference's recipe through the fused kernel (``fused_optimizer``)
    or plain ops (``SGD``); any other recipe through ``Optimizer``."""
    check_recipe(cfg)
    if is_reference_recipe(cfg):
        cls = FusedSGD if cfg.fused_optimizer else SGD
        return cls(cfg.learning_rate, cfg.momentum, cfg.weight_decay)
    return Optimizer(cfg.optimizer, make_schedule(cfg), cfg.momentum, cfg.weight_decay,
                     cfg.grad_clip_norm)


class BoundOptimizer:
    """An ``Optimizer`` over a fixed parameter list whose ``step()``
    reads each parameter's ``grad`` (the LM trainer's interface)."""

    def __init__(self, tx: Optimizer, params: Sequence[torch.Tensor]):
        self.tx, self.params = tx, list(params)
        self.momentum = tx.init(self.params)

    def step(self) -> None:
        self.tx.apply(self.params, self.momentum, [p.grad for p in self.params])


def make_lm_optimizer(cfg, params: Sequence[torch.Tensor]) -> BoundOptimizer:
    """The LM config's optimizer over ``params``: the same registry (the
    JAX LM builds its optimizer with the same ``make_optimizer``)."""
    check_recipe(cfg)
    tx = Optimizer(cfg.optimizer, make_schedule(cfg), cfg.momentum, cfg.weight_decay,
                   cfg.grad_clip_norm)
    return BoundOptimizer(tx, params)
