"""On-device metrics, ported from the JAX package's ``obs/metrics.py``:
so far the MoE router's ``expert_load_entropy``."""

from __future__ import annotations

import math

import torch


def expert_load_entropy(load: torch.Tensor) -> torch.Tensor:
    """Normalized entropy of per-expert token-load fractions [..., E]:
    entropy / log(E) in [0, 1], averaged over leading dimensions (1.0 is
    balanced routing, 0.0 total collapse onto one expert); 1.0 for one
    expert. A 0-d fp32 tensor on ``load``'s device."""
    load = load.float()
    e = load.shape[-1]
    if e <= 1:
        return torch.ones((), device=load.device)
    p = load / load.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    ent = -(p * torch.log(p + 1e-9)).sum(dim=-1)
    return ent.mean() / math.log(e)
