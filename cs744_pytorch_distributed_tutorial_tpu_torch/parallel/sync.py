"""Gradient-sync strategies — the reference's parts as plug-ins.

=================  =============================================  ==========================
strategy           reference                                      mechanism here
=================  =============================================  ==========================
``none``           part1 (single process, no comm)                identity
``gather_scatter`` part2a  (``master/part2a/part2a.py:42-52``)    gather to rank 0, scatter
``p2p_star``       part2a_extra (``part2a_extra.py:41-58``)       sequential isend/irecv star
``allreduce``      part2b  (``master/part2b/part2b.py:43-45``)    divide + all_reduce(SUM)
``ring``           (explicit variant)                             neighbour send/recv ring
``auto``           part3 DDP (``master/part3/part3.py:116``)      DistributedDataParallel
=================  =============================================  ==========================

A strategy is ``fn(tensor, world_size) -> mean tensor``, applied per
parameter after ``backward()`` — the reference's
``for p in model.parameters():`` loops. ``auto`` is the trainer's: it
wraps the model in ``DistributedDataParallel``, whose reducer averages
the gradients during ``backward()``; called directly it is an
all-reduce mean, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import collectives as C

SyncFn = Callable[[torch.Tensor, int], torch.Tensor]


def _none(g: torch.Tensor, world_size: int) -> torch.Tensor:
    """part1: single process, no communication."""
    return g


SYNC_STRATEGIES: dict[str, SyncFn] = {
    "none": _none,
    "allreduce": C.all_reduce_mean,
    "gather_scatter": C.gather_scatter_mean,
    "p2p_star": C.star_mean,
    "ring": C.ring_all_reduce_mean,
    "auto": C.all_reduce_mean,
}

# Strategies of the JAX package that the port does not run yet.
_NOT_YET_PORTED = ("zero1", "fsdp", "int8_allreduce", "int8_ring")


def get_sync(name: str) -> SyncFn:
    if name in _NOT_YET_PORTED:
        raise NotImplementedError(f"sync strategy {name!r} is not yet ported")
    try:
        return SYNC_STRATEGIES[name]
    except KeyError:
        raise ValueError(
            f"unknown sync strategy {name!r}; choose from {sorted(SYNC_STRATEGIES)}"
        ) from None


@torch.no_grad()
def sync_grads(grads: Sequence[torch.Tensor], name: str, world_size: int) -> None:
    """Replace every gradient with its mean over the world, in place."""
    fn = get_sync(name)
    if fn is _none:
        return
    for g in grads:
        g.copy_(fn(g, world_size))


def sync_wire_bytes(
    params: Sequence[torch.Tensor] | int, name: str, world_size: int
) -> int:
    """Analytic gradient-sync payload bytes sent per rank per step
    (the JAX package's ``buckets.sync_bytes_per_step`` for the float
    strategies): 2(n-1)/n of the gradient bytes for allreduce, ring,
    auto and the star (the star's cost is serialisation, not mean
    bytes); (n-1) x for gather_scatter; 0 for none or a world of one.
    ``params`` is a parameter list or an fp32 element count."""
    get_sync(name)
    if isinstance(params, int):
        nbytes = 4 * params
    else:
        nbytes = sum(p.numel() * p.element_size() for p in params)
    n = int(world_size)
    if name == "none" or n <= 1:
        return 0
    if name == "gather_scatter":
        return int((n - 1) * nbytes)
    return int(2.0 * (n - 1) / n * nbytes)
