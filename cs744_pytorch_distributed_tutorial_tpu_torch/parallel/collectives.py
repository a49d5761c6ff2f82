"""Gradient-averaging collectives over ``torch.distributed``.

The reference's communication: ``gather``, ``scatter``, ``all_reduce``,
``isend``/``irecv`` (``master/part2a/part2a.py:42-52``,
``master/part2b/part2b.py:43-45``, ``master/part2a/part2a_extra.py:42-58``).
Each function takes one rank's tensor and returns the mean over the
world; they differ in the shape of their communication, which is what
the tutorial teaches. A process group must be initialized.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist


def all_reduce_mean(x: torch.Tensor, world_size: int) -> torch.Tensor:
    """part2b: ``p.grad /= N; dist.all_reduce(p.grad, SUM)``
    (``master/part2b/part2b.py:43-45``)."""
    y = x / world_size
    dist.all_reduce(y, op=dist.ReduceOp.SUM)
    return y


def gather_scatter_mean(x: torch.Tensor, world_size: int) -> torch.Tensor:
    """part2a: rank 0 ``gather``s every rank's tensor, averages, and
    ``scatter``s the mean back (``master/part2a/part2a.py:42-52``)."""
    x = x.contiguous()
    out = torch.empty_like(x)
    if dist.get_rank() == 0:
        gathered = [torch.empty_like(x) for _ in range(world_size)]
        dist.gather(x, gathered, dst=0)
        mean = torch.stack(gathered).mean(dim=0)
        dist.scatter(out, [mean] * world_size, src=0)
    else:
        dist.gather(x, None, dst=0)
        dist.scatter(out, None, src=0)
    return out


def star_mean(x: torch.Tensor, world_size: int) -> torch.Tensor:
    """part2a_extra: the parameter-server star of point-to-point hops.
    Rank 0 receives each worker's tensor in turn, each ``irecv``
    immediately waited, averages, then sends the mean back one worker at
    a time (``master/part2a/part2a_extra.py:42-58``)."""
    x = x.contiguous()
    if dist.get_rank() == 0:
        acc = x.clone()
        buf = torch.empty_like(x)
        for k in range(1, world_size):
            dist.irecv(buf, src=k).wait()
            acc += buf
        mean = acc / world_size
        for k in range(1, world_size):
            dist.isend(mean, dst=k).wait()
        return mean
    dist.isend(x, dst=0).wait()
    out = torch.empty_like(x)
    dist.irecv(out, src=0).wait()
    return out


def ring_hop(send: Sequence[torch.Tensor], recv: Sequence[torch.Tensor]) -> None:
    """One hop up the ring: ``send`` to rank + 1 and ``recv`` from rank - 1
    at once, one batch of pairs, so no rank blocks on a send its
    neighbour has not posted a receive for."""
    n, idx = dist.get_world_size(), dist.get_rank()
    ops = [dist.P2POp(dist.isend, t, (idx + 1) % n) for t in send]
    ops += [dist.P2POp(dist.irecv, t, (idx - 1) % n) for t in recv]
    for req in dist.batch_isend_irecv(ops):
        req.wait()


def ring_all_reduce_rows(chunks: torch.Tensor, world_size: int) -> torch.Tensor:
    """Ring all-reduce (sum), in place, of an ``[n, cols]`` matrix whose
    row ``c`` is ring chunk ``c``: reduce-scatter, then all-gather,
    2(n-1) neighbour hops of one row each (the JAX package's
    ``parallel/collectives.py::ring_all_reduce_rows``). An element's
    summation order depends only on its row and the ring position, so
    the bucketed sync can run many tensors' row blocks through one ring
    and match the per-tensor calls bit for bit."""
    n = world_size
    if n == 1:
        return chunks
    if chunks.shape[0] != n or chunks.dim() != 2:
        raise ValueError(f"expected [{n}, cols] chunk rows, got shape {tuple(chunks.shape)}")
    idx = dist.get_rank()
    buf = torch.empty_like(chunks[0])
    # Reduce-scatter: at step s rank i sends its running sum of chunk
    # (i - s) mod n and adds what it receives into chunk (i - s - 1) mod n;
    # after n-1 steps rank i holds the full sum of chunk (i + 1) mod n.
    for s in range(n - 1):
        ring_hop([chunks[(idx - s) % n]], [buf])
        chunks[(idx - s - 1) % n] += buf
    # All-gather: rotate the finished chunks around the ring.
    for s in range(n - 1):
        ring_hop([chunks[(idx + 1 - s) % n]], [buf])
        chunks[(idx - s) % n] = buf
    return chunks


def ring_all_reduce(x: torch.Tensor, world_size: int) -> torch.Tensor:
    """Bandwidth-optimal ring all-reduce (sum) of any tensor: chunk
    ``c`` is row ``c`` of its zero-padded ``[n, cols]`` view."""
    n = world_size
    if n == 1:
        return x.clone()
    size = x.numel()
    flat = x.new_zeros(size + (-size) % n)
    flat[:size] = x.reshape(-1)
    chunks = ring_all_reduce_rows(flat.reshape(n, -1), n)
    return chunks.reshape(-1)[:size].reshape(x.shape)


def ring_all_reduce_mean(x: torch.Tensor, world_size: int) -> torch.Tensor:
    return ring_all_reduce(x, world_size) / world_size


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The world's sum of ``x`` (a copy; JAX's ``lax.psum``): the sharded
    clip's squared sums and the trainers' metric means."""
    y = x.clone()
    dist.all_reduce(y)
    return y


def reduce_scatter_sum(rows: torch.Tensor) -> torch.Tensor:
    """Row ``rank`` of the world's sum of an ``[n, cols]`` matrix: one
    ``reduce_scatter_tensor`` (JAX's ``lax.psum_scatter`` over the
    leading axis)."""
    out = rows.new_empty(rows.shape[1:])
    dist.reduce_scatter_tensor(out, rows.reshape(-1))  # flat: gloo splits dim 0
    return out


def all_gather_flat(x: torch.Tensor) -> torch.Tensor:
    """Every rank's flat ``[cols]`` buffer stacked ``[n, cols]`` in rank
    order: one ``all_gather_into_tensor`` (JAX's ``lax.all_gather``)."""
    n = dist.get_world_size()
    out = x.new_empty(n * x.numel())  # flat: gloo stacks along dim 0
    dist.all_gather_into_tensor(out, x.contiguous().reshape(-1))
    return out.view(n, *x.shape)


class GatherRows(torch.autograd.Function):
    """``all_gather_flat`` whose backward reduce-scatters the cotangent's
    sum: the AD transpose of ``all_gather`` that JAX's FSDP relies on
    (its ``parallel/zero.py::FsdpSGD``), written out. The gradient a
    shard receives is the world's sum for its row, issued the moment
    autograd reaches this node."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        return all_gather_flat(x)

    @staticmethod
    def backward(ctx, ct: torch.Tensor) -> torch.Tensor:
        return reduce_scatter_sum(ct)


class AllReduceMean(torch.autograd.Function):
    """The world's mean of a tensor (JAX's ``lax.pmean``), differentiable:
    the backward is the mean of the cotangents, pmean's transpose. Its
    collectives run where autograd puts them, so every rank must build
    the same graph."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        y = x.clone()
        dist.all_reduce(y)
        return y / dist.get_world_size()

    @staticmethod
    def backward(ctx, ct: torch.Tensor) -> torch.Tensor:
        y = ct.clone()
        dist.all_reduce(y)
        return y / dist.get_world_size()
