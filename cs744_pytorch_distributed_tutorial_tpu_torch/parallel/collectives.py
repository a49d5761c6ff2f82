"""Gradient-averaging collectives over ``torch.distributed``.

The reference's communication: ``gather``, ``scatter``, ``all_reduce``,
``isend``/``irecv`` (``master/part2a/part2a.py:42-52``,
``master/part2b/part2b.py:43-45``, ``master/part2a/part2a_extra.py:42-58``).
Each function takes one rank's tensor and returns the mean over the
world; they differ in the shape of their communication, which is what
the tutorial teaches. A process group must be initialized.
"""

from __future__ import annotations

import collections
from typing import Sequence

import numpy as np
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


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (default: the world; a copy, JAX's
    ``lax.psum``): the sharded clip's squared sums and the trainers'
    metric means."""
    y = x.clone()
    dist.all_reduce(y, group=group)
    return y


def reduce_scatter_sum(rows: torch.Tensor, group=None) -> torch.Tensor:
    """Row ``rank`` (in ``group``, default the world) of the group's sum
    of an ``[n, cols]`` matrix: one ``reduce_scatter_tensor`` (JAX's
    ``lax.psum_scatter`` over the leading axis)."""
    out = rows.new_empty(rows.shape[1:])
    dist.reduce_scatter_tensor(out, rows.reshape(-1), group=group)  # flat: gloo splits dim 0
    return out


def all_gather_flat(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's (of ``group``, default the world) flat ``[cols]``
    buffer stacked ``[n, cols]`` in rank order: one
    ``all_gather_into_tensor`` (JAX's ``lax.all_gather``)."""
    n = dist.get_world_size(group)
    out = x.new_empty(n * x.numel())  # flat: gloo stacks along dim 0
    dist.all_gather_into_tensor(out, x.contiguous().reshape(-1), group=group)
    return out.view(n, *x.shape)


class GatherRows(torch.autograd.Function):
    """``all_gather_flat`` over ``group`` (None: the world) whose backward
    reduce-scatters the cotangent's
    sum: the AD transpose of ``all_gather`` that JAX's FSDP relies on
    (its ``parallel/zero.py::FsdpSGD``), written out. The gradient a
    shard receives is the world's sum for its row, issued the moment
    autograd reaches this node."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return all_gather_flat(x, group)

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        return reduce_scatter_sum(ct, ctx.group), None


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


# --------------------------------------------------- collectives on mesh axes
# The sequence, tensor and expert axes' collectives (``parallel/mesh.py::
# Mesh``): each runs on the group of this rank's line along its axes and is
# the identity on a line of one rank. The autograd Functions' backwards are
# JAX's transposes.
hops: collections.Counter = collections.Counter()  # ring permutes by axis


class _AxisReduce(torch.autograd.Function):
    """The sum (or mean) over a line of ranks; its backward is the same
    reduction of the cotangent (JAX's transpose of psum and of pmean)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, mean: bool):
        ctx.args = (mesh, axes, mean)
        return _reduce(x, mesh, axes, mean)

    @staticmethod
    def backward(ctx, ct):
        return _reduce(ct, *ctx.args), None, None, None


def _reduce(x: torch.Tensor, mesh, axes, mean: bool) -> torch.Tensor:
    y = all_reduce_sum(x.contiguous(), mesh.group(*axes))
    if not mean:
        return y
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops.quant import true_div

    return true_div(y, mesh.size(*axes))


def axis_sum(x: torch.Tensor, mesh, *axes: str) -> torch.Tensor:
    """``lax.psum`` over ``axes``: the sum over this rank's line (``x``
    itself on a line of one rank); differentiable."""
    return x if mesh.size(*axes) == 1 else _AxisReduce.apply(x, mesh, axes, False)


def axis_mean(x: torch.Tensor, mesh, *axes: str) -> torch.Tensor:
    """``lax.pmean`` over ``axes``: the line's sum divided by its size;
    differentiable."""
    return x if mesh.size(*axes) == 1 else _AxisReduce.apply(x, mesh, axes, True)


def reduce_by_axes(tensors: Sequence[torch.Tensor], axes: Sequence[tuple[str, ...]], mesh,
                   mean: bool = True) -> list[torch.Tensor]:
    """Each tensor averaged (``mean``) or summed over its own set of axes
    (an empty set, or a line of one rank: as it is), one all-reduce for
    the tensors of each set of axes, flattened and concatenated."""
    out = list(tensors)
    by_axes: dict[tuple[str, ...], list[int]] = {}
    for i, ax in enumerate(axes):
        if ax and mesh.size(*ax) > 1:
            by_axes.setdefault(tuple(ax), []).append(i)
    for ax, idx in by_axes.items():
        flat = torch.cat([out[i].reshape(-1) for i in idx])
        flat = _reduce(flat, mesh, ax, mean)
        for i, part in zip(idx, flat.split([out[i].numel() for i in idx])):
            out[i] = part.view(out[i].shape)
    return out


class _Transfer:
    """Tensors on their way: ``wait()`` returns them once received."""

    def __init__(self, reqs, tensors):
        self.reqs, self.tensors = reqs, tensors

    def wait(self) -> list[torch.Tensor]:
        for req in self.reqs:
            req.wait()
        return self.tensors


def start_permute(tensors: Sequence[torch.Tensor], mesh, axis: str, shift: int = 1) -> _Transfer:
    """One hop along ``axis`` (``lax.ppermute`` by ``shift``): each tensor
    goes to the rank ``shift`` ahead and its like comes from the rank
    ``shift`` behind, into fresh buffers; returns at once with the
    transfer under way (one ``batch_isend_irecv``)."""
    hops[axis] += 1
    tensors = [t.contiguous() for t in tensors]
    if mesh.size(axis) == 1:
        return _Transfer([], tensors)
    recv = [torch.empty_like(t) for t in tensors]
    group = mesh.group(axis)
    dst, src = mesh.peer(axis, shift), mesh.peer(axis, -shift)
    ops = [dist.P2POp(dist.isend, t, dst, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, t, src, group) for t in recv]
    return _Transfer(dist.batch_isend_irecv(ops), recv)


class RingPermute(torch.autograd.Function):
    """``lax.ppermute`` one step up ``axis``, differentiable: the backward
    sends the cotangents one step down (ppermute's transpose)."""

    @staticmethod
    def forward(ctx, mesh, axis: str, *tensors):
        ctx.mesh, ctx.axis = mesh, axis
        return tuple(start_permute(tensors, mesh, axis, 1).wait())

    @staticmethod
    def backward(ctx, *cts):
        return (None, None, *start_permute(cts, ctx.mesh, ctx.axis, -1).wait())


def all_to_all(x: torch.Tensor, mesh, axis: str, split_axis: int, concat_axis: int) -> torch.Tensor:
    """JAX's tiled ``lax.all_to_all``: chunk i of ``split_axis`` goes to the
    rank at index i of ``axis`` and the chunks received concatenate along
    ``concat_axis`` in rank order. ``all_to_all_single`` splits dim 0, so
    the chunks are stacked on a new leading dim around it."""
    n = mesh.size(axis)
    if n == 1:
        return x
    send = torch.stack(x.chunk(n, dim=split_axis)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.group(axis))
    return torch.cat(recv.unbind(0), dim=concat_axis)


class AllToAll(torch.autograd.Function):
    """``all_to_all``, differentiable: the backward is the exchange with
    the split and concat axes swapped (all_to_all's transpose)."""

    @staticmethod
    def forward(ctx, x, mesh, axis: str, split_axis: int, concat_axis: int):
        ctx.args = (mesh, axis, split_axis, concat_axis)
        return all_to_all(x, mesh, axis, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, ct):
        mesh, axis, split_axis, concat_axis = ctx.args
        return all_to_all(ct, mesh, axis, concat_axis, split_axis), None, None, None, None


def axis_gather_rows(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Every rank's ``x`` [b, ...] along ``axis`` joined [n * b, ...] in
    coordinate order (the global array of rows that JAX's ``shard_map``
    returns for an output split over ``axis``): one all-gather; ``x``
    itself on a line of one rank."""
    n = mesh.size(axis)
    if n == 1:
        return x
    return all_gather_flat(x, mesh.group(axis)).reshape(n * x.shape[0], *x.shape[1:])


def broadcast_host(x: np.ndarray, mesh) -> np.ndarray:
    """Global rank 0's copy of the host array ``x`` on every rank of
    ``mesh`` (a new array; ``x`` is left as it is), one broadcast over
    the mesh's host group: how the ranks of a tensor-parallel serving
    engine take rank 0's clock readings and tokens."""
    if mesh.world_size == 1:
        return x
    t = torch.from_numpy(np.array(x, copy=True))
    dist.broadcast(t, src=0, group=mesh.host_group())
    return t.numpy()
