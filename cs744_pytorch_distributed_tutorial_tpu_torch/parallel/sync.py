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
``int8_allreduce`` (compressed wire)                              int8 all_to_all + all_gather
``int8_ring``      (compressed wire)                              int8 requantizing ring
``zero1``          (sharded optimizer)                            identity here: ``zero.py``
``fsdp``           (sharded parameters)                           identity here: ``zero.py``
=================  =============================================  ==========================

A strategy is ``fn(tensor, world_size) -> mean tensor``, applied per
parameter after ``backward()`` — the reference's
``for p in model.parameters():`` loops. ``allreduce`` and ``ring`` are
bucketed by default (``sync_grads``, ``parallel/buckets.py``), as in the
JAX package. ``auto`` is the trainer's: it wraps the model in
``DistributedDataParallel``, whose reducer averages the gradients during
``backward()``; called directly it is an all-reduce mean. The int8
strategies called per tensor drop their residual; the trainer routes
int8 through ``sync_grads_compressed``, which keeps it as error feedback.
``zero1`` and ``fsdp`` leave the gradients as they are: zero1's
reduce-scatter is part of its sharded update, fsdp's the backward of its
parameter all-gather (``parallel/zero.py``).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist

from cs744_pytorch_distributed_tutorial_tpu_torch.ops.quant import (
    dequantize_chunked,
    quantize_chunked,
    true_div,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import buckets as B
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import collectives as C
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.buckets import DEFAULT_BUCKET_BYTES

SyncFn = Callable[[torch.Tensor, int], torch.Tensor]

#: Elements that share one fp32 scale on the int8 wire (4/256 bytes of
#: scale an element).
QUANT_CHUNK = 256


def _none(g: torch.Tensor, world_size: int) -> torch.Tensor:
    """part1: single process, no communication."""
    return g


def _padded(x: torch.Tensor, total: int) -> torch.Tensor:
    xp = x.new_zeros(total, dtype=torch.float32)
    xp[: x.numel()] = x.reshape(-1)
    return xp


def _int8_allreduce_flat(
    x: torch.Tensor, world_size: int, quant_chunk: int = QUANT_CHUNK
) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantized all-reduce mean of a flat fp32 buffer: ``(mean,
    residual)``, the residual being what the wire failed to deliver of
    this rank's share (the JAX package's ``sync.py::_int8_allreduce_flat``).

    1. pad to ``n * m * Q`` and quantize a chunk at a time;
    2. ``all_to_all``: rank d collects every sender's shard d, codes and
       the sender's scales;
    3. dequantize and sum in fp32, each sender's own scale applied;
    4. requantize the shard mean and ``all_gather`` codes and scales.

    Two-stage residual: the sender error ``x - dequant(quant(x))``
    everywhere, plus ``n`` times the server error of step 4 on the shard
    this rank reduced (the next sync divides by n). At a world of one the
    wire still quantizes."""
    n = world_size
    size = x.numel()
    m = -(-size // (n * quant_chunk))  # chunks a shard
    xp = _padded(x, n * m * quant_chunk)
    q, scale = quantize_chunked(xp, quant_chunk)  # [n*m, Q], [n*m]
    own_full = dequantize_chunked(q, scale)
    if n == 1:
        return own_full[:size], (xp - own_full)[:size]
    q_all, s_all = torch.empty_like(q), torch.empty_like(scale)
    dist.all_to_all_single(q_all, q)  # row block i: sender i's shard of this rank
    dist.all_to_all_single(s_all, scale)
    parts = dequantize_chunked(q_all, s_all).reshape(n, m * quant_chunk)
    total = parts[0]
    for i in range(1, n):  # senders in rank order
        total = total + parts[i]
    shard_mean = true_div(total, n)
    q2, s2 = quantize_chunked(shard_mean, quant_chunk)
    q2g = [torch.empty_like(q2) for _ in range(n)]
    s2g = [torch.empty_like(s2) for _ in range(n)]
    dist.all_gather(q2g, q2)
    dist.all_gather(s2g, s2)
    mean = dequantize_chunked(torch.cat(q2g), torch.cat(s2g))[:size]
    resid = (xp - own_full).reshape(n, m * quant_chunk)
    idx = dist.get_rank()
    resid[idx] += n * (shard_mean - dequantize_chunked(q2, s2))
    return mean, resid.reshape(-1)[:size]


def _int8_ring_flat(
    x: torch.Tensor, world_size: int, quant_chunk: int = QUANT_CHUNK
) -> tuple[torch.Tensor, torch.Tensor]:
    """EQuARX-style quantized ring all-reduce mean of a flat fp32 buffer:
    ``(mean, residual)`` as ``_int8_allreduce_flat`` (the JAX package's
    ``sync.py::_int8_ring_flat``).

    Reduce-scatter: the fp32 running sum of a row is requantized before
    every hop; the receiver dequantizes and adds in fp32. The sums start
    from ``dequant(quant(x))``, so the first rounding lands in the
    residual. All-gather: the finished row, averaged, is quantized once
    and its codes rotate verbatim. Its owner books ``n`` times that last
    rounding into its row of the residual; only the per-hop
    requantization of partial sums is not fed back."""
    n = world_size
    size = x.numel()
    cols = -(-size // n)
    cols = -(-cols // quant_chunk) * quant_chunk  # a row, Q-aligned
    xp = _padded(x, n * cols)
    q0, s0 = quantize_chunked(xp, quant_chunk)
    own_full = dequantize_chunked(q0, s0)
    if n == 1:
        return own_full[:size], (xp - own_full)[:size]
    acc = own_full.reshape(n, cols).clone()
    idx = dist.get_rank()
    per_row = cols // quant_chunk
    q_r = torch.empty(per_row, quant_chunk, dtype=torch.int8, device=x.device)
    s_r = torch.empty(per_row, dtype=torch.float32, device=x.device)
    for s in range(n - 1):
        q, sc = quantize_chunked(acc[(idx - s) % n], quant_chunk)
        C.ring_hop([q, sc], [q_r, s_r])
        acc[(idx - s - 1) % n] += dequantize_chunked(q_r, s_r)
    done_row = (idx + 1) % n
    mine = true_div(acc[done_row], n)
    qf, sf = quantize_chunked(mine, quant_chunk)
    out_q = torch.zeros(n, per_row, quant_chunk, dtype=torch.int8, device=x.device)
    out_s = torch.zeros(n, per_row, dtype=torch.float32, device=x.device)
    out_q[done_row], out_s[done_row] = qf, sf
    for s in range(n - 1):
        C.ring_hop([out_q[(idx + 1 - s) % n], out_s[(idx + 1 - s) % n]], [q_r, s_r])
        out_q[(idx - s) % n], out_s[(idx - s) % n] = q_r, s_r
    mean = dequantize_chunked(out_q.reshape(-1, quant_chunk), out_s.reshape(-1))[:size]
    resid = (xp - own_full).reshape(n, cols)
    resid[done_row] += n * (mine - dequantize_chunked(qf, sf))
    return mean, resid.reshape(-1)[:size]


def _int8_allreduce(g: torch.Tensor, world_size: int) -> torch.Tensor:
    """Per-tensor int8 all-reduce mean, the residual dropped."""
    mean, _ = _int8_allreduce_flat(g.reshape(-1), world_size)
    return mean.reshape(g.shape).to(g.dtype)


def _int8_ring(g: torch.Tensor, world_size: int) -> torch.Tensor:
    """Per-tensor int8 ring all-reduce mean, the residual dropped."""
    mean, _ = _int8_ring_flat(g.reshape(-1), world_size)
    return mean.reshape(g.shape).to(g.dtype)


SYNC_STRATEGIES: dict[str, SyncFn] = {
    "none": _none,
    "allreduce": C.all_reduce_mean,
    "gather_scatter": C.gather_scatter_mean,
    "p2p_star": C.star_mean,
    "ring": C.ring_all_reduce_mean,
    "auto": C.all_reduce_mean,
    "int8_allreduce": _int8_allreduce,
    "int8_ring": _int8_ring,
    "zero1": _none,
    "fsdp": _none,
}

#: The JAX package's strategies whose outputs its replication checker
#: cannot prove replicated (its ``shard_map`` then runs unchecked). The
#: port has no such checker; its Trainer keeps the JAX rule that the flash
#: ViT runs only under these (or ``none``), to refuse what JAX refuses.
UNCHECKED_REPLICATION = frozenset(
    {"p2p_star", "ring", "gather_scatter", "zero1", "fsdp", "int8_allreduce", "int8_ring"})

#: Strategies whose collective is an elementwise mean over flat data,
#: which the bucketed path may coalesce.
_BUCKETED = ("allreduce", "ring")


def get_sync(name: str) -> SyncFn:
    try:
        return SYNC_STRATEGIES[name]
    except KeyError:
        raise ValueError(
            f"unknown sync strategy {name!r}; choose from {sorted(SYNC_STRATEGIES)}"
        ) from None


def wire_name(name: str) -> str:
    """The int8 wire for a base strategy: the ring's, or the all-to-all's."""
    return "int8_ring" if name in ("ring", "int8_ring") else "int8_allreduce"


def sync_bucket(buf: torch.Tensor, name: str, world_size: int) -> torch.Tensor:
    """The mean over the world of one float bucket buffer: a flat one
    for ``allreduce``, ``[n, cols]`` rows for ``ring``."""
    if name == "ring":
        return C.ring_all_reduce_rows(buf, world_size) / world_size
    if name == "allreduce":
        return C.all_reduce_mean(buf, world_size)
    raise ValueError(f"sync strategy {name!r} has no bucketed form; choose 'allreduce' or 'ring'")


def sync_bucket_compressed(
    gbuf: torch.Tensor, ebuf: torch.Tensor, name: str, world_size: int,
    quant_chunk: int = QUANT_CHUNK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 sync of one flat bucket with its error feedback: ``(mean in
    the gradient's dtype, fp32 residual)`` of ``g + ef``."""
    flat_fn = _int8_ring_flat if wire_name(name) == "int8_ring" else _int8_allreduce_flat
    mean, resid = flat_fn(gbuf.float() + ebuf.float(), world_size, quant_chunk)
    return mean.to(gbuf.dtype), resid


@torch.no_grad()
def sync_grads(
    grads: Sequence[torch.Tensor], name: str, world_size: int,
    bucket_bytes: int | None = DEFAULT_BUCKET_BYTES,
) -> None:
    """Replace every gradient with its mean over the world, in place.

    ``allreduce`` and ``ring`` go a bucket at a time (``bucket_bytes``;
    0 or None for one collective a tensor); the ring's row-chunked layout
    keeps it bitwise equal to the per-tensor ring. Other strategies go a
    tensor at a time: their communication's shape is the point."""
    fn = get_sync(name)
    if fn is _none:
        return
    if bucket_bytes and name in _BUCKETED and world_size > 1:
        layout = B.bucket_layout(grads, bucket_bytes, rows=world_size if name == "ring" else 0)
        synced = [sync_bucket(buf, name, world_size) for buf in B.flatten_for_sync(grads, layout)]
        for g, u in zip(grads, B.unflatten(synced, layout)):
            g.copy_(u)
        return
    for g in grads:
        g.copy_(fn(g, world_size))


@torch.no_grad()
def sync_grads_compressed(
    grads: Sequence[torch.Tensor], ef: Sequence[torch.Tensor], name: str, world_size: int,
    *, bucket_bytes: int | None = DEFAULT_BUCKET_BYTES, quant_chunk: int = QUANT_CHUNK,
) -> None:
    """int8 gradient sync with error feedback, in place: a bucket at a
    time, ``g + ef`` goes over the wire (``wire_name(name)``), ``grads``
    become the dequantized means and ``ef`` the residuals this rank
    failed to send (per-rank state). Buckets always apply
    (``bucket_bytes`` None or 0 means the default), so quantization
    chunks span tensor boundaries."""
    layout = B.bucket_layout(grads, bucket_bytes or DEFAULT_BUCKET_BYTES, rows=0)
    g_bufs = B.flatten_for_sync(grads, layout)
    e_bufs = B.flatten_for_sync(ef, layout)
    means, resids = zip(*(sync_bucket_compressed(g, e, name, world_size, quant_chunk)
                          for g, e in zip(g_bufs, e_bufs)))
    for g, u in zip(grads, B.unflatten(means, layout)):
        g.copy_(u)
    for e, u in zip(ef, B.unflatten(resids, layout)):
        e.copy_(u)


def lm_strategy(zero1: bool, fsdp: bool, grad_compress: str = "none") -> str:
    """The LM trainer's data-parallel wire as the JAX ``LMTrainer.fit``
    names it for ``sync_wire_bytes``: ``fsdp``, ``zero1`` (priced as
    ``zero1_int8`` under int8), ``int8_allreduce``, or ``allreduce``."""
    if fsdp:
        return "fsdp"
    if zero1:
        return "zero1"
    return "int8_allreduce" if grad_compress == "int8" else "allreduce"


def sync_wire_bytes(
    params, name: str, world_size: int, grad_compress: str = "none", *,
    quant_chunk: int = QUANT_CHUNK, bucket_bytes: int | None = None, overlap: bool = False,
) -> int:
    """Gradient-sync payload bytes sent per rank per step of a run's
    configuration (the JAX package's ``sync.py::sync_wire_bytes``): the
    strategy, or its int8 wire under ``grad_compress="int8"`` (zero1's
    own, ``zero1_int8``), priced by ``buckets.sync_bytes_per_step``;
    ``overlap`` selects the overlapped schedule's reverse-order layout.
    ``params`` is a parameter list or an fp32 element count."""
    if name == "zero1" and grad_compress == "int8":
        strategy = "zero1_int8"
    elif grad_compress == "int8" or name in ("int8_allreduce", "int8_ring"):
        strategy = wire_name(name)
    else:
        strategy = name
    return B.sync_bytes_per_step(params, strategy, world_size, quant_chunk=quant_chunk,
                                 bucket_bytes=bucket_bytes, reverse=overlap)
