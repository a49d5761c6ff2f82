"""Gradient-averaging collectives over ``torch.distributed``.

The reference's communication: ``gather``, ``scatter``, ``all_reduce``,
``isend``/``irecv`` (``master/part2a/part2a.py:42-52``,
``master/part2b/part2b.py:43-45``, ``master/part2a/part2a_extra.py:42-58``).
Each function takes one rank's tensor and returns the mean over the
world; they differ in the shape of their communication, which is what
the tutorial teaches. A process group must be initialized.
"""

from __future__ import annotations

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


def _ring_hop(send: torch.Tensor, recv: torch.Tensor, nxt: int, prv: int) -> None:
    """Send to the next rank and receive from the previous one at once:
    one batched pair, so no rank blocks on a send its neighbour has not
    posted a receive for."""
    ops = [dist.P2POp(dist.isend, send, nxt), dist.P2POp(dist.irecv, recv, prv)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()


def ring_all_reduce(x: torch.Tensor, world_size: int) -> torch.Tensor:
    """Bandwidth-optimal ring all-reduce (sum): reduce-scatter, then
    all-gather, 2(n-1) neighbour hops of |x|/n each. Chunk ``c`` is row
    ``c`` of the zero-padded ``[n, cols]`` view; the hop schedule is the
    JAX package's (``parallel/collectives.py::ring_all_reduce_rows``)."""
    n = world_size
    if n == 1:
        return x.clone()
    idx = dist.get_rank()
    nxt, prv = (idx + 1) % n, (idx - 1) % n
    size = x.numel()
    flat = x.new_zeros(size + (-size) % n)
    flat[:size] = x.reshape(-1)
    chunks = flat.reshape(n, -1)
    buf = torch.empty_like(chunks[0])
    # Reduce-scatter: at step s rank i sends its running sum of chunk
    # (i - s) mod n and adds what it receives into chunk (i - s - 1) mod n;
    # after n-1 steps rank i holds the full sum of chunk (i + 1) mod n.
    for s in range(n - 1):
        _ring_hop(chunks[(idx - s) % n], buf, nxt, prv)
        chunks[(idx - s - 1) % n] += buf
    # All-gather: rotate the finished chunks around the ring.
    for s in range(n - 1):
        _ring_hop(chunks[(idx + 1 - s) % n], buf, nxt, prv)
        chunks[(idx - s) % n] = buf
    return chunks.reshape(-1)[:size].reshape(x.shape)


def ring_all_reduce_mean(x: torch.Tensor, world_size: int) -> torch.Tensor:
    return ring_all_reduce(x, world_size) / world_size
