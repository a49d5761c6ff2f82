"""Overlapped gradient sync: reverse-order buckets, each one's collective
fired from gradient hooks, SGD applied a bucket at a time.

Port of the JAX package's ``parallel/overlap.py``. The fused schedule
(``sync_grads`` or ``sync_grads_compressed``, then one update over every
parameter) waits for the whole backward before the first collective and
for every collective before the update. DDP's reducer instead fires a
bucket's all-reduce as soon as its gradients exist
(``master/part3/part3.py:116``). JAX says this as dataflow inside one
XLA program; here it is host-side, as in DDP:

- buckets are laid out in reverse parameter order
  (``bucket_layout(reverse=True)``): backward produces the last layers'
  gradients first, so bucket 0 completes first;
- a ``register_post_accumulate_grad_hook`` on each parameter counts it
  into its bucket; when a bucket is complete, its collective is issued,
  and so is every later bucket already complete. Buckets are issued in
  layout order on every rank, whatever order autograd runs the hooks in
  (a residual branch can reorder them), so the ranks' collectives pair
  up;
- after backward, ``finish`` waits on each bucket in turn and applies
  SGD to it: one ``fused_sgd_multi_`` call over the bucket's parameters,
  momenta and gradient views into the synced buffer (one kernel launch
  a bucket on the card, the plain update on the CPU). The update is
  JAX's ``apply_bucket``: ``g = s + wd p; t = g + mu t; p = p - lr t``.

The float all-reduce is asynchronous (``async_op=True``); the ring and
the int8 wires run their hops inside the hook that completes the
bucket. For ``allreduce`` and ``ring`` the result equals the fused
schedule's (the ring bit for bit: the row-chunked layout keeps every
element's ring row); the int8 wire is not bitwise (reverse buckets
regroup the quantization chunks) and is held to the short-run bar.

ZeRO-1's lane (``OverlappedZero1``) keeps the hooks and the layout order
on ``Zero1SGD``'s row-chunked reverse layout: a complete bucket's
reduce-scatter (or its int8 all-reduce) is issued from the hooks, and
``finish`` runs each bucket's chunk updates and its delta all-gather.
The parameters change only in ``finish``, after autograd is done with
them. FSDP's lane is its gather in the reverse layout
(``FsdpSGD(overlap=True)``): each bucket's reduce-scatter is the
backward of its all-gather, issued as autograd reaches it.

The LM trainer takes the same lanes: pure data parallelism through
``OverlappedSGD`` (sgd at a constant lr, as JAX admits it: one fused-SGD
launch a bucket), its ZeRO-1 rules through ``OverlappedZero1LM`` (the
step scalars hoisted once a step, each bucket's chunk rule and delta
all-gather in ``finish``) and FSDP through ``FsdpAdam(overlap=True)``'s
reverse gather. Each parameter's hook fires once a backward, whatever
its uses: autograd sums a tensor's gradients before it accumulates them
(tied embeddings, ``scan_layers``' one stacked tensor a layer stack);
remat's recompute produces no parameter gradient of its own.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from cs744_pytorch_distributed_tutorial_tpu_torch.ops.fused_sgd import fused_sgd_multi_
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import buckets as B
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.sync import (
    QUANT_CHUNK,
    sync_bucket,
    sync_bucket_compressed,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.zero import Zero1Adam, Zero1SGD

#: ``--sync-overlap`` modes: ``bucket`` overlaps the float wire
#: (allreduce, ring), ``bucket+int8`` the int8 wire with error feedback.
OVERLAP_MODES = ("off", "bucket", "bucket+int8")


def overlap_layout(params: Sequence, name: str, world_size: int, bucket_bytes: int | None,
                   *, compressed: bool = False) -> B.BucketLayout:
    """Reverse parameter order; the float ring keeps its row-chunked
    layout (the int8 wires take flat buffers)."""
    rows = world_size if (not compressed and name == "ring") else 0
    return B.bucket_layout(params, bucket_bytes or B.DEFAULT_BUCKET_BYTES, rows=rows,
                           reverse=True)


class OverlappedSGD:
    """The overlapped schedule over one model's parameters.

    ``momentum`` (and ``ef``, the int8 wire's residuals, None for the
    float wire) are updated in place. Each step: ``begin()`` before the
    backward that produces the gradients, ``finish()`` after it. With
    gradient accumulation, ``begin(prefix, accum)`` arms the last
    microbatch's backward: each hook first makes the parameter's
    gradient ``(prefix + grad) / accum``, the earlier microbatches' sum
    plus its own, as the fused schedule accumulates."""

    def __init__(self, params: Sequence[torch.Tensor], momentum: Sequence[torch.Tensor],
                 ef: Sequence[torch.Tensor] | None, *, name: str, world_size: int, lr: float,
                 mu: float, wd: float, bucket_bytes: int | None = B.DEFAULT_BUCKET_BYTES,
                 quant_chunk: int = QUANT_CHUNK):
        self.params, self.momentum = list(params), list(momentum)
        self.ef = None if ef is None else list(ef)
        self.name, self.world_size, self.quant_chunk = name, world_size, quant_chunk
        self.lr, self.mu, self.wd = lr, mu, wd
        self._install(overlap_layout(self.params, name, world_size, bucket_bytes,
                                     compressed=self.ef is not None))

    def _install(self, layout: B.BucketLayout) -> None:
        self.layout = layout
        self.members = B.bucket_members(layout)
        self._armed = False
        self._handles = [p.register_post_accumulate_grad_hook(self._hook(i))
                         for i, p in enumerate(self.params)]

    @property
    def num_buckets(self) -> int:
        return len(self.members)

    def remove_hooks(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []

    def begin(self, prefix: Sequence[torch.Tensor] | None = None, accum: int = 1) -> None:
        """Arm the hooks for the next backward."""
        self._armed = True
        self._prefix, self._accum = prefix, accum
        self._arrived = [0] * self.num_buckets
        self._next = 0  # the first bucket not yet issued
        self._pending: list = [None] * self.num_buckets

    def _hook(self, i: int):
        def hook(p: torch.Tensor) -> None:
            if self._armed:
                self._arrive(i, p)
        return hook

    @torch.no_grad()
    def _arrive(self, i: int, p: torch.Tensor) -> None:
        if self._prefix is not None:
            p.grad = (self._prefix[i] + p.grad) / self._accum
        self._arrived[self.layout.slots[i].bucket] += 1
        while (self._next < self.num_buckets
               and self._arrived[self._next] == len(self.members[self._next])):
            self._issue(self._next)
            self._next += 1

    def _issue(self, b: int) -> None:
        members = self.members[b]
        buf = B.flatten_bucket([p.grad for p in self.params], self.layout, b, members)
        if self.ef is not None:
            ebuf = B.flatten_bucket(self.ef, self.layout, b, members)
            self._pending[b] = sync_bucket_compressed(buf, ebuf, self.name, self.world_size,
                                                      self.quant_chunk)
        elif self.name == "allreduce" and self.world_size > 1:
            buf = buf / self.world_size
            self._pending[b] = (buf, dist.all_reduce(buf, async_op=True))
        else:
            self._pending[b] = (sync_bucket(buf, self.name, self.world_size), None)

    def _disarm(self) -> None:
        self._armed = False
        if self._next != self.num_buckets:
            raise RuntimeError(
                f"backward completed {self._next} of {self.num_buckets} gradient buckets: "
                "every parameter must receive a gradient"
            )

    @torch.no_grad()
    def finish(self) -> None:
        """Wait on each bucket in layout order and apply SGD to it; the
        parameters' ``grad`` become views of the synced means."""
        self._disarm()
        for b, members in enumerate(self.members):
            synced, extra = self._pending[b]
            if self.ef is not None:
                for i in members:
                    self.ef[i].copy_(B.leaf_view(extra, self.layout, self.layout.slots[i]))
            elif extra is not None:
                extra.wait()
            grads = [B.leaf_view(synced, self.layout, self.layout.slots[i]) for i in members]
            fused_sgd_multi_([self.params[i] for i in members],
                             [self.momentum[i] for i in members], grads,
                             lr=self.lr, mu=self.mu, wd=self.wd)
            for i, g in zip(members, grads):
                self.params[i].grad = g
        self._pending = [None] * self.num_buckets
        self._prefix = None


class OverlappedZero1(OverlappedSGD):
    """ZeRO-1's overlapped lane over ``zero``'s reverse row-chunked
    layout (``Zero1SGD(overlap=True)``): a complete bucket's
    reduce-scatter (with ``ef``, its int8 all-reduce) is issued from the
    hooks in layout order; ``finish`` takes each bucket's rows of the
    mean through the chunk updates and one delta all-gather. The
    parameters' ``grad`` stay the local gradients, as zero1 never forms
    the synced ones. The buckets are used at any world size."""

    def __init__(self, params: Sequence[torch.Tensor], momentum: Sequence[torch.Tensor],
                 ef: Sequence[torch.Tensor] | None, zero: Zero1SGD):
        self.params, self.momentum = list(params), list(momentum)
        self.ef = None if ef is None else list(ef)
        self.zero = zero
        self._install(zero.layout(self.params))

    def _issue(self, b: int) -> None:
        members = self.members[b]
        gbuf = B.flatten_bucket([p.grad for p in self.params], self.layout, b, members)
        ebuf = None if self.ef is None else B.flatten_bucket(self.ef, self.layout, b, members)
        self._pending[b] = self.zero.scatter_bucket(gbuf, ebuf)

    @torch.no_grad()
    def finish(self) -> None:
        """Each bucket in layout order: chunk updates, delta all-gather."""
        self._disarm()
        for b, members in enumerate(self.members):
            g_mine, resid = self._pending[b]
            self.zero.update_bucket(self.params, self.momentum, self.layout, members, g_mine)
            if resid is not None:
                for i in members:
                    self.ef[i].copy_(B.leaf_view(resid, self.layout, self.layout.slots[i]))
        self._pending = [None] * self.num_buckets
        self._prefix = None


class OverlappedZero1LM(OverlappedZero1):
    """The LM's sharded rules on the overlapped lane (the JAX
    ``Zero1Adam._apply_overlapped``): ``zero`` (a ``Zero1Adam`` or a
    subclass, built with ``overlap=True``) over its replicated
    ``params``. The hooks issue each complete bucket's reduce-scatter
    (with ``ef``, its int8 all-reduce) in layout order; ``finish`` takes
    the step scalars once (the schedule's lr, the bias corrections), then
    each bucket's chunk rule and its delta all-gather, and counts the
    update. The rule is elementwise, so the float path equals the fused
    ``apply``'s where the backend sums each element alike."""

    def __init__(self, zero: Zero1Adam, ef: Sequence[torch.Tensor] | None = None):
        self.params, self.momentum = zero.params, zero.momentum
        self.ef = None if ef is None else list(ef)
        self.zero = zero
        self._install(zero.layout(self.params))

    @torch.no_grad()
    def finish(self) -> None:
        self._disarm()
        scalars = self.zero.step_scalars()
        for b, members in enumerate(self.members):
            g_mine, resid = self._pending[b]
            slots = [self.layout.slots[i] for i in members]
            self.zero.update_bucket(self.params, self.layout, members,
                                    [g_mine[s.offset : s.offset + s.size] for s in slots],
                                    scalars)
            if resid is not None:
                for i, slot in zip(members, slots):
                    self.ef[i].copy_(B.leaf_view(resid, self.layout, slot))
        self.zero.count += 1
        self._pending = [None] * self.num_buckets
        self._prefix = None
