"""Pipeline parallelism over the ``pipe`` axis of the mesh, ported from
the JAX package's ``parallel/pipeline.py``.

The JAX engine runs one SPMD program on every device: a schedule is a
``lax.scan`` of lockstep ticks whose activations move one stage along
with ``lax.ppermute``, and ``jax.grad`` of the GPipe and interleaved
forwards *is* their reverse pipeline. Here each stage is a process (a
rank of ``parallel/mesh.py::Mesh``), or one of S stages run in lockstep
in one process, so the schedules are written as **step generators**, as
the ring attention is (``parallel/ring_attention.py``): a stage's code
yields its pipe-axis communication and resumes with the result.

- ``Shift``: ``lax.ppermute`` one stage on (``shift=1``) or back
  (``-1``), over the pairs (i, i + 1) (stage 0 of a forward hop, and the
  last stage of a backward one, receive nothing) or round the ring. A
  stage posts its send only when the stage ahead consumes the tensor on
  the next tick, and its receive only when it will consume one: JAX
  masks the other ticks' values, so nothing is lost. One ``Shift`` is
  yielded a tick, so ``collectives.hops["pipe"]`` counts JAX's ppermutes.
- ``PipeReduce``: ``lax.psum``/``lax.pmax`` over the pipe axis.

``drive_pipe`` runs a stage's generator on the process group (a
``batch_isend_irecv`` on the pipe axis's group, an ``all_reduce`` for a
reduction); ``simulate_pipe`` runs S of them in one process, each
stage's tensor handed to the stage that receives it.

The backward is never differentiated through a hop. GPipe and the
interleaved schedule keep each tick's autograd graph (its input a leaf)
and ``*_backward`` replays the ticks in reverse: each active tick's
``torch.autograd.grad`` of its output against the cotangent that
arrived, its input's cotangent hopped one stage back. That is the AD
transpose JAX derives, with the same accumulation order; a stage with no
microbatch on a tick computes nothing (JAX computes on masked values and
gives them zero cotangents), so the flash launches a step are those of
the microbatches alone. 1F1B writes its backward out as the JAX engine
does (a no-grad forward, then a recompute and a VJP a wave; the stash is
one input a microbatch in flight).

The Megatron f/g boundaries of the pipe axis are explicit: the outputs
are psum-broadcast from the last stage (g, identity backward: each stage
differentiates the replicated loss and only the last stage's cotangent
enters the reverse pipeline), and the input cotangent is psum-broadcast
from stage 0 (f's backward), so the embeddings' gradients are the same
on every stage. ``_sharded_ce`` reduces over the pipe axis by yields and
over the tensor axis through its process group.

The block functions (``init_block_params``, ``block_apply``,
``stack_apply``) are the JAX pure-pytree block, on tensors.
``PipelineLMTrainer`` (below) trains the LM's ``Block`` on these
schedules.
"""

from __future__ import annotations

import dataclasses
import inspect
import math
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import collectives as C
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    PIPE_AXIS,
    SEQ_AXIS,
    TENSOR_AXIS,
)

__all__ = [
    "BLOCK_PARAM_NAMES", "DATA_AXIS", "PIPE_AXIS", "PipeReduce", "SEQ_AXIS", "Shift",
    "TENSOR_AXIS", "block_apply", "drive_pipe", "init_block_params", "interleave_layers",
    "interleaved_stats", "one_f_one_b_pipeline", "one_f_one_b_stats", "simulate_pipe",
    "spmd_pipeline", "spmd_pipeline_backward", "spmd_pipeline_interleaved",
    "spmd_pipeline_interleaved_backward", "stack_apply",
]


# --------------------------------------------------------------------------
# Steps, and the functions that run them
# --------------------------------------------------------------------------
class Shift:
    """A hop along the pipe axis: ``send`` (None: nothing to send) to the
    stage ``shift`` ahead (modulo S on a ``ring``, else only when it
    exists); ``recv``: whether this stage takes what the stage ``shift``
    behind sends, a tensor like ``like``. Resumes with that tensor or
    None."""

    def __init__(self, send: torch.Tensor | None, shift: int, ring: bool, recv: bool,
                 like: torch.Tensor):
        self.send, self.shift, self.ring, self.recv, self.like = send, shift, ring, recv, like


class PipeReduce:
    """The sum (``op="sum"``) or maximum (``"max"``) of each of
    ``tensors`` over the pipe axis; resumes with the results, the same on
    every stage."""

    def __init__(self, tensors: Sequence[torch.Tensor], op: str = "sum"):
        if op not in ("sum", "max"):
            raise ValueError(f"unknown pipe reduction {op!r}")
        self.tensors, self.op = list(tensors), op


def _peers(stage: int, n: int, shift: int, ring: bool) -> tuple[int | None, int | None]:
    """(the stage this one sends to, the stage it receives from)."""
    dst, src = stage + shift, stage - shift
    if ring:
        return dst % n, src % n
    return (dst if 0 <= dst < n else None), (src if 0 <= src < n else None)


def drive_pipe(steps, mesh):
    """Run a stage's step generator as this rank's position on the pipe
    axis of ``mesh``: a ``Shift`` is one ``batch_isend_irecv`` on the pipe
    axis's group (counted in ``collectives.hops["pipe"]``), a
    ``PipeReduce`` an ``all_reduce`` a tensor. Returns the generator's
    result."""
    n, stage = mesh.size(PIPE_AXIS), mesh.axis_index(PIPE_AXIS)
    group = mesh.group(PIPE_AXIS)
    try:
        req = next(steps)
        while True:
            if isinstance(req, Shift):
                C.hops[PIPE_AXIS] += 1
                dst, src = _peers(stage, n, req.shift, req.ring)
                ops, out = [], None
                if req.send is not None and dst is not None:
                    ops.append(dist.P2POp(dist.isend, req.send.contiguous(),
                                          mesh.peer(PIPE_AXIS, dst - stage), group))
                if req.recv and src is not None:
                    out = torch.empty_like(req.like)
                    ops.append(dist.P2POp(dist.irecv, out, mesh.peer(PIPE_AXIS, src - stage),
                                          group))
                for r in dist.batch_isend_irecv(ops) if ops else ():
                    r.wait()
                req = steps.send(out)
            else:
                out = []
                for t in req.tensors:
                    y = t.detach().contiguous().clone()
                    if n > 1:
                        op = dist.ReduceOp.SUM if req.op == "sum" else dist.ReduceOp.MAX
                        dist.all_reduce(y, op=op, group=group)
                    out.append(y)
                req = steps.send(out)
    except StopIteration as stop:
        return stop.value


def simulate_pipe(gens: Sequence) -> list:
    """Run S stage generators (stage i at position i) in lockstep in one
    process: a ``Shift`` hands each sent tensor to the stage that
    receives it (one count in ``collectives.hops["pipe"]`` a tick), a
    ``PipeReduce`` gives every stage the sum (stage order) or maximum.
    Returns the results by stage."""
    n = len(gens)
    reqs, results = [], [None] * n
    done = [False] * n
    for i, g in enumerate(gens):
        try:
            reqs.append(next(g))
        except StopIteration as stop:
            done[i], results[i] = True, stop.value
            reqs.append(None)
    while not all(done):
        if any(done):
            raise RuntimeError("pipeline stages ended at different steps")
        kinds = {type(r) for r in reqs}
        if len(kinds) != 1:
            raise RuntimeError(f"pipeline stages out of step: {[type(r).__name__ for r in reqs]}")
        if isinstance(reqs[0], Shift):
            C.hops[PIPE_AXIS] += 1
            handles = []
            for i, r in enumerate(reqs):
                _, src = _peers(i, n, r.shift, r.ring)
                got = None
                if r.recv and src is not None:
                    got = reqs[src].send
                    if got is None:
                        raise RuntimeError(f"stage {i} waits on stage {src}, which sends nothing")
                handles.append(got)
        else:
            handles = []
            for k in range(len(reqs[0].tensors)):
                acc = reqs[0].tensors[k].detach().clone()
                for r in reqs[1:]:
                    t = r.tensors[k].detach()
                    acc = acc + t if r.op == "sum" else torch.maximum(acc, t)
                handles.append(acc)
            handles = [[h.clone() for h in handles] for _ in range(n)]
        nxt = []
        for i, (g, h) in enumerate(zip(gens, handles)):
            try:
                nxt.append(g.send(h))
            except StopIteration as stop:
                done[i], results[i] = True, stop.value
                nxt.append(None)
        reqs = nxt
    return results


def _call(fn, *args, grad: bool):
    """``yield from`` this: ``fn(*args)`` with grad mode ``grad`` while its
    code runs; a generator function's steps are passed on and the mode is
    restored at each of them (a ``with`` block held across a yield would
    leak it into the stages run in between)."""
    with torch.set_grad_enabled(grad):
        result = fn(*args)
    if not inspect.isgenerator(result):
        return result
    value = None
    while True:
        prev = torch.is_grad_enabled()
        torch.set_grad_enabled(grad)
        try:
            req = result.send(value)
        except StopIteration as stop:
            return stop.value
        finally:
            torch.set_grad_enabled(prev)
        value = yield req


class _Replace(torch.autograd.Function):
    """Forward: ``value`` (``x`` reduced elsewhere); backward: the
    identity to ``x`` (the Megatron g boundary's rule)."""

    @staticmethod
    def forward(ctx, x, value):
        return value.clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


def _pipe_sum_fwd(x: torch.Tensor):
    """``yield from`` this: the sum of ``x`` over the pipe axis forward,
    the identity backward (``reduce_from_tp_region`` on the pipe axis)."""
    (total,) = yield PipeReduce([x])
    return _Replace.apply(x, total)


def _apply(fn, params, x, mb: int, pass_mb_index: bool, *extra):
    return fn(params, x, mb, *extra) if pass_mb_index else fn(params, x)


def _grads(out: torch.Tensor, inputs: Sequence[torch.Tensor], ct: torch.Tensor | None):
    """``torch.autograd.grad`` of ``out`` (against ``ct``) with unused
    inputs' gradients None."""
    return torch.autograd.grad(out, list(inputs), ct, allow_unused=True)


def _accumulate(acc: dict, names: Sequence[str], grads, rows: slice | None = None) -> None:
    for name, g in zip(names, grads):
        if g is not None:
            target = acc[name] if rows is None else acc[name][rows]
            target += g


# --------------------------------------------------------------------------
# The schedules
# --------------------------------------------------------------------------
class _Tape:
    """A stage's forward ticks for the reverse pass: tick -> (input leaf,
    output, extras)."""

    def __init__(self, stage: int, num_stages: int, num_microbatches: int, params: dict,
                 mb_inputs: torch.Tensor, num_chunks: int = 1):
        self.stage, self.s, self.m, self.v = stage, num_stages, num_microbatches, num_chunks
        self.params, self.like = params, mb_inputs[0]
        self.shape = mb_inputs.shape
        self.ticks: dict[int, tuple] = {}


def spmd_pipeline(stage_fn, stage_params: dict, mb_inputs: torch.Tensor, *, stage: int,
                  num_stages: int, num_microbatches: int, pass_mb_index: bool = False,
                  grad: bool = True):
    """``yield from`` this: the GPipe forward of ``mb_inputs`` [M, ...]
    through ``num_stages`` stages, this stage being ``stage`` (the JAX
    ``spmd_pipeline``). ``stage_fn(stage_params, x[, mb_idx]) -> y`` is
    shape-preserving; ``stage_params`` is a dict of this stage's tensors.
    Returns ``(outputs, tape)``: the last stage's [M, ...] outputs,
    psum-broadcast to every stage, and the tape ``spmd_pipeline_backward``
    replays (None with ``grad=False``). M + S - 1 ticks, each a forward
    hop over the pairs (i, i + 1)."""
    s, m = num_stages, num_microbatches
    if mb_inputs.shape[0] != m:
        raise ValueError(f"mb_inputs leading dim {mb_inputs.shape[0]} != num_microbatches {m}")
    tape = _Tape(stage, s, m, stage_params, mb_inputs) if grad else None
    outputs = torch.zeros_like(mb_inputs, requires_grad=False)
    state = None
    for t in range(m + s - 1):
        mb = t - stage
        y = None
        if 0 <= mb < m:
            x = (mb_inputs[t] if stage == 0 else state).detach()
            with torch.set_grad_enabled(grad):
                if grad:
                    x.requires_grad_(True)
                y = _apply(stage_fn, stage_params, x, mb, pass_mb_index)
            if grad:
                tape.ticks[t] = (x, y)
            if stage == s - 1:
                outputs[mb] = y.detach()
        if s > 1:
            # The stage ahead consumes y on the next tick exactly when
            # this one held a microbatch.
            state = yield Shift(y.detach() if y is not None and stage < s - 1 else None, 1,
                                False, recv=stage > 0 and 0 <= t + 1 - stage < m,
                                like=mb_inputs[0])
    if s > 1:  # the g boundary: psum-forward of the last stage's buffer
        (outputs,) = yield PipeReduce([outputs if stage == s - 1 else torch.zeros_like(outputs)])
    return outputs, tape


def spmd_pipeline_backward(tape: _Tape, d_outputs: torch.Tensor):
    """``yield from`` this: the reverse of ``spmd_pipeline`` (JAX's AD
    transpose of its scan) for the cotangent ``d_outputs`` [M, ...] of its
    outputs (only the last stage's is read). Returns ``(d_stage_params,
    d_mb_inputs)``: this stage's parameter gradients (a dict, summed over
    its ticks in reverse order) and the inputs' cotangent, psum-broadcast
    from stage 0 (the f boundary's backward)."""
    stage, s, m = tape.stage, tape.s, tape.m
    names = list(tape.params)
    d_params = {k: torch.zeros_like(p) for k, p in tape.params.items()}
    d_mb = torch.zeros(tape.shape, dtype=tape.like.dtype, device=tape.like.device)
    carry = None
    for t in reversed(range(m + s - 1)):
        mb = t - stage
        dx = None
        if 0 <= mb < m:
            x, y = tape.ticks.pop(t)
            dy = d_outputs[mb] if stage == s - 1 else carry
            *g, dx = _grads(y, [*tape.params.values(), x], dy)
            _accumulate(d_params, names, g)
            if stage == 0:
                d_mb[mb] = dx
        if s > 1:
            carry = yield Shift(dx if dx is not None and stage > 0 else None, -1, False,
                                recv=stage < s - 1 and 0 <= t - 1 - stage < m,
                                like=tape.like)
    if s > 1:
        (d_mb,) = yield PipeReduce([d_mb])
    return d_params, d_mb


def _interleaved_unit(t: int, stage: int, s: int, m: int, v: int):
    """The (microbatch, chunk) stage ``stage`` runs on tick ``t`` of the
    interleaved schedule, or None: ``t - stage = g V S + c S + i``,
    microbatch ``g S + i``, chunk ``c``."""
    r = t - stage
    if not 0 <= r < v * m:
        return None
    g, rem = divmod(r, v * s)
    c, i = divmod(rem, s)
    return g * s + i, c


def spmd_pipeline_interleaved(chunk_fn, stage_chunks: dict, mb_inputs: torch.Tensor, *,
                              stage: int, num_stages: int, num_microbatches: int,
                              num_chunks: int, pass_mb_index: bool = False, grad: bool = True):
    """``yield from`` this: the virtual-stage forward (the JAX
    ``spmd_pipeline_interleaved``). Each stage owns ``V = num_chunks``
    chunks, virtual stage ``j = c S + d`` on stage ``d``; tick t runs the
    unit of ``t - d = g V S + c S + i`` (microbatch ``g S + i``, chunk
    ``c``), one ring hop a tick carrying both the hop within a chunk and
    the step from stage S - 1 back to stage 0 (``M % S == 0``).
    ``chunk_fn(chunk_params, x[, mb_idx, c])``, ``chunk_params`` chunk c's
    rows ``[c C, (c + 1) C)`` of each tensor of ``stage_chunks`` (the
    interleaved storage order). V M + S - 1 ticks. Returns ``(outputs,
    tape)`` as ``spmd_pipeline``."""
    s, m, v = num_stages, num_microbatches, num_chunks
    if mb_inputs.shape[0] != m:
        raise ValueError(f"mb_inputs leading dim {mb_inputs.shape[0]} != num_microbatches {m}")
    if m % s:
        raise ValueError(
            f"the interleaved schedule needs num_microbatches ({m}) divisible by the pipe "
            f"axis ({s}) — microbatch groups of S fill each chunk in turn")
    layers_local = next(iter(stage_chunks.values())).shape[0]
    if layers_local % v:
        raise ValueError(f"per-device layer count {layers_local} not divisible by num_chunks {v}")
    c = layers_local // v
    tape = _Tape(stage, s, m, stage_chunks, mb_inputs, v) if grad else None
    outputs = torch.zeros_like(mb_inputs, requires_grad=False)
    state = None

    def consumes(d: int, t: int) -> bool:  # stage d reads the hop's tensor on tick t
        unit = _interleaved_unit(t, d, s, m, v)
        return unit is not None and not (unit[1] == 0 and d == 0)

    for t in range(v * m + s - 1):
        unit = _interleaved_unit(t, stage, s, m, v)
        y = None
        if unit is not None:
            mb, ch = unit
            inject = ch == 0 and stage == 0
            x = (mb_inputs[mb] if inject else state).detach()
            with torch.set_grad_enabled(grad):
                if grad:
                    x.requires_grad_(True)
                params = {k: a[ch * c:(ch + 1) * c] for k, a in stage_chunks.items()}
                y = _apply(chunk_fn, params, x, mb, pass_mb_index, ch)
            if grad:
                tape.ticks[t] = (x, y, params, mb, ch)
            if ch == v - 1 and stage == s - 1:
                outputs[mb] = y.detach()
        if s > 1:
            nxt = (stage + 1) % s
            state = yield Shift(y.detach() if y is not None and consumes(nxt, t + 1) else None,
                                1, True, recv=consumes(stage, t + 1), like=mb_inputs[0])
        else:
            state = y.detach() if y is not None else None
    if s > 1:
        (outputs,) = yield PipeReduce([outputs if stage == s - 1 else torch.zeros_like(outputs)])
    return outputs, tape


def spmd_pipeline_interleaved_backward(tape: _Tape, d_outputs: torch.Tensor):
    """``yield from`` this: the reverse of ``spmd_pipeline_interleaved``
    (one backward ring hop a tick). Returns ``(d_stage_chunks,
    d_mb_inputs)`` as ``spmd_pipeline_backward``; a chunk's gradients land
    in its rows of the stacked tensors."""
    stage, s, m, v = tape.stage, tape.s, tape.m, tape.v
    names = list(tape.params)
    c = next(iter(tape.params.values())).shape[0] // v
    d_params = {k: torch.zeros_like(p) for k, p in tape.params.items()}
    d_mb = torch.zeros(tape.shape, dtype=tape.like.dtype, device=tape.like.device)
    carry = None

    def recorded(d: int, t: int) -> bool:
        unit = _interleaved_unit(t, d, s, m, v)
        return unit is not None and unit[1] == v - 1 and d == s - 1

    for t in reversed(range(v * m + s - 1)):
        dx, inject = None, True
        if t in tape.ticks:
            x, y, params, mb, ch = tape.ticks.pop(t)
            dy = d_outputs[mb] if recorded(stage, t) else carry
            *g, dx = _grads(y, [*params.values(), x], dy)
            _accumulate(d_params, names, g, slice(ch * c, (ch + 1) * c))
            inject = ch == 0 and stage == 0
            if inject:
                d_mb[mb] = dx
        if s > 1:
            prev = _interleaved_unit(t - 1, stage, s, m, v)
            carry = yield Shift(None if inject else dx, -1, True,
                                recv=prev is not None and not recorded(stage, t - 1),
                                like=tape.like)
        else:
            carry = dx
    if s > 1:
        (d_mb,) = yield PipeReduce([d_mb])
    return d_params, d_mb


def interleave_layers(num_layers: int, num_stages: int, num_chunks: int):
    """Storage order of the stacked layer dim for the interleaved
    schedule: logical layer ``l`` belongs to virtual stage ``j = l // C``
    (``C = num_layers / (V*S)``), device ``j % S``, chunk ``j // S``;
    storage sorts by (device, chunk, position) so each stage's contiguous
    slice holds its V chunks stacked. Returns (perm, inv) index arrays:
    ``storage = logical[perm]``, ``logical = storage[inv]``."""
    vs = num_stages * num_chunks
    if num_layers % vs:
        raise ValueError(f"num_layers {num_layers} not divisible by num_stages*num_chunks {vs}")
    c = num_layers // vs
    perm = np.array([(v * num_stages + dev) * c + p for dev in range(num_stages)
                     for v in range(num_chunks) for p in range(c)], np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(num_layers)
    return perm, inv


def interleaved_stats(num_stages: int, num_microbatches: int, num_chunks: int) -> dict:
    """Static bubble accounting in chunk-ticks (the JAX function's
    dict): both schedules do ``V*M`` busy chunk-ticks a stage a
    direction; the plain schedule idles ``(S-1)*V``, the interleaved one
    ``S-1``."""
    s, m, v = num_stages, num_microbatches, num_chunks
    return {
        "interleaved_ticks": v * m + s - 1,
        "interleaved_idle_chunk_ticks": s - 1,
        "plain_idle_chunk_ticks": (s - 1) * v,
        "bubble_fraction": (s - 1) / (v * m + s - 1),
        "plain_bubble_fraction": (s - 1) / (m + s - 1),
        "bubble_cut_factor": v,
    }


def one_f_one_b_pipeline(stage_fn, post_fn, stage_params: dict, post_params: dict,
                         mb_inputs: torch.Tensor, mb_targets: torch.Tensor, *, stage: int,
                         num_stages: int, num_microbatches: int, pass_mb_index: bool = False,
                         distributed_tail: bool = False):
    """``yield from`` this: the one-forward-one-backward schedule with its
    backward written out (the JAX ``one_f_one_b_pipeline``): warm-up
    waves ``[0, S-1)`` forward only, ``M`` mixed waves (a forward, then a
    backward), drain waves backward only. Wave t: stage d forwards
    microbatch ``t - d`` without a graph (its input stashed) and backwards
    microbatch ``t - 2(S-1) + d``: the stage recomputed on the stashed
    input, then its VJP against the cotangent that came back (the last
    stage's from ``post_fn(post_params, y, targets) -> scalar``, the
    per-microbatch tail; a generator function may yield pipe steps).

    ``distributed_tail``: each backward wave the last stage's output is
    psum-broadcast to every stage and each computes its vocab slice of
    the tail (``post_fn`` must then be the pipe-sharded tail,
    ``_sharded_ce`` over the pipe axis); the slices' cotangents of the
    broadcast output are summed back onto the last stage.

    Returns ``(loss, d_stage_params, d_post_params, d_mb_inputs)``, all
    averaged over microbatches; loss, ``d_post`` and ``d_mb`` are
    psum-replicated over the pipe axis."""
    s, m = num_stages, num_microbatches
    if mb_inputs.shape[0] != m:
        raise ValueError(f"mb_inputs leading dim {mb_inputs.shape[0]} != num_microbatches {m}")
    is_last = stage == s - 1
    like = mb_inputs[0]
    s_names, p_names = list(stage_params), list(post_params)
    d_stage = {k: torch.zeros_like(p) for k, p in stage_params.items()}
    d_post = {k: torch.zeros_like(p) for k, p in post_params.items()}
    d_in = torch.zeros_like(mb_inputs, requires_grad=False)
    loss = torch.zeros((), dtype=torch.float32, device=mb_inputs.device)
    stash: dict[int, torch.Tensor] = {}
    carry = {"f": None, "b": None}

    def fwd_half(t: int):
        f = t - stage
        y = None
        if 0 <= f < m:
            x = (mb_inputs[t] if stage == 0 else carry["f"]).detach()
            stash[f] = x
            with torch.no_grad():
                y = _apply(stage_fn, stage_params, x, f, pass_mb_index)
        if s > 1:
            carry["f"] = yield Shift(y if y is not None and not is_last else None, 1, False,
                                     recv=stage > 0 and 0 <= t + 1 - stage < m, like=like)

    def bwd_half(t: int):
        nonlocal loss
        b = t - 2 * (s - 1) + stage
        active = 0 <= b < m
        dx = y = x = None
        if active:
            x = stash.pop(b).requires_grad_(True)
            with torch.enable_grad():
                y = _apply(stage_fn, stage_params, x, b, pass_mb_index)
        if distributed_tail:
            tail = t - (s - 1)  # the last stage's microbatch this wave, the same on every stage
            dy = carry["b"]
            if 0 <= tail < m:
                (y_full,) = yield PipeReduce([y.detach() if is_last else torch.zeros_like(like)])
                y_full.requires_grad_(True)
                per_mb = yield from _call(post_fn, post_params, y_full, mb_targets[tail],
                                          grad=True)
                *g, d_y = _grads(per_mb, [*post_params.values(), y_full], None)
                _accumulate(d_post, p_names, g)
                (d_y,) = yield PipeReduce([d_y])  # the copy boundary's backward
                if is_last:
                    dy = d_y
                    loss = loss + per_mb.detach()
            if active:
                *g, dx = _grads(y, [*stage_params.values(), x], dy)
                _accumulate(d_stage, s_names, g)
        elif active:
            if is_last:
                per_mb = yield from _call(post_fn, post_params, y, mb_targets[b], grad=True)
                grads = _grads(per_mb, [*stage_params.values(), *post_params.values(), x], None)
                _accumulate(d_stage, s_names, grads[:len(s_names)])
                _accumulate(d_post, p_names, grads[len(s_names):-1])
                dx = grads[-1]
                loss = loss + per_mb.detach()
            else:
                *g, dx = _grads(y, [*stage_params.values(), x], carry["b"])
                _accumulate(d_stage, s_names, g)
        if active and stage == 0:
            d_in[b] = dx
        if s > 1:
            carry["b"] = yield Shift(dx if active and stage > 0 else None, -1, False,
                                     recv=stage < s - 1 and 0 <= t + 1 - 2 * (s - 1) + stage < m,
                                     like=like)

    for t in range(s - 1):
        yield from fwd_half(t)
    for t in range(s - 1, m + s - 1):
        yield from fwd_half(t)
        yield from bwd_half(t)
    for t in range(m + s - 1, m + 2 * (s - 1)):
        yield from bwd_half(t)

    scale = 1.0 / m
    d_stage = {k: g * scale for k, g in d_stage.items()}
    d_post = {k: g * scale for k, g in d_post.items()}
    d_in, loss = d_in * scale, loss * scale
    if s > 1:
        *post, d_in, loss = yield PipeReduce([*d_post.values(), d_in, loss])
        d_post = dict(zip(p_names, post))
    return loss, d_stage, d_post, d_in


def one_f_one_b_stats(num_stages: int, num_microbatches: int) -> dict:
    """Static schedule accounting (the JAX function's dict): waves, stash
    slots and the GPipe equivalents."""
    s, m = num_stages, num_microbatches
    return {
        "f1b_waves": (s - 1) + m + (s - 1),
        "f1b_stash_slots": 2 * s - 1,
        "gpipe_ticks": 2 * (m + s - 1),
        "gpipe_stash_slots": m + s - 1,
        "bubble_fraction": (s - 1) / (m + s - 1),
    }


def _reduce_max(x: torch.Tensor, axes: tuple, mesh):
    """``yield from`` this: ``lax.pmax`` of ``x`` over ``axes`` (the pipe
    axis by a yield, the others through the mesh's groups)."""
    real = tuple(a for a in axes if a != PIPE_AXIS)
    if real and mesh.size(*real) > 1:
        x = x.clone()
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.group(*real))
    if PIPE_AXIS in axes:
        (x,) = yield PipeReduce([x], "max")
    return x


def _psum_fwd(x: torch.Tensor, axes: tuple, mesh):
    """``yield from`` this: ``reduce_from_tp_region`` over ``axes``: the
    sum forward, the identity backward."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.tensor import (
        reduce_from_tp_region,
    )

    real = tuple(a for a in axes if a != PIPE_AXIS)
    if real:
        x = reduce_from_tp_region(x, mesh, *real)
    if PIPE_AXIS in axes:
        x = yield from _pipe_sum_fwd(x)
    return x


def _sharded_ce(logits_loc: torch.Tensor, targets: torch.Tensor, axis_name,
                shard_offset=None, *, mesh=None, stage: int = 0):
    """``yield from`` this: the mean softmax cross-entropy over a
    vocab-sharded logit slice ``[..., V/n]`` (the JAX ``_sharded_ce``),
    exact against the full-vocab computation:
    ``log(psum sum exp(z - m)) + m - psum masked(z_t)`` with ``m`` the
    global row max (no gradient). The two sums are psum forward /
    identity backward, so each shard's logit cotangent is its
    ``softmax - onehot``. ``axis_name``: ``"pipe"`` (``stage`` is this
    stage), ``"tensor"`` (through ``mesh``) or the tuple of both, which
    needs ``shard_offset``, the global vocab id of local column 0."""
    axes = tuple(axis_name) if isinstance(axis_name, (tuple, list)) else (axis_name,)
    vloc = logits_loc.shape[-1]
    if shard_offset is None:
        if isinstance(axis_name, (tuple, list)):
            raise ValueError("joint-axis _sharded_ce needs an explicit shard_offset (the global "
                             "vocab id of local column 0)")
        index = stage if axis_name == PIPE_AXIS else mesh.axis_index(axis_name)
        shard_offset = index * vloc
    m = yield from _reduce_max(logits_loc.detach().amax(dim=-1), axes, mesh)
    e_sum = torch.exp(logits_loc - m[..., None]).sum(dim=-1)
    s = yield from _psum_fwd(e_sum, axes, mesh)
    local_t = targets - shard_offset
    in_range = (local_t >= 0) & (local_t < vloc)
    picked = logits_loc.gather(-1, local_t.clamp(0, vloc - 1)[..., None])[..., 0]
    tgt = yield from _psum_fwd(torch.where(in_range, picked, torch.zeros_like(picked)), axes,
                               mesh)
    return (torch.log(s) + m - tgt).mean()


# --------------------------------------------------------------------------
# A pure-pytree transformer stack to pipeline
# --------------------------------------------------------------------------
def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """The JAX ``_layer_norm``: statistics in ``x``'s dtype, then the
    affine in the promoted dtype."""
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


#: The 12 tensors of one block's dict (``init_block_params``).
BLOCK_PARAM_NAMES = (
    "ln1_scale", "ln1_bias", "wq", "wk", "wv", "wo",
    "ln2_scale", "ln2_bias", "w1", "b1", "w2", "b2",
)


def init_block_params(generator: torch.Generator, d_model: int, d_ff: int,
                      device=None) -> dict[str, torch.Tensor]:
    """One pre-LN transformer block (dense causal attention + GELU MLP) as
    a dict of tensors, kernels ``[in, out]`` lecun-normal (truncated, as
    flax's), norms one and biases zero."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.vgg import _lecun_normal_

    d = d_model

    def kernel(fan_in, fan_out):
        w = torch.empty(fan_in, fan_out)
        _lecun_normal_(w, fan_in, generator)
        return w.to(device)

    zeros = lambda n: torch.zeros(n, device=device)  # noqa: E731
    ones = lambda n: torch.ones(n, device=device)  # noqa: E731
    return {
        "ln1_scale": ones(d), "ln1_bias": zeros(d),
        "wq": kernel(d, d), "wk": kernel(d, d), "wv": kernel(d, d), "wo": kernel(d, d),
        "ln2_scale": ones(d), "ln2_bias": zeros(d),
        "w1": kernel(d, d_ff), "b1": zeros(d_ff), "w2": kernel(d_ff, d), "b2": zeros(d),
    }


def block_apply(p: dict, x: torch.Tensor, num_heads: int, impl: str = "dense") -> torch.Tensor:
    """[B, T, D] -> [B, T, D]; causal attention + MLP, pre-LN. ``impl``:
    ``dense`` (``parallel/ring_attention.py::dense_attention``) or
    ``flash`` (the CUDA kernels; their plain version on CPU tensors)."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops.flash_attention import flash_attention
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.ring_attention import (
        dense_attention,
    )

    b, t, d = x.shape
    h = _layer_norm(x, p["ln1_scale"], p["ln1_bias"])
    q, k, v = ((h @ p[w]).reshape(b, t, num_heads, d // num_heads) for w in ("wq", "wk", "wv"))
    attn = (flash_attention(q, k, v, causal=True) if impl == "flash"
            else dense_attention(q, k, v, causal=True))
    x = x + attn.reshape(b, t, d) @ p["wo"]
    h = _layer_norm(x, p["ln2_scale"], p["ln2_bias"])
    return x + F.gelu(h @ p["w1"] + p["b1"], approximate="tanh") @ p["w2"] + p["b2"]


def stack_apply(stacked: dict, x: torch.Tensor, num_heads: int, remat: bool = False,
                impl: str = "dense", remat_policy: str = "none") -> torch.Tensor:
    """Apply a stack of blocks (leading layer dim), one after another.
    ``remat`` recomputes each block in the backward
    (``torch.utils.checkpoint``; ``remat_policy="dots"`` keeps the matrix
    products' outputs): the same numbers, less activation memory."""
    from torch.utils.checkpoint import checkpoint

    from cs744_pytorch_distributed_tutorial_tpu_torch.models.transformer import (
        resolve_remat_policy,
    )

    context = resolve_remat_policy(remat_policy) if remat else None
    n = next(iter(stacked.values())).shape[0]
    for i in range(n):
        layer = {k: a[i] for k, a in stacked.items()}
        if remat and torch.is_grad_enabled():
            kw = {} if context is None else {"context_fn": context}
            x = checkpoint(block_apply, layer, x, num_heads, impl, use_reentrant=False, **kw)
        else:
            x = block_apply(layer, x, num_heads, impl)
    return x


# --------------------------------------------------------------------------
# The trainer: data x pipe x seq x tensor
# --------------------------------------------------------------------------
@dataclasses.dataclass
class PipelineLMConfig:
    """Causal-LM training over a (data, pipe, seq, tensor) mesh, with the
    JAX ``PipelineLMConfig``'s fields and defaults, plus ``device``."""

    vocab_size: int = 1024
    num_layers: int = 4
    num_heads: int = 4
    d_model: int = 128
    d_ff: int = 512
    max_seq_len: int = 512
    compute_dtype: str = "float32"
    use_rope: bool = False
    num_kv_heads: int | None = None
    norm: str = "layernorm"
    mlp: str = "gelu"
    # MoE FFN in every block (the router's aux loss is not plumbed through
    # the schedules, as in JAX); with moe_expert_parallel the experts split
    # over the data axis.
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_groups: int = 1
    moe_dispatch: str = "scatter"
    moe_gmm_impl: str = "auto"
    moe_expert_parallel: bool = False
    data_parallel: int = 1
    pipeline_parallel: int = 2
    tensor_parallel: int = 1
    seq_parallel: int = 1
    num_microbatches: int = 2
    # "gpipe", "1f1b" or "interleaved" (num_virtual_stages chunks a stage).
    schedule: str = "gpipe"
    num_virtual_stages: int = 2
    remat: bool = False
    remat_policy: str = "none"
    attention_impl: str = "dense"
    global_batch_size: int = 8
    seq_len: int = 64
    learning_rate: float = 1e-3
    seed: int = 0
    # Residual dropout keyed by (seed, step, data shard[, seq shard],
    # storage layer id, microbatch); the 1F1B recompute replays the keys.
    dropout_rate: float = 0.0
    optimizer: str = "adamw"
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    total_steps: int | None = None
    momentum: float = 0.9
    weight_decay: float = 1e-4
    grad_clip_norm: float | None = None
    zero1: bool = False
    fsdp: bool = False
    checkpoint_dir: str | None = None
    checkpoint_every: int = 0
    halt_on_nonfinite: bool = True
    device: str = "cuda"

    def replace(self, **kw: Any) -> "PipelineLMConfig":
        return dataclasses.replace(self, **kw)


def check_pipeline_config(cfg: PipelineLMConfig) -> None:
    """Every refusal of the JAX ``PipelineLMTrainer.__init__``, in its
    order, with its messages; none needs a process group."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.state import check_recipe

    data, pipe = cfg.data_parallel, cfg.pipeline_parallel
    seq, tensor = cfg.seq_parallel, cfg.tensor_parallel
    if cfg.num_layers % pipe:
        raise ValueError(f"num_layers {cfg.num_layers} not divisible by pipe axis {pipe}")
    if cfg.global_batch_size % data:
        raise ValueError(f"global batch {cfg.global_batch_size} not divisible by data axis "
                         f"{data}")
    local_batch = cfg.global_batch_size // data
    if local_batch % cfg.num_microbatches:
        raise ValueError(f"per-device batch {local_batch} not divisible by num_microbatches "
                         f"{cfg.num_microbatches}")
    if cfg.seq_len > cfg.max_seq_len:
        raise ValueError(f"seq_len {cfg.seq_len} > max_seq_len {cfg.max_seq_len}")
    if cfg.schedule not in ("gpipe", "1f1b", "interleaved"):
        raise ValueError(f"unknown schedule {cfg.schedule!r}; choose 'gpipe', '1f1b' or "
                         "'interleaved'")
    if cfg.schedule == "interleaved":
        v = cfg.num_virtual_stages
        if v < 1:
            raise ValueError(f"num_virtual_stages must be >= 1, got {v}")
        if cfg.num_layers % (pipe * v):
            raise ValueError(f"num_layers {cfg.num_layers} not divisible by pipe * "
                             f"num_virtual_stages ({pipe} * {v})")
        if cfg.num_microbatches % pipe:
            raise ValueError(f"the interleaved schedule needs num_microbatches "
                             f"({cfg.num_microbatches}) divisible by the pipe axis ({pipe})")
    if seq > 1:
        if cfg.attention_impl not in ("ring", "ring_flash", "ulysses", "ulysses_flash"):
            raise ValueError(
                f"attention_impl={cfg.attention_impl!r} is incompatible with seq_parallel > 1 "
                "(a sequence-sharded stage cannot attend to the full sequence without "
                "communication); use 'ring', 'ring_flash', 'ulysses' or 'ulysses_flash'")
        if cfg.seq_len % seq:
            raise ValueError(f"seq_len {cfg.seq_len} not divisible by seq axis {seq}")
    elif cfg.attention_impl not in ("dense", "flash"):
        raise ValueError(
            f"unknown attention_impl {cfg.attention_impl!r}; without a seq axis each stage "
            "holds the full sequence — use 'dense' or 'flash' (sequence-parallel impls need "
            "seq_parallel > 1)")
    if cfg.num_heads % tensor:
        raise ValueError(f"num_heads {cfg.num_heads} not divisible by tensor axis {tensor}")
    if cfg.moe_experts == 0 and cfg.d_ff % tensor:
        raise ValueError(f"d_ff {cfg.d_ff} not divisible by tensor axis {tensor}")
    kv = cfg.num_heads if cfg.num_kv_heads is None else cfg.num_kv_heads
    if kv % tensor:
        raise ValueError(f"num_kv_heads {kv} not divisible by tensor axis {tensor}")
    heads_local = cfg.num_heads // tensor
    if cfg.attention_impl in ("ulysses", "ulysses_flash") and heads_local % seq:
        raise ValueError(f"ulysses needs per-tensor-shard heads ({heads_local}) divisible by "
                         f"the seq axis ({seq})")
    if cfg.vocab_size % tensor:
        raise ValueError(f"vocab_size {cfg.vocab_size} not divisible by tensor axis {tensor} "
                         "(the LM head is vocab-sharded over it)")
    if not 0.0 <= cfg.dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {cfg.dropout_rate}")
    ep = _expert_parallel(cfg)
    if ep and cfg.moe_experts % data:
        raise ValueError(f"moe_experts {cfg.moe_experts} not divisible by the data axis "
                         f"({data}) for expert parallelism")
    if ep and cfg.moe_dispatch == "dropless":
        raise ValueError(
            "moe_dispatch='dropless' does not compose with moe_expert_parallel: EP's "
            "all_to_all needs static per-destination counts (capacity slots); use "
            "moe_dispatch='scatter' for expert-parallel layouts")
    if cfg.zero1 and cfg.fsdp:
        raise ValueError("zero1 and fsdp are mutually exclusive")
    if (cfg.zero1 or cfg.fsdp) and cfg.optimizer not in ("sgd", "adamw", "lion"):
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}; choose from "
                         "('sgd', 'adamw', 'lion')")
    check_recipe(cfg)


def _expert_parallel(cfg: PipelineLMConfig) -> bool:
    return bool(cfg.moe_expert_parallel and cfg.moe_experts > 0 and cfg.data_parallel > 1)


_TAIL = ("ln_f_scale", "ln_f_bias", "head")


class PipelineLMTrainer:
    """The LM's ``models/transformer.py::Block`` stack pipelined over the
    pipe axis (the JAX ``PipelineLMTrainer``), one process a rank of a
    (data, pipe, seq, tensor) mesh, or, with ``stage`` given, stage
    ``stage`` of a pipeline that ``simulate_train_step`` runs in one
    process (every other axis 1).

    Each stage holds its ``num_layers / S`` blocks as stacked tensors
    (``blocks.<Block parameter>``, a leading layer axis in storage order:
    ``interleave_layers`` under the interleaved schedule), each layer run
    on views of them (``torch.func.functional_call``), its kernels cut
    over the tensor axis by the LM's rules (``lm_param_specs``), experts
    over the data axis under expert parallelism. ``embed`` (``[V, d]``),
    ``pos`` (``[max_seq_len, d]``, without RoPE), ``ln_f_scale``,
    ``ln_f_bias`` and ``head`` (``[d, V]``, vocab-split over the tensor
    axis) are replicated over the pipe axis: the JAX tree's names and
    layouts. ``param_specs`` names the axis each dimension is split over.

    A step (``train_step``): the embedding, the schedule's forward and
    backward through ``drive_pipe``, the tail (final norm, head, plain
    cross-entropy, ``_sharded_ce`` over a vocab-split head; 1F1B's
    distributed tail when the per-tensor-shard vocab divides the pipe
    axis), the loss averaged over the data and seq axes, then the update:
    the gradients synced by spec (JAX's ``sync_grad``: the pipe axis's
    mean for the replicated tensors) behind the spec-aware clip, or
    ``parallel/zero.py``'s zero1 or fsdp rules chunked per (pipe[,
    tensor]) coordinate on the data axis. Every JAX refusal is raised
    before a process group is needed."""

    def __init__(self, cfg: PipelineLMConfig, stage: int | None = None):
        from cs744_pytorch_distributed_tutorial_tpu_torch.config import (
            resolve_device,
            resolve_dtype,
        )
        from cs744_pytorch_distributed_tutorial_tpu_torch.models.transformer import (
            Block,
            lm_param_specs,
        )
        from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.mesh import (
            Mesh,
            rank_device,
            world,
        )

        check_pipeline_config(cfg)
        self.cfg = cfg
        self.data_size, self.pipe_size = cfg.data_parallel, cfg.pipeline_parallel
        self.seq_size, self.tensor_size = cfg.seq_parallel, cfg.tensor_parallel
        if cfg.schedule == "interleaved":
            self.num_chunks = cfg.num_virtual_stages
            self._perm, self._inv = (interleave_layers(cfg.num_layers, self.pipe_size,
                                                       self.num_chunks)
                                     if self.num_chunks > 1 else (None, None))
        else:
            self.num_chunks, self._perm, self._inv = 1, None, None
        self._layout_code = (self.pipe_size * 100000 + self.num_chunks
                             if self._perm is not None else 0)
        self.expert_parallel = _expert_parallel(cfg)
        self.world_size, self.rank = world()
        self.simulated = stage is not None
        if self.simulated:
            if not 0 <= stage < self.pipe_size:
                raise ValueError(f"stage {stage} outside the pipe axis of {self.pipe_size}")
            if (self.data_size, self.seq_size, self.tensor_size) != (1, 1, 1) or cfg.zero1 \
                    or cfg.fsdp or self.world_size != 1:
                raise ValueError("a simulated stage runs the pipe axis alone in one process: "
                                 "data, seq and tensor axes of 1, no zero1/fsdp, a world of one")
            self.mesh = Mesh.get()
            self.stage = stage
        else:
            layout = self.data_size * self.pipe_size * self.seq_size * self.tensor_size
            if layout != self.world_size:
                raise ValueError(
                    f"data_parallel={self.data_size} x pipeline_parallel={self.pipe_size} x "
                    f"seq_parallel={self.seq_size} x tensor_parallel={self.tensor_size} but the "
                    f"process group has world size {self.world_size}; launch one process per "
                    "rank")
            self.mesh = Mesh.get(self.data_size, self.seq_size, self.tensor_size,
                                 pipe=self.pipe_size)
            self.stage = self.mesh.axis_index(PIPE_AXIS)
        self.coords = {**self.mesh.coords, PIPE_AXIS: self.stage}
        self.sizes = {**self.mesh.sizes, PIPE_AXIS: self.pipe_size}
        self.device = rank_device(resolve_device(cfg.device), self.rank)
        self.dtype = resolve_dtype(cfg.compute_dtype)
        self._has_tensor = self.tensor_size > 1
        moe = None
        if cfg.moe_experts > 0:
            moe = dict(num_experts=cfg.moe_experts, top_k=cfg.moe_top_k,
                       capacity_factor=cfg.moe_capacity_factor, num_groups=cfg.moe_groups,
                       dispatch_impl=cfg.moe_dispatch, gmm_impl=cfg.moe_gmm_impl,
                       expert_axis=DATA_AXIS if self.expert_parallel else None,
                       expert_axis_size=self.data_size if self.expert_parallel else 1)
        block_kw = dict(norm=cfg.norm, mlp=cfg.mlp, num_kv_heads=cfg.num_kv_heads,
                        impl=cfg.attention_impl, rope=cfg.use_rope, moe=moe,
                        dropout_rate=cfg.dropout_rate)
        with torch.device("meta"):
            # Templates: functional_call runs them on a layer's views.
            self.block = Block(cfg.d_model, cfg.num_heads, cfg.d_ff, **block_kw,
                               seq_size=self.seq_size, tensor_size=self.tensor_size,
                               mesh=self.mesh)
            host_moe = None if moe is None else dict(moe, expert_axis=None, expert_axis_size=1)
            self._block_host = Block(cfg.d_model, cfg.num_heads, cfg.d_ff,
                                     **dict(block_kw, moe=host_moe,
                                            impl="flash" if "flash" in cfg.attention_impl
                                            else "dense"))
        self._block_names = [n for n, _ in self.block.named_parameters()]
        embed_keys = ("embed",) if cfg.use_rope else ("embed", "pos")
        self._embed_keys = embed_keys
        self.names = [f"blocks.{n}" for n in self._block_names] + [*embed_keys, *_TAIL]
        shapes = self._global_shapes()
        specs = lm_param_specs({k: torch.empty(v, device="meta") for k, v in shapes.items()
                                if k.startswith("blocks.")},
                               TENSOR_AXIS if self._has_tensor else None,
                               DATA_AXIS if self.expert_parallel else None)
        self.param_specs = {k: (PIPE_AXIS, *specs[k][1:]) for k in specs}
        for k in (*embed_keys, "ln_f_scale", "ln_f_bias"):
            self.param_specs[k] = (None,) * len(shapes[k])
        self.param_specs["head"] = (None, TENSOR_AXIS if self._has_tensor else None)
        self._dist_tail = (cfg.schedule == "1f1b" and self.pipe_size > 1
                           and (cfg.vocab_size // self.tensor_size) % self.pipe_size == 0)
        self.params: dict[str, torch.Tensor] | None = None
        self.optimizer = None
        self.step = 0

    # ---------------------------------------------------------- parameters
    def _global_shapes(self) -> dict[str, tuple]:
        """Every parameter's global shape by name (the blocks stacked over
        all ``num_layers``)."""
        cfg = self.cfg
        shapes = {f"blocks.{n}": (cfg.num_layers, *p.shape)
                  for n, p in self._block_host.named_parameters()}
        shapes["embed"] = (cfg.vocab_size, cfg.d_model)
        if not cfg.use_rope:
            shapes["pos"] = (cfg.max_seq_len, cfg.d_model)
        shapes.update(ln_f_scale=(cfg.d_model,), ln_f_bias=(cfg.d_model,),
                      head=(cfg.d_model, cfg.vocab_size))
        return {k: shapes[k] for k in self.names}

    def init_params(self, seed: int | None = None) -> dict[str, torch.Tensor]:
        """The global parameters in logical layer order, drawn from a
        ``torch.Generator`` seeded with ``seed`` (default ``cfg.seed``) with
        the JAX ``_init_host``'s distributions: each block as the LM's
        (lecun-normal kernels, zero biases, unit norms, the MoE's own),
        ``embed``, ``pos`` and ``head`` N(0, 0.02)."""
        from cs744_pytorch_distributed_tutorial_tpu_torch.models.transformer import (
            TransformerLM,
        )

        cfg = self.cfg
        gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
        lm = TransformerLM(vocab_size=8, num_layers=cfg.num_layers, num_heads=cfg.num_heads,
                           d_model=cfg.d_model, d_ff=cfg.d_ff, max_seq_len=8,
                           num_kv_heads=cfg.num_kv_heads, norm=cfg.norm, mlp=cfg.mlp,
                           num_experts=cfg.moe_experts, use_rope=True, generator=gen,
                           attention_impl="dense")
        sd = lm.state_dict()
        out = {f"blocks.{n}": torch.stack([sd[f"blocks.{i}.{n}"] for i in range(cfg.num_layers)])
               for n in self._block_names}
        normal = lambda *shape: torch.randn(shape, generator=gen) * 0.02  # noqa: E731
        out["embed"] = normal(cfg.vocab_size, cfg.d_model)
        if not cfg.use_rope:
            out["pos"] = normal(cfg.max_seq_len, cfg.d_model)
        out.update(ln_f_scale=torch.ones(cfg.d_model), ln_f_bias=torch.zeros(cfg.d_model),
                   head=normal(cfg.d_model, cfg.vocab_size))
        return {k: out[k] for k in self.names}

    def blocks_to_storage(self, params: dict) -> dict:
        """Logical layer order -> storage order (the identity unless the
        schedule is interleaved)."""
        if self._perm is None:
            return dict(params)
        perm = torch.as_tensor(self._perm)
        return {k: v[perm] if k.startswith("blocks.") else v for k, v in params.items()}

    def blocks_to_logical(self, params: dict) -> dict:
        """The inverse of ``blocks_to_storage``."""
        if self._inv is None:
            return dict(params)
        inv = torch.as_tensor(self._inv)
        return {k: v[inv] if k.startswith("blocks.") else v for k, v in params.items()}

    def init(self, seed: int | None = None, params: dict | None = None):
        """This rank's parameters (its slices of ``params``, the global tree
        in logical layer order, or of ``init_params(seed)``), stored in
        storage order, and the optimizer; returns ``(params,
        optimizer)``. Under fsdp ``params`` are gathered from the
        optimizer's rows for each step."""
        from cs744_pytorch_distributed_tutorial_tpu_torch.models.transformer import shard_tensor
        from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.zero import LM_RULES
        from cs744_pytorch_distributed_tutorial_tpu_torch.train.state import (
            make_lm_optimizer,
            make_schedule,
        )

        cfg = self.cfg
        full = self.init_params(seed) if params is None else params
        full = self.blocks_to_storage({k: torch.as_tensor(full[k]) for k in self.names})
        local = {k: shard_tensor(v.detach(), self.param_specs[k], self.coords, self.sizes)
                 .to(self.device, torch.float32, copy=True).requires_grad_(True)
                 for k, v in full.items()}
        self._local_shapes = [(tuple(v.shape), v.dtype) for v in local.values()]
        specs = [self.param_specs[k] for k in self.names]
        if cfg.zero1 or cfg.fsdp:
            z1_cls, fsdp_cls = LM_RULES[cfg.optimizer]
            rows = list(local.values())
            if cfg.fsdp:
                rows = fsdp_cls.shard_params(rows, self.data_size, self.mesh, specs)
            self.optimizer = (fsdp_cls if cfg.fsdp else z1_cls)(
                rows, make_schedule(cfg), cfg.momentum, cfg.weight_decay, self.data_size,
                clip_norm=cfg.grad_clip_norm, bucket_bytes=0, mesh=self.mesh, specs=specs)
            self.params = None if cfg.fsdp else local
        else:
            self.params = local
            self.optimizer = make_lm_optimizer(cfg.replace(grad_clip_norm=None),
                                               list(local.values()))
        if not self.simulated and self.pipe_size > 1:
            # The pipe group's first call is a collective every stage joins:
            # under NCCL a first call that is a batched P2P some stages skip
            # (tick 0's hop) is undefined.
            C.all_reduce_sum(torch.zeros(1, device=self.device), self.mesh.group(PIPE_AXIS))
        self.step = 0
        return self.params, self.optimizer

    def _materialize(self) -> dict[str, torch.Tensor]:
        """This rank's parameters for a step: under fsdp each gathered from
        the data axis's rows (an expert-split one is local already)."""
        if not self.cfg.fsdp:
            return self.params
        from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.zero import _unshard

        group = self.mesh.group(DATA_AXIS)
        out = {}
        for name, row, (shape, _) in zip(self.names, self.optimizer.params, self._local_shapes):
            if DATA_AXIS in self.param_specs[name]:
                out[name] = row.detach().view(shape)
            else:
                out[name] = _unshard(C.all_gather_flat(row.detach(), group), shape)
            out[name] = out[name].clone().requires_grad_(True)
        return out

    # ---------------------------------------------------------- the model
    def _stage_fn(self, drop_base: tuple | None):
        """``(stacked, x[, mb_idx[, chunk]]) -> y``: this stage's layers
        (or chunk ``chunk``'s) one after another, each ``Block`` run on its
        views of the stacked tensors, under ``torch.utils.checkpoint``
        with ``remat``. ``drop_base`` arms dropout: layer keys are
        ``(*drop_base, storage layer id, mb_idx)``."""
        from torch.func import functional_call
        from torch.utils.checkpoint import checkpoint

        from cs744_pytorch_distributed_tutorial_tpu_torch.models.transformer import (
            resolve_remat_policy,
        )

        cfg = self.cfg
        layers_local = cfg.num_layers // self.pipe_size
        c = layers_local // self.num_chunks
        context = resolve_remat_policy(cfg.remat_policy) if cfg.remat else None
        ckpt_kw = {} if context is None else {"context_fn": context}
        block, dtype, skip = self.block, self.dtype, len("blocks.")

        def layer(views, x, key):
            return functional_call(block, views, (x, dtype), {"drop_key": key})

        def run(stacked, x, mb=None, chunk=0):
            base = self.stage * layers_local + chunk * c
            # One unbind a tensor: its backward stacks the layers' gradients
            # once, where a view a layer would scatter each into a zeroed stack.
            names = [k[skip:] for k in stacked]
            for i, layer_views in enumerate(zip(*(a.unbind(0) for a in stacked.values()))):
                views = dict(zip(names, layer_views))
                key = None if drop_base is None else (*drop_base, base + i, mb)
                if cfg.remat and torch.is_grad_enabled():
                    x = checkpoint(layer, views, x, key, use_reentrant=False, **ckpt_kw)
                else:
                    x = layer(views, x, key)
            return x

        return run if drop_base is not None else (lambda stacked, x: run(stacked, x))

    def _embed(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        """Token (and, without RoPE, absolute position) embedding in the
        compute dtype; on a seq axis the positions start at this shard's
        global offset."""
        t = tokens.shape[-1]
        x = F.embedding(tokens, params["embed"].to(self.dtype))
        if not self.cfg.use_rope:
            off = self.mesh.axis_index(SEQ_AXIS) * t if self.seq_size > 1 else 0
            x = x + params["pos"].to(self.dtype)[off:off + t]
        return x

    def _tail(self, params: dict, y: torch.Tensor) -> torch.Tensor:
        """Final norm and head -> fp32 logits (this rank's vocab slice
        under a tensor axis, behind the f boundary on the head's input)."""
        from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.tensor import copy_to_tp_region

        z = _layer_norm(y, params["ln_f_scale"], params["ln_f_bias"]).to(self.dtype)
        if self._has_tensor:
            z = copy_to_tp_region(z, self.mesh, TENSOR_AXIS)
        return (z @ params["head"].to(self.dtype)).float()

    def _ce(self, logits: torch.Tensor, targets: torch.Tensor):
        """``yield from`` this: the mean next-token CE of ``_tail``'s
        logits (the vocab-sharded form under a tensor axis)."""
        if not self._has_tensor:
            v = logits.shape[-1]
            return F.cross_entropy(logits.reshape(-1, v), targets.reshape(-1))
        return (yield from _sharded_ce(logits, targets, TENSOR_AXIS, mesh=self.mesh))

    def _drop_base(self, step: int) -> tuple | None:
        if self.cfg.dropout_rate <= 0.0:
            return None
        key = (self.cfg.seed, step, self.mesh.axis_index(DATA_AXIS))
        return key + (self.mesh.axis_index(SEQ_AXIS),) if self.seq_size > 1 else key

    def _forward(self, params: dict, tokens: torch.Tensor, drop_base=None, grad: bool = False):
        """``yield from`` this: the pipelined forward's outputs [B, T, d]
        (psum-broadcast) and its tape."""
        cfg, s, m = self.cfg, self.pipe_size, self.cfg.num_microbatches
        b, t = tokens.shape
        with torch.set_grad_enabled(grad):
            x = self._embed(params, tokens)
        mb = x.reshape(m, b // m, t, cfg.d_model)
        blocks = {k: params[k] for k in self.names if k.startswith("blocks.")}
        with_mb = drop_base is not None
        sfn = self._stage_fn(drop_base)
        if cfg.schedule == "interleaved":
            out, tape = yield from spmd_pipeline_interleaved(
                sfn, blocks, mb, stage=self.stage, num_stages=s, num_microbatches=m,
                num_chunks=self.num_chunks, pass_mb_index=with_mb, grad=grad)
        else:
            out, tape = yield from spmd_pipeline(sfn, blocks, mb, stage=self.stage,
                                                 num_stages=s, num_microbatches=m,
                                                 pass_mb_index=with_mb, grad=grad)
        return mb, out.reshape(b, t, cfg.d_model), tape

    def _local_step_gpipe(self, params: dict, tokens, targets, drop_base):
        mb, out, tape = yield from self._forward(params, tokens, drop_base, grad=True)
        y = out.detach().requires_grad_(True)
        with torch.enable_grad():
            logits = self._tail(params, y)
        loss = yield from _call(self._ce, logits, targets, grad=True)
        *g_tail, d_y = _grads(loss, [*(params[k] for k in _TAIL), y], None)
        backward = (spmd_pipeline_interleaved_backward if self.cfg.schedule == "interleaved"
                    else spmd_pipeline_backward)
        d_blocks, d_mb = yield from backward(tape, d_y.reshape(mb.shape))
        g_embed = _grads(mb, [params[k] for k in self._embed_keys], d_mb)
        return loss.detach(), {**d_blocks, **dict(zip(_TAIL, g_tail)),
                               **dict(zip(self._embed_keys, g_embed))}

    def _post_fn(self):
        """The 1F1B per-microbatch tail: the plain one, or the distributed
        tail's pipe slice of the head (``V / (S T)`` columns) with the CE
        over the (pipe[, tensor]) region."""
        if not self._dist_tail:
            def post(pp, y, tgt):
                return (yield from _call(self._ce, self._tail(pp, y), tgt, grad=True))
            return post
        from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.tensor import copy_to_tp_region

        vloc_t = self.cfg.vocab_size // self.tensor_size
        vs = vloc_t // self.pipe_size
        axes = (PIPE_AXIS, TENSOR_AXIS) if self._has_tensor else PIPE_AXIS
        offset = self.stage * vs
        if self._has_tensor:
            offset += self.mesh.axis_index(TENSOR_AXIS) * vloc_t

        def post(pp, y, tgt):
            z = _layer_norm(y, pp["ln_f_scale"], pp["ln_f_bias"]).to(self.dtype)
            if self._has_tensor:
                z = copy_to_tp_region(z, self.mesh, TENSOR_AXIS)
            head = pp["head"].to(self.dtype)[:, self.stage * vs:(self.stage + 1) * vs]
            logits = (z @ head).float()
            return (yield from _sharded_ce(logits, tgt, axes, shard_offset=offset,
                                           mesh=self.mesh, stage=self.stage))

        return post

    def _local_step_1f1b(self, params: dict, tokens, targets, drop_base):
        cfg, s, m = self.cfg, self.pipe_size, self.cfg.num_microbatches
        b, t = tokens.shape
        with torch.enable_grad():
            mb = self._embed(params, tokens).reshape(m, b // m, t, cfg.d_model)
        blocks = {k: params[k] for k in self.names if k.startswith("blocks.")}
        post = {k: params[k] for k in _TAIL}
        loss, d_blocks, d_post, d_mb = yield from one_f_one_b_pipeline(
            self._stage_fn(drop_base), self._post_fn(), blocks, post, mb,
            targets.reshape(m, b // m, t), stage=self.stage, num_stages=s, num_microbatches=m,
            pass_mb_index=drop_base is not None, distributed_tail=self._dist_tail)
        g_embed = _grads(mb, [params[k] for k in self._embed_keys], d_mb)
        return loss, {**d_blocks, **d_post, **dict(zip(self._embed_keys, g_embed))}

    # ------------------------------------------------------------- a step
    def _world_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the data and seq axes (the loss's pmeans)."""
        return C.axis_mean(C.axis_mean(x, self.mesh, DATA_AXIS), self.mesh, SEQ_AXIS)

    def _sync_grads(self, grads: list[torch.Tensor]):
        """``yield from`` this: JAX's ``sync_grad`` on every gradient: an
        expert-split one summed over seq and divided by data x seq, any
        other averaged over data and seq; then the pipe axis's mean where
        the pipe axis does not split it, the tensor axis's likewise (one
        all-reduce for each set of axes; the pipe axis's by a yield)."""
        from cs744_pytorch_distributed_tutorial_tpu_torch.ops.quant import true_div

        specs = [self.param_specs[n] for n in self.names]
        axes = [(SEQ_AXIS,) + ((TENSOR_AXIS,) if TENSOR_AXIS not in sp else ())
                if DATA_AXIS in sp
                else (DATA_AXIS, SEQ_AXIS) + ((TENSOR_AXIS,) if TENSOR_AXIS not in sp else ())
                for sp in specs]
        out = C.reduce_by_axes(grads, axes, self.mesh)
        out = [true_div(g, self.data_size) if DATA_AXIS in sp else g
               for g, sp in zip(out, specs)]
        if self.pipe_size > 1:
            idx = [i for i, sp in enumerate(specs) if PIPE_AXIS not in sp]
            summed = yield PipeReduce([out[i] for i in idx])
            for i, g in zip(idx, summed):
                out[i] = true_div(g, self.pipe_size)
        return out

    def _global_norm(self, grads: list[torch.Tensor]):
        """``yield from`` this: the global L2 norm of the synced gradients,
        each one's squared sum summed over the axes its spec names (JAX's
        ``clip_by_global_norm_sharded``)."""
        specs = [self.param_specs[n] for n in self.names]
        sq = list(torch.stack(torch._foreach_norm(grads, 2, dtype=torch.float32)).square()
                  .unbind())
        real = [tuple(a for a in (DATA_AXIS, TENSOR_AXIS) if a in sp) for sp in specs]
        sq = C.reduce_by_axes(sq, real, self.mesh, mean=False)
        idx = [i for i, sp in enumerate(specs) if PIPE_AXIS in sp]
        if self.pipe_size > 1 and idx:
            (summed,) = yield PipeReduce([torch.stack([sq[i] for i in idx])])
            for i, v in zip(idx, summed.unbind()):
                sq[i] = v
        return torch.stack(sq).sum().sqrt()

    def train_steps(self, inputs: torch.Tensor, targets: torch.Tensor, step: int | None = None):
        """``yield from`` this (the step generator ``train_step`` drives):
        one update on this rank's rows of a batch; ``step`` keys dropout
        (default ``self.step``). Returns ``{"loss"}``, the mean over the
        data and seq axes."""
        from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.zero import _shard_flat
        from cs744_pytorch_distributed_tutorial_tpu_torch.train.state import clip_by_norm

        cfg = self.cfg
        params = self._materialize()
        drop_base = self._drop_base(self.step if step is None else step)
        local = self._local_step_1f1b if cfg.schedule == "1f1b" else self._local_step_gpipe
        loss, grads = yield from local(params, inputs, targets, drop_base)
        grads = [grads[n] for n in self.names]
        loss = self._world_mean(loss.detach())
        # The gradients carry no graph: no grad-mode block is needed (nor
        # may one be held across the yields below).
        if cfg.fsdp:
            group = self.mesh.group(DATA_AXIS)
            self.optimizer.apply([
                g if DATA_AXIS in self.param_specs[n]
                else C.reduce_scatter_sum(_shard_flat(g, self.data_size), group)
                for n, g in zip(self.names, grads)])
        elif cfg.zero1:
            self.optimizer.apply(grads)
        else:
            grads = yield from self._sync_grads(grads)
            if cfg.grad_clip_norm is not None:
                norm = yield from self._global_norm(grads)
                grads = clip_by_norm(grads, norm, cfg.grad_clip_norm)
            self.optimizer.tx.apply(self.optimizer.params, self.optimizer.momentum, grads)
        return {"loss": loss}

    def train_step(self, inputs: torch.Tensor, targets: torch.Tensor,
                   step: int | None = None) -> dict[str, torch.Tensor]:
        """One update over the process group (``drive_pipe``)."""
        self._driven()
        metrics = drive_pipe(self.train_steps(inputs, targets, step), self.mesh)
        self.step += 1
        return metrics

    def eval_steps(self, inputs: torch.Tensor, targets: torch.Tensor):
        """``yield from`` this: the plain mean CE of the pipelined forward
        (no dropout), averaged over the data and seq axes."""
        return (yield from _call(self._eval, inputs, targets, grad=False))

    def _eval(self, inputs, targets):
        params = self._materialize()
        _, out, _ = yield from self._forward(params, inputs)
        loss = yield from self._ce(self._tail(params, out), targets)
        return {"loss": self._world_mean(loss)}

    def eval_step(self, inputs: torch.Tensor, targets: torch.Tensor) -> dict[str, torch.Tensor]:
        self._driven()
        return drive_pipe(self.eval_steps(inputs, targets), self.mesh)

    def forward_steps(self, tokens: torch.Tensor):
        """``yield from`` this: the logits [B, T, V] (this rank's vocab slice
        under a tensor axis) of the pipelined forward."""
        return (yield from _call(self._logits, tokens, grad=False))

    def _logits(self, tokens):
        params = self._materialize()
        _, out, _ = yield from self._forward(params, tokens)
        return self._tail(params, out)

    def forward_fn(self, tokens: torch.Tensor) -> torch.Tensor:
        self._driven()
        return drive_pipe(self.forward_steps(tokens), self.mesh)

    def _driven(self) -> None:
        if self.simulated:
            raise ValueError("a simulated stage runs through simulate_pipe "
                             "(simulate_train_step), not over a process group")
        if self.optimizer is None:
            self.init()

    def split_batch(self, tokens) -> tuple[torch.Tensor, torch.Tensor]:
        """A global batch [B, seq_len + 1] -> (inputs, targets) of this
        rank's rows (its data index) and, on a seq axis, its columns; the
        targets shifted before the cut (the JAX ``shard_batch``)."""
        tokens = np.asarray(tokens)
        per = len(tokens) // self.data_size
        d = self.mesh.axis_index(DATA_AXIS)
        tokens = torch.as_tensor(tokens[d * per:(d + 1) * per], dtype=torch.int64)
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        cols = inputs.shape[1] // self.seq_size
        j = self.mesh.axis_index(SEQ_AXIS)
        return tuple(x[:, j * cols:(j + 1) * cols].contiguous().to(self.device)
                     for x in (inputs, targets))

    shard_batch = split_batch

    # --------------------------------------------------- the global tree
    @torch.no_grad()
    def host_params(self) -> dict[str, torch.Tensor]:
        """The global parameters on the host in STORAGE layer order
        (``blocks_to_logical`` undoes the interleaving): every split
        tensor gathered over its axes, fsdp's rows over the data axis (a
        collective every rank joins)."""
        self._driven()
        local = self._materialize() if self.cfg.fsdp else self.params
        out = {}
        for name in self.names:
            x = local[name].detach()
            for dim, axis in enumerate(self.param_specs[name]):
                if axis is not None and self.sizes[axis] > 1:
                    parts = C.all_gather_flat(x.contiguous(), self.mesh.group(axis))
                    x = torch.cat([p.view(x.shape) for p in parts.unbind(0)], dim=dim)
            out[name] = x.cpu()
        return out

    def reference_forward(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        """The unpipelined forward of the global ``params`` (logical layer
        order) on this rank's device: the parity oracle."""
        from torch.func import functional_call

        with torch.no_grad():
            p = {k: torch.as_tensor(v).to(self.device, torch.float32) for k, v in params.items()}
            t = tokens.shape[-1]
            x = F.embedding(tokens, p["embed"].to(self.dtype))
            if not self.cfg.use_rope:
                x = x + p["pos"].to(self.dtype)[:t]
            for i in range(self.cfg.num_layers):
                views = {n: p[f"blocks.{n}"][i] for n in self._block_names}
                x = functional_call(self._block_host, views, (x, self.dtype))
            z = _layer_norm(x, p["ln_f_scale"], p["ln_f_bias"]).to(self.dtype)
            return (z @ p["head"].to(self.dtype)).float()

    # ---------------------------------------------------------- run loop
    def _opt_state(self) -> dict:
        opt = self.optimizer
        if self.cfg.zero1 or self.cfg.fsdp:
            return {"moments": opt.moments, "count": opt.count}
        return {"moments": {"mu": opt.momentum, "nu": opt.tx.nu}, "count": opt.tx.count}

    @torch.no_grad()
    def capture_state(self, *, clone: bool = False) -> dict[str, Any]:
        """This rank's state for an exact resume (a checkpoint's file; the
        JAX ``PipelineLMState``): the step, the storage ``layout`` code (0
        logical, ``S * 100000 + V`` interleaved: every tensor shape is the
        same across layouts, so ``fit`` refuses a checkpoint of another),
        the mesh, the parameters (fsdp's rows), the optimizer's moments and
        update count."""
        take = (lambda t: t.detach().clone()) if clone else (lambda t: t.detach())
        opt = self._opt_state()
        params = self.optimizer.params
        return {
            "step": int(self.step), "layout": self._layout_code,
            "world_size": self.world_size,
            "mesh": [self.data_size, self.pipe_size, self.seq_size, self.tensor_size],
            "params": [take(p) for p in params],
            "moments": {k: [take(m) for m in v] for k, v in opt["moments"].items()},
            "opt_count": int(opt["count"]),
        }

    @torch.no_grad()
    def elastic_state(self, states: Sequence[dict]) -> dict:
        """This rank's state from every rank's saved one
        (``Checkpointer.restore_latest``'s ``adapt``): its own when the
        mesh is the same; saved at another ``data_parallel`` (every other
        axis pinned, as in JAX), the replicated tensors from the old rank
        at this rank's (pipe, seq, tensor) coordinates and the ZeRO rows
        (zero1's moments, fsdp's parameters too) re-chunked from the old
        data ranks' rows (``parallel/zero.py::rechunk_elastic``)."""
        from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.mesh import mesh_coords
        from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.zero import rechunk_elastic

        first = states[0]
        mesh_now = [self.data_size, self.pipe_size, self.seq_size, self.tensor_size]
        old = list(first.get("mesh", mesh_now))
        if old == mesh_now and len(states) == self.world_size:
            return states[self.rank]
        if old[1:] != mesh_now[1:]:
            raise ValueError(f"checkpoint mesh (data, pipe, seq, tensor) {old} cannot resume "
                             f"on {mesh_now}: only data_parallel may differ")
        sizes = dict(zip((DATA_AXIS, PIPE_AXIS, SEQ_AXIS, TENSOR_AXIS), old))
        me = self.coords
        line = [r for r in range(len(states))
                if all(mesh_coords(r, sizes)[a] == me[a] for a in (PIPE_AXIS, SEQ_AXIS,
                                                                    TENSOR_AXIS))]
        zero = self.cfg.zero1 or self.cfg.fsdp
        out = dict(states[line[0]], world_size=self.world_size, mesh=mesh_now)

        def rows(key, i, sub=None):
            saved = torch.stack([(states[r][key] if sub is None else states[r][key][sub])[i]
                                 for r in line])
            n = math.prod(self._local_shapes[i][0])
            like = torch.empty(self.data_size, -(-n // self.data_size))
            return rechunk_elastic(saved, like, n)[self.mesh.axis_index(DATA_AXIS)]

        if zero:
            out["moments"] = {k: [rows("moments", i, k) if DATA_AXIS not in
                                  self.param_specs[self.names[i]] else v[i]
                                  for i in range(len(v))]
                              for k, v in first["moments"].items()}
            if self.cfg.fsdp:
                out["params"] = [rows("params", i) if DATA_AXIS not in
                                 self.param_specs[self.names[i]] else first["params"][i]
                                 for i in range(len(first["params"]))]
        return out

    @torch.no_grad()
    def restore_state(self, state: dict) -> None:
        """Copy ``capture_state``'s dict into the live tensors."""
        opt = self._opt_state()
        for dst, src in zip(self.optimizer.params, state["params"], strict=True):
            dst.copy_(src)
        for k, live in opt["moments"].items():
            for dst, src in zip(live, state["moments"][k], strict=True):
                dst.copy_(src)
        if self.cfg.zero1 or self.cfg.fsdp:
            self.optimizer.count = int(state["opt_count"])
        else:
            self.optimizer.tx.count = int(state["opt_count"])
        self.step = int(state["step"])

    def evaluate(self, tokens) -> dict[str, float]:
        """Held-out mean next-token CE and perplexity over ``tokens`` [N,
        seq_len + 1] in batches of ``global_batch_size``, a ragged tail
        dropped (the JAX ``evaluate_heldout`` contract)."""
        b = self.cfg.global_batch_size
        n_batches = len(tokens) // b
        if n_batches == 0:
            raise ValueError(f"need at least global_batch_size={b} sequences, got {len(tokens)}")
        total = 0.0
        for i in range(n_batches):
            total += float(self.eval_step(*self.split_batch(tokens[i * b:(i + 1) * b]))["loss"])
        mean_loss = total / n_batches
        return {"loss": mean_loss, "perplexity": math.exp(mean_loss)}

    def fit(self, tokens, steps: int):
        """Cycle batches of ``tokens`` [N, seq_len + 1] (batch k starts at
        ``(k * B) % max(N - B + 1, 1)``) until ``steps`` steps have run,
        from a fresh ``init()`` or, with ``cfg.checkpoint_dir``, the newest
        checkpoint (another ``data_parallel`` re-cut by
        ``elastic_state``; another storage layout refused). Checkpoints
        every ``checkpoint_every`` steps and at the end; with
        ``halt_on_nonfinite`` a NaN/inf loss raises ``NonFiniteLossError``
        and a due checkpoint is written only once a later finite loss (the
        forward over its parameters) certifies it, the last one after an
        eval forward. Returns ``(params, optimizer, losses)``."""
        from cs744_pytorch_distributed_tutorial_tpu_torch.utils.checkpoint import Checkpointer
        from cs744_pytorch_distributed_tutorial_tpu_torch.utils.failure import (
            NonFiniteLossError,
        )

        cfg = self.cfg
        self.init()
        start_step = 0
        ckpt = Checkpointer(cfg.checkpoint_dir) if cfg.checkpoint_dir else None
        losses: list[float] = []
        pending = None
        x = y = None
        try:
            if ckpt is not None:
                restored = ckpt.restore_latest(adapt=self.elastic_state)
                if restored is not None:
                    saved_layout = int(restored.get("layout", 0))
                    if saved_layout != self._layout_code:
                        raise ValueError(
                            f"checkpoint {cfg.checkpoint_dir!r} stores blocks in layer-storage "
                            f"layout {saved_layout}, this trainer uses {self._layout_code} "
                            "(schedule/num_virtual_stages changed?) — every leaf shape matches, "
                            "so resuming would silently assign layers to the wrong virtual "
                            "stages")
                    self.restore_state(restored)
                    start_step = self.step
            n, b = len(tokens), cfg.global_batch_size
            for step in range(start_step, steps):
                lo = (step * b) % max(n - b + 1, 1)
                x, y = self.split_batch(tokens[lo:lo + b])
                loss = float(self.train_step(x, y, step)["loss"])
                if cfg.halt_on_nonfinite and not math.isfinite(loss):
                    raise NonFiniteLossError(step, loss)
                if pending is not None:
                    ckpt.save(pending)
                    pending = None
                losses.append(loss)
                if ckpt and cfg.checkpoint_every and (step + 1) % cfg.checkpoint_every == 0:
                    if cfg.halt_on_nonfinite:
                        pending = self.capture_state(clone=True)
                    else:
                        ckpt.save(self.capture_state())
            if ckpt is not None:
                if cfg.halt_on_nonfinite and steps > start_step:
                    f_loss = float(self.eval_step(x, y)["loss"])
                    if not math.isfinite(f_loss):
                        raise NonFiniteLossError(steps, f_loss)
                ckpt.save(self.capture_state(), force=True)
        finally:
            if ckpt is not None:
                ckpt.close()
        return self.params, self.optimizer, losses


# --------------------------------------------------- simulated pipelines
def simulate_train_step(trainers: Sequence[PipelineLMTrainer], inputs: torch.Tensor,
                        targets: torch.Tensor, step: int | None = None) -> dict:
    """One update of the S simulated stages (``PipelineLMTrainer(cfg,
    stage=i)``, i = 0..S-1) in lockstep in one process; returns stage 0's
    metrics (every stage's loss is the same)."""
    for tr in trainers:
        if tr.optimizer is None:
            tr.init()
    out = simulate_pipe([tr.train_steps(inputs, targets, step) for tr in trainers])
    for tr in trainers:
        tr.step += 1
    return out[0]


def simulate_forward(trainers: Sequence[PipelineLMTrainer], tokens: torch.Tensor) -> torch.Tensor:
    """The logits of the simulated stages' pipelined forward."""
    return simulate_pipe([tr.forward_steps(tokens) for tr in trainers])[0]


def simulated_host_params(trainers: Sequence[PipelineLMTrainer]) -> dict[str, torch.Tensor]:
    """The global parameters (storage order) of the simulated stages: the
    stacked blocks joined over the stages, the rest stage 0's."""
    out = {}
    for name in trainers[0].names:
        parts = [tr.params[name].detach().cpu() for tr in trainers]
        out[name] = torch.cat(parts) if name.startswith("blocks.") else parts[0]
    return out


def from_transformer_lm_params(lm_params: dict, num_layers: int) -> dict[str, torch.Tensor]:
    """A port ``TransformerLM`` ``state_dict`` (untied; unrolled or
    ``scan_layers``) -> the pipeline trainer's global tree in logical
    order: the blocks stacked (``blocks.<name>`` [L, ...]), ``embed``,
    ``pos`` (absolute positions only), ``ln_f_scale``, ``ln_f_bias`` and
    ``head`` ``[d, V]`` (the transposed ``lm_head.weight``)."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.transformer import (
        is_stacked,
        stack_block_params,
    )

    sd = dict(lm_params) if is_stacked(lm_params) else stack_block_params(lm_params, num_layers)
    out = {k: v for k, v in sd.items() if k.startswith("blocks.")}
    out["embed"] = sd["tok_embed.weight"]
    if "pos_embed.weight" in sd:
        out["pos"] = sd["pos_embed.weight"]
    out.update(ln_f_scale=sd["ln_f.weight"], ln_f_bias=sd["ln_f.bias"],
               head=sd["lm_head.weight"].transpose(0, 1).contiguous())
    return out
