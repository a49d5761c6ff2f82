"""Attention on [B, T, H, D]: the plain softmax reference, the GQA head
repeat, the decode steps against a KV cache (dense or paged), and the
sequence-parallel variants that move K/V between the ranks of a mesh
axis.

Ported from the JAX package's ``parallel/ring_attention.py``
(``dense_attention``, ``repeat_kv``, ``decode_attention``,
``decode_mask``, ``gather_pages``, ``paged_decode_attention``,
``ring_attention``, ``ring_flash_attention``, ``ulysses_attention``,
``grouped_kv_plan`` and ``ulysses_kv_exchange_width``). Each rank holds
its ``T / n`` positions of the sequence (``q`` [B, T/n, H, D], ``k``/``v``
at kv width [B, T/n, Hkv, D]) on a mesh axis of n ranks:

- ``ring_attention``: the K/V blocks go round the ring one hop a step
  (n - 1 hops, the last merge peeled) while each rank folds the block it
  holds into fp32 running (max, normaliser, output) accumulators
  (``ring_merge``), its global causal mask from the block's home index;
  autograd differentiates through the hops (``RingPermute``: the
  backward sends the cotangents the other way).
- ``ring_flash_attention``: the same ring with the flash kernels doing a
  hop's arithmetic (``ops/flash_attention.py``). A hop is one of three
  cases by the block's home index against the rank's: diagonal (the
  kernel's own causal mask), earlier (no mask) or later (masked: nothing
  launched, the accumulators unchanged, as JAX's merge of a masked hop
  leaves them). ``rfa_merge`` folds a hop's output, already rounded to
  ``v.dtype`` by the kernel and widened to fp32, into the accumulators by
  ``logaddexp`` from ``_MASK`` (finite: no ``-inf - -inf``). The backward
  is JAX's ring FA-2: per hop ``rfa_dq`` (accumulated here in fp32) and
  ``rfa_dkv`` (its fp32 dk/dv accumulators travel the ring with their
  block, n hops, and land home), both against the ring's final merged
  ``lse`` and ``delta = rowsum(g * out)``; under GQA the head groups'
  dk/dv sum back onto their kv head.
- ``ulysses_attention``: one tiled all-to-all turns the sequence split
  into a head split (each rank the whole sequence for H/n heads), local
  attention (``dense`` or the ``flash`` kernels), and one back; K/V at kv
  width where the kv heads divide over the axis, else routed by
  ``grouped_kv_plan`` or widened first, as JAX chooses.

The ring and Ulysses variants are written once, as generators of
collective steps (a ``Permute`` of blocks to the next rank, or an
``Exchange``: an all-to-all) that resume with a transfer to ``wait()``
on. ``drive`` runs one on a process group (each rank its position);
``simulate`` runs n of them in lockstep in one process, every position's
blocks handed on in the order a ring delivers them, so the hop
functions and the accumulation order are the same with or without a
group. ``C.hops`` counts the ring's hops.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import collectives as C

# Additive mask value: large-negative instead of -inf so exp() underflows
# to exactly 0.0 without NaNs in fully-masked rows.
_MASK = -1e30


def dense_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
) -> torch.Tensor:
    """Plain softmax attention on [B, T, H, D]: fp32 scores (the products
    of the inputs, summed in fp32) times ``D**-0.5``, masked with
    ``_MASK``, an fp32 softmax, and the probabilities cast to ``v.dtype``
    before the product with ``v``. Returns ``v.dtype``."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        keep = torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, _MASK)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(v.dtype)


def repeat_kv(x: torch.Tensor, rep: int) -> torch.Tensor:
    """Widen [B, T, Hkv, D] KV heads to the query head count (the GQA
    repeat; identity when rep == 1)."""
    return x.repeat_interleave(rep, dim=2) if rep > 1 else x


def decode_mask(cache_len: int, t: int, pos, device=None) -> torch.Tensor:
    """Key visibility for decode steps, broadcastable against [B, Hkv,
    group, t, L] scores: key ``k`` is visible to query row ``i`` iff
    ``k <= pos + i``. A scalar ``pos`` gives a [1, 1, 1, t, L] mask, a
    [B] tensor a per-slot [B, 1, 1, t, L] one."""
    k_pos = torch.arange(cache_len, device=device)
    rows = torch.arange(t, device=device)
    if not torch.is_tensor(pos) or pos.dim() == 0:
        return (k_pos[None, :] <= (rows + pos)[:, None])[None, None, None]
    if pos.dim() != 1:
        raise ValueError(f"pos must be a scalar or [B] vector, got shape {tuple(pos.shape)}")
    q_pos = pos[:, None] + rows  # [B, t]
    return (k_pos[None, None, :] <= q_pos[:, :, None])[:, None, None]


def decode_attention(q: torch.Tensor, cached_k: torch.Tensor, cached_v: torch.Tensor,
                     pos) -> torch.Tensor:
    """Decode step(s) of ``q`` [B, t, Hq, D] (row i at position pos + i)
    against a [B, L, Hkv, D] cache; ``pos`` a scalar or a [B] tensor.
    Query head h reads KV head h // (Hq / Hkv): the cache is never widened.
    fp32 scores times ``D**-0.5``, ``_MASK`` past each row's position, an
    fp32 softmax, the probabilities cast to the cache dtype before the
    product with V. Returns the cache dtype."""
    b, t, hq, d = q.shape
    hkv = cached_k.shape[2]
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    qg = q.reshape(b, t, hkv, hq // hkv, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), cached_k.float()) * d**-0.5
    scores = scores.masked_fill(~decode_mask(cached_k.shape[1], t, pos, q.device), _MASK)
    probs = torch.softmax(scores, dim=-1).to(cached_v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.float(), cached_v.float())
    return out.reshape(b, t, hq, d).to(cached_v.dtype)


def gather_pages(pages: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """Each slot's contiguous view of a [num_pages, page_size, ...] pool
    through its ``page_table`` [B, P] row: [B, P*page_size, ...], token
    position i of slot b at row i (the dense cache's layout)."""
    b, p = page_table.shape
    g = pages[page_table.long()]  # [B, P, page_size, ...]
    return g.reshape(b, p * pages.shape[1], *pages.shape[2:])


def paged_decode_attention(q: torch.Tensor, key_pages: torch.Tensor, value_pages: torch.Tensor,
                           page_table: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``decode_attention`` against paged [num_pages, page_size, Hkv, D]
    pools: gather each slot's pages, then the dense decode step. The
    plain version of ``ops/paged_attention.py::paged_attention``; its
    reads scale with page capacity, not with the live tokens."""
    return decode_attention(q, gather_pages(key_pages, page_table),
                            gather_pages(value_pages, page_table), pos)


# ------------------------------------------------------- sequence parallelism
def _kv_group(q: torch.Tensor, k: torch.Tensor) -> int:
    """GQA head grouping for the ring variants: query heads must be a
    multiple of KV heads; returns the repeat factor."""
    hq, hkv = q.shape[2], k.shape[2]
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    return hq // hkv


def narrow_grad(gx: torch.Tensor, rep: int) -> torch.Tensor:
    """The transpose of ``repeat_kv``: each query-head group's gradient
    summed back onto its shared KV head."""
    if rep == 1:
        return gx
    b, t, hq, d = gx.shape
    return gx.reshape(b, t, hq // rep, rep, d).sum(dim=3)


class Permute:
    """A collective step: ``tensors`` one hop up the ring."""

    def __init__(self, tensors: Sequence[torch.Tensor]):
        self.tensors = list(tensors)


class Exchange:
    """A collective step: the tiled all-to-all of ``tensor``."""

    def __init__(self, tensor: torch.Tensor, split_axis: int, concat_axis: int):
        self.tensor, self.split_axis, self.concat_axis = tensor, split_axis, concat_axis


class _Ready:
    def __init__(self, tensors):
        self.tensors = list(tensors)

    def wait(self) -> list[torch.Tensor]:
        return self.tensors


def _exchange(x: torch.Tensor, split_axis: int, concat_axis: int):
    """``yield from`` this in a step generator: the all-to-all's result."""
    return (yield Exchange(x, split_axis, concat_axis)).wait()[0]


def drive(steps, mesh, axis: str, differentiable: bool = False):
    """Run a step generator as this rank's position on ``axis``: a
    ``Permute`` starts the hop at once (``differentiable``: through
    ``RingPermute``, finished before the generator resumes) and an
    ``Exchange`` runs the autograd ``AllToAll``. Returns the generator's
    result."""
    try:
        req = next(steps)
        while True:
            if isinstance(req, Permute):
                if differentiable:
                    handle = _Ready(C.RingPermute.apply(mesh, axis, *req.tensors))
                else:
                    handle = C.start_permute(req.tensors, mesh, axis)
            else:
                handle = _Ready([C.AllToAll.apply(req.tensor, mesh, axis, req.split_axis,
                                                  req.concat_axis)])
            req = steps.send(handle)
    except StopIteration as stop:
        return stop.value


def simulate(gens: Sequence, axis: str = "seq") -> list:
    """Run n step generators (position i of a ring of n) in lockstep in
    one process: at each step every position's blocks go to the next
    position, or the all-to-all's chunks to their positions. Returns the
    results by position."""
    n = len(gens)
    reqs = [next(g) for g in gens]
    while True:
        if isinstance(reqs[0], Permute):
            C.hops[axis] += 1
            handles = [_Ready(reqs[(i - 1) % n].tensors) for i in range(n)]
        else:
            handles = [_Ready([torch.cat([r.tensor.chunk(n, dim=r.split_axis)[i] for r in reqs],
                                         dim=reqs[0].concat_axis)]) for i in range(n)]
        results, nxt = [], []
        for g, h in zip(gens, handles):
            try:
                nxt.append(g.send(h))
            except StopIteration as stop:
                results.append(stop.value)
        if results:
            if len(results) != n:
                raise RuntimeError("ring positions ended at different steps")
            return results
        reqs = nxt


def _blocks(x: torch.Tensor, n: int) -> list[torch.Tensor]:
    """Position i's [B, T/n, ...] block of a whole sequence."""
    return list(x.chunk(n, dim=1))


def ring_merge(q, kb, vb, m, l, o, q_blk: int, k_blk: int, causal: bool, rep: int):
    """One ring hop of ``ring_attention`` (JAX's ``merge``): the scores of
    ``q`` (home block ``q_blk``) against the visiting block (home
    ``k_blk``) in fp32, masked by global positions when causal, folded
    into the running max ``m`` and normaliser ``l`` ([B, H, t]) and the
    unnormalised output ``o`` ([B, t, H, D]), all fp32; the probabilities
    are rounded to ``v.dtype`` before their product with V."""
    kb, vb = repeat_kv(kb, rep), repeat_kv(vb, rep)
    t = q.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kb.float()) * q.shape[-1] ** -0.5
    if causal:
        pos = torch.arange(t, device=q.device)
        keep = (q_blk * t + pos)[:, None] >= (k_blk * t + pos)[None, :]
        scores = scores.masked_fill(~keep, _MASK)
    m_new = torch.maximum(m, scores.amax(dim=-1))
    correction = torch.exp(m - m_new)
    p = torch.exp(scores - m_new[..., None])
    l_new = correction * l + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(vb.dtype).float(), vb.float())
    return m_new, l_new, o * correction.transpose(1, 2)[..., None] + pv


def _ring_steps(q, k, v, q_blk: int, n: int, causal: bool):
    rep = _kv_group(q, k)
    b, t, h, d = q.shape
    m = torch.full((b, h, t), _MASK, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, t), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, t, h, d), dtype=torch.float32, device=q.device)
    kb, vb = k, v
    for s in range(n):
        # The hop is asked for before this block merges, but the
        # differentiable drive (``RingPermute``) finishes it first: the
        # transfer and the merge run one after the other. The last hop
        # is peeled.
        handle = (yield Permute([kb, vb])) if s < n - 1 else None
        m, l, o = ring_merge(q, kb, vb, m, l, o, q_blk, (q_blk - s) % n, causal, rep)
        if handle is not None:
            kb, vb = handle.wait()
    return (o / l.transpose(1, 2)[..., None]).to(v.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, axis: str, *,
                   causal: bool = False) -> torch.Tensor:
    """Blockwise ring attention over the sequence-sharded ``axis`` of
    ``mesh`` (JAX ``ring_attention``): n - 1 hops of kv-width blocks, each
    widened per hop for the arithmetic; differentiable."""
    n = mesh.size(axis)
    if n == 1:
        rep = _kv_group(q, k)
        return dense_attention(q, repeat_kv(k, rep), repeat_kv(v, rep), causal=causal)
    return drive(_ring_steps(q, k, v, mesh.axis_index(axis), n, causal), mesh, axis,
                 differentiable=True)


def simulate_ring_attention(q, k, v, n: int, causal: bool = False) -> torch.Tensor:
    """``ring_attention`` over whole-sequence tensors in one process, the
    sequence cut into n positions run in lockstep; differentiable."""
    outs = simulate([_ring_steps(qb, kb, vb, i, n, causal) for i, (qb, kb, vb) in
                     enumerate(zip(_blocks(q, n), _blocks(k, n), _blocks(v, n)))])
    return torch.cat(outs, dim=1)


# ring_flash: a hop's arithmetic on the flash kernels.
def _rows(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    """A [B*H, t, 1] row statistic as [B, t, H, 1]."""
    return x.reshape(b, h, -1, 1).transpose(1, 2)


def _hop(causal: bool, q_blk: int, k_blk: int):
    """The hop's case: None when masked (a later block under the causal
    mask), else whether the kernel applies its own causal mask (the
    diagonal block)."""
    if causal and k_blk > q_blk:
        return None
    return causal and k_blk == q_blk


def rfa_merge(q, kb, vb, o, lse, q_blk: int, k_blk: int, causal: bool, rep: int):
    """One hop of ``ring_flash_attention``'s forward: the flash forward of
    ``q`` over the visiting block (widened to the query heads), its output
    widened from ``v.dtype`` to fp32, folded into the fp32 accumulators
    ``o`` [B, t, H, D] and ``lse`` [B*H, t, 1] by logaddexp. A masked hop
    launches nothing and returns them as they are."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import flash_attention as A

    hop = _hop(causal, q_blk, k_blk)
    if hop is None:
        return o, lse
    b, _, h, _ = q.shape
    out_h, lse_h = A.flash_forward_lse(q, repeat_kv(kb, rep), repeat_kv(vb, rep), hop)
    new_lse = torch.logaddexp(lse, lse_h)
    o = o * torch.exp(_rows(lse - new_lse, b, h)) + out_h.float() * torch.exp(
        _rows(lse_h - new_lse, b, h))
    return o, new_lse


def rfa_dq(q, kb, vb, g, lse, delta, q_blk: int, k_blk: int, causal: bool, rep: int):
    """One hop of the backward's dq, fp32, against the ring's final
    ``lse`` and ``delta``; None for a masked hop (nothing launched)."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import flash_attention as A

    hop = _hop(causal, q_blk, k_blk)
    if hop is None:
        return None
    return A.flash_dq(q, repeat_kv(kb, rep), repeat_kv(vb, rep), g, lse, delta, hop).float()


def rfa_dkv(q, kb, vb, g, lse, delta, q_blk: int, k_blk: int, causal: bool, rep: int):
    """One hop of the backward's dk and dv for the visiting block, fp32 at
    kv width; (None, None) for a masked hop."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import flash_attention as A

    hop = _hop(causal, q_blk, k_blk)
    if hop is None:
        return None, None
    dk, dv = A.flash_dkv(q, repeat_kv(kb, rep), repeat_kv(vb, rep), g, lse, delta, hop)
    return narrow_grad(dk.float(), rep), narrow_grad(dv.float(), rep)


def _rfa_forward_steps(q, k, v, q_blk: int, n: int, causal: bool):
    rep = _kv_group(q, k)
    b, t, h, d = q.shape
    o = torch.zeros((b, t, h, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b * h, t, 1), _MASK, dtype=torch.float32, device=q.device)
    kb, vb = k, v
    for s in range(n):
        # Started before the merge (``start_permute``), waited for after
        # it: the hop's transfer runs under its kernel.
        handle = (yield Permute([kb, vb])) if s < n - 1 else None
        o, lse = rfa_merge(q, kb, vb, o, lse, q_blk, (q_blk - s) % n, causal, rep)
        if handle is not None:
            kb, vb = handle.wait()
    return o.to(v.dtype), lse


def _rfa_backward_steps(q, k, v, out, lse, g, q_blk: int, n: int, causal: bool):
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import flash_attention as A

    rep = _kv_group(q, k)
    delta = A.flash_delta(out, g)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    kb, vb = k, v
    for s in range(n):
        k_blk = (q_blk - s) % n
        dq_h = rfa_dq(q, kb, vb, g, lse, delta, q_blk, k_blk, causal, rep)
        dk_h, dv_h = rfa_dkv(q, kb, vb, g, lse, delta, q_blk, k_blk, causal, rep)
        if dq_h is not None:
            dq = dq + dq_h
        if dk_h is not None:
            dk, dv = dk + dk_h, dv + dv_h
        # The accumulators ride with their block; after the n-th hop each
        # block's dk/dv is home. They are this hop's kernels' outputs, so
        # the transfer starts after them and is waited for at once: it
        # does not overlap the kernels.
        kb, vb, dk, dv = (yield Permute([kb, vb, dk, dv])).wait()
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mesh, axis: str, causal: bool):
        idx, n = mesh.axis_index(axis), mesh.size(axis)
        out, lse = drive(_rfa_forward_steps(q, k, v, idx, n, causal), mesh, axis)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (mesh, axis, causal)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        mesh, axis, causal = ctx.args
        idx, n = mesh.axis_index(axis), mesh.size(axis)
        dq, dk, dv = drive(_rfa_backward_steps(q, k, v, out, lse, g.contiguous(), idx, n, causal),
                           mesh, axis)
        return dq, dk, dv, None, None, None


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, axis: str,
                         causal: bool = False) -> torch.Tensor:
    """Ring attention with the flash kernels doing each hop's arithmetic
    (JAX ``ring_flash_attention``), its backward the ring FA-2."""
    return _RingFlash.apply(q, k, v, mesh, axis, causal)


def simulate_ring_flash(q, k, v, n: int, causal: bool = False, g: torch.Tensor | None = None):
    """``ring_flash_attention`` over whole-sequence tensors in one process:
    the n positions' forwards in lockstep, then, given the output's
    cotangent ``g``, their backwards. Returns ``(out, lse)`` with the
    positions' [B*H, T/n, 1] lse concatenated along T, plus ``(dq, dk,
    dv)`` when ``g`` is given."""
    qs, ks, vs = _blocks(q, n), _blocks(k, n), _blocks(v, n)
    fwd = simulate([_rfa_forward_steps(qs[i], ks[i], vs[i], i, n, causal) for i in range(n)])
    out = torch.cat([o for o, _ in fwd], dim=1)
    lse = torch.cat([l for _, l in fwd], dim=1)
    if g is None:
        return out, lse
    gs = _blocks(g.contiguous(), n)
    bwd = simulate([_rfa_backward_steps(qs[i], ks[i], vs[i], fwd[i][0], fwd[i][1],
                                        gs[i].contiguous(), i, n, causal) for i in range(n)])
    return out, lse, tuple(torch.cat(x, dim=1) for x in zip(*bwd))


# Ulysses: sequence -> heads, local attention, heads -> sequence.
def grouped_kv_plan(h: int, hkv: int, n: int):
    """Per-device kv routing for ragged GQA (``hkv % n != 0``), host-side
    numpy: ``(idx, local_map, per_dev)``. ``idx`` ([n * per_dev]) lists the
    kv head for each pre-exchange slot (device i's slots
    ``idx[i*per_dev:(i+1)*per_dev]``: the distinct kv heads its query
    group needs, right-padded by repetition); ``local_map`` ([n, h/n])
    maps each device's local query head to its received slot."""
    rep = h // hkv
    groups = []
    for i in range(n):
        lo, hi = i * h // n, (i + 1) * h // n
        groups.append(sorted({qh // rep for qh in range(lo, hi)}))
    per_dev = max(len(g) for g in groups)
    idx, local = [], []
    for i, g in enumerate(groups):
        g_pad = g + [g[-1]] * (per_dev - len(g))
        idx.extend(g_pad)
        lo = i * h // n
        local.append([g_pad.index((lo + ql) // rep) for ql in range(h // n)])
    return np.asarray(idx, np.int32), np.asarray(local, np.int32), per_dev


def ulysses_kv_exchange_width(h: int, hkv: int, n: int) -> int:
    """Heads a device the K/V all-to-all moves under the grouped plan
    (widen-first moves ``h // n``; divisible kv width ``hkv // n``)."""
    if hkv % n == 0:
        return hkv // n
    return grouped_kv_plan(h, hkv, n)[2]


def _local_attention(q, k, v, causal: bool, inner: str) -> torch.Tensor:
    """Ulysses's attention over the whole sequence of a head group."""
    if inner == "flash":
        from cs744_pytorch_distributed_tutorial_tpu_torch.ops.flash_attention import (
            flash_attention,
        )

        return flash_attention(q, k, v, causal)
    return dense_attention(q, k, v, causal=causal)


def _ulysses_steps(q, k, v, idx: int, n: int, causal: bool, inner: str):
    rep = _kv_group(q, k)
    h, hkv = q.shape[2], k.shape[2]
    if rep > 1 and hkv % n == 0:
        # kv-width exchanges, widened after.
        kg = repeat_kv((yield from _exchange(k, 2, 1)), rep)
        vg = repeat_kv((yield from _exchange(v, 2, 1)), rep)
    elif rep > 1 and ulysses_kv_exchange_width(h, hkv, n) < h // n:
        # Ragged kv heads: each device's slots hold the kv heads its query
        # group reads; each local query head then picks its slot.
        sel, local_map, _ = grouped_kv_plan(h, hkv, n)
        sel = torch.as_tensor(sel, dtype=torch.long, device=k.device)
        lmap = torch.as_tensor(local_map[idx], dtype=torch.long, device=k.device)
        kg = (yield from _exchange(k.index_select(2, sel), 2, 1)).index_select(2, lmap)
        vg = (yield from _exchange(v.index_select(2, sel), 2, 1)).index_select(2, lmap)
    else:
        kg = yield from _exchange(repeat_kv(k, rep), 2, 1)
        vg = yield from _exchange(repeat_kv(v, rep), 2, 1)
    qg = yield from _exchange(q, 2, 1)
    out = _local_attention(qg, kg.contiguous(), vg.contiguous(), causal, inner)
    return (yield from _exchange(out, 1, 2))


def _check_ulysses(q, k, n: int, inner: str) -> None:
    if inner not in ("dense", "flash"):
        raise ValueError(f"unknown inner attention {inner!r}")
    _kv_group(q, k)
    if q.shape[2] % n:
        raise ValueError(f"ulysses needs num_heads ({q.shape[2]}) divisible by axis size ({n})")


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, axis: str, *,
                      causal: bool = False, inner: str = "dense") -> torch.Tensor:
    """All-to-all sequence parallelism (JAX ``ulysses_attention``): two
    tiled all-to-alls per tensor around the whole-sequence attention of
    H/n heads, ``inner`` ``dense`` or ``flash``; differentiable."""
    n = mesh.size(axis)
    _check_ulysses(q, k, n, inner)
    if n == 1:
        rep = _kv_group(q, k)
        return _local_attention(q, repeat_kv(k, rep), repeat_kv(v, rep), causal, inner)
    return drive(_ulysses_steps(q, k, v, mesh.axis_index(axis), n, causal, inner), mesh, axis)


def simulate_ulysses(q, k, v, n: int, causal: bool = False, inner: str = "dense"):
    """``ulysses_attention`` over whole-sequence tensors in one process, its
    n positions in lockstep; differentiable."""
    _check_ulysses(q, k, n, inner)
    outs = simulate([_ulysses_steps(qb, kb, vb, i, n, causal, inner) for i, (qb, kb, vb) in
                     enumerate(zip(_blocks(q, n), _blocks(k, n), _blocks(v, n)))])
    return torch.cat(outs, dim=1)
