"""ZeRO-1 and FSDP: optimizer state (and, under FSDP, the parameters)
sharded over the data-parallel ranks.

Port of the JAX package's ``parallel/zero.py``: the CIFAR Trainer's
``Zero1SGD`` and ``FsdpSGD``, and the LM trainer's rules ``Zero1Adam``,
``Zero1Lion``, ``Zero1SgdLM``, ``FsdpAdam``, ``FsdpLion`` and
``FsdpSgdLM`` (``LM_RULES``), with their helpers. The reference keeps a full optimizer
replica on every rank (plain SGD over a full model copy,
``master/part2a/part2a.py:127-128``); these remove that redundancy.

The layout, the JAX package's: a tensor of ``size`` elements is
flattened, zero-padded to ``n * chunk`` (``chunk = ceil(size / n)``) and
viewed ``[n, chunk]``; rank ``r`` owns row ``r``. Each rank keeps one
``[chunk]`` momentum tensor a parameter (its row), and under FSDP one
``[chunk]`` parameter shard too, so ``models/convert.py`` carries state
across frameworks leaf by leaf.

- ZeRO-1 (``Zero1SGD``): the local gradients are reduce-scattered (each
  rank receives its row of the sum and divides it into the mean), each
  rank applies torch-SGD to its rows, and one all-gather of the
  parameter *deltas* restores the replicated parameters. One pair of
  collectives a tensor, or with ``bucket_bytes`` one a bucket of the
  row-chunked layout (``buckets.bucket_layout(rows=n)``: each tensor's
  ``[n, chunk]`` block a block of columns, so every element keeps its
  row). The int8 wire replaces a bucket's reduce-scatter with the
  quantized all-reduce of ``sync._int8_allreduce_flat``.
- FSDP (``FsdpSGD``): each rank persists only its rows. A step gathers
  the full parameters (one all-gather a tensor or a bucket,
  ``collectives.GatherRows``), runs forward and backward on them, and
  the gather's backward reduce-scatters the gradients' sum into each
  shard's ``grad``; ``apply`` divides by ``n`` and updates the rows.

At a world of one the collectives run all the same (copies); the JAX
schedule counts them as none.

The elastic re-chunk (``rechunk_elastic``, ``local_chunk_shapes``,
``chunk_local_sizes``, ``make_elastic_adapt``; the JAX package's, keyed by
``state_dict`` names) carries the LM's rows across data sizes: the old
rows concatenated, the padding dropped, re-padded into the new world's
chunks (``LMTrainer.elastic_state``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from cs744_pytorch_distributed_tutorial_tpu_torch.ops.quant import true_div
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import buckets as B
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import collectives as C
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SEQ_AXIS,
    TENSOR_AXIS,
    Mesh,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.sync import _int8_allreduce_flat


def chunk_size(size: int, world_size: int) -> int:
    return -(-size // world_size)


def _shard_flat(x: torch.Tensor, world_size: int) -> torch.Tensor:
    """A tensor -> its zero-padded ``[n, chunk]`` flat layout."""
    chunk = chunk_size(x.numel(), world_size)
    return F.pad(x.reshape(-1), (0, world_size * chunk - x.numel())).view(world_size, chunk)


def _unshard(rows: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``[n, chunk]`` rows (gathered) -> the tensor of ``shape``."""
    return rows.reshape(-1)[: math.prod(shape)].view(tuple(shape))


def _gather_flat(shards: Sequence[torch.Tensor], shapes: Sequence,
                 group=None) -> list[torch.Tensor]:
    """Each rank's (of ``group``, None the world) ``[chunk]`` shards -> the
    full tensors, one all-gather a tensor (differentiable: the backward
    reduce-scatters)."""
    return [_unshard(C.GatherRows.apply(sh, group), shape)
            for sh, (shape, _) in zip(shards, shapes)]


def _gather_bucketed_flat(shards: Sequence[torch.Tensor], shapes: Sequence, world_size: int,
                          bucket_bytes: int, *, reverse: bool = False) -> list[torch.Tensor]:
    """Bucketed unshard: a bucket's shards concatenate in slot-offset
    order into one flat buffer, one all-gather gives ``[n, cols]``, and
    the tensors slice out of it. Its backward is one reduce-scatter a
    bucket. ``reverse`` is the overlapped schedule's layout: the
    reduce-scatters then run bucket by bucket in backward order."""
    layout = B.bucket_layout(shapes, bucket_bytes, rows=world_size, reverse=reverse)
    out: list[torch.Tensor | None] = [None] * len(shapes)
    for members in B.bucket_members(layout):
        full = C.GatherRows.apply(torch.cat([shards[i] for i in members]), None)
        for i in members:
            out[i] = B.leaf_view(full, layout, layout.slots[i])
    return out


def _scatter_rows(gbuf: torch.Tensor, ebuf: torch.Tensor | None, world_size: int,
                  rank: int) -> tuple[torch.Tensor, torch.Tensor | None]:
    """This rank's row of the world's mean of an ``[n, cols]`` bucket, and,
    on the int8 wire (``ebuf``, the bucket's residuals), the new ``[n,
    cols]`` residuals: the quantized all-reduce of ``g + ef``, whose row
    this rank keeps."""
    if ebuf is None:
        return true_div(C.reduce_scatter_sum(gbuf), world_size), None
    mean, resid = _int8_allreduce_flat(gbuf.reshape(-1).float() + ebuf.reshape(-1).float(),
                                       world_size)
    return mean.view(gbuf.shape)[rank].to(gbuf.dtype), resid.view(gbuf.shape)


# ------------------------------------------------------- the elastic re-chunk
def _spec_dim(spec, axis: str | None) -> int | None:
    """The dimension ``spec`` (an axis name or None a dimension) splits
    over ``axis``; None when it does not (replicated over that axis)."""
    if spec is None or axis is None:
        return None
    for i, entry in enumerate(spec):
        if entry == axis or (isinstance(entry, (tuple, list)) and axis in entry):
            return i
    return None


def rechunk_elastic(saved, like, local_size: int):
    """The JAX package's mesh-elastic re-chunk of flat ZeRO state:
    ``[dp_old, *mid, chunk_old]`` -> ``[dp_new, *mid, chunk_new]`` (the
    shape of ``like``). For each middle (model-shard) coordinate the
    dp_old rows are concatenated, the zero padding is dropped at
    ``local_size`` (that coordinate's true flat length) and the result is
    re-padded into dp_new rows. The middle dims are layout-pinned (the
    model-parallel axes must match the save), and the saved chunking must
    be ``ceil(local_size / dp_old)``: anything else means the model
    changed since the save. ``saved`` is a tensor or a numpy array; the
    result is of its kind, its values copied bit for bit."""
    import numpy as np

    as_numpy = isinstance(saved, np.ndarray)
    src = torch.from_numpy(np.ascontiguousarray(saved)) if as_numpy else saved
    like_shape = tuple(like.shape)
    if tuple(src.shape[1:-1]) != like_shape[1:-1]:
        raise ValueError(
            "ZeRO resume cannot re-chunk across model-shard axes "
            f"(saved middle dims {tuple(src.shape[1:-1])}, now {like_shape[1:-1]})"
        )
    if src.shape[-1] != -(-local_size // src.shape[0]):
        raise ValueError(
            f"saved chunking [dp={src.shape[0]}, chunk={src.shape[-1]}] "
            f"is inconsistent with the current leaf's local size "
            f"{local_size} (expected chunk "
            f"{-(-local_size // src.shape[0])}) — the model shape "
            "changed since the save; only data_parallel may differ"
        )
    mid = math.prod(src.shape[1:-1])
    s3 = src.reshape(src.shape[0], mid, src.shape[-1])
    dp_new, c_new = like_shape[0], like_shape[-1]
    out = src.new_zeros((dp_new, mid, c_new))
    for t in range(mid):
        flat = s3[:, t, :].reshape(-1)[:local_size]
        out[:, t, :] = F.pad(flat, (0, dp_new * c_new - local_size)).view(dp_new, c_new)
    out = out.reshape(like_shape)
    return out.numpy() if as_numpy else out


def local_chunk_shapes(param_shapes: dict, specs: dict, shard_axes: dict) -> dict:
    """Each parameter's LOCAL shape by name: its global shape with every
    dimension that a present ``shard_axes`` axis splits divided by that
    axis's size (the JAX ``local_chunk_shapes``, keyed by ``state_dict``
    names)."""
    out = {}
    for name, shape in param_shapes.items():
        dims = list(shape)
        for axis, size in shard_axes.items():
            k = _spec_dim(specs.get(name), axis)
            if k is not None:
                dims[k] //= size
        out[name] = tuple(dims)
    return out


def chunk_local_sizes(param_shapes: dict, specs: dict, shard_axes: dict,
                      exclude_axis: str | None = None) -> dict:
    """The unpadded local flat size of each parameter by name, the length
    its ``[n, chunk]`` rows were cut from: its element count divided by
    the sizes of the ``shard_axes`` its spec names. A parameter whose spec
    names ``exclude_axis`` (an expert-parallel one, split over the data
    axis itself) is left out: its state is natural-shaped, not rows, and
    restores across data sizes by plain re-sharding (the JAX
    ``chunk_local_sizes``)."""
    return {
        name: math.prod(shape) // math.prod(
            n for a, n in shard_axes.items() if _spec_dim(specs.get(name), a) is not None)
        for name, shape in param_shapes.items()
        if _spec_dim(specs.get(name), exclude_axis) is None
    }


def make_elastic_adapt(local_sizes: dict, prefixes: tuple = ("momentum/", "opt_nu/")):
    """The per-leaf ``adapt(path_key, saved, like)`` of the elastic restore
    (``utils/checkpoint.py::adapt_host_leaf``): a leaf under one of
    ``prefixes`` (the row-chunked collections: the moments, and fsdp's
    ``params/``) whose parameter has a local size re-chunks across data
    sizes through ``rechunk_elastic``; every other leaf gets None and
    falls through to the default slice/tile (the JAX
    ``make_elastic_adapt``, its keys the port's ``<collection>/<name>``)."""

    def adapt(path_key: str, saved, like):
        for prefix in prefixes:
            if path_key.startswith(prefix):
                suffix = path_key[len(prefix):]
                break
        else:
            return None
        local_size = local_sizes.get(suffix)
        if local_size is None or saved.ndim != len(like.shape):
            return None
        return rechunk_elastic(saved, like, local_size)

    return adapt


def zero1_collective_schedule(units: int, axis_size: int) -> dict[str, int]:
    """One ZeRO-1 step's collectives: a reduce-scatter and an all-gather
    a sync unit (bucket, or tensor); none on a world of one."""
    if axis_size <= 1:
        return {}
    return {"reduce_scatter": units, "all_gather": units}


def fsdp_collective_schedule(units: int, axis_size: int) -> dict[str, int]:
    """FSDP's: the parameter all-gather a unit and its transpose, one
    reduce-scatter; ZeRO-1's pair count on the other side of the model."""
    return zero1_collective_schedule(units, axis_size)


def zero1_int8_collective_schedule(units: int, axis_size: int) -> dict[str, int]:
    """ZeRO-1 on the int8 wire: a unit's quantized all-reduce (2
    all-to-alls, 2 all-gathers: codes and scales apart) and the float
    delta all-gather; no reduce-scatter."""
    if axis_size <= 1:
        return {}
    return {"all_to_all": 2 * units, "all_gather": 3 * units}


class Zero1SGD:
    """SGD(momentum, weight decay) with rank-sharded momentum.

    ``init`` gives this rank's ``[chunk]`` momentum rows; ``apply``
    takes the LOCAL gradients (before any sync) and updates the
    replicated parameters and this rank's rows in place. Per tensor when
    ``bucket_bytes`` is 0 or the world is one, bucketed otherwise;
    ``overlap`` selects the reverse-order layout of the overlapped
    schedule (``OverlappedZero1`` drives it from gradient hooks)."""

    def __init__(self, learning_rate: float, momentum: float, weight_decay: float,
                 world_size: int, bucket_bytes: int | None = None, overlap: bool = False):
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.world_size = world_size
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.bucket_bytes = B.DEFAULT_BUCKET_BYTES if bucket_bytes is None else int(bucket_bytes)
        self.overlap = bool(overlap)

    def init(self, params: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """This rank's momentum rows: ``[chunk]`` zeros a parameter."""
        return [p.new_zeros(chunk_size(p.numel(), self.world_size), dtype=torch.float32)
                for p in params]

    def layout(self, params: Sequence) -> B.BucketLayout:
        return B.bucket_layout(params, self.bucket_bytes, rows=self.world_size,
                               reverse=self.overlap)

    def _sgd_chunk_update(self, p_mine: torch.Tensor, m_mine: torch.Tensor,
                          g_mine: torch.Tensor) -> torch.Tensor:
        """The torch-SGD rule on this rank's rows (``g + wd p``, then ``mu
        m + g``, then ``-lr m``): updates ``m_mine`` in place, returns
        the parameter delta."""
        g_eff = g_mine + p_mine * self.weight_decay
        m_mine.mul_(self.momentum).add_(g_eff)
        return m_mine * -self.learning_rate

    @torch.no_grad()
    def apply(self, params: Sequence[torch.Tensor], momenta: Sequence[torch.Tensor],
              grads: Sequence[torch.Tensor], ef: Sequence[torch.Tensor] | None = None) -> None:
        """One ZeRO-1 step; ``ef`` (per-parameter fp32 residuals) sends
        each bucket over the int8 wire and keeps its residual."""
        s = self.world_size
        if self.bucket_bytes and s > 1:
            layout = self.layout(grads)
            for b, members in enumerate(B.bucket_members(layout)):
                gbuf = B.flatten_bucket(grads, layout, b, members)
                ebuf = None if ef is None else B.flatten_bucket(ef, layout, b, members)
                g_mine, resid = self.scatter_bucket(gbuf, ebuf)
                self.update_bucket(params, momenta, layout, members, g_mine)
                if resid is not None:
                    for i in members:
                        ef[i].copy_(B.leaf_view(resid, layout, layout.slots[i]))
            return
        if ef is not None:
            raise ValueError(
                "the int8 wire for zero1 requires the bucketed path (bucket_bytes > 0 "
                "and world size > 1): quantization chunks are defined on bucket boundaries"
            )
        for p, m, g in zip(params, momenta, grads, strict=True):
            g_mine = true_div(C.reduce_scatter_sum(_shard_flat(g, s)), s)
            delta = self._sgd_chunk_update(_shard_flat(p, s)[self.rank], m, g_mine)
            p.add_(_unshard(C.all_gather_flat(delta), p.shape))

    def scatter_bucket(self, gbuf: torch.Tensor, ebuf: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor | None]:
        return _scatter_rows(gbuf, ebuf, self.world_size, self.rank)

    def update_bucket(self, params: Sequence[torch.Tensor], momenta: Sequence[torch.Tensor],
                      layout: B.BucketLayout, members: Sequence[int], g_mine: torch.Tensor) -> None:
        """A bucket's chunk updates in slot-offset order, then one
        all-gather of their deltas, added to the parameters."""
        deltas = []
        for i in members:
            slot = layout.slots[i]
            p_mine = _shard_flat(params[i], self.world_size)[self.rank]
            deltas.append(self._sgd_chunk_update(
                p_mine, momenta[i], g_mine[slot.offset : slot.offset + slot.size]))
        delta_buf = C.all_gather_flat(torch.cat(deltas))
        for i in members:
            params[i].add_(B.leaf_view(delta_buf, layout, layout.slots[i]))


class FsdpSGD(Zero1SGD):
    """ZeRO-3/FSDP: parameters and momentum sharded alike.

    ``shard_params`` keeps this rank's ``[chunk]`` rows of each
    parameter; ``gather_params`` rebuilds the full tensors before each
    forward (per tensor, or a bucket at a time as ``Zero1SGD`` chooses);
    differentiating through it leaves each shard's ``grad`` the world's
    SUM of its rows, which ``apply`` divides into the mean before the
    torch-SGD rule. Persistent memory for parameters and momentum:
    ``2 * params / n`` a rank."""

    def shard_params(self, params: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """This rank's rows of each parameter, as new leaf tensors."""
        return [_shard_flat(p.detach(), self.world_size)[self.rank].clone().requires_grad_()
                for p in params]

    def gather_params(self, shards: Sequence[torch.Tensor], shapes: Sequence) -> list[torch.Tensor]:
        """``shapes``: each parameter's ``(shape, dtype)``."""
        if not (self.bucket_bytes and self.world_size > 1):
            return _gather_flat(shards, shapes)
        return _gather_bucketed_flat(shards, shapes, self.world_size, self.bucket_bytes,
                                     reverse=self.overlap)

    @torch.no_grad()
    def apply(self, shards: Sequence[torch.Tensor], momenta: Sequence[torch.Tensor],
              grad_chunks: Sequence[torch.Tensor]) -> None:
        """One step from the shards' gradient sums (``[chunk]`` each)."""
        for sh, m, g in zip(shards, momenta, grad_chunks, strict=True):
            sh.add_(self._sgd_chunk_update(sh, m, true_div(g, self.world_size)))


# ------------------------------------------------------------- the LM's rules
def _rules():
    """``train/state.py``, whose multi-tensor rule arithmetic the LM's
    sharded rules run on rows (imported on use: ``train`` imports this
    module)."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.train import state

    return state


class Zero1Adam:
    """ZeRO-1 AdamW for the LM trainer (the JAX package's ``Zero1Adam``):
    both moments live only as this rank's ``[chunk]`` rows of each
    parameter's ``[n, chunk]`` layout, so optimizer memory drops from 2x
    the parameters to 2x / n a rank (GPT-2-medium's fp32 moments are about
    2.8 GB replicated).

    Bound to its parameters at construction (``params``: the replicated
    parameters, or fsdp's rows), it keeps ``moments`` (``MOMENTS`` order,
    one ``[chunk]`` row a parameter each) and ``count``. ``apply`` takes
    the LOCAL gradients: one reduce-scatter of each tensor's (or each
    bucket's) ``[n, chunk]`` rows gives this rank's rows of the world's
    sum, divided into the mean; the chunk rule updates them and one
    all-gather of the parameter deltas restores the replicated
    parameters. Per tensor when ``bucket_bytes`` is 0 or the world is one,
    else a bucket at a time on ``buckets.bucket_layout(rows=n)`` (reversed
    under ``overlap``, which ``overlap.OverlappedZero1LM`` drives from
    gradient hooks). The JAX package runs the fused path per leaf and
    buckets only its overlapped one; the rule is elementwise, so the
    buckets change which collective carries an element, not its value.

    The step scalars are hoisted once a step (``step_scalars``: the
    schedule's lr at the count before this update, the bias corrections
    at the count after, as optax). ``clip_norm`` is optax's
    ``clip_by_global_norm`` on the mean's rows with the exact global norm:
    each row's sum of squares, summed over the ranks.

    The chunk rules are ``train/state.py``'s multi-tensor arithmetic run
    on rows (``adamw_updates``, ``lion_updates``, ``sgd_deltas``,
    ``decayed_deltas``), so at a world of one, where a row is the whole
    flat tensor, an update is the replicated ``Optimizer``'s bit for bit.
    Two things differ from it at a world above one: the mean is the
    reduce-scatter's sum in the backend's order divided by n (the
    replicated path divides first, then all-reduces), and the clip's norm
    sums rows over ranks (another order than the tensors' sums).
    Against JAX the ``nu`` update rounds ``(1 - b2) * (g * g)`` as optax
    does where JAX's ``Zero1Adam`` rounds ``((1 - b2) * g) * g``.

    On its ``mesh`` (``parallel/mesh.py::Mesh``, by default the process
    group's world as one data axis; ``world_size`` is the data axis's size
    and the rows are cut along that axis) with the
    parameters' ``specs`` (``models/transformer.py::lm_param_specs``), the
    JAX rule's model-shard branches: a tensor-split parameter's rows are
    its local slice's, cut per (data, tensor) coordinate; after the
    data-axis reduce-scatter every row is averaged over the sequence axis
    and, unless the tensor axis splits it, over the tensor axis (one
    all-reduce for each such set of axes); an expert-split parameter (its
    spec names the data axis, JAX's ``_data_sharded``) keeps its local
    tensor whole, its moments whole, no collective of the data axis: its
    gradient is already the sum over its data row, divided here by n and
    averaged over the other axes (``_expert_mean``); the clip sums each
    row's squares over the tensor axis for the parameters it splits, and
    over the data axis. Such layouts go a tensor at a
    time, as JAX's fused path; ``overlap`` refuses them, as JAX does."""

    MOMENTS: tuple[str, ...] = ("mu", "nu")
    #: ``params`` are this rank's rows already (fsdp), not whole tensors.
    ROWS = False

    def __init__(self, params: Sequence[torch.Tensor], schedule, b1: float, weight_decay: float,
                 world_size: int, *, clip_norm: float | None = None,
                 bucket_bytes: int | None = None, overlap: bool = False, mesh=None,
                 specs: Sequence[tuple] | None = None):
        self.params = list(params)
        self.mesh = mesh = mesh if mesh is not None else Mesh.get(world_size)
        self.specs = [tuple(sp) for sp in specs] if specs is not None else [()] * len(self.params)
        self.expert = [DATA_AXIS in sp for sp in self.specs]
        self.model_sharded = mesh.size(SEQ_AXIS, TENSOR_AXIS) > 1 or any(self.expert)
        if clip_norm is not None and clip_norm <= 0:
            raise ValueError(f"clip_norm must be > 0, got {clip_norm}")
        if overlap and (clip_norm is not None or self.model_sharded):
            raise ValueError(
                "sync_overlap with a sharded optimizer admits pure data parallelism only: "
                "seq/tensor/expert sharding and grad_clip_norm need cross-chunk joins that "
                "defeat the per-bucket schedule"
            )
        self.schedule, self.b1, self.weight_decay = schedule, b1, weight_decay
        self.world_size = world_size
        self.rank, self.group = mesh.axis_index(DATA_AXIS), mesh.group(DATA_AXIS)
        self.clip_norm = clip_norm
        self.bucket_bytes = B.DEFAULT_BUCKET_BYTES if bucket_bytes is None else int(bucket_bytes)
        self.overlap = bool(overlap)
        self.count = 0

        def size(i, p):
            whole = self.ROWS or self.expert[i]
            return p.numel() if whole else chunk_size(p.numel(), world_size)

        self.moments = {name: [p.new_zeros(size(i, p), dtype=torch.float32)
                               for i, p in enumerate(self.params)] for name in self.MOMENTS}

    @property
    def momentum(self) -> list[torch.Tensor]:
        """The first moment's rows (the trainers' ``momentum``)."""
        return self.moments["mu"]

    @property
    def bucketed(self) -> bool:
        return bool(self.bucket_bytes) and self.world_size > 1 and not self.model_sharded

    def layout(self, params: Sequence) -> B.BucketLayout:
        return B.bucket_layout(params, self.bucket_bytes, rows=self.world_size,
                               reverse=self.overlap)

    def step_scalars(self) -> tuple[float, int]:
        """(lr, incremented count) of the coming update."""
        return float(self.schedule(self.count)), self.count + 1

    def _deltas(self, p_rows: list, idx: Sequence[int], g_rows: list,
                scalars: tuple[float, int]) -> list[torch.Tensor]:
        """The rule on rows: ``p_rows``/``g_rows`` are the parameters'
        and the mean's rows of parameters ``idx``; their moments move in
        place; returns the parameter deltas."""
        lr, count = scalars
        mu = [self.moments["mu"][i] for i in idx]
        updates = _rules().adamw_updates(mu, [self.moments["nu"][i] for i in idx], g_rows, count,
                                         self.b1)
        return _rules().decayed_deltas(p_rows, updates, lr, self.weight_decay)

    def _axis_means(self, rows: list[torch.Tensor]) -> list[torch.Tensor]:
        """Each parameter's rows of the data axis's mean averaged over the
        sequence axis and, unless the tensor axis splits the parameter,
        over the tensor axis (JAX's pmeans on the chunk: the seq replicas'
        gradients differ, the tensor replicas' agree)."""
        return C.reduce_by_axes(rows, [tuple(a for a in (SEQ_AXIS, TENSOR_AXIS) if a not in spec)
                                       for spec in self.specs], self.mesh)

    def _clip(self, g_rows: list[torch.Tensor]) -> list[torch.Tensor]:
        """``clip_by_global_norm`` on every parameter's rows of the mean
        (in parameter order) with the global norm: each row's squares,
        summed over the tensor axis where it splits the parameter (a row
        it does not split is the same on each of its ranks and counts
        once), then over the data axis in one all-reduce, issued at a
        world of one too, as the rows' reduce-scatters are."""
        if self.clip_norm is None:
            return g_rows
        from cs744_pytorch_distributed_tutorial_tpu_torch.obs.metrics import tree_sq_norm

        local = tree_sq_norm(g_rows, [(TENSOR_AXIS,) if TENSOR_AXIS in spec else ()
                                      for spec in self.specs], self.mesh)
        norm = C.all_reduce_sum(local, self.group).sqrt()
        return _rules().clip_by_norm(g_rows, norm, self.clip_norm)

    def scatter_bucket(self, gbuf: torch.Tensor, ebuf: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor | None]:
        return _scatter_rows(gbuf, ebuf, self.world_size, self.rank)

    def update_bucket(self, params: Sequence[torch.Tensor], layout: B.BucketLayout,
                      members: Sequence[int], g_rows: Sequence[torch.Tensor],
                      scalars: tuple[float, int]) -> None:
        """A bucket's rule on the rows of ``members`` (``g_rows``, theirs
        of the mean), then one all-gather of their deltas, added to the
        replicated parameters."""
        p_rows = [_shard_flat(params[i].detach(), self.world_size)[self.rank] for i in members]
        deltas = self._deltas(p_rows, members, list(g_rows), scalars)
        delta_buf = C.all_gather_flat(torch.cat(deltas))
        for i in members:
            params[i].add_(B.leaf_view(delta_buf, layout, layout.slots[i]))

    def _mean_row(self, i: int, g: torch.Tensor) -> torch.Tensor:
        """Parameter ``i``'s rows of the data axis's mean gradient: the
        reduce-scatter of its ``[n, chunk]`` rows divided by n, or for an
        expert-split parameter its local gradient divided by n."""
        s = self.world_size
        if self.expert[i]:
            return true_div(g.float().reshape(-1), s)
        return true_div(C.reduce_scatter_sum(_shard_flat(g, s), self.group), s)

    @torch.no_grad()
    def apply(self, grads: Sequence[torch.Tensor]) -> None:
        """One ZeRO-1 step from this rank's LOCAL gradients of ``params``."""
        s, params = self.world_size, self.params
        scalars = self.step_scalars()
        if self.bucketed:
            layout = self.layout(grads)
            members = B.bucket_members(layout)
            g_rows: list = [None] * len(params)
            for b, m in enumerate(members):
                g_mine, _ = self.scatter_bucket(B.flatten_bucket(grads, layout, b, m))
                for i in m:
                    slot = layout.slots[i]
                    g_rows[i] = g_mine[slot.offset : slot.offset + slot.size]
            g_rows = self._clip(g_rows)
            for m in members:
                self.update_bucket(params, layout, m, [g_rows[i] for i in m], scalars)
        else:
            g_rows = self._clip(self._axis_means(
                [self._mean_row(i, g) for i, g in enumerate(grads)]))
            p_rows = [p.detach().reshape(-1) if self.expert[i]
                      else _shard_flat(p.detach(), s)[self.rank] for i, p in enumerate(params)]
            deltas = self._deltas(p_rows, range(len(params)), g_rows, scalars)
            for i, (p, d) in enumerate(zip(params, deltas, strict=True)):
                if self.expert[i]:
                    p.add_(d.view(p.shape))
                else:
                    p.add_(_unshard(C.all_gather_flat(d, self.group), p.shape))
        self.count += 1


class Zero1Lion(Zero1Adam):
    """ZeRO-1 Lion (the JAX ``Zero1Lion``): one sharded moment, optax.lion's
    rule on the rows (``train/state.py::lion_updates``)."""

    MOMENTS = ("mu",)

    def _deltas(self, p_rows, idx, g_rows, scalars):
        lr, _ = scalars
        updates = _rules().lion_updates([self.moments["mu"][i] for i in idx], g_rows, self.b1)
        return _rules().decayed_deltas(p_rows, updates, lr, self.weight_decay)


class Zero1SgdLM(Zero1Adam):
    """ZeRO-1 SGD(momentum, weight decay) for the LM (the JAX
    ``Zero1SgdLM``): the decay folds into the gradient before the trace
    (``train/state.py::sgd_deltas``)."""

    MOMENTS = ("mu",)

    def _deltas(self, p_rows, idx, g_rows, scalars):
        lr, _ = scalars
        return _rules().sgd_deltas(p_rows, [self.moments["mu"][i] for i in idx], g_rows, lr,
                                   self.b1, self.weight_decay)


class FsdpAdam(Zero1Adam):
    """ZeRO-3/FSDP AdamW for the LM (the JAX ``FsdpAdam``): the parameters
    persist only as this rank's rows too (3x the parameters / n a rank
    with both moments). ``params`` are the rows (``shard_params``); a
    step gathers the full tensors before the forward (``gather_params``:
    one all-gather a tensor, or a bucket with ``bucket_bytes`` at a world
    above one, reversed under ``overlap``) and differentiating through the
    gather leaves each row's ``grad`` the world's sum of its rows (the
    gather's backward is a reduce-scatter). ``apply`` divides into the
    mean and runs the rule on the rows in place; nothing is gathered
    after the update. The gathered tensors live until the backward is
    done with them, as in JAX, whose residuals keep them.

    On a mesh the rows are of this rank's tensor slice and the gather
    runs on the data axis; an expert-split parameter stays whole (its
    ``grad`` is its local gradient, ``_expert_mean``)."""

    ROWS = True

    def gather_params(self, shapes: Sequence) -> list[torch.Tensor]:
        """This rank's parameters from ``params`` (differentiable):
        the whole tensors, or on a mesh its tensor slices, an expert-split
        one as it is; ``shapes`` holds each one's ``(shape, dtype)``."""
        if self.bucketed:
            return _gather_bucketed_flat(self.params, shapes, self.world_size,
                                         self.bucket_bytes, reverse=self.overlap)
        return [p if self.expert[i] else _gather_flat([p], [shapes[i]], self.group)[0]
                for i, p in enumerate(self.params)]

    @staticmethod
    def shard_params(params: Sequence[torch.Tensor], world_size: int, mesh=None,
                     specs: Sequence[tuple] | None = None) -> list[torch.Tensor]:
        """This rank's rows of each parameter, as new leaf tensors (an
        expert-split one whole); the rows cut along the data axis of
        ``mesh`` (by default the process group's world)."""
        rank = (mesh if mesh is not None else Mesh.get(world_size)).axis_index(DATA_AXIS)
        specs = specs if specs is not None else [()] * len(params)
        return [(p.detach() if DATA_AXIS in spec else _shard_flat(p.detach(), world_size)[rank])
                .clone().requires_grad_() for p, spec in zip(params, specs, strict=True)]

    @torch.no_grad()
    def apply(self, grad_sums: Sequence[torch.Tensor]) -> None:
        """One step from the rows' gradient sums (``[chunk]`` each; an
        expert-split parameter's local gradient)."""
        scalars = self.step_scalars()
        g_rows = self._clip(self._axis_means(
            [true_div(g.float().reshape(-1) if self.expert[i] else g, self.world_size)
             for i, g in enumerate(grad_sums)]))
        rows = [p.reshape(-1) for p in self.params]
        deltas = self._deltas(rows, range(len(self.params)), g_rows, scalars)
        torch._foreach_add_(rows, deltas)
        self.count += 1


class FsdpLion(FsdpAdam, Zero1Lion):
    """FSDP with Lion's rule (the JAX ``FsdpLion``)."""


class FsdpSgdLM(FsdpAdam, Zero1SgdLM):
    """FSDP with torch-SGD's rule (the JAX ``FsdpSgdLM``)."""


#: optimizer name -> (ZeRO-1 class, FSDP class), as the JAX LM picks them.
LM_RULES = {"adamw": (Zero1Adam, FsdpAdam), "lion": (Zero1Lion, FsdpLion),
            "sgd": (Zero1SgdLM, FsdpSgdLM)}

