"""LM training engine, ported from the JAX package's ``train/lm.py``:
one process a rank of a (data, seq, tensor) mesh.

A step: the model's forward on [B, T] token ids (``models/
transformer.py``; bf16 compute when ``compute_dtype="bfloat16"``, by
explicit casts inside each module, fp32 parameters, fp32 logits), the
mean cross-entropy (the JAX ``_smoothed_xent``, label smoothing
included; with ``fused_xent`` the CUDA kernels of ``ops/fused_xent.py``,
which compute plain CE, so label smoothing then raises), ``backward()``,
and the optimizer update (``adamw``, ``sgd`` or ``lion`` at a constant,
warmup or cosine lr, behind an optional global-norm clip, with optax's
semantics; ``train/state.py::make_lm_optimizer``). The
step returns ``{loss, grad_norm, param_norm}`` as 0-d tensors on the
device: the global L2 norms of the gradient and of the updated
parameters.

``remat`` (with ``remat_policy`` ``none`` or ``dots``), ``scan_layers``
and ``dropout_rate`` are the model's options (``models/transformer.py``).
Dropout is keyed by (seed, step, microbatch): ``train_step`` takes the
step index (default ``self.step``, which ``fit`` keeps), as the JAX
trainer folds it into its dropout key, so a resumed run draws the masks
the uninterrupted one drew. ``accum_steps`` splits the batch into that
many contiguous microbatches, each with its own forward and backward
(and its own dropout key), then divides the gradient sum, the loss sum
and the MoE statistics' sums by ``accum_steps`` (JAX
``train/lm.py:1044-1077``).

With ``moe_experts > 0`` each block's FFN is a routed ``MoEFFN``
(``models/moe.py``; dispatch ``scatter``, the JAX default, ``einsum`` or
``dropless``, the grouped-matmul kernels), the objective is ``ce +
moe_aux_coef * sum of the layers' Switch aux losses`` (JAX
``train/lm.py:1009-1021``; ``loss`` is that total) and the step also
returns ``moe_aux`` (the sum over layers), ``moe_drop`` and
``moe_load_entropy`` (each the mean over layers).

``fit`` is the JAX ``LMTrainer.fit`` run loop: the JAX batch plan (batch
k starts at sequence ``(k * B) % max(N - B + 1, 1)``, a pure function of
k, so a restored run replays the same remaining plan), every step metric
in ``history``, and the two recovery tiers (disk checkpoints,
``utils/checkpoint.py``, every ``checkpoint_every`` steps; host-RAM
snapshots, ``utils/memstore.py``, every ``snapshot_every``), the newer
restored at entry (memory on a tie) behind the divergence-safe
pending/certify gate; the metric stream and run manifest
(``obs/metrics.py``, every ``metrics_every`` steps), the flight recorder
(``obs/flight.py``), the step watchdog (``step_timeout_s``, the first
step exempt), a profiler window (``profile_dir``, steps
``[profile_start_step, + profile_num_steps)``) and the non-finite halt.
``capture_state``/``restore_state`` carry the parameters, the
optimizer's moments and count, the int8 wire's residuals and the step
(a rank's rows of them under zero1 and fsdp; the checkpoint keeps a file
a rank), copied into the live tensors; ``elastic_state`` re-cuts every
rank's saved state for another ``data_parallel`` or ``seq_parallel``
(the JAX package's elastic restore; ``tensor_parallel`` is pinned).

For generation and serving, ``decode_model`` and
``quantized_decode_model`` build a decode copy of the model (dense
attention for the prompt pass, the float weights already in the compute
dtype, int8 projections and/or an int8 KV cache on request, no remat,
the unrolled layout) from the trainer's weights or from a
``state_dict``; ``quantize_for_decode`` makes the int8 ``state_dict``
and ``gather_for_decode`` gives the unrolled weights (under fsdp
all-gathered from the ranks' rows, a collective every rank joins).
``tp_decode_model`` keeps the tensor axis instead: its decode copy holds
this rank's slices, with no gather, for the mesh path of
``infer/generate.py``, ``infer/beam.py`` and ``serve/engine.py``
(``mesh=trainer.mesh, param_specs=trainer.param_specs``).

Across ranks (``data_parallel``: the process group's world, one rank a
card, NCCL between cards and Gloo on the CPU, ``parallel/mesh.py::
initialize``; without a process group the world is one), as the JAX
trainer on its data axis:

- rank r trains on rows ``[r B/n, (r+1) B/n)`` of each global batch
  (``split_batch``), ``accum_steps`` splitting its own rows; ``loss``
  and the MoE statistics are the world's means; dropout keys carry the
  rank (rank 0's key is the one-device key, so a world of one draws the
  masks it always drew);
- the plain path all-reduces the mean gradient (a bucket at a time,
  ``sync_bucket_mb``) before the replicated optimizer;
  ``grad_compress="int8"`` sends it over the int8 wire with a residual a
  rank (``sync_grads_compressed``); ``sync_overlap="bucket"`` (sgd at a
  constant lr) or ``"bucket+int8"`` fires each reverse-order bucket from
  gradient hooks and applies the fused SGD a bucket (``OverlappedSGD``);
- ``zero1`` hands the local gradients to ``parallel/zero.py``'s sharded
  rule of the optimizer (``Zero1Adam``/``Zero1Lion``/``Zero1SgdLM``:
  reduce-scatter, the rule on this rank's rows, an all-gather of the
  deltas; overlapped through ``OverlappedZero1LM``); ``fsdp`` keeps only
  this rank's rows of the parameters (``FsdpAdam`` & co.), gathers them
  for each forward (``functional_call``; the module's own parameters are
  empty) and its gather's backward reduce-scatters the gradients.
  ``grad_norm``/``param_norm`` are left out under both, as in JAX.

The sequence and tensor axes and expert parallelism (the JAX
trainer's ``seq_parallel``, ``tensor_parallel``, ``moe_expert_parallel``)
lay the world out as ``data x seq x tensor`` ranks, data outermost
(``parallel/mesh.py::Mesh``: rank r at the JAX mesh's coordinates of
device r, a process group a line of each set of axes):

- the model is this rank's slice of the global one (``models/
  transformer.py``): its T / seq positions of each row through ring,
  ring-flash or Ulysses attention, its heads and ``d_ff`` slice of the
  tensor axis (Megatron), its ``E / data`` experts (the capacity slots'
  all-to-all over the data axis); ``split_batch`` takes the rank's rows
  by its data index and its columns by its seq index, the targets
  shifted before the cut;
- ``loss`` and the MoE statistics are the means over the ranks;
  dropout keys carry the data and seq indices, never the tensor index
  (the MLP's dropout applies to the row-parallel partial sums, so the
  tensor ranks must draw the same masks);
- without zero1/fsdp the gradients sync by spec (JAX's ``sync_grad``):
  an expert-split one is summed over seq and divided by data x seq, then
  averaged over tensor; any other is averaged over data and seq, and
  over tensor unless the tensor axis splits it; one all-reduce for each
  set of axes. With a tensor axis or experts the clip is the sharded one
  (``train/state.py::clip_by_global_norm_sharded``) and ``grad_norm``/
  ``param_norm`` sum each split tensor's squares over its axes;
- zero1/fsdp take the sharded rules' model-shard branches
  (``parallel/zero.py``, on the data axis's group);
- ``state_dict()`` gathers the global tensors (a collective every rank
  joins); ``capture_state`` records the layout and a restore into
  another ``tensor_parallel`` raises (layout-pinned, as JAX).

Every JAX rejection of these options is raised, with its exception type,
before a process group is needed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call

from cs744_pytorch_distributed_tutorial_tpu_torch.config import resolve_device, resolve_dtype
from cs744_pytorch_distributed_tutorial_tpu_torch.models.transformer import (
    ATTENTION_IMPLS,
    TransformerLM,
    is_stacked,
    resolve_remat_policy,
    shard_tensor,
    unstack_block_params,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.obs.metrics import tree_l2_norm
from cs744_pytorch_distributed_tutorial_tpu_torch.ops.fused_xent import fused_cross_entropy
from cs744_pytorch_distributed_tutorial_tpu_torch.ops.quant import (
    quantize_lm_params,
    resolve_quant_modules,
    true_div,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import collectives as C
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SEQ_AXIS,
    TENSOR_AXIS,
    Mesh,
    rank_device,
    spec_axes,
    world,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.overlap import (
    OVERLAP_MODES,
    OverlappedSGD,
    OverlappedZero1LM,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.sync import (
    sync_grads,
    sync_grads_compressed,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.zero import (
    LM_RULES,
    _unshard,
    chunk_local_sizes,
    make_elastic_adapt,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.train.engine import _smoothed_xent
from cs744_pytorch_distributed_tutorial_tpu_torch.train.state import (
    check_recipe,
    clip_by_global_norm_sharded,
    make_lm_optimizer,
    make_schedule,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.utils.checkpoint import adapt_host_leaf, agreed
from cs744_pytorch_distributed_tutorial_tpu_torch.utils.failure import NonFiniteLossError
from cs744_pytorch_distributed_tutorial_tpu_torch.utils.memstore import ReplicatedSnapshot

__all__ = ["LMConfig", "LMTrainer", "NonFiniteLossError"]


@dataclasses.dataclass
class LMConfig:
    """Model dims and training recipe, with the JAX package's names and
    defaults, plus ``device``."""

    vocab_size: int = 1024
    num_layers: int = 2
    num_heads: int = 8
    d_model: int = 128
    d_ff: int = 512
    max_seq_len: int = 2048
    attention_impl: str = "ring"  # ring | ring_flash | ulysses | ulysses_flash | dense | flash
    compute_dtype: str = "float32"
    tie_embeddings: bool = False
    norm: str = "layernorm"
    mlp: str = "gelu"
    use_rope: bool = False
    num_kv_heads: int | None = None
    # Rematerialization of each block in the backward: remat_policy "none"
    # recomputes everything, "dots" keeps the matrix products' outputs.
    remat: bool = False
    remat_policy: str = "none"
    # The layer-stacked parameter layout (one ``blocks`` with a leading
    # [num_layers] axis; models/transformer.py::stack_block_params).
    scan_layers: bool = False
    # Residual dropout on each block's attention and MLP outputs, keyed by
    # (seed, step, microbatch); 0.0 is the dropout-free path exactly.
    dropout_rate: float = 0.0
    # Gradient accumulation: this many microbatches a step (must divide
    # global_batch_size); the gradient is the mean of theirs.
    accum_steps: int = 1

    # MoE (models/moe.py): moe_experts > 0 swaps each block's dense FFN
    # for a routed expert mixture; moe_aux_coef weighs its aux loss.
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_groups: int = 1
    moe_dispatch: str = "scatter"  # einsum | scatter | dropless
    moe_gmm_impl: str = "auto"  # auto | ragged | pallas
    moe_aux_coef: float = 0.01
    # The CUDA fused softmax-CE (ops/fused_xent.py): one pass over the
    # logits, no [N, V] log-softmax. Incompatible with label smoothing.
    fused_xent: bool = False

    global_batch_size: int = 8
    seq_len: int = 256
    learning_rate: float = 1e-3
    seed: int = 0
    optimizer: str = "adamw"  # "adamw" | "sgd" | "lion"
    lr_schedule: str = "constant"  # | "cosine" | "warmup_cosine"
    warmup_steps: int = 0
    # cosine schedules need total_steps, warmup ramps linearly from 0 first.
    total_steps: int | None = None
    grad_clip_norm: float | None = None
    momentum: float = 0.9  # adamw b1; sgd momentum
    weight_decay: float = 1e-4
    label_smoothing: float = 0.0
    # The run loop (fit), with the JAX LMConfig's names and defaults:
    # checkpoints every checkpoint_every steps (0: only at the end) when
    # checkpoint_dir is set; host-RAM snapshots every snapshot_every
    # steps (0: off), snapshot_keep kept; NaN/inf losses raise
    # NonFiniteLossError; step_timeout_s arms the hang watchdog around
    # each step after the first; metrics_dir writes manifest.json and
    # metrics.jsonl every metrics_every steps; profile_dir traces steps
    # [profile_start_step, + profile_num_steps).
    halt_on_nonfinite: bool = True
    checkpoint_dir: str | None = None
    checkpoint_every: int = 0
    snapshot_every: int = 0
    snapshot_keep: int = 2
    step_timeout_s: float | None = None
    metrics_dir: str | None = None
    metrics_every: int = 1
    profile_dir: str | None = None
    profile_start_step: int = 2
    profile_num_steps: int = 3

    # Data parallelism: the process group's world size (1 without one).
    data_parallel: int = 1
    # The gradient wire: "int8" quantizes the data-parallel sync with
    # error feedback; sync_bucket_mb sizes its buckets (0: one collective
    # a tensor where the path allows); sync_overlap "bucket"/"bucket+int8"
    # fires each reverse-order bucket from the backward.
    grad_compress: str = "none"
    sync_bucket_mb: float = 4.0
    sync_overlap: str = "off"
    # ZeRO-1 (moments as this rank's rows) and FSDP (parameters too).
    zero1: bool = False
    fsdp: bool = False

    # The sequence and tensor axes (the world is data x seq x tensor
    # ranks), and the MoE experts split over the data axis.
    seq_parallel: int = 1
    tensor_parallel: int = 1
    moe_expert_parallel: bool = False

    # "cuda" (default) or "cpu".
    device: str = "cuda"

    def replace(self, **kw: Any) -> "LMConfig":
        return dataclasses.replace(self, **kw)


def expert_parallel(cfg: LMConfig) -> bool:
    """Whether the experts split over the data axis (JAX: asked for, with
    experts, on a data axis above one)."""
    return bool(cfg.moe_expert_parallel and cfg.moe_experts > 0 and cfg.data_parallel > 1)


def model_sharded(cfg: LMConfig) -> bool:
    """Whether the layout is more than pure data parallelism."""
    return cfg.seq_parallel > 1 or cfg.tensor_parallel > 1 or expert_parallel(cfg)


def check_config(cfg: LMConfig) -> None:
    """Every check that needs no process group: the JAX ``LMTrainer``'s
    (its ``train/lm.py:352-480,567-571``), in its order."""
    for name in ("data_parallel", "seq_parallel", "tensor_parallel"):
        if getattr(cfg, name) < 1:
            raise ValueError(f"{name} must be >= 1, got {getattr(cfg, name)}")
    seq, tensor = cfg.seq_parallel, cfg.tensor_parallel
    if cfg.global_batch_size % cfg.data_parallel:
        raise ValueError(f"global batch {cfg.global_batch_size} not divisible by data axis "
                         f"{cfg.data_parallel}")
    if cfg.seq_len % seq:
        raise ValueError(f"seq_len {cfg.seq_len} not divisible by seq axis {seq}")
    if cfg.attention_impl not in ATTENTION_IMPLS:
        raise ValueError(
            f"unknown attention_impl {cfg.attention_impl!r}; choose from {ATTENTION_IMPLS}"
        )
    if cfg.seq_len > cfg.max_seq_len:
        raise ValueError(f"seq_len {cfg.seq_len} exceeds max_seq_len {cfg.max_seq_len}")
    if cfg.attention_impl in ("dense", "flash") and seq > 1:
        raise ValueError(
            f"attention_impl={cfg.attention_impl!r} is incompatible with seq_parallel > 1 (a "
            "sequence-sharded block cannot attend to the full sequence without "
            "communication); use 'ring', 'ulysses', or 'ulysses_flash'")
    if cfg.num_heads % tensor:
        raise ValueError(f"num_heads {cfg.num_heads} not divisible by tensor axis {tensor}")
    if cfg.d_ff % tensor:
        raise ValueError(f"d_ff {cfg.d_ff} not divisible by tensor axis {tensor}")
    heads_local = cfg.num_heads // tensor
    if cfg.attention_impl in ("ulysses", "ulysses_flash") and heads_local % seq:
        raise ValueError(f"ulysses needs per-tensor-shard heads ({heads_local}) divisible by "
                         f"the seq axis ({seq})")
    local_batch = cfg.global_batch_size // cfg.data_parallel
    if cfg.accum_steps < 1 or local_batch % cfg.accum_steps:
        raise ValueError(f"accum_steps {cfg.accum_steps} must divide the per-device batch shard "
                         f"({local_batch} sequences)")
    if expert_parallel(cfg) and cfg.moe_experts % cfg.data_parallel:
        raise ValueError(f"moe_experts {cfg.moe_experts} not divisible by the data axis "
                         f"({cfg.data_parallel}) for expert parallelism")
    if expert_parallel(cfg) and cfg.moe_dispatch == "dropless":
        raise ValueError(
            "moe_dispatch='dropless' does not compose with moe_expert_parallel: EP's "
            "all_to_all needs static per-destination counts (capacity slots); use "
            "moe_dispatch='scatter' for expert-parallel layouts")
    _check_wire(cfg)
    if not 0.0 <= cfg.label_smoothing < 1.0:
        raise ValueError(f"label_smoothing must be in [0, 1), got {cfg.label_smoothing}")
    if cfg.remat:
        resolve_remat_policy(cfg.remat_policy)
    check_recipe(cfg)
    if cfg.label_smoothing and cfg.fused_xent:
        raise ValueError("label_smoothing is incompatible with fused_xent: the fused kernel "
                         "computes plain CE")
    if cfg.zero1 and cfg.fsdp:
        raise ValueError("zero1 and fsdp are mutually exclusive (fsdp subsumes zero1's moment "
                         "sharding and additionally shards params)")
    if (cfg.zero1 or cfg.fsdp) and cfg.sync_overlap != "off" and cfg.grad_clip_norm is not None:
        raise ValueError(
            "sync_overlap with a sharded optimizer admits pure data parallelism only: "
            "seq/tensor/expert sharding and grad_clip_norm need cross-chunk joins that "
            "defeat the per-bucket schedule"
        )


def _check_wire(cfg: LMConfig) -> None:
    """The JAX ``LMTrainer``'s checks of the gradient wire, in its order
    and with its messages."""
    if cfg.grad_compress not in ("none", "int8"):
        raise ValueError(f"unknown grad_compress {cfg.grad_compress!r}; choose 'none' or 'int8'")
    compress = cfg.grad_compress == "int8"
    if compress and cfg.fsdp:
        raise ValueError(
            "grad_compress='int8' cannot ride fsdp: its gradient reduction IS the backward "
            "of the param all-gather, so there is no separate grad-sync pass to quantize; "
            "for a quantized sharded-optimizer wire use zero1 with "
            "sync_overlap='bucket+int8'"
        )
    if compress and model_sharded(cfg):
        raise ValueError(
            "grad_compress='int8' requires a data-parallel layout (tensor_parallel == "
            "seq_parallel == 1, no expert parallelism): the quantized bucket all-reduce models "
            "the plain data-axis gradient reduction, not locally-sharded grads")
    if compress and cfg.zero1 and cfg.sync_overlap != "bucket+int8":
        raise ValueError(
            "grad_compress='int8' under zero1 quantizes on the overlapped schedule's bucket "
            "boundaries (Zero1Adam's overlapped lane): arm it with "
            "sync_overlap='bucket+int8' (the fused zero1 path has no separate grad-sync pass "
            "to compress)"
        )
    if cfg.sync_bucket_mb < 0:
        raise ValueError(f"sync_bucket_mb must be >= 0, got {cfg.sync_bucket_mb}")
    if cfg.sync_overlap not in OVERLAP_MODES:
        raise ValueError(f"unknown sync_overlap {cfg.sync_overlap!r}; choose from "
                         f"{OVERLAP_MODES}")
    if cfg.sync_overlap == "off":
        return
    if model_sharded(cfg):
        raise ValueError(
            "sync_overlap requires a data-parallel layout (tensor_parallel == seq_parallel == "
            "1, no expert parallelism): seq/tensor/expert sharding needs cross-chunk joins "
            "(psums over other axes) that defeat the per-bucket schedule")
    if not (cfg.zero1 or cfg.fsdp) and (
            cfg.optimizer != "sgd" or cfg.lr_schedule != "constant" or cfg.warmup_steps
            or cfg.grad_clip_norm is not None):
        raise ValueError(
            "pure-DP sync_overlap requires the reference's fixed-LR SGD recipe "
            "(optimizer='sgd', lr_schedule='constant', warmup_steps=0, grad_clip_norm=None): "
            "the per-bucket apply is the flat torch-SGD update, and a clip or schedule would "
            "reintroduce the tree-wide barrier the overlap removes. zero1/fsdp overlap admits "
            "any registry optimizer and LR schedule (the sharded optimizers apply their chunk "
            "rules per bucket)"
        )
    if cfg.sync_overlap == "bucket" and compress:
        raise ValueError("sync_overlap='bucket' overlaps the float wire; with "
                         "grad_compress='int8' use sync_overlap='bucket+int8'")
    if cfg.sync_overlap == "bucket+int8" and not compress:
        raise ValueError("sync_overlap='bucket+int8' overlaps the int8+EF wire; set "
                         "grad_compress='int8'")


class LMTrainer:
    """``TransformerLM`` training on this rank's device: ``init``,
    ``split_batch``, ``train_step``, ``eval_step``, ``evaluate`` and
    ``fit``. The process group, when there is one, is initialized before
    the trainer is built; its world size must be ``data_parallel *
    seq_parallel * tensor_parallel``.
    ``memstore`` is the in-memory snapshot tier; without one,
    ``cfg.snapshot_every`` builds it."""

    def __init__(self, cfg: LMConfig, memstore: ReplicatedSnapshot | None = None):
        check_config(cfg)
        self.cfg = cfg
        self.world_size, self.rank = world()
        layout = cfg.data_parallel * cfg.seq_parallel * cfg.tensor_parallel
        if layout != self.world_size:
            raise ValueError(
                f"data_parallel={cfg.data_parallel} x seq_parallel={cfg.seq_parallel} x "
                f"tensor_parallel={cfg.tensor_parallel} but the process group has world size "
                f"{self.world_size}; launch one process per rank"
            )
        self.mesh = Mesh.get(cfg.data_parallel, cfg.seq_parallel, cfg.tensor_parallel)
        self.expert_parallel = expert_parallel(cfg)
        # Beyond pure data parallelism the sync goes by spec.
        self._sharded = model_sharded(cfg)
        self._zero = cfg.zero1 or cfg.fsdp
        self._compress = cfg.grad_compress == "int8"
        self._overlap = cfg.sync_overlap != "off"
        # The data-parallel wire runs whenever there is a process group,
        # at a world of one too (its collectives are copies there).
        self._synced = dist.is_initialized()
        if (self._zero or self._compress or self._overlap) and not self._synced:
            raise ValueError(
                "zero1/fsdp/grad_compress/sync_overlap communicate through "
                "torch.distributed: initialize a process group first "
                "(parallel.mesh.initialize), a world of one included"
            )
        self._bucket_bytes = int(cfg.sync_bucket_mb * 2**20)
        self.device = rank_device(resolve_device(cfg.device), self.rank)
        self.dtype = resolve_dtype(cfg.compute_dtype)
        if memstore is None and cfg.snapshot_every:
            memstore = ReplicatedSnapshot(max_to_keep=cfg.snapshot_keep)
        self.memstore = memstore
        self.model: TransformerLM | None = None
        self.optimizer = None
        self.overlap = None
        self._ef: list[torch.Tensor] = []
        self.step = 0

    def init(self, seed: int | None = None, state_dict: dict | None = None):
        """Build the model (parameters from ``seed``, default
        ``cfg.seed``, or copies of ``state_dict``'s, in this
        configuration's layout: stacked under ``scan_layers``) and its
        optimizer; returns ``(model, optimizer)``. Under fsdp the
        optimizer's ``params`` are this rank's rows and the model's own
        parameters are empty."""
        cfg = self.cfg
        kw = dict(self._model_kw(), attention_impl=cfg.attention_impl,
                  seq_axis_size=cfg.seq_parallel, tensor_axis_size=cfg.tensor_parallel,
                  expert_axis_size=cfg.data_parallel if self.expert_parallel else 1,
                  mesh=self.mesh)
        if state_dict is None:
            gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
            self.model = TransformerLM(**kw, generator=gen).to(self.device)
        else:  # no init drawn: the weights are this rank's slices of the given ones
            with torch.device("meta"):
                self.model = TransformerLM(**kw)
            specs, m = self.model.param_specs, self.mesh
            self.model.load_state_dict(
                {k: shard_tensor(v.detach(), specs[k], m.coords, m.sizes).to(self.device,
                                                                            copy=True)
                 for k, v in state_dict.items()}, assign=True)
        self._specs = [self.model.param_specs[n] for n, _ in self.model.named_parameters()]
        params = list(self.model.parameters())
        if self.overlap is not None:
            self.overlap.remove_hooks()
        self.overlap = None
        self._ef = ([torch.zeros_like(p, dtype=torch.float32) for p in params]
                    if self._compress else [])
        if self._zero:
            self.optimizer = self._sharded_rule(params)
        else:
            # The sharded clip runs before the optimizer, which then clips nothing.
            self.optimizer = make_lm_optimizer(
                cfg.replace(grad_clip_norm=None) if self._sharded_clip else cfg, params)
            if self._overlap:
                self.overlap = OverlappedSGD(
                    params, self.optimizer.momentum, self._ef or None, name="allreduce",
                    world_size=self.world_size, lr=cfg.learning_rate, mu=cfg.momentum,
                    wd=cfg.weight_decay, bucket_bytes=self._bucket_bytes)
        self.step = 0
        return self.model, self.optimizer

    def _sharded_rule(self, params: list[torch.Tensor]):
        """zero1's or fsdp's rule of ``cfg.optimizer`` over ``params``;
        under fsdp the module's parameters are swapped for empty
        placeholders and the rule keeps this rank's rows."""
        cfg = self.cfg
        z1_cls, fsdp_cls = LM_RULES[cfg.optimizer]
        if cfg.fsdp:
            self._param_names = [name for name, _ in self.model.named_parameters()]
            self._param_shapes = [(tuple(p.shape), p.dtype) for p in params]
            params = fsdp_cls.shard_params(params, cfg.data_parallel, self.mesh, self._specs)
            for name in self._param_names:
                module_name, _, attr = name.rpartition(".")
                setattr(self.model.get_submodule(module_name), attr,
                        nn.Parameter(torch.empty(0, device=self.device), requires_grad=False))
        rule = (fsdp_cls if cfg.fsdp else z1_cls)(
            params, make_schedule(cfg), cfg.momentum, cfg.weight_decay, cfg.data_parallel,
            clip_norm=cfg.grad_clip_norm, bucket_bytes=self._bucket_bytes, overlap=self._overlap,
            mesh=self.mesh, specs=self._specs)
        if cfg.zero1 and self._overlap:
            self.overlap = OverlappedZero1LM(rule, self._ef or None)
        return rule

    def _full_params(self) -> dict[str, torch.Tensor]:
        """fsdp: every parameter gathered from the ranks' rows, by name
        (differentiable: the gather's backward reduce-scatters)."""
        return dict(zip(self._param_names, self.optimizer.gather_params(self._param_shapes)))

    def _model_kw(self) -> dict:
        cfg = self.cfg
        return dict(
            vocab_size=cfg.vocab_size, num_layers=cfg.num_layers, num_heads=cfg.num_heads,
            d_model=cfg.d_model, d_ff=cfg.d_ff, max_seq_len=cfg.max_seq_len, dtype=self.dtype,
            tie_embeddings=cfg.tie_embeddings, use_rope=cfg.use_rope,
            num_kv_heads=cfg.num_kv_heads, norm=cfg.norm, mlp=cfg.mlp,
            num_experts=cfg.moe_experts, moe_top_k=cfg.moe_top_k,
            moe_capacity_factor=cfg.moe_capacity_factor, moe_num_groups=cfg.moe_groups,
            moe_dispatch=cfg.moe_dispatch, moe_gmm_impl=cfg.moe_gmm_impl,
            remat=cfg.remat, remat_policy=cfg.remat_policy, scan_layers=cfg.scan_layers,
            dropout_rate=cfg.dropout_rate,
        )

    def gather_for_decode(self, params: dict | None = None) -> dict:
        """The full weights for a decode copy, in the unrolled layout:
        ``params``, or the trainer's model's ``state_dict`` (built by
        ``init()`` if there is none yet), unstacked if stacked. Under fsdp
        the ranks' rows are all-gathered into the whole tensors (the JAX
        ``unshard_host``): a collective every rank joins."""
        if params is None:
            if self.model is None:
                self.init()
            params = self.state_dict()
        return unstack_block_params(params) if is_stacked(params) else params

    @torch.no_grad()
    def state_dict(self) -> dict[str, torch.Tensor]:
        """The model's full ``state_dict``: under fsdp gathered from the
        ranks' rows, and each tensor- or expert-split tensor from its
        slices (collectives every rank must join)."""
        if not self.cfg.fsdp:
            local = self.model.state_dict()
        else:
            group = self.mesh.group(DATA_AXIS)
            local = {name: row.detach().clone() if DATA_AXIS in spec
                     else _unshard(C.all_gather_flat(row, group), shape).clone()
                     for name, row, (shape, _), spec in zip(
                         self._param_names, self.optimizer.params, self._param_shapes,
                         self._specs, strict=True)}
        return {name: self._unsplit(value, self.model.param_specs[name])
                for name, value in local.items()}

    def _unsplit(self, x: torch.Tensor, spec: tuple) -> torch.Tensor:
        """The global tensor from this rank's slice: an all-gather over each
        axis the spec names, the slices joined in coordinate order."""
        for dim, axis in enumerate(spec):
            if axis is not None and self.mesh.size(axis) > 1:
                parts = C.all_gather_flat(x.contiguous(), self.mesh.group(axis))
                x = torch.cat([part.view(x.shape) for part in parts.unbind(0)], dim=dim)
        return x

    def _decode_copy(self, params: dict, **options) -> TransformerLM:
        """A ``TransformerLM`` with dense attention for the prompt pass, no
        remat and the unrolled layout, built without an init and loaded
        with copies of ``params`` on the trainer's device, its float
        weights cast to the compute dtype."""
        params = unstack_block_params(params) if is_stacked(params) else params
        kw = dict(self._model_kw(), remat=False, scan_layers=False)
        with torch.device("meta"):
            model = TransformerLM(**kw, attention_impl="dense", **options)
        model.load_state_dict(
            {k: v.detach().to(self.device, copy=True) for k, v in params.items()}, assign=True)
        return model.cast_for_decode_()

    def decode_model(self, params: dict | None = None, *, kv_cache: bool = False) -> TransformerLM:
        """The decode copy for ``infer/generate.py`` and ``serve/`` (the
        JAX ``decode_model``; with ``kv_cache=True`` its
        ``clone(quant_kv_cache=True)``), holding ``params`` (a float
        ``state_dict``, default the trainer's weights)::

            trainer.fit(tokens, steps)
            generate = make_generator(trainer.decode_model(), max_new_tokens=64,
                                      temperature=0.8)
            out = generate(prompt)
        """
        return self._decode_copy(self.gather_for_decode(params), quant_kv_cache=kv_cache)

    @property
    def param_specs(self) -> dict[str, tuple]:
        """Which dimension of each parameter each axis splits (the JAX
        trainer's ``param_specs``): the model's ``lm_param_specs``, by
        ``state_dict`` name. Builds the model (``init()``) if there is none
        yet."""
        if self.model is None:
            self.init()
        return self.model.param_specs

    def tp_decode_model(self, *, kv_cache: bool = False) -> TransformerLM:
        """The tensor-parallel decode copy (JAX ``tp_decode_model``): the
        trainer's layout with no sequence axis (the KV cache holds the whole
        sequence), the tensor axis kept, dense attention, no remat, the
        ``scan_layers`` layout kept; it holds copies of this rank's slices
        of the weights (no gather) in the compute dtype, so each rank
        projects and caches only its heads. ``kv_cache=True`` stores the
        KV cache and page pools int8 (their scales split over the heads
        too). Every rank builds its own and runs the decoder on it::

            generate = make_generator(trainer.tp_decode_model(), max_new_tokens=32,
                                      temperature=0.0, mesh=trainer.mesh,
                                      param_specs=trainer.param_specs)
            out = generate(prompt)  # the same [B, 32] on every rank
        """
        if self.expert_parallel:
            raise ValueError(
                "tp_decode_model does not support expert parallelism; "
                "decode EP models from gathered params (decode_model)"
            )
        if self.cfg.fsdp:
            raise ValueError(
                "tp_decode_model does not apply to fsdp-chunked params "
                "(they are flat [dp(, tp), chunk] shards, not the "
                "tensor-sharded layout this model expects); use "
                "gather_for_decode + decode_model"
            )
        if self.model is None:
            self.init()
        kw = dict(self._model_kw(), remat=False, tensor_axis_size=self.cfg.tensor_parallel,
                  mesh=self.mesh)
        with torch.device("meta"):
            model = TransformerLM(**kw, attention_impl="dense", quant_kv_cache=kv_cache)
        model.load_state_dict({k: v.detach().to(self.device, copy=True)
                               for k, v in self.model.state_dict().items()}, assign=True)
        return model.cast_for_decode_()

    def quantized_decode_model(self, modules: str = "head", kv_cache: bool = False,
                               params: dict | None = None) -> TransformerLM:
        """``decode_model`` with int8 projections (``ops/quant.py``): scope
        ``head`` (default) quantizes ``lm_head`` only, ``all`` every
        projection; ``kv_cache=True`` also stores the KV cache int8.
        ``params`` is a ``quantize_for_decode(..., modules)`` ``state_dict``
        (default: the trainer's weights, quantized). With tied embeddings
        there is no ``lm_head``, so scope ``head`` gives the KV-only model
        when ``kv_cache`` is set and raises otherwise, as in JAX."""
        if self.cfg.tie_embeddings and modules == "head":
            if kv_cache:
                return self.decode_model(params, kv_cache=True)
            raise ValueError(
                "int8-decode scope 'head' is a no-op with tied embeddings (no lm_head "
                "exists; the embedding head stays float): use modules='all', or "
                "kv_cache=True, which needs no weight scope"
            )
        if params is None:
            params = self.quantize_for_decode(self.gather_for_decode(), modules)
        return self._decode_copy(params, quant_dense=True,
                                 quant_modules=resolve_quant_modules(modules),
                                 quant_kv_cache=kv_cache)

    @staticmethod
    def quantize_for_decode(params: dict, modules: str = "head") -> dict:
        """A float ``state_dict`` -> the int8 one a
        ``quantized_decode_model(modules)`` loads (``ops/quant.py::
        quantize_lm_params``)."""
        return quantize_lm_params(params, resolve_quant_modules(modules))

    def split_batch(self, tokens) -> tuple[torch.Tensor, torch.Tensor]:
        """A global batch [B, seq_len + 1] of tokens -> (inputs [:, :-1],
        targets [:, 1:]) of this rank's rows ``[d B/n, (d+1) B/n)`` (d its
        data index) and, on a seq axis of s ranks, its columns ``[j T/s,
        (j+1) T/s)`` (j its seq index): int64 tensors on the device (the
        JAX ``shard_batch``; the targets are shifted before the cut, so a
        block's last label is its true next token)."""
        tokens = np.asarray(tokens)
        per = len(tokens) // self.cfg.data_parallel
        d = self.mesh.axis_index(DATA_AXIS)
        tokens = torch.as_tensor(tokens[d * per : (d + 1) * per], dtype=torch.int64)
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        cols = inputs.shape[1] // self.cfg.seq_parallel
        j = self.mesh.axis_index(SEQ_AXIS)
        inputs, targets = (x[:, j * cols : (j + 1) * cols].contiguous() for x in (inputs, targets))
        return (inputs.to(self.device, non_blocking=True),
                targets.to(self.device, non_blocking=True))

    def _logits(self, inputs: torch.Tensor, dropout: tuple[int, ...] | None = None):
        if self.cfg.fsdp:
            return functional_call(self.model, self._full_params(), (inputs,),
                                   {"dropout": dropout})
        return self.model(inputs, dropout=dropout)

    def _loss(self, inputs: torch.Tensor, targets: torch.Tensor, smoothing: float,
              fused: bool = False, dropout: tuple[int, ...] | None = None):
        logits = self._logits(inputs, dropout)
        v = logits.shape[-1]
        if fused:
            return fused_cross_entropy(logits.reshape(-1, v), targets.reshape(-1)).mean()
        return _smoothed_xent(logits.reshape(-1, v), targets.reshape(-1), smoothing)

    def world_mean(self, values: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Each 0-d value's mean over the ranks (JAX's ``pmean``: the sum,
        one all-reduce for them all, divided by n); the values as they are
        without a process group."""
        if not self._synced or not values:
            return values
        total = C.all_reduce_sum(torch.stack([v.float() for v in values.values()]))
        mean = true_div(total, self.world_size)
        return dict(zip(values, mean.unbind()))

    def _moe_stats(self) -> dict[str, torch.Tensor]:
        """The MoE layers' statistics of the last forward made with grad:
        ``moe_aux`` summed over layers, ``moe_drop`` and
        ``moe_load_entropy`` averaged (JAX ``moe_aux_loss`` and
        ``sown_scalar_mean``)."""
        layers = [b.moe for b in self.model.blocks]
        return {
            "moe_aux": torch.stack([m.aux_loss for m in layers]).sum(),
            "moe_drop": torch.stack([m.drop_rate for m in layers]).mean(),
            "moe_load_entropy": torch.stack([m.load_entropy for m in layers]).mean(),
        }

    def objective(self, inputs: torch.Tensor, targets: torch.Tensor, step: int | None = None,
                  microbatch: int = 0) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """The training loss (cross-entropy, label-smoothed or through the
        fused kernels, plus ``moe_aux_coef`` times the MoE aux loss) and
        the MoE statistics of its forward (empty for a dense model), read
        right after the forward (a remat recompute in the backward sets
        them again). Dropout, when on, is keyed by (seed, ``step``,
        default ``self.step``, ``microbatch``), then by this rank's data
        index (and its seq index on a seq axis) where either is above 0,
        so the data and seq ranks draw their own masks (JAX folds both
        indices into its key) while the tensor ranks draw the same ones
        and data and seq index 0 keeps the one-device key."""
        cfg = self.cfg
        key = None
        if cfg.dropout_rate > 0.0:
            key = (cfg.seed, self.step if step is None else step, microbatch)
            d, j = self.mesh.axis_index(DATA_AXIS), self.mesh.axis_index(SEQ_AXIS)
            if d or j:
                key += (d,) if cfg.seq_parallel == 1 else (d, j)
        loss = self._loss(inputs, targets, cfg.label_smoothing, fused=cfg.fused_xent, dropout=key)
        moe = self._moe_stats() if cfg.moe_experts > 0 else {}
        if moe:
            loss = loss + cfg.moe_aux_coef * moe["moe_aux"]
        return loss, moe

    def train_step(self, inputs: torch.Tensor, targets: torch.Tensor,
                   step: int | None = None) -> dict[str, torch.Tensor]:
        """One update on this rank's rows of a batch; ``step`` keys the
        dropout masks (default ``self.step``; inert at ``dropout_rate``
        0). The metrics are the world's means."""
        cfg = self.cfg
        params = self.optimizer.params
        for p in params:
            p.grad = None
        step = self.step if step is None else step
        accum = cfg.accum_steps
        loss, moe = None, {}
        # Microbatch i is rows [i b/a, (i+1) b/a) of this rank's b; the
        # gradients accumulate in ``grad`` and the sums are divided by
        # accum_steps, as JAX's scan carry. The overlapped lane arms the
        # last microbatch's backward with the earlier ones' sum.
        for i, (x, y) in enumerate(zip(inputs.chunk(accum), targets.chunk(accum))):
            if self.overlap is not None and i == accum - 1:
                prefix = None
                if accum > 1:
                    prefix = [p.grad for p in params]
                    for p in params:
                        p.grad = None
                self.overlap.begin(prefix, accum)
            mb_loss, mb_moe = self.objective(x, y, step, microbatch=i)
            mb_loss.backward()
            loss = mb_loss.detach() if loss is None else loss + mb_loss.detach()
            for k, v in mb_moe.items():
                moe[k] = v.detach() if k not in moe else moe[k] + v.detach()
        if accum > 1:
            if self.overlap is None:
                torch._foreach_div_([p.grad for p in params], accum)
            loss = loss / accum
            moe = {k: v / accum for k, v in moe.items()}
        self._update(params)
        self.step += 1
        metrics = self.world_mean({"loss": loss, **moe})
        if not self._zero:  # zero1/fsdp never form the synced gradients
            with torch.no_grad():
                # Split tensors' squares summed over their axes.
                axes = [spec_axes(spec) for spec in self._specs]
                metrics["grad_norm"] = tree_l2_norm([p.grad for p in params], axes, self.mesh)
                metrics["param_norm"] = tree_l2_norm(params, axes, self.mesh)
        return {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def _update(self, params: list[torch.Tensor]) -> None:
        """The data-parallel sync and the update (the JAX step's paths):
        the overlapped lane's buckets; zero1's and fsdp's sharded rules
        (the local gradients, or the rows' sums); the int8 wire with this
        rank's residuals, or the all-reduce mean, before the replicated
        optimizer. Without a process group, the optimizer alone."""
        grads = [p.grad for p in params]
        if self.overlap is not None:
            self.overlap.finish()
            return
        if self._zero:
            self.optimizer.apply(grads)
            return
        if self._compress:
            sync_grads_compressed(grads, self._ef, "int8_allreduce", self.world_size,
                                  bucket_bytes=self._bucket_bytes)
        elif self._sharded:
            self._sync_by_spec(grads)
            if self._sharded_clip:  # the metrics read the unclipped gradients, as JAX's
                opt = self.optimizer
                opt.tx.apply(params, opt.momentum, clip_by_global_norm_sharded(
                    grads, self.cfg.grad_clip_norm, self._specs, self.mesh))
                return
        elif self._synced:
            sync_grads(grads, "allreduce", self.world_size, self._bucket_bytes)
        self.optimizer.step()

    @property
    def _sharded_clip(self) -> bool:
        """JAX chains the spec-aware clip before the optimizer when a
        tensor axis or the experts split gradients."""
        return self.cfg.grad_clip_norm is not None and (
            self.cfg.tensor_parallel > 1 or self.expert_parallel)

    def _sync_by_spec(self, grads: list[torch.Tensor]) -> None:
        """JAX's ``sync_grad`` a gradient at a time, in place: an
        expert-split gradient (its spec names the data axis; the
        all-to-all's backward summed it over its data row) summed over seq
        and divided by data x seq, then averaged over tensor; any other
        averaged over data and seq, and over tensor unless that axis splits
        it. The gradients of one set of axes go in one all-reduce."""
        axes = [(SEQ_AXIS, TENSOR_AXIS) if DATA_AXIS in spec
                else (DATA_AXIS, SEQ_AXIS) if TENSOR_AXIS in spec
                else (DATA_AXIS, SEQ_AXIS, TENSOR_AXIS) for spec in self._specs]
        synced = C.reduce_by_axes(grads, axes, self.mesh)
        for i, (g, spec) in enumerate(zip(grads, self._specs, strict=True)):
            g.copy_(true_div(synced[i], self.cfg.data_parallel) if DATA_AXIS in spec
                    else synced[i])

    def _opt_state(self) -> tuple[list, list, int]:
        """(first moments, second moments or [], update count): the
        replicated optimizer's or this rank's rows of the sharded rule's."""
        opt = self.optimizer
        if self._zero:
            return opt.momentum, opt.moments.get("nu", []), opt.count
        return opt.momentum, opt.tx.nu, opt.tx.count

    @torch.no_grad()
    def capture_state(self, *, clone: bool = False) -> dict[str, Any]:
        """Everything a bitwise resume needs (the checkpoint's and the
        snapshot's content, a file a rank): the step, the world size, the
        optimizer's parameters (under fsdp this rank's rows), its first
        moments (``momentum``), AdamW's second moments, the update count
        (zero1's and fsdp's moments are this rank's rows) and the int8
        wire's residuals. ``clone`` copies the tensors on their device."""
        take = (lambda t: t.detach().clone()) if clone else (lambda t: t.detach())
        mu, nu, count = self._opt_state()
        return {
            "step": int(self.step),
            "world_size": self.world_size,
            "layout": [self.cfg.data_parallel, self.cfg.seq_parallel, self.cfg.tensor_parallel],
            "params": [take(p) for p in self.optimizer.params],
            "momentum": [take(m) for m in mu],
            "opt_nu": [take(v) for v in nu],
            "opt_count": int(count),
            "ef": [take(e) for e in self._ef],
        }

    def _check_tensor_pinned(self, state: dict[str, Any]) -> None:
        saved_tp = state.get("layout", [0, 0, 1])[2]
        if saved_tp != self.cfg.tensor_parallel:
            raise ValueError(
                f"state saved at tensor_parallel={saved_tp} cannot load into tensor_parallel="
                f"{self.cfg.tensor_parallel}: tensor_parallel is layout-pinned and must match "
                "the save")

    def replicated_keys(self) -> tuple[str, ...]:
        """The ``capture_state`` collections every rank holds alike (the
        in-memory snapshot gathers the others): under pure data
        parallelism, the parameters unless fsdp cuts them into rows and
        the moments unless zero1 or fsdp does."""
        if self._sharded:
            return ()
        keys = [] if self.cfg.fsdp else ["params"]
        if not self._zero:
            keys += ["momentum", "opt_nu"]
        return tuple(keys)

    @torch.no_grad()
    def elastic_state(self, states: Sequence[dict[str, Any]]) -> dict[str, Any]:
        """This rank's state built from every rank's saved one (a
        checkpoint's ``RankStates`` or a snapshot's entry), the ``adapt``
        of ``Checkpointer.restore_latest`` and
        ``ReplicatedSnapshot.restore_latest``; call it after ``init()``.
        Saved by this layout, it is this rank's own. Saved at another
        ``data_parallel`` or ``seq_parallel``, the JAX package's elastic
        restore of the ``LMState``: ``tensor_parallel`` is layout-pinned
        (another one raises); the flat ZeRO rows (zero1's and fsdp's
        moments, fsdp's parameters) are stacked into JAX's ``[dp, (tp,)
        chunk]`` leaves from the old ranks of each data coordinate and
        re-chunked by ``parallel/zero.py::make_elastic_adapt``;
        expert-parallel tensors (split over the data axis) re-shard whole
        experts across the new data axis; every other tensor is taken,
        for this rank's tensor coordinate, from any rank once they agree;
        the int8 wire's residuals are per replica (sliced or tiled
        cyclically); the step and the update count are the ranks' one
        value."""
        cfg = self.cfg
        first = states[0]
        self._check_tensor_pinned(first)
        layout = [cfg.data_parallel, cfg.seq_parallel, cfg.tensor_parallel]
        old = list(first.get("layout", [len(states), 1, 1]))
        if len(states) == self.world_size and old == layout:
            return states[self.rank]
        d_old, s_old, t_old = old
        if d_old * s_old * t_old != len(states):
            raise ValueError(f"saved layout {old} does not match its {len(states)} rank states")

        def at(d: int, t: int, s: int = 0) -> dict:
            return states[(d * s_old + s) * t_old + t]

        coords = self.mesh.coords
        d_new, t_me = coords[DATA_AXIS], coords[TENSOR_AXIS]
        names = [n for n, _ in self.model.named_parameters()]
        local = ([shape for shape, _ in self._param_shapes] if cfg.fsdp
                 else [tuple(p.shape) for p in self.optimizer.params])
        specs = dict(zip(names, self._specs, strict=True))
        sizes = self.mesh.sizes

        def global_shape(name: str, shape: tuple) -> tuple:
            return tuple(n * sizes[a] if a in (DATA_AXIS, TENSOR_AXIS) else n
                         for n, a in zip(shape, specs[name] + (None,) * len(shape)))

        adapt = None
        if self._zero:
            adapt = make_elastic_adapt(
                chunk_local_sizes({n: global_shape(n, sh) for n, sh in zip(names, local)},
                                  specs, {TENSOR_AXIS: cfg.tensor_parallel},
                                  exclude_axis=DATA_AXIS),
                prefixes=("momentum/", "opt_nu/") + (("params/",) if cfg.fsdp else ()))

        def replicas(key: str, i: int, d: int, t: int) -> torch.Tensor:
            """Old rank (d, ., t)'s tensor, equal on every seq coordinate."""
            return agreed(f"{key}/{names[i]}", [at(d, t, s)[key][i] for s in range(s_old)])

        def leaf(key: str, i: int, live: torch.Tensor) -> torch.Tensor:
            name, spec = names[i], specs[names[i]]
            rows = key != "params" and self._zero or key == "params" and cfg.fsdp
            if DATA_AXIS in spec:  # expert-split: whole experts re-shard over data
                k = spec.index(DATA_AXIS)
                shape = list(local[i])  # the old ranks' slices: E / d_old experts
                shape[k] = shape[k] * cfg.data_parallel // d_old
                full = torch.cat([replicas(key, i, d, t_me).reshape(shape)
                                  for d in range(d_old)], dim=k)
                return full.chunk(cfg.data_parallel, dim=k)[d_new].reshape(live.shape).clone()
            if rows:
                tensor_split = TENSOR_AXIS in spec
                ts = range(t_old) if tensor_split else [t_me]
                saved = torch.stack([torch.stack([replicas(key, i, d, t) for t in ts])
                                     for d in range(d_old)])
                like = (cfg.data_parallel, t_old, live.numel()) if tensor_split else (
                    cfg.data_parallel, 1, live.numel())
                out = adapt_host_leaf(f"{key}/{name}", saved if tensor_split else saved[:, 0],
                                      like if tensor_split else (like[0], like[2]), adapt)
                return (out[d_new, t_me] if tensor_split else out[d_new]).reshape(live.shape)
            return agreed(f"{key}/{name}", [at(d, t_me, s)[key][i]
                                            for d in range(d_old) for s in range(s_old)])

        mu, nu, _ = self._opt_state()
        out: dict[str, Any] = {
            "step": agreed("step", [st["step"] for st in states]),
            "world_size": self.world_size,
            "layout": layout,
            "opt_count": agreed("opt_count", [st["opt_count"] for st in states]),
        }
        for key, live in (("params", self.optimizer.params), ("momentum", mu), ("opt_nu", nu)):
            if len(first.get(key, [])) != len(live):
                raise ValueError(f"saved {key} do not match this trainer's configuration")
            out[key] = [leaf(key, i, t) for i, t in enumerate(live)]
        # The int8 wire's residuals: per replica (pure data parallelism).
        out["ef"] = [adapt_host_leaf(f"ef/{i}", torch.stack([at(d, 0)["ef"][i]
                                                             for d in range(d_old)]),
                                     (cfg.data_parallel, *e.shape))[d_new]
                     for i, e in enumerate(self._ef)]
        return out

    @torch.no_grad()
    def restore_state(self, state: dict[str, Any]) -> None:
        """Load ``capture_state``'s dict by copying into the live tensors
        (the overlapped lanes and fsdp's gathers hold references to
        them). A state saved by another layout raises (``elastic_state``
        re-cuts it from every rank's first), and so does one of another
        ``tensor_parallel`` (the tensor slices are layout-pinned, as in
        JAX)."""
        self._check_tensor_pinned(state)
        layout = [self.cfg.data_parallel, self.cfg.seq_parallel, self.cfg.tensor_parallel]
        if (state.get("world_size", 1) != self.world_size
                or list(state.get("layout", layout)) != layout):
            raise ValueError(
                f"state saved by a world of {state['world_size']} ranks (layout "
                f"{state.get('layout')}) cannot load into layout {layout} as it is: build this "
                "rank's state with elastic_state from every rank's saved state "
                "(Checkpointer.restore_latest(adapt=trainer.elastic_state))"
            )
        mu, nu, _ = self._opt_state()
        for key, live in (("params", self.optimizer.params), ("momentum", mu), ("opt_nu", nu),
                          ("ef", self._ef)):
            saved = state.get(key, [])
            if len(live) != len(saved) or any(a.shape != b.shape for a, b in zip(live, saved)):
                raise ValueError(f"saved {key} do not match this trainer's configuration")
            for dst, src in zip(live, saved):
                dst.copy_(src)
        if self._zero:
            self.optimizer.count = int(state["opt_count"])
        else:
            self.optimizer.tx.count = int(state["opt_count"])
        self.step = int(state["step"])

    @torch.no_grad()
    def eval_step(self, inputs: torch.Tensor, targets: torch.Tensor) -> dict[str, torch.Tensor]:
        """Plain mean cross-entropy (no label smoothing, and not the fused
        kernel, as the JAX ``local_eval``) on this rank's rows, meaned over
        the ranks; under fsdp on parameters gathered for the call."""
        return self.world_mean({"loss": self._loss(inputs, targets, 0.0)})

    def evaluate(self, tokens) -> dict[str, float]:
        """Mean next-token cross-entropy and perplexity over ``tokens``
        [N, seq_len + 1], in global batches of ``global_batch_size`` (each
        rank its rows, the ranks' means averaged); a ragged tail is
        dropped."""
        b = self.cfg.global_batch_size
        n_batches = len(tokens) // b
        if n_batches == 0:
            raise ValueError(f"need at least global_batch_size={b} sequences, got {len(tokens)}")
        total = 0.0
        for i in range(n_batches):
            x, y = self.split_batch(tokens[i * b : (i + 1) * b])
            total += float(self.eval_step(x, y)["loss"])
        mean_loss = total / n_batches
        return {"loss": mean_loss, "perplexity": math.exp(mean_loss)}

    def _telemetry(self) -> tuple[Any, int]:
        """The run's Telemetry (manifest written) and the data-parallel
        wire bytes a step of its layout (``parallel/sync.py::lm_strategy``;
        0 at a world of one)."""
        from cs744_pytorch_distributed_tutorial_tpu_torch.obs.flops import (
            transformer_train_flops_per_token,
        )
        from cs744_pytorch_distributed_tutorial_tpu_torch.obs.metrics import Telemetry
        from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.sync import (
            lm_strategy,
            sync_wire_bytes,
        )

        cfg = self.cfg
        shapes = (self._param_shapes if cfg.fsdp
                  else [(tuple(p.shape), p.dtype) for p in self.optimizer.params])
        # The model's global shapes: each split dimension times its axis.
        shapes = [(tuple(n * (self.mesh.size(a) if a else 1) for n, a in zip(shape, spec)), dt)
                  for (shape, dt), spec in zip(shapes, self._specs, strict=True)]
        n_params = sum(math.prod(shape) for shape, _ in shapes)
        wire_bytes = sync_wire_bytes(shapes, lm_strategy(cfg.zero1, cfg.fsdp, cfg.grad_compress),
                                     cfg.data_parallel, cfg.grad_compress,
                                     bucket_bytes=self._bucket_bytes, overlap=self._overlap)
        on_card = self.device.type == "cuda"
        telemetry = Telemetry(
            cfg.metrics_dir, every=cfg.metrics_every, run="lm",
            flops_per_step=(transformer_train_flops_per_token(n_params)
                            * cfg.global_batch_size * cfg.seq_len),
            n_chips=self.world_size,
            device_kind=torch.cuda.get_device_name(self.device) if on_card else "cpu",
            device=self.device,
        )
        telemetry.write_manifest(config=cfg, n_params=n_params, grad_sync_bytes_per_step=wire_bytes)
        return telemetry, wire_bytes

    def fit(self, tokens, steps: int):
        """Train until ``steps`` steps have run, over batches of ``tokens``
        [N, seq_len + 1], from a fresh ``init()`` or from the newest
        recoverable state (the in-memory snapshot when it is at least as
        new as the newest checkpoint); returns ``(model, optimizer,
        losses)``, the losses of the steps this call ran.
        ``self.history`` holds their metrics.

        The JAX ``LMTrainer.fit``, step for step: every loss is fetched
        (the non-finite check and the step records ride that fetch); a
        due checkpoint or snapshot is held, under ``halt_on_nonfinite``,
        until the next finite loss (the forward over its parameters)
        certifies it, and the final state is certified by one eval
        forward before the last save; the watchdog spares the first step,
        which builds the kernels."""
        from cs744_pytorch_distributed_tutorial_tpu_torch.obs.flight import (
            FlightRecorder,
            HbmHighWater,
            StragglerMonitor,
        )
        from cs744_pytorch_distributed_tutorial_tpu_torch.utils import profiling
        from cs744_pytorch_distributed_tutorial_tpu_torch.utils.checkpoint import Checkpointer
        from cs744_pytorch_distributed_tutorial_tpu_torch.utils.failure import StepWatchdog

        cfg = self.cfg
        model, optimizer = self.init()
        mem = self.memstore
        ckpt = Checkpointer(cfg.checkpoint_dir) if cfg.checkpoint_dir else None
        mem_step = mem.latest_step() if mem is not None else None
        disk_step = ckpt.latest_step() if ckpt is not None else None
        restored = source = None
        if mem_step is not None and (disk_step is None or disk_step <= mem_step):
            restored, source = mem.restore_latest(adapt=self.elastic_state), "memory"
        elif disk_step is not None:
            restored, source = ckpt.restore_latest(adapt=self.elastic_state), "disk"
        if restored is not None:
            self.restore_state(restored)
        start_step = self.step
        losses: list[float] = []
        self.history: dict[str, list[float]] = {"loss": losses}
        n, b = len(tokens), cfg.global_batch_size

        telemetry, wire_bytes = self._telemetry()
        if source is not None:
            telemetry.emit_event("restore", source=source, step=start_step)
        lr_at = make_schedule(cfg)
        straggler = StragglerMonitor()
        flight = FlightRecorder(telemetry=telemetry, straggler=straggler,
                                hbm=HbmHighWater([self.device] if self.device.type == "cuda"
                                                 else []))
        flight.install()
        watchdog = None
        if cfg.step_timeout_s:
            watchdog = StepWatchdog(cfg.step_timeout_s, metric_ring=telemetry.ring,
                                    flight_recorder=flight)
        capture: profiling.Trace | None = None

        def stop_profile() -> None:
            nonlocal capture
            if capture is not None:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                capture.stop()
                capture = None

        # Divergence-safe saves: the loss fetched at step k is the forward
        # over the parameters the previous update made, so a due state is
        # held as (state cloned on the device, to disk, to memory) and
        # persisted once a later finite loss certifies it.
        pending: tuple[dict, bool, bool] | None = None
        x = y = None
        prev_mono = None  # per-step wall clock for the straggler ring
        step = start_step
        try:
            for step in range(start_step, steps):
                lo = (step * b) % max(n - b + 1, 1)
                fetch_ctx = (profiling.annotate("input_fetch") if capture is not None
                             else contextlib.nullcontext())
                with fetch_ctx:
                    x, y = self.split_batch(tokens[lo : lo + b])
                if (cfg.profile_dir and capture is None and cfg.profile_start_step
                        <= step < cfg.profile_start_step + cfg.profile_num_steps):
                    capture = profiling.Trace(cfg.profile_dir)
                    capture.start()
                arm_now = watchdog is not None and step > start_step
                if arm_now:
                    watchdog.arm()
                step_ctx = (profiling.step_annotation("lm", step) if capture is not None
                            else contextlib.nullcontext())
                try:
                    with step_ctx:
                        m = self.train_step(x, y)
                        self.step = step + 1
                        # (wall, mono) around the blocking fetch, as the
                        # JAX loop records them.
                        sync_enter_wall, sync_enter_mono = time.time(), time.monotonic()
                        loss = float(m["loss"])
                        sync_exit_wall, sync_exit_mono = time.time(), time.monotonic()
                finally:
                    if arm_now:
                        watchdog.disarm()
                now_mono = time.monotonic()
                if prev_mono is not None:
                    outlier = straggler.record(step, now_mono - prev_mono)
                    if outlier is not None:
                        telemetry.emit_event("straggler", **outlier)
                prev_mono = now_mono
                if capture is not None and step + 1 >= cfg.profile_start_step + cfg.profile_num_steps:
                    stop_profile()
                if cfg.halt_on_nonfinite and not math.isfinite(loss):
                    telemetry.emit_event("non_finite_loss", step=step, loss=loss)
                    raise NonFiniteLossError(step, loss)
                if pending is not None:  # this finite loss certifies it
                    pstate, to_disk, to_mem = pending
                    if to_disk:
                        ckpt.save(pstate)
                    if to_mem:
                        mem.save(pstate, shared=self.replicated_keys())
                    pending = None
                losses.append(loss)
                fields = {key: float(value) for key, value in m.items() if key != "loss"}
                for key, value in fields.items():
                    self.history.setdefault(key, []).append(value)
                if telemetry.due(step):
                    telemetry.emit_step(
                        step, loss=loss, lr=float(lr_at(step)), grad_sync_bytes=wire_bytes,
                        sync_enter_wall=sync_enter_wall, sync_enter_mono=sync_enter_mono,
                        sync_exit_wall=sync_exit_wall, sync_exit_mono=sync_exit_mono, **fields,
                    )
                ckpt_due = bool(ckpt and cfg.checkpoint_every
                                and (step + 1) % cfg.checkpoint_every == 0)
                snap_due = bool(mem is not None and cfg.snapshot_every
                                and (step + 1) % cfg.snapshot_every == 0)
                if ckpt_due or snap_due:
                    if cfg.halt_on_nonfinite:
                        pending = (self.capture_state(clone=True), ckpt_due, snap_due)
                    else:
                        if ckpt_due:
                            ckpt.save(self.capture_state())
                        if snap_due:
                            mem.save(self.capture_state(), shared=self.replicated_keys())
            if ckpt is not None or mem is not None:
                if cfg.halt_on_nonfinite and steps > start_step:
                    # Certify the final parameters with one eval forward
                    # (no later train step will).
                    f_loss = float(self.eval_step(x, y)["loss"])
                    if not math.isfinite(f_loss):
                        raise NonFiniteLossError(steps, f_loss)
                if ckpt is not None:
                    ckpt.save(self.capture_state(), force=True)
                if mem is not None:
                    mem.save(self.capture_state(), shared=self.replicated_keys())
        except BaseException as e:
            flight.dump("exception", error=repr(e), step=step)
            raise
        finally:
            stop_profile()
            flight.uninstall()
            if watchdog is not None:
                watchdog.close()
            if ckpt is not None:
                ckpt.close()
            telemetry.close()
        return model, optimizer, losses


# ------------------------------------------------------------------ graftcheck
#: The LM entries on a card: GPT-2-small through the flash and fused
#: cross-entropy kernels, in bf16 (the main path's LM at full width).
CARD_LM = dict(vocab_size=50304, num_layers=12, num_heads=12, d_model=768, d_ff=3072,
               max_seq_len=1024, seq_len=1024, global_batch_size=8, attention_impl="flash",
               fused_xent=True, compute_dtype="bfloat16", use_rope=False)


def make_lm_trace_entry(device: str = "cuda", **overrides):
    """A graftcheck ``TracedStep`` around the LM engine's real
    ``LMTrainer.train_step`` (the JAX ``make_lm_trace_entry``): a tiny
    transformer over the process group that exists (or a world of one) as
    pure data parallelism, the state the step updates in place, and the
    data-parallel wire's contract and the same byte accounting ``fit``
    writes to telemetry. ``overrides`` are ``LMConfig`` fields.

    The port's uncompressed data-parallel sync is bucketed (the all-reduce
    mean and the zero1/fsdp rules alike, ``sync_bucket_mb``), where the
    JAX LM syncs a tensor at a time: the contract is JAX's
    ``expected_collective_schedule`` over ``sync_units`` with this
    trainer's bucket size."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.trace.registry import (
        TracedStep,
        ensure_process_group,
    )
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.sync import (
        expected_collective_schedule,
        lm_strategy,
        sync_units,
        sync_wire_bytes,
    )

    ensure_process_group(resolve_device(device))
    n = dist.get_world_size()
    kw: dict[str, Any] = dict(
        vocab_size=64, num_layers=2, num_heads=2, d_model=32, d_ff=64, max_seq_len=16,
        seq_len=16, global_batch_size=2 * n, data_parallel=n, seq_parallel=1,
        attention_impl="dense", device=device,
    )
    kw.update(overrides)
    cfg = LMConfig(**kw)
    trainer = LMTrainer(cfg)
    trainer.init()
    rng = np.random.default_rng(cfg.seed)
    tokens = rng.integers(0, cfg.vocab_size, (cfg.global_batch_size, cfg.seq_len + 1))
    x, y = trainer.split_batch(tokens)

    shapes = (trainer._param_shapes if cfg.fsdp
              else [(tuple(p.shape), p.dtype) for p in trainer.optimizer.params])
    strategy = lm_strategy(cfg.zero1, cfg.fsdp, cfg.grad_compress)
    units = sync_units(shapes, strategy, n, bucket_bytes=trainer._bucket_bytes,
                       grad_compress=cfg.grad_compress, overlap=trainer._overlap)
    schedule = expected_collective_schedule(strategy, n, units, grad_compress=cfg.grad_compress)
    wire_bytes = sync_wire_bytes(shapes, strategy, n, cfg.grad_compress,
                                 bucket_bytes=trainer._bucket_bytes, overlap=trainer._overlap)

    def state() -> dict[str, list[torch.Tensor]]:
        mu, nu, _ = trainer._opt_state()
        return {"params": list(trainer.optimizer.params), "mu": list(mu), "nu": list(nu),
                "ef": list(trainer._ef)}

    # TA008's contract: fsdp keeps parameter and moment rows, zero1 moment rows.
    sharded = {}
    if cfg.zero1 or cfg.fsdp:
        sharded = {"mu": shapes, **({"nu": shapes} if cfg.optimizer != "sgd" else {})}
    if cfg.fsdp:
        sharded["params"] = shapes
    return TracedStep(
        name="lm",
        fn=lambda: trainer.train_step(x, y),
        state=state,
        args={"inputs": [x], "targets": [y], "buffers": list(trainer.model.buffers())},
        axis_sizes={"data": n},
        sync=strategy,
        grad_compress=cfg.grad_compress,
        compute_dtype=cfg.compute_dtype,
        expected_schedule=schedule,
        expected_wire_bytes=float(wire_bytes),
        check_donation=True,
        sharded_state=sharded,
        detail={"layers": cfg.num_layers, "d_model": cfg.d_model, "dp": n,
                "sync_overlap": cfg.sync_overlap, "attention_impl": cfg.attention_impl,
                "fused_xent": cfg.fused_xent, "seq_len": cfg.seq_len,
                "global_batch_size": cfg.global_batch_size},
    )


def _card_lm(device: str, **options) -> dict[str, Any]:
    """An entry's options, at ``CARD_LM``'s width on a card."""
    return {**CARD_LM, **options} if device.startswith("cuda") else options


def _lm_entry(device: str = "cuda"):
    return make_lm_trace_entry(device, **_card_lm(device))


def _lm_overlap_entry(device: str = "cuda"):
    # The pure-DP overlapped schedule needs the fixed-LR SGD recipe.
    return make_lm_trace_entry(device, **_card_lm(device, optimizer="sgd",
                                                  sync_overlap="bucket"))


def _lm_overlap_fsdp_entry(device: str = "cuda"):
    # Overlapped reduce-scatter schedule under fsdp: the forward gathers
    # parameters per reverse-order bucket, the gather's backward scatters
    # the gradients per bucket, and the sharded AdamW applies by rows.
    return make_lm_trace_entry(device, **_card_lm(device, fsdp=True, sync_overlap="bucket"))


def _register_lm_trace_entries() -> None:
    from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.trace.registry import (
        register_entrypoint,
    )

    register_entrypoint("lm", _lm_entry, tags=("lm",))
    register_entrypoint("lm-overlap", _lm_overlap_entry, tags=("lm", "overlap"))
    register_entrypoint("lm-overlap-fsdp", _lm_overlap_fsdp_entry,
                        tags=("lm", "overlap", "fsdp"))
