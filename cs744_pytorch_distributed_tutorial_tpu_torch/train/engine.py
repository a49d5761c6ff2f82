"""The training engine: one ``Trainer`` for every reference part.

The reference writes its trainer five times (part1, part2a, part2a_extra,
part2b, part3) as scripts that differ only in the gradient-sync section
of ``train_model`` (SURVEY §1). Here, as in the JAX package, one engine
takes the sync strategy as a plug-in (``parallel/sync.py``). Each rank is
one process driving one device. A step:

1. augmentation of the local uint8 batch on the device (``data/augment``);
2. forward + loss (CrossEntropy, mean over the local batch) with local
   BatchNorm batch statistics — the reference's data-parallel semantics;
3. ``backward()``;
4. the strategy's gradient averaging over the world (under ``auto``,
   ``DistributedDataParallel``'s reducer does it inside ``backward()``;
   ``allreduce`` and ``ring`` a bucket at a time);
5. the update: the reference's SGD(momentum, wd) through the fused CUDA
   kernel (``ops/fused_sgd.py``) when ``fused_optimizer`` is set, else
   the registry's recipe (``train/state.py``: SGD, AdamW or Lion, a
   schedule, a global-norm clip on the synced gradients). Every rank
   applies it to identical synced gradients.

``zero1`` and ``fsdp`` (``parallel/zero.py``) replace steps 4-5: zero1
reduce-scatters the local gradients, updates this rank's rows of
momentum and parameters and all-gathers the deltas; fsdp holds only its
rows of the parameters, gathers them for forward and backward
(``functional_call`` on the module, whose own parameters are released),
and its gather's backward reduce-scatters the gradients.

With ``accum_steps`` > 1, steps 2–4 run a microbatch at a time and the
gradients are summed, ``((0 + g1) + g2) ...``, then divided by the
count, as the JAX engine's scan: the float strategies (and DDP) sync
each microbatch, the int8 wire and the overlapped schedule sync once,
after accumulation. ``grad_compress="int8"`` replaces step 4 with the
int8 wire and its per-rank error feedback (``sync_grads_compressed``);
``sync_overlap`` replaces steps 4–5 with the overlapped schedule
(``parallel/overlap.py``): each bucket's collective fires from gradient
hooks as backward completes it, and SGD is applied a bucket at a time.

BatchNorm running statistics stay per replica, as in the reference's
manual parts and the JAX package: DDP is built with
``broadcast_buffers=False``. ``sync_bn`` takes the world's batch
statistics instead (``models/batchnorm.py``); its all-reduces run in
forward and backward, in the same order on every rank. With
``debug_sync_check`` each rank's checksum of its synced gradients (zero1:
its parameters) is all-gathered every step and checked at each epoch's
end (``utils/debug.py``).

``fit`` wraps the epoch loop in the JAX engine's run loop: batches
prefetched a producer thread ahead (``data/prefetch.py``), two recovery
tiers (disk checkpoints, ``utils/checkpoint.py``; host-RAM snapshots,
``utils/memstore.py``) with mid-epoch resume, a step watchdog and a
non-finite-loss halt (``utils/failure.py``), the metric stream and run
manifest (``obs/metrics.py``), the flight recorder (``obs/flight.py``)
and a profiler window (``utils/profiling.py``).
"""

from __future__ import annotations

import contextlib
import logging
import math
import os
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.nn.parallel import DistributedDataParallel

from cs744_pytorch_distributed_tutorial_tpu_torch.config import (
    TrainConfig,
    resolve_device,
    resolve_dtype,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.data import BatchLoader, load_cifar10
from cs744_pytorch_distributed_tutorial_tpu_torch.data.augment import (
    augment_train_batch,
    eval_batch,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.data.prefetch import PrefetchIterator, prefetch
from cs744_pytorch_distributed_tutorial_tpu_torch.models import get_model
from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import shard_row
from cs744_pytorch_distributed_tutorial_tpu_torch.native import native_available
from cs744_pytorch_distributed_tutorial_tpu_torch.obs.flight import (
    FlightRecorder,
    HbmHighWater,
    StragglerMonitor,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.obs.flops import (
    resnet18_cifar_train_flops_per_sample,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.obs.metrics import Telemetry, tree_l2_norm
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import collectives as C
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.mesh import rank_device, world
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.overlap import (
    OVERLAP_MODES,
    OverlappedSGD,
    OverlappedZero1,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.sync import (
    UNCHECKED_REPLICATION,
    get_sync,
    sync_grads,
    sync_grads_compressed,
    sync_wire_bytes,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.zero import FsdpSGD, Zero1SGD
from cs744_pytorch_distributed_tutorial_tpu_torch.train.state import (
    Optimizer,
    TrainState,
    check_recipe,
    is_reference_recipe,
    make_optimizer,
    make_schedule,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.utils import profiling
from cs744_pytorch_distributed_tutorial_tpu_torch.utils.debug import (
    DivergenceMonitor,
    tree_checksum,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.utils.checkpoint import Checkpointer, to_host
from cs744_pytorch_distributed_tutorial_tpu_torch.utils.failure import (
    NonFiniteLossError,
    StepWatchdog,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.utils.memstore import ReplicatedSnapshot
from cs744_pytorch_distributed_tutorial_tpu_torch.utils.timing import StepTimer

log = logging.getLogger("cs744_pytorch_distributed_tutorial_tpu_torch")


def _load_dataset(cfg: TrainConfig):
    return load_cifar10(
        cfg.data_root,
        synthetic=cfg.synthetic_data,
        synthetic_train_size=cfg.synthetic_train_size,
        synthetic_test_size=cfg.synthetic_test_size,
        image_size=cfg.image_size,
        num_classes=cfg.num_classes,
    )


def _smoothed_xent(
    logits: torch.Tensor, labels: torch.Tensor, smoothing: float
) -> torch.Tensor:
    """Mean CE against the (1-s) one-hot + s/K smoothed target; s=0 is the
    reference's CrossEntropyLoss."""
    return F.cross_entropy(logits, labels, label_smoothing=smoothing)


class Trainer:
    """One engine, pluggable sync strategies.

    The process group, when the strategy needs one, is initialized before
    the trainer is built (``parallel/mesh.py::initialize``); its world
    size is the data-parallel degree. ``memstore`` is the in-memory
    snapshot tier; without one, ``cfg.snapshot_every`` builds it.
    """

    def __init__(self, cfg: TrainConfig, memstore: ReplicatedSnapshot | None = None):
        self.cfg = cfg
        if memstore is None and cfg.snapshot_every:
            memstore = ReplicatedSnapshot(max_to_keep=cfg.snapshot_keep)
        self.memstore = memstore
        self.world_size, self.rank = world()
        self.device = rank_device(resolve_device(cfg.device), self.rank)
        if cfg.num_devices is not None and cfg.num_devices != self.world_size:
            raise ValueError(
                f"num_devices={cfg.num_devices} but the process group has world "
                f"size {self.world_size}; launch one process per rank"
            )
        get_sync(cfg.sync)
        if cfg.sync == "none" and self.world_size > 1:
            raise ValueError(
                "sync='none' (part1 semantics) requires a world of one; "
                f"got {self.world_size}. Pick a sync strategy."
            )
        if cfg.global_batch_size % self.world_size:
            raise ValueError(
                f"global batch {cfg.global_batch_size} not divisible by "
                f"world size {self.world_size}"
            )
        if not 0.0 <= cfg.label_smoothing < 1.0:
            raise ValueError(
                f"label_smoothing must be in [0, 1), got {cfg.label_smoothing}"
            )
        per_rank = cfg.global_batch_size // self.world_size
        if cfg.accum_steps < 1 or per_rank % cfg.accum_steps:
            raise ValueError(
                f"accum_steps {cfg.accum_steps} must divide the per-rank "
                f"batch shard ({per_rank})"
            )
        if cfg.sync_bn and not (cfg.model.startswith(("vgg", "resnet"))
                                or cfg.model == "tiny_cnn"):
            raise ValueError(
                f"sync_bn applies to BatchNorm models only; {cfg.model!r} has no BN layers"
            )
        self._vit = cfg.model.startswith("vit")
        vit_kw = self._vit_options(cfg)
        self._zero1, self._fsdp = cfg.sync == "zero1", cfg.sync == "fsdp"
        if (self._zero1 or self._fsdp) and cfg.fused_optimizer:
            raise ValueError(
                f"sync={cfg.sync!r} shards the optimizer state and supplies its own "
                "update; it cannot combine with fused_optimizer"
            )
        if (self._zero1 or self._fsdp or cfg.fused_optimizer) and not is_reference_recipe(cfg):
            raise ValueError(
                f"optimizer={cfg.optimizer!r}/lr_schedule={cfg.lr_schedule!r}/"
                f"warmup_steps={cfg.warmup_steps}/grad_clip_norm={cfg.grad_clip_norm} "
                "require the registry's optimizer path (train/state.py::make_optimizer); "
                f"sync={cfg.sync!r} fused_optimizer={cfg.fused_optimizer} hard-code "
                "unclipped SGD(momentum) at a fixed lr"
            )
        self._check_sync_options(cfg)
        check_recipe(cfg)
        if cfg.hang_action not in ("log", "abort", "escalate"):
            raise ValueError(
                f"unknown hang_action {cfg.hang_action!r}; choose 'log', "
                "'abort', or 'escalate'"
            )
        if cfg.prefetch_depth < 0:
            raise ValueError(f"prefetch_depth must be >= 0, got {cfg.prefetch_depth}")
        if cfg.debug_sync_check and self._fsdp:
            raise ValueError(
                "debug_sync_check is meaningless under sync='fsdp': each rank's "
                "parameters are its own shards and the only replicated values are "
                "all-gather outputs, equal by construction; check replication under "
                "zero1 or a replicated strategy instead"
            )
        if cfg.sync != "none" and not dist.is_initialized():
            raise ValueError(
                f"sync={cfg.sync!r} communicates through torch.distributed: "
                "initialize a process group first (parallel.mesh.initialize)"
            )
        self.compute_dtype = resolve_dtype(cfg.compute_dtype)
        if self._zero1 or self._fsdp:
            cls = FsdpSGD if self._fsdp else Zero1SGD
            self.tx = cls(cfg.learning_rate, cfg.momentum, cfg.weight_decay, self.world_size,
                          bucket_bytes=self._bucket_bytes, overlap=self._overlap)
        else:
            self.tx = make_optimizer(cfg)

        model_kw: dict[str, Any] = {} if self._vit else {"sync_bn": cfg.sync_bn}
        if cfg.model.startswith("resnet"):
            use_imagenet_stem = (
                cfg.image_size > 64
                if cfg.imagenet_stem is None
                else cfg.imagenet_stem
            )
            model_kw.update(cifar_stem=not use_imagenet_stem, fast_conv=cfg.fast_conv)
        elif cfg.fast_conv:
            raise ValueError(
                f"fast_conv routes ResNet 3x3 convs; {cfg.model!r} has none"
            )
        else:
            model_kw["image_size"] = cfg.image_size
        model_kw.update(vit_kw)
        gen = torch.Generator().manual_seed(cfg.seed)
        self.model = get_model(
            cfg.model, num_classes=cfg.num_classes, generator=gen, **model_kw
        ).to(self.device)
        self.params = list(self.model.parameters())
        # part3: DDP averages the gradients inside backward(); its
        # construction also broadcasts rank 0's parameters.
        self.forward_module = self.model
        if cfg.sync == "auto":
            self.forward_module = DistributedDataParallel(
                self.model,
                device_ids=[self.device.index] if self.device.type == "cuda" else None,
                broadcast_buffers=False,
            )
        momentum = self.tx.init(self.params)
        ef = ([torch.zeros_like(p, dtype=torch.float32) for p in self.params]
              if self._compress else [])
        if self._fsdp:
            self._shard_model()
        self.state = TrainState(step=0, params=self.params, momentum=momentum, ef=ef)
        self.overlap = None
        if self._overlap and self._zero1:
            self.overlap = OverlappedZero1(self.params, momentum, ef or None, self.tx)
        elif self._overlap and not self._fsdp:
            self.overlap = OverlappedSGD(
                self.params, momentum, ef if self._compress else None,
                name=cfg.sync, world_size=self.world_size, lr=cfg.learning_rate,
                mu=cfg.momentum, wd=cfg.weight_decay, bucket_bytes=self._bucket_bytes,
            )
        self.sync_monitor = DivergenceMonitor() if cfg.debug_sync_check else None
        # Crop/flip randomness per rank, seeded from (seed, rank).
        seed = int(np.random.SeedSequence([cfg.seed, self.rank]).generate_state(1)[0])
        self.augment_gen = torch.Generator().manual_seed(seed)
        # The state fit() starts over from when it is entered again with
        # no tier to restore (JAX's fit re-initializes): kept on the host
        # at the first fit, only when a recovery tier exists.
        self._initial_state: dict | None = None
        self._fits = 0
        # Batches fit's loaders assembled with the native gather.
        self.native_batches = 0

    def _vit_options(self, cfg: TrainConfig) -> dict[str, Any]:
        """The JAX Trainer's rules for ``dropout_rate`` and ``vit_attention``
        (its ``engine.py:173-207``), and the ViT's own model options: its
        compute dtype (the family casts explicitly, without autocast), its
        dropout rate and its attention."""
        if not 0.0 <= cfg.dropout_rate < 1.0:
            raise ValueError(f"dropout_rate must be in [0, 1), got {cfg.dropout_rate}")
        kw: dict[str, Any] = {"dtype": resolve_dtype(cfg.compute_dtype)} if self._vit else {}
        if cfg.dropout_rate:
            if not self._vit:
                raise ValueError(
                    f"dropout_rate applies to the ViT family; {cfg.model!r} follows the "
                    "reference (no dropout)")
            kw["dropout_rate"] = cfg.dropout_rate
        if cfg.vit_attention is not None:
            if not self._vit:
                raise ValueError(
                    f"vit_attention applies to the ViT family; {cfg.model!r} has no attention")
            if cfg.vit_attention not in ("dense", "flash"):
                raise ValueError(
                    f"vit_attention must be 'dense' or 'flash', got {cfg.vit_attention!r}")
            if cfg.vit_attention == "flash" and cfg.sync not in UNCHECKED_REPLICATION | {"none"}:
                # The JAX package's limit (its shard_map's replication check
                # cannot see through the Pallas kernel), kept so that the
                # port refuses what JAX refuses.
                raise ValueError(
                    "vit_attention='flash' requires an explicit-sync strategy "
                    f"{sorted(UNCHECKED_REPLICATION)} or 'none' (got sync={cfg.sync!r}: its "
                    "replication analysis cannot see through the Pallas kernel)")
            kw["attention_impl"] = cfg.vit_attention
        return kw

    def _dropout_key(self, microbatch: int) -> tuple[int, ...] | None:
        """The ViT's dropout key of this step's ``microbatch``: (seed, step,
        microbatch), then this rank above rank 0 (each data rank draws its
        own masks; rank 0 keeps the one-device key, as the LM's). None
        without dropout."""
        if not (self._vit and self.cfg.dropout_rate > 0.0):
            return None
        key = (self.cfg.seed, int(self.state.step), microbatch)
        return key + (self.rank,) if self.rank else key

    def _shard_model(self) -> None:
        """FSDP: keep this rank's rows of each parameter (``self.params``)
        and release the module's own tensors; forward and backward take
        the gathered tensors through ``functional_call``."""
        self._param_names = [name for name, _ in self.model.named_parameters()]
        self._param_shapes = [(tuple(p.shape), p.dtype) for p in self.params]
        shards = self.tx.shard_params(self.params)
        for name in self._param_names:
            module_name, _, attr = name.rpartition(".")
            setattr(self.model.get_submodule(module_name), attr,
                    nn.Parameter(torch.empty(0, device=self.device), requires_grad=False))
        self.params = shards

    def _full_params(self) -> dict[str, torch.Tensor]:
        """FSDP: the gathered parameters by name (differentiable)."""
        full = self.tx.gather_params(self.params, self._param_shapes)
        return dict(zip(self._param_names, full))

    def _forward(self, x: torch.Tensor, drop_key: tuple[int, ...] | None = None) -> torch.Tensor:
        kw = {} if drop_key is None else {"dropout": drop_key}
        if self._fsdp:
            return functional_call(self.model, self._full_params(), (x,), kw)
        return self.forward_module(x, **kw)

    def state_dict(self) -> dict[str, torch.Tensor]:
        """The model's full state dict; under FSDP its parameters are
        gathered, a collective every rank must join."""
        sd = self.model.state_dict()
        if self._fsdp:
            with torch.no_grad():
                sd.update({k: v.clone() for k, v in self._full_params().items()})
        return sd

    @torch.no_grad()
    def load_state_dict(self, state_dict: dict) -> None:
        """Load a full state dict; under FSDP each parameter's rows for
        this rank go to its shard (``models/convert.py::shard_row``)."""
        if not self._fsdp:
            self.model.load_state_dict(state_dict)
            return
        for name, buf in self.model.named_buffers():
            buf.copy_(state_dict[name])
        for name, shard in zip(self._param_names, self.params):
            shard.copy_(shard_row(state_dict[name], self.rank, self.world_size))

    def _check_sync_options(self, cfg: TrainConfig) -> None:
        """The JAX engine's checks of the wire options (its
        ``engine.py:253-392``)."""
        if cfg.sync_bucket_mb < 0:
            raise ValueError(f"sync_bucket_mb must be >= 0, got {cfg.sync_bucket_mb}")
        self._bucket_bytes = int(cfg.sync_bucket_mb * 2**20)
        if cfg.grad_compress not in ("none", "int8"):
            raise ValueError(
                f"unknown grad_compress {cfg.grad_compress!r}; choose 'none' or 'int8'"
            )
        # Naming an int8_* strategy implies compression; either way the
        # sync keeps its residual as per-rank error feedback.
        self._compress = cfg.grad_compress == "int8" or cfg.sync in (
            "int8_allreduce", "int8_ring")
        if self._compress:
            if cfg.sync == "zero1" and cfg.sync_overlap == "bucket+int8":
                pass  # zero1's int8 wire lives on its overlapped reverse buckets
            elif cfg.sync == "fsdp":
                raise ValueError(
                    "grad_compress='int8' cannot ride sync='fsdp': its gradient "
                    "reduction is the backward of the parameter all-gather, so there "
                    "is no separate grad-sync pass to quantize; for a quantized "
                    "sharded-optimizer wire use sync='zero1' with "
                    "sync_overlap='bucket+int8'"
                )
            elif cfg.sync not in ("allreduce", "ring", "int8_allreduce", "int8_ring"):
                raise ValueError(
                    "grad_compress='int8' applies to the flat allreduce syncs only "
                    "(allreduce, ring, int8_allreduce, int8_ring) or sync='zero1' with "
                    f"sync_overlap='bucket+int8'; sync={cfg.sync!r} either has no "
                    "grad-sync pass to compress (auto/none, zero1 without the "
                    "overlapped schedule) or exists to teach an uncompressed wire "
                    "shape (gather_scatter, p2p_star)"
                )
            if cfg.fused_optimizer:
                raise ValueError(
                    "grad_compress='int8' does not compose with fused_optimizer (the "
                    "compressed sync hands back bucket-dequantized gradients plus "
                    "error-feedback state the fused update does not carry)"
                )
        if cfg.sync_overlap not in OVERLAP_MODES:
            raise ValueError(
                f"unknown sync_overlap {cfg.sync_overlap!r}; choose from {OVERLAP_MODES}"
            )
        self._overlap = cfg.sync_overlap != "off"
        if not self._overlap:
            return
        if cfg.fused_optimizer:
            raise ValueError(
                f"sync_overlap={cfg.sync_overlap!r} replaces the whole-model update "
                "with per-bucket updates; fused_optimizer names the whole-model "
                "update and cannot combine"
            )
        if not is_reference_recipe(cfg):
            raise ValueError(
                "sync_overlap applies the reference's fixed-lr SGD(momentum) per "
                f"bucket; optimizer={cfg.optimizer!r}/lr_schedule={cfg.lr_schedule!r}/"
                f"warmup_steps={cfg.warmup_steps}/grad_clip_norm={cfg.grad_clip_norm} "
                "need the whole-model update (a global clip or schedule state cannot "
                "be applied bucket-locally)"
            )
        if cfg.sync_overlap == "bucket":
            if self._compress or cfg.sync not in ("allreduce", "ring", "zero1", "fsdp"):
                raise ValueError(
                    "sync_overlap='bucket' overlaps the float bucketed wire: requires "
                    "sync in ('allreduce', 'ring', 'zero1', 'fsdp') and "
                    f"grad_compress='none' (got sync={cfg.sync!r}, "
                    f"grad_compress={cfg.grad_compress!r}; for the quantized wire use "
                    "sync_overlap='bucket+int8')"
                )
        elif not self._compress:
            raise ValueError(
                "sync_overlap='bucket+int8' overlaps the int8+EF compressed wire: "
                "requires grad_compress='int8' or an int8_* sync strategy (got "
                f"sync={cfg.sync!r}, grad_compress={cfg.grad_compress!r})"
            )

    def _autocast(self):
        # The ViT casts to its compute dtype itself, as the LM does.
        if self.compute_dtype == torch.float32 or self._vit:
            return contextlib.nullcontext()
        return torch.autocast(self.device.type, dtype=self.compute_dtype)

    # ------------------------------------------------------------------ step
    def train_step(self, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """One step on this rank's uint8 NHWC batch; returns the local
        loss (a 0-dim tensor on the device, not fetched): with
        accumulation, the mean of the microbatches' losses."""
        cfg = self.cfg
        x = (
            augment_train_batch(self.augment_gen, images)
            if cfg.augment
            else eval_batch(images)
        )
        self.model.train()
        accum = cfg.accum_steps
        # Float strategies sync every microbatch (DDP inside backward);
        # the int8 wire, the overlapped schedule and zero1 once, after the
        # sum; fsdp's sync is its gather's backward, every microbatch.
        sync_each = cfg.sync not in ("auto", "zero1", "fsdp") and not (
            self._compress or self._overlap)
        g_sum = loss_sum = None
        for k, (xm, ym) in enumerate(zip(x.chunk(accum), labels.chunk(accum))):
            last = k == accum - 1
            if self.overlap is not None and last:
                self.overlap.begin(g_sum, accum)
            with self._autocast():
                logits = self._forward(xm, self._dropout_key(k))
            loss = _smoothed_xent(logits.float(), ym, cfg.label_smoothing)
            for p in self.params:
                p.grad = None
            loss.backward()
            loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
            if self.overlap is not None and last:
                break
            grads = [p.grad for p in self.params]
            if sync_each:
                sync_grads(grads, cfg.sync, self.world_size, self._bucket_bytes)
            if accum > 1:
                g_sum = [(torch.zeros_like(g) if g_sum is None else g_sum[i]) + g
                         for i, g in enumerate(grads)]
        if self.overlap is not None:
            self.overlap.finish()
        else:
            if accum > 1:
                grads = [g / accum for g in g_sum]
                for p, g in zip(self.params, grads):
                    p.grad = g
            if self._compress:
                sync_grads_compressed(grads, self.state.ef, cfg.sync, self.world_size,
                                      bucket_bytes=self._bucket_bytes)
            self.tx.apply(self.params, self.state.momentum, grads)
        if self.sync_monitor is not None:
            self._record_checksum()
        self.state.step += 1
        return loss_sum / accum if accum > 1 else loss_sum

    @torch.no_grad()
    def _record_checksum(self) -> None:
        """Every rank's checksum of its synced gradients (zero1, which
        never forms them: of its updated parameters), all-gathered."""
        tensors = self.params if self._zero1 else [p.grad for p in self.params]
        local = tree_checksum(tensors).reshape(1)
        every = C.all_gather_flat(local) if dist.is_initialized() else local
        self.sync_monitor.record_world(self.state.step, every.reshape(-1))

    def global_mean(self, local: torch.Tensor) -> float:
        """Mean of a per-rank scalar over the world, fetched to the host."""
        if self.world_size > 1:
            local = local / self.world_size
            dist.all_reduce(local)
        return float(local)

    # ------------------------------------------------------------ state
    @torch.no_grad()
    def capture_state(self, *, clone: bool = False) -> dict[str, Any]:
        """Everything a bitwise resume needs, as a dict of tensors and
        scalars (the checkpoint's and the snapshot's content): the step,
        the world size, this rank's parameters (under fsdp its rows),
        momentum and error feedback, the BatchNorm buffers, the
        registry optimizer's count and second moments, and the
        augmentation generator's state. ``clone`` copies the tensors on
        their device (the pending/certify gate holds a state across the
        next step, which updates the live tensors in place)."""
        take = (lambda t: t.detach().clone()) if clone else (lambda t: t.detach())
        opt = self.tx if isinstance(self.tx, Optimizer) else None
        return {
            "step": int(self.state.step),
            "world_size": self.world_size,
            "params": [take(p) for p in self.state.params],
            "momentum": [take(m) for m in self.state.momentum],
            "ef": [take(e) for e in self.state.ef],
            "buffers": {n: take(b) for n, b in self.model.named_buffers()},
            "opt_count": None if opt is None else opt.count,
            "opt_nu": [] if opt is None else [take(v) for v in opt.nu],
            "augment_gen": self.augment_gen.get_state(),
        }

    @torch.no_grad()
    def restore_state(self, state: dict[str, Any]) -> None:
        """Load ``capture_state``'s dict by copying into the live tensors:
        DDP, the overlapped schedules and fsdp's shards hold references
        to them, so they are never rebound."""
        if state["world_size"] != self.world_size:
            raise ValueError(
                f"state saved by a world of {state['world_size']} ranks cannot load "
                f"into a world of {self.world_size}: restoring onto another world "
                "size needs the elastic restore (the JAX package's "
                "utils/checkpoint.py adapt), which the port does not have yet"
            )
        groups = [(self.state.params, state["params"]), (self.state.momentum, state["momentum"]),
                  (self.state.ef, state["ef"])]
        opt = self.tx if isinstance(self.tx, Optimizer) else None
        if opt is not None:
            groups.append((opt.nu, state["opt_nu"]))
        for live, saved in groups:
            if len(live) != len(saved) or any(a.shape != b.shape for a, b in zip(live, saved)):
                raise ValueError("saved state does not match this trainer's configuration")
            for dst, src in zip(live, saved):
                dst.copy_(src)
        for name, buf in self.model.named_buffers():
            buf.copy_(state["buffers"][name])
        if opt is not None:
            opt.count = int(state["opt_count"])
        self.augment_gen.set_state(state["augment_gen"])
        self.state.step = int(state["step"])

    # ------------------------------------------------------------------ loops
    def _loaders(self, dataset) -> tuple[BatchLoader, BatchLoader]:
        cfg = self.cfg
        kw = dict(device=self.device, world_size=self.world_size, rank=self.rank)
        train = BatchLoader(dataset.train_images, dataset.train_labels, cfg.global_batch_size,
                            shuffle=True, seed=cfg.seed, **kw)
        test = BatchLoader(dataset.test_images, dataset.test_labels, cfg.global_batch_size,
                           shuffle=False, drop_last=False, **kw)
        return train, test

    def _telemetry(self) -> tuple[Telemetry, int]:
        """The run's Telemetry (manifest written) and its analytic wire
        bytes a step."""
        cfg = self.cfg
        flops_per_step = None
        if cfg.model == "resnet18":
            flops_per_step = resnet18_cifar_train_flops_per_sample() * cfg.global_batch_size
        # The float strategies sync each microbatch; the int8 wire, zero1
        # and the overlapped schedule once a step (fsdp gathers and
        # scatters each microbatch, overlapped or not).
        syncs = (1 if (self._compress or self._zero1 or (self._overlap and not self._fsdp))
                 else cfg.accum_steps)
        shapes = self._param_shapes if self._fsdp else self.params
        wire_bytes = syncs * sync_wire_bytes(shapes, cfg.sync, self.world_size, cfg.grad_compress,
                                             bucket_bytes=self._bucket_bytes,
                                             overlap=self._overlap)
        on_card = self.device.type == "cuda"
        telemetry = Telemetry(
            cfg.metrics_dir, every=cfg.metrics_every or cfg.log_every, run="cifar",
            flops_per_step=flops_per_step, n_chips=self.world_size,
            device_kind=torch.cuda.get_device_name(self.device) if on_card else "cpu",
            device=self.device,
        )
        telemetry.write_manifest(config=cfg, grad_sync_bytes_per_step=wire_bytes,
                                 native_gather=native_available("batcher"))
        return telemetry, wire_bytes

    def fit(
        self, dataset=None, epochs: int | None = None
    ) -> tuple[TrainState, dict[str, Any]]:
        """The reference's epoch loop (``master/part1/part1.py:101-103``)
        with its three signals (loss every ``log_every`` batches, the
        average per-batch time over the timing window, eval after each
        epoch) inside the JAX engine's run loop, step for step: telemetry
        and manifest; the flight recorder; the restore tiers (the newer
        wins, memory on a tie) and a resume mid-epoch; the watchdog
        (the first step, which builds the kernels, exempt); the pending/
        certify gate in front of checkpoints and snapshots; the profiler
        window; the loss fetched only where timing, logging, telemetry or
        the gate needs it (the non-finite check and the step records ride
        that fetch); a forced save at the end."""
        cfg = self.cfg
        if dataset is None:
            dataset = _load_dataset(cfg)
        train_loader, test_loader = self._loaders(dataset)
        telemetry, wire_bytes = self._telemetry()
        lr_at = make_schedule(cfg)
        obs_norms = not (self._zero1 or self._fsdp)  # they never form the synced grads

        straggler = StragglerMonitor()
        flight = FlightRecorder(telemetry=telemetry, straggler=straggler,
                                hbm=HbmHighWater([self.device] if self.device.type == "cuda" else []))
        flight.install()

        history: dict[str, Any] = {"train_loss": [], "eval": [], "avg_batch_time": None}
        timer = StepTimer(window=cfg.timing_batches, device=self.device)
        mem = self.memstore
        ckpt = Checkpointer(cfg.checkpoint_dir) if cfg.checkpoint_dir else None
        if self._fits == 0 and (ckpt is not None or mem is not None):
            self._initial_state = to_host(self.capture_state())
        self._fits += 1
        mem_step = mem.latest_step() if mem is not None else None
        disk_step = ckpt.latest_step() if ckpt is not None else None
        restored = source = None
        if mem_step is not None and (disk_step is None or disk_step <= mem_step):
            restored, source = mem.restore_latest(), "memory"
        elif disk_step is not None:
            restored, source = ckpt.restore_latest(), "disk"
        steps_per_epoch = len(train_loader)
        if restored is not None:
            self.restore_state(restored)
            telemetry.emit_event("restore", source=source, step=self.state.step)
        elif self._fits > 1 and self._initial_state is not None:
            self.restore_state(self._initial_state)
        steps_done = self.state.step
        start_epoch = steps_done // max(steps_per_epoch, 1)
        if restored is not None:
            log.info("restored %s state at step %d (resuming at epoch %d)",
                     source, steps_done, start_epoch)

        watchdog = None
        if cfg.step_timeout_s:
            on_hang = None
            if cfg.hang_action in ("abort", "escalate"):
                # A wedged device fetch cannot be unblocked from inside the
                # process: exit so a supervisor restarts the job, which
                # resumes from the newest checkpoint.
                def on_hang(elapsed_s: float) -> None:
                    os._exit(13)

            watchdog = StepWatchdog(
                cfg.step_timeout_s, on_hang=on_hang, metric_ring=telemetry.ring,
                flight_recorder=flight,
                escalation=("warn", "dump", "abort") if cfg.hang_action == "escalate" else None,
            )

        # Mid-epoch resume: the restored state holds the epoch's first
        # steps_done % steps_per_epoch batches; the loader's start skips
        # them by index arithmetic (its order is a function of seed and
        # epoch), so none is replayed.
        resume_skip = steps_done % steps_per_epoch if steps_per_epoch else 0

        def guarded_save(state: dict, *, force: bool = False) -> None:
            """A save under a widened watchdog window."""
            if watchdog is not None:
                watchdog.arm(cfg.step_timeout_s * 10)
            try:
                ckpt.save(state, force=force)
            finally:
                if watchdog is not None:
                    watchdog.disarm()

        # Under halt_on_nonfinite a due checkpoint or snapshot is held as
        # (step, state cloned on the device, to disk, to memory) and
        # persisted once the next fetched loss (the forward pass over
        # those parameters) comes back finite: neither tier ever holds a
        # state whose own forward pass diverged.
        pending: tuple[int, dict, bool, bool] | None = None

        def certify() -> None:
            nonlocal pending
            _, pstate, to_disk, to_mem = pending
            if to_disk:
                guarded_save(pstate)
            if to_mem:
                mem.save(pstate)
            pending = None

        compile_pending = True  # the first step builds the kernels: not watched
        capture: profiling.Trace | None = None

        def stop_profile(fence: bool) -> None:
            nonlocal capture
            if capture is None:
                return
            if fence and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            capture.stop()
            capture = None

        prev_mono = None  # per-step wall clock for the straggler ring
        source_iter = None
        try:
            for epoch in range(start_epoch, epochs if epochs is not None else cfg.epochs):
                timer.start()
                skip = resume_skip if epoch == start_epoch else 0
                source_iter = prefetch(train_loader.epoch(epoch, start=skip),
                                       cfg.prefetch_depth, self.device)
                batch_iter = enumerate(source_iter, start=skip)
                while True:
                    # The armed window covers the batch's acquisition: a
                    # wedged card blocks the producer's copy and this
                    # thread then waits on the queue.
                    arm_now = watchdog is not None and not compile_pending
                    if arm_now:
                        watchdog.arm()
                    fetch_ctx = (profiling.annotate("input_fetch") if capture is not None
                                 else contextlib.nullcontext())
                    try:
                        with fetch_ctx:
                            batch_idx, (x, y) = next(batch_iter)
                    except StopIteration:
                        if arm_now:
                            watchdog.disarm()
                        stop_profile(True)  # never trace the eval or a save
                        break
                    if (cfg.profile_dir and capture is None and cfg.profile_start_step
                            <= steps_done < cfg.profile_start_step + cfg.profile_num_steps):
                        capture = profiling.Trace(cfg.profile_dir)
                        capture.start()
                    step_ctx = (profiling.step_annotation("train", steps_done)
                                if capture is not None else contextlib.nullcontext())
                    with step_ctx:
                        loss_t = self.train_step(x, y)
                    compile_pending = False
                    if (capture is not None and steps_done + 1
                            >= cfg.profile_start_step + cfg.profile_num_steps):
                        stop_profile(True)
                    timing_active = timer.steps_recorded <= cfg.timing_batches[1]
                    should_log = batch_idx % cfg.log_every == 0
                    metrics_due = telemetry.due(steps_done)
                    checkpoint_due = bool(ckpt and cfg.checkpoint_every
                                          and (steps_done + 1) % cfg.checkpoint_every == 0)
                    snapshot_due = bool(mem is not None and cfg.snapshot_every
                                        and (steps_done + 1) % cfg.snapshot_every == 0)
                    if timing_active or should_log or metrics_due or pending is not None:
                        sync_enter_wall, sync_enter_mono = time.time(), time.monotonic()
                        loss = self.global_mean(loss_t)
                        sync_exit_wall, sync_exit_mono = time.time(), time.monotonic()
                        if watchdog is not None:
                            watchdog.disarm()  # the fetch is where a hang shows
                        if cfg.halt_on_nonfinite and not math.isfinite(loss):
                            telemetry.emit_event("non_finite_loss", step=steps_done, loss=loss)
                            raise NonFiniteLossError(steps_done, loss)
                        if metrics_due:
                            norms = {}
                            if obs_norms:
                                norms = {
                                    "grad_norm": float(tree_l2_norm([p.grad for p in self.params])),
                                    "param_norm": float(tree_l2_norm(self.params)),
                                }
                            telemetry.emit_step(
                                steps_done, loss=loss, epoch=epoch, batch=batch_idx,
                                lr=float(lr_at(steps_done)), grad_sync_bytes=wire_bytes,
                                sync_enter_wall=sync_enter_wall,
                                sync_enter_mono=sync_enter_mono,
                                sync_exit_wall=sync_exit_wall, sync_exit_mono=sync_exit_mono,
                                **norms,
                            )
                        if pending is not None and steps_done == pending[0]:
                            certify()  # this loss is the pending state's forward pass
                    elif watchdog is not None:
                        watchdog.disarm()
                    if timing_active:
                        timer.tick()
                        if timer.steps_recorded == cfg.timing_batches[1] + 1:
                            history["avg_batch_time"] = timer.window_average()
                            log.info("average time:  %f", history["avg_batch_time"])
                    if should_log:
                        history["train_loss"].append((epoch, batch_idx, loss))
                        log.info("%d loss:  %f", batch_idx, loss)
                    # Straggler ring: the wall time between iterations
                    # (launches are asynchronous, so a slow step shows at
                    # the next fetch or as queue back-pressure).
                    now_mono = time.monotonic()
                    if prev_mono is not None:
                        outlier = straggler.record(steps_done, now_mono - prev_mono)
                        if outlier is not None:
                            telemetry.emit_event("straggler", **outlier)
                    prev_mono = now_mono
                    steps_done += 1
                    if checkpoint_due or snapshot_due:
                        if cfg.halt_on_nonfinite:
                            pending = (steps_done, self.capture_state(clone=True),
                                       checkpoint_due, snapshot_due)
                        else:
                            if checkpoint_due:
                                guarded_save(self.capture_state())
                            if snapshot_due:
                                mem.save(self.capture_state())
                if self.sync_monitor is not None:
                    bad = self.sync_monitor.divergent_steps()
                    telemetry.emit_event(
                        "divergence_check", epoch=epoch,
                        steps_checked=self.sync_monitor.steps_recorded,
                        divergent_steps=len(bad), in_sync=not bad,
                    )
                    log.info("divergence check: %d steps, %d divergent",
                             self.sync_monitor.steps_recorded, len(bad))
                    self.sync_monitor.assert_in_sync()
                metrics = self.evaluate(test_loader, watchdog=watchdog)
                history["eval"].append(metrics)
                telemetry.emit_event("eval", epoch=epoch, step=steps_done,
                                     avg_loss=metrics["avg_loss"], accuracy=metrics["accuracy"])
                log.info(
                    "Test set: Average loss: %.4f, Accuracy: %d/%d (%.0f%%)",
                    metrics["avg_loss"], metrics["correct"], metrics["count"],
                    100.0 * metrics["accuracy"],
                )
                if cfg.halt_on_nonfinite and not math.isfinite(metrics["avg_loss"]):
                    raise NonFiniteLossError(steps_done, metrics["avg_loss"])
                if pending is not None and steps_done == pending[0]:
                    certify()  # the eval loss certified the state the epoch ended on
            if ckpt is not None:
                guarded_save(self.capture_state(), force=True)
            if mem is not None:
                mem.save(self.capture_state())
            if (cfg.profile_dir and cfg.profile_num_steps
                    and steps_done <= cfg.profile_start_step):
                log.warning(
                    "profile window [%d, %d) never opened: run ended after %d steps; "
                    "lower profile_start_step",
                    cfg.profile_start_step, cfg.profile_start_step + cfg.profile_num_steps,
                    steps_done,
                )
        except BaseException as e:
            flight.dump("exception", error=repr(e), step=steps_done)
            raise
        finally:
            if isinstance(source_iter, PrefetchIterator):
                source_iter.close()
            stop_profile(False)
            flight.uninstall()
            if watchdog is not None:
                watchdog.close()
            if ckpt is not None:
                ckpt.close()
            telemetry.close()
            self.native_batches += train_loader.native_batches + test_loader.native_batches
        return self.state, history

    def evaluate_only(self, dataset=None) -> dict[str, float]:
        """Restore the newest checkpoint of ``cfg.checkpoint_dir`` and run
        the held-out evaluation without training (``--eval-only``);
        ``FileNotFoundError`` when the directory holds none. Without a
        checkpoint directory this evaluates the initial parameters."""
        cfg = self.cfg
        if dataset is None:
            dataset = _load_dataset(cfg)
        _, test_loader = self._loaders(dataset)
        if cfg.checkpoint_dir:
            ckpt = Checkpointer(cfg.checkpoint_dir)
            try:
                restored = ckpt.restore_latest()
            finally:
                ckpt.close()
            if restored is None:
                raise FileNotFoundError(f"no checkpoint under {cfg.checkpoint_dir!r} to evaluate")
            self.restore_state(restored)
        metrics = self.evaluate(test_loader)
        log.info(
            "Test set: Average loss: %.4f, Accuracy: %d/%d (%.0f%%)",
            metrics["avg_loss"], metrics["correct"], metrics["count"],
            100.0 * metrics["accuracy"],
        )
        return metrics

    @torch.no_grad()
    def evaluate(self, test_loader: BatchLoader, watchdog: StepWatchdog | None = None
                 ) -> dict[str, float]:
        """Eval over the test set with this replica's running BN stats; the
        loss sum, correct count and example count are summed over ranks.
        FSDP gathers its parameters once for the whole pass. ``watchdog``,
        when given, is armed around each batch after the first (which
        builds the eval's kernels) and around the final fetch."""
        self.model.eval()
        totals = torch.zeros(3, dtype=torch.float64, device=self.device)
        full = self._full_params() if self._fsdp else None
        batches = prefetch(test_loader.epoch_padded(0), self.cfg.prefetch_depth, self.device)
        first = True
        try:
            while True:
                arm_now = watchdog is not None and not first
                if arm_now:
                    watchdog.arm()
                try:
                    try:
                        x, y, mask = next(batches)
                    except StopIteration:
                        break
                    with self._autocast():
                        logits = (self.model(eval_batch(x)) if full is None
                                  else functional_call(self.model, full, (eval_batch(x),)))
                    losses = F.cross_entropy(logits.float(), y, reduction="none")
                    correct = (logits.argmax(dim=-1) == y).float()
                    totals += torch.stack(
                        [(losses * mask).sum(), (correct * mask).sum(), mask.sum()]
                    ).double()
                finally:
                    if arm_now:
                        watchdog.disarm()
                first = False
        finally:
            if isinstance(batches, PrefetchIterator):
                batches.close()
        if watchdog is not None:
            watchdog.arm()
        try:
            if self.world_size > 1:
                dist.all_reduce(totals)
            loss_sum, correct, count = totals.tolist()
        finally:
            if watchdog is not None:
                watchdog.disarm()
        return {
            "avg_loss": loss_sum / max(count, 1),
            "correct": int(correct),
            "count": int(count),
            "accuracy": correct / max(count, 1),
        }
