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
"""

from __future__ import annotations

import contextlib
import logging
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
from cs744_pytorch_distributed_tutorial_tpu_torch.models import get_model
from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import shard_row
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import collectives as C
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.mesh import rank_device, world
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.overlap import (
    OVERLAP_MODES,
    OverlappedSGD,
    OverlappedZero1,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.sync import (
    get_sync,
    sync_grads,
    sync_grads_compressed,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.zero import FsdpSGD, Zero1SGD
from cs744_pytorch_distributed_tutorial_tpu_torch.train.state import (
    TrainState,
    check_recipe,
    is_reference_recipe,
    make_optimizer,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.utils.debug import (
    DivergenceMonitor,
    tree_checksum,
)
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
    size is the data-parallel degree.
    """

    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg
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

        model_kw: dict[str, Any] = {"sync_bn": cfg.sync_bn}
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

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._fsdp:
            return functional_call(self.model, self._full_params(), (x,))
        return self.forward_module(x)

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
        if self.compute_dtype == torch.float32:
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
                logits = self._forward(xm)
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

    # ------------------------------------------------------------------ loops
    def fit(
        self, dataset=None, epochs: int | None = None
    ) -> tuple[TrainState, dict[str, Any]]:
        """The reference's epoch loop (``master/part1/part1.py:101-103``)
        with its three signals: loss every ``log_every`` batches, average
        per-batch time over the timing window, eval after each epoch."""
        cfg = self.cfg
        if dataset is None:
            dataset = _load_dataset(cfg)
        loader_kw = dict(
            device=self.device, world_size=self.world_size, rank=self.rank
        )
        train_loader = BatchLoader(
            dataset.train_images, dataset.train_labels, cfg.global_batch_size,
            shuffle=True, seed=cfg.seed, **loader_kw,
        )
        test_loader = BatchLoader(
            dataset.test_images, dataset.test_labels, cfg.global_batch_size,
            shuffle=False, drop_last=False, **loader_kw,
        )
        history: dict[str, Any] = {"train_loss": [], "eval": [], "avg_batch_time": None}
        timer = StepTimer(window=cfg.timing_batches, device=self.device)
        last = cfg.timing_batches[1]
        for epoch in range(epochs if epochs is not None else cfg.epochs):
            timer.start()
            for batch_idx, (x, y) in enumerate(train_loader.epoch(epoch)):
                loss = self.train_step(x, y)
                if timer.steps_recorded <= last:
                    timer.tick()
                    if timer.steps_recorded == last + 1:
                        history["avg_batch_time"] = timer.window_average()
                        log.info("average time:  %f", history["avg_batch_time"])
                if batch_idx % cfg.log_every == 0:
                    value = self.global_mean(loss)
                    history["train_loss"].append((epoch, batch_idx, value))
                    log.info("%d loss:  %f", batch_idx, value)
            if self.sync_monitor is not None:
                bad = self.sync_monitor.divergent_steps()
                log.info("divergence check: %d steps, %d divergent",
                         self.sync_monitor.steps_recorded, len(bad))
                self.sync_monitor.assert_in_sync()
            metrics = self.evaluate(test_loader)
            history["eval"].append(metrics)
            log.info(
                "Test set: Average loss: %.4f, Accuracy: %d/%d (%.0f%%)",
                metrics["avg_loss"], metrics["correct"], metrics["count"],
                100.0 * metrics["accuracy"],
            )
        return self.state, history

    @torch.no_grad()
    def evaluate(self, test_loader: BatchLoader) -> dict[str, float]:
        """Eval over the test set with this replica's running BN stats; the
        loss sum, correct count and example count are summed over ranks.
        FSDP gathers its parameters once for the whole pass."""
        self.model.eval()
        totals = torch.zeros(3, dtype=torch.float64, device=self.device)
        full = self._full_params() if self._fsdp else None
        for x, y, mask in test_loader.epoch_padded(0):
            with self._autocast():
                logits = (self.model(eval_batch(x)) if full is None
                          else functional_call(self.model, full, (eval_batch(x),)))
            losses = F.cross_entropy(logits.float(), y, reduction="none")
            correct = (logits.argmax(dim=-1) == y).float()
            totals += torch.stack(
                [(losses * mask).sum(), (correct * mask).sum(), mask.sum()]
            ).double()
        if self.world_size > 1:
            dist.all_reduce(totals)
        loss_sum, correct, count = totals.tolist()
        return {
            "avg_loss": loss_sum / max(count, 1),
            "correct": int(correct),
            "count": int(count),
            "accuracy": correct / max(count, 1),
        }
