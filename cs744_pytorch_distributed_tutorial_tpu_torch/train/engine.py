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
5. the SGD(momentum, wd) update — the fused CUDA kernel
   (``ops/fused_sgd.py``) when ``fused_optimizer`` is set, plain tensor
   ops otherwise. Every rank applies it to identical synced gradients.

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
``broadcast_buffers=False``.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
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
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.mesh import rank_device, world
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.overlap import (
    OVERLAP_MODES,
    OverlappedSGD,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.sync import (
    get_sync,
    sync_grads,
    sync_grads_compressed,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.train.state import (
    TrainState,
    make_optimizer,
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
        if cfg.sync != "none" and not dist.is_initialized():
            raise ValueError(
                f"sync={cfg.sync!r} communicates through torch.distributed: "
                "initialize a process group first (parallel.mesh.initialize)"
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
        self._check_sync_options(cfg)
        self.compute_dtype = resolve_dtype(cfg.compute_dtype)
        self.tx = make_optimizer(cfg)

        model_kw: dict[str, Any] = {}
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
        self.state = TrainState(
            step=0, params=self.params, momentum=self.tx.init(self.params),
            ef=[torch.zeros_like(p, dtype=torch.float32) for p in self.params]
            if self._compress else [],
        )
        self.overlap = None
        if self._overlap:
            self.overlap = OverlappedSGD(
                self.params, self.state.momentum, self.state.ef if self._compress else None,
                name=cfg.sync, world_size=self.world_size, lr=cfg.learning_rate,
                mu=cfg.momentum, wd=cfg.weight_decay, bucket_bytes=self._bucket_bytes,
            )
        # Crop/flip randomness per rank, seeded from (seed, rank).
        seed = int(np.random.SeedSequence([cfg.seed, self.rank]).generate_state(1)[0])
        self.augment_gen = torch.Generator().manual_seed(seed)

    def _check_sync_options(self, cfg: TrainConfig) -> None:
        """The JAX engine's checks of the wire options (its
        ``engine.py:253-392``) for those the port runs."""
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
            if cfg.sync not in ("allreduce", "ring", "int8_allreduce", "int8_ring"):
                raise ValueError(
                    "grad_compress='int8' applies to the flat allreduce syncs only "
                    f"(allreduce, ring, int8_allreduce, int8_ring); sync={cfg.sync!r} "
                    "either has no grad-sync pass to compress (auto/none) or exists "
                    "to teach an uncompressed wire shape (gather_scatter, p2p_star)"
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
        if (cfg.optimizer != "sgd" or cfg.lr_schedule != "constant" or cfg.warmup_steps
                or cfg.grad_clip_norm is not None):
            raise ValueError(
                "sync_overlap applies the reference's fixed-lr SGD(momentum) per "
                f"bucket; optimizer={cfg.optimizer!r}/lr_schedule={cfg.lr_schedule!r}/"
                f"warmup_steps={cfg.warmup_steps}/grad_clip_norm={cfg.grad_clip_norm} "
                "need the whole-model update"
            )
        if cfg.sync_overlap == "bucket":
            if self._compress or cfg.sync not in ("allreduce", "ring"):
                raise ValueError(
                    "sync_overlap='bucket' overlaps the float bucketed wire: requires "
                    "sync in ('allreduce', 'ring') and grad_compress='none' (got "
                    f"sync={cfg.sync!r}, grad_compress={cfg.grad_compress!r}; for the "
                    "quantized wire use sync_overlap='bucket+int8')"
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
        # the int8 wire and the overlapped schedule once, after the sum.
        sync_each = cfg.sync != "auto" and not (self._compress or self._overlap)
        g_sum = loss_sum = None
        for k, (xm, ym) in enumerate(zip(x.chunk(accum), labels.chunk(accum))):
            last = k == accum - 1
            if self.overlap is not None and last:
                self.overlap.begin(g_sum, accum)
            with self._autocast():
                logits = self.forward_module(xm)
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
        self.state.step += 1
        return loss_sum / accum if accum > 1 else loss_sum

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
        loss sum, correct count and example count are summed over ranks."""
        self.model.eval()
        totals = torch.zeros(3, dtype=torch.float64, device=self.device)
        for x, y, mask in test_loader.epoch_padded(0):
            with self._autocast():
                logits = self.model(eval_batch(x))
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
