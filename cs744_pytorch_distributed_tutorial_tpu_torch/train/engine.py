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
   ``DistributedDataParallel``'s reducer does it inside ``backward()``);
5. the SGD(momentum, wd) update — the fused CUDA kernel
   (``ops/fused_sgd.py``) when ``fused_optimizer`` is set, plain tensor
   ops otherwise. Every rank applies it to identical synced gradients.

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
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.sync import (
    get_sync,
    sync_grads,
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
        if cfg.accum_steps != 1:
            raise NotImplementedError("accum_steps > 1 is not yet ported")
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
            step=0, params=self.params, momentum=self.tx.init(self.params)
        )
        # Crop/flip randomness per rank, seeded from (seed, rank).
        seed = int(np.random.SeedSequence([cfg.seed, self.rank]).generate_state(1)[0])
        self.augment_gen = torch.Generator().manual_seed(seed)

    def _autocast(self):
        if self.compute_dtype == torch.float32:
            return contextlib.nullcontext()
        return torch.autocast(self.device.type, dtype=self.compute_dtype)

    # ------------------------------------------------------------------ step
    def train_step(self, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """One step on this rank's uint8 NHWC batch; returns the local
        loss (a 0-dim tensor on the device, not fetched)."""
        cfg = self.cfg
        x = (
            augment_train_batch(self.augment_gen, images)
            if cfg.augment
            else eval_batch(images)
        )
        self.model.train()
        with self._autocast():
            logits = self.forward_module(x)
        loss = _smoothed_xent(logits.float(), labels, cfg.label_smoothing)
        for p in self.params:
            p.grad = None
        loss.backward()
        grads = [p.grad for p in self.params]
        if cfg.sync != "auto":
            sync_grads(grads, cfg.sync, self.world_size)
        self.tx.apply(self.params, self.state.momentum, grads)
        self.state.step += 1
        return loss.detach()

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
