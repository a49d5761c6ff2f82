"""Single dataclass config for the port.

The fields this slice uses, with the JAX package's names and defaults
(the reference's SGD recipe, batch 256 and seed 5000,
``master/part1/part1.py:17,98-101,107``), plus ``device``. Options of
the JAX config that the port does not run yet are absent rather than
accepted and ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

COMPUTE_DTYPES = ("float32", "bfloat16")


def resolve_dtype(name: str) -> torch.dtype:
    table = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    try:
        return table[name]
    except KeyError:
        raise ValueError(
            f"unknown compute_dtype {name!r}; choose from {COMPUTE_DTYPES}"
        ) from None


def resolve_device(name: str) -> torch.device:
    """The device a run asked for. ``cuda`` without a visible GPU raises:
    the port never falls back to the CPU on its own."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (--device cpu) to run on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}; use 'cuda' or 'cpu'")
    return device


@dataclasses.dataclass
class TrainConfig:
    """Everything needed to reproduce a training run.

    Defaults reproduce the reference workload: VGG-11 on CIFAR-10,
    global batch 256, SGD lr=0.1 momentum=0.9 wd=1e-4, 1 epoch, seed 5000.
    """

    # Model / data
    model: str = "vgg11"
    num_classes: int = 10
    image_size: int = 32
    # ResNet stem selection: None = auto (CIFAR 3x3 stem at image_size
    # <= 64, ImageNet 7x7/stride-2 + maxpool above); True/False forces.
    # Ignored by non-ResNet models.
    imagenet_stem: bool | None = None
    data_root: str = "./data"
    synthetic_data: bool | None = None  # None = auto (synthetic if no local CIFAR-10)
    synthetic_train_size: int = 50_000
    synthetic_test_size: int = 10_000

    # Optimization (reference: master/part1/part1.py:98-101)
    global_batch_size: int = 256
    learning_rate: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 1e-4
    epochs: int = 1
    seed: int = 5000
    optimizer: str = "sgd"
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    grad_clip_norm: float | None = None
    label_smoothing: float = 0.0
    # Train-time crop/flip (the reference's transform_train). False trains
    # on normalize-only inputs, for deterministic cross-framework checks.
    augment: bool = True
    accum_steps: int = 1

    # Parallelism: none|gather_scatter|p2p_star|allreduce|ring|auto.
    # num_devices is the data-parallel world size: one process per rank.
    sync: str = "allreduce"
    num_devices: int | None = None

    compute_dtype: str = "float32"

    # Route the SGD update through the CUDA fused-SGD kernel (ops/fused_sgd.py).
    fused_optimizer: bool = False

    # Route the wide stride-1 3x3 ResNet convs' weight gradient through
    # the CUDA wgrad kernel (ops/fused_conv.py); ResNet models only.
    fast_conv: bool = False

    # Logging / instrumentation (the reference prints loss every 20 batches
    # and the avg per-batch time over batches 1-10: master/part1/part1.py:39-44)
    log_every: int = 20
    timing_batches: tuple[int, int] = (1, 10)

    # Rendezvous (the reference's --master-ip/--num-nodes/--rank,
    # master/part2a/part2a.py:136-143): "host:port", world size, rank.
    coordinator_address: str | None = None
    num_processes: int | None = None
    process_id: int | None = None

    # "cuda" (one card per rank) or "cpu" (tests; gloo between ranks).
    device: str = "cuda"

    @property
    def world_size(self) -> int:
        return self.num_processes or self.num_devices or 1


# The reference's parts as presets: same model, data and hyperparameters,
# one sync mechanism each. part1 is one rank at batch 256; parts 2-3 are
# 64/rank x 4 ranks (part2a.py:20,32).
PART_PRESETS: dict[str, dict[str, Any]] = {
    "1": dict(sync="none", num_devices=1, global_batch_size=256),
    "2a": dict(sync="gather_scatter", num_devices=4, global_batch_size=256),
    "2a_extra": dict(sync="p2p_star", num_devices=4, global_batch_size=256),
    "2b": dict(sync="allreduce", num_devices=4, global_batch_size=256),
    "3": dict(sync="auto", num_devices=4, global_batch_size=256),
}


def config_for_part(part: str, **overrides: Any) -> TrainConfig:
    """Build a config for one of the reference's parts (1, 2a, 2a_extra, 2b, 3)."""
    if part not in PART_PRESETS:
        raise ValueError(f"unknown part {part!r}; choose from {sorted(PART_PRESETS)}")
    kw = dict(PART_PRESETS[part])
    kw.update(overrides)
    return TrainConfig(**kw)
