"""Single dataclass config for the port.

The fields the port runs, with the JAX package's names and defaults
(the reference's SGD recipe, batch 256 and seed 5000,
``master/part1/part1.py:17,98-101,107``; the run loop's prefetch,
telemetry, checkpoint, snapshot, failure and profiler fields), plus
``device``. Options of the JAX config that the port does not run yet
are absent rather than accepted and ignored.
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
    # Cross-replica BatchNorm statistics (models/batchnorm.py); False is
    # the reference's per-replica BatchNorm.
    sync_bn: bool = False
    # Dropout for the models that have it (the ViT family), in [0, 1); the
    # conv models follow the reference and have none.
    dropout_rate: float = 0.0
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
    total_steps: int | None = None  # the cosine schedules' horizon
    grad_clip_norm: float | None = None
    label_smoothing: float = 0.0
    # Train-time crop/flip (the reference's transform_train). False trains
    # on normalize-only inputs, for deterministic cross-framework checks.
    augment: bool = True
    accum_steps: int = 1

    # Parallelism: none|gather_scatter|p2p_star|allreduce|ring|auto|
    # int8_allreduce|int8_ring|zero1|fsdp (parallel/sync.py, parallel/zero.py).
    # num_devices is the data-parallel world size: one process per rank.
    sync: str = "allreduce"
    num_devices: int | None = None
    # The gradient wire: "int8" quantizes each bucket with error feedback
    # (allreduce, ring and the int8_* strategies); buckets of
    # sync_bucket_mb MiB (0: one collective a tensor); sync_overlap
    # "bucket" (float) or "bucket+int8" syncs and applies SGD a bucket at
    # a time as backward produces them (parallel/overlap.py; zero1's and
    # fsdp's lanes in parallel/zero.py).
    grad_compress: str = "none"
    sync_bucket_mb: float = 4.0
    sync_overlap: str = "off"

    compute_dtype: str = "float32"

    # Route the SGD update through the CUDA fused-SGD kernel (ops/fused_sgd.py).
    fused_optimizer: bool = False

    # Route the wide stride-1 3x3 ResNet convs' weight gradient through
    # the CUDA wgrad kernel (ops/fused_conv.py); ResNet models only.
    fast_conv: bool = False

    # The ViT family's attention: None (the model's default, "dense"),
    # "dense" or "flash" (the CUDA kernels of ops/flash_attention.py); the
    # conv families have no attention and refuse it.
    vit_attention: str | None = None

    # Input-pipeline prefetch depth: batches a producer thread stages
    # ahead, their host-to-device copies on a side stream from pinned
    # memory (data/prefetch.py; the DataLoader num_workers/pin_memory
    # analog, master/part1/part1.py:80-93). 0 disables.
    prefetch_depth: int = 2

    # Logging / instrumentation (the reference prints loss every 20 batches
    # and the avg per-batch time over batches 1-10: master/part1/part1.py:39-44)
    log_every: int = 20
    timing_batches: tuple[int, int] = (1, 10)

    # Telemetry (obs/): metrics_dir writes manifest.json + metrics.jsonl
    # (per-step loss, grad and param norms, lr, grad_sync_bytes, step time;
    # rank 0 only). metrics_every is the emission cadence in steps; 0 rides
    # the log_every cadence, so telemetry adds no fetch of its own.
    metrics_dir: str | None = None
    metrics_every: int = 0

    # Checkpoints (utils/checkpoint.py): every checkpoint_every steps and
    # at the end (0: at the end only) when checkpoint_dir is set.
    checkpoint_dir: str | None = None
    checkpoint_every: int = 0

    # In-memory snapshots (utils/memstore.py): the last snapshot_keep
    # certified states in host RAM every snapshot_every steps (0: off), a
    # restore tier that reads no file.
    snapshot_every: int = 0
    snapshot_keep: int = 2

    # Failure detection (utils/failure.py): halt_on_nonfinite raises
    # NonFiniteLossError when a fetched loss is NaN/inf (at the fetches
    # logging already makes); step_timeout_s arms a watchdog around each
    # step after the first (which builds the kernels); hang_action is
    # "log", "abort" (os._exit(13) so a supervisor restarts the job) or
    # "escalate" (warn, then dump, then abort on successive expiries).
    halt_on_nonfinite: bool = True
    step_timeout_s: float | None = None
    hang_action: str = "log"

    # Profiler window (utils/profiling.py): a torch.profiler Chrome trace
    # of steps [profile_start_step, profile_start_step + profile_num_steps)
    # written into profile_dir.
    profile_dir: str | None = None
    profile_start_step: int = 10
    profile_num_steps: int = 5
    # All-gather a checksum of each rank's synced gradients (zero1: its
    # parameters) every step and fail at the epoch's end if the ranks
    # disagree (utils/debug.py).
    debug_sync_check: bool = False

    # Rendezvous (the reference's --master-ip/--num-nodes/--rank,
    # master/part2a/part2a.py:136-143): "host:port", world size, rank.
    coordinator_address: str | None = None
    num_processes: int | None = None
    process_id: int | None = None

    # "cuda" (one card per rank) or "cpu" (tests; gloo between ranks).
    device: str = "cuda"

    def replace(self, **kw: Any) -> "TrainConfig":
        return dataclasses.replace(self, **kw)

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
