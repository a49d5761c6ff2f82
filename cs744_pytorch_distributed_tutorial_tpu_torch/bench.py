"""Headline benchmark of the port: CIFAR-10 ResNet-18 training samples/s
per card.

    python -m cs744_pytorch_distributed_tutorial_tpu_torch.bench [--metrics-dir DIR]

The JAX package's root ``bench.py`` headline on PyTorch: ResNet-18 on
synthetic CIFAR (``synthetic_cifar10(batch, 16, seed=0)``, one batch
trained on again and again), bf16 autocast, ``sync="auto"`` (DDP) on a
process group of one, augmentation on, neither ``fast_conv`` nor
``fused_optimizer``. Global batch 4096 (10 warm-up steps, then 30
timed) and 1024 (10, then 90), each timed window fenced by a device
synchronise at both ends. One ``kind: "bench"`` line goes to stdout
(and to ``metrics.jsonl`` under ``--metrics-dir``) with the JAX
headline's keys; ``mfu`` is against the card's peak dense BF16 rate
(``obs/flops.py``), null for a card without a known peak.
``vs_baseline`` and ``vs_baseline_b1024`` are null: the repo's only
baseline was measured on another accelerator.

``--device cuda`` (default) or ``cpu``. ``--sync-compare``,
``--phase-breakdown`` and ``--serve`` exit "not yet ported".
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import sys
import time

import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.obs.flops import (
    mfu,
    resnet18_cifar_train_flops_per_sample,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.obs.sinks import (
    JsonlSink,
    MultiSink,
    StreamSink,
)

GLOBAL_BATCH = 4096
BATCH_SMALL = 1024
WARMUP_STEPS = 10
MEASURE_STEPS = 30
MEASURE_STEPS_SMALL = 90  # shorter steps: a longer window

log = logging.getLogger("cs744_pytorch_distributed_tutorial_tpu_torch")

_NOT_YET_PORTED = {
    "sync_compare": "--sync-compare needs obs/phases.py's phase records",
    "phase_breakdown": "--phase-breakdown needs obs/phases.py",
    "serve": "--serve needs the serving tracer and guard",
}


def _make_sink(metrics_dir: str | None) -> MultiSink:
    sinks = [StreamSink(sys.stdout)]
    if metrics_dir:
        os.makedirs(metrics_dir, exist_ok=True)
        sinks.append(JsonlSink(os.path.join(metrics_dir, "metrics.jsonl")))
    return MultiSink(sinks)


def _fence(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def headline_trainer(batch: int, device: str = "cuda"):
    """The headline configuration at global batch ``batch``: ``(trainer,
    images, labels)`` on the device, inside a process group of one (or
    the caller's)."""
    import torch.distributed as dist

    from cs744_pytorch_distributed_tutorial_tpu_torch.config import TrainConfig, resolve_device
    from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_cifar10
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import mesh
    from cs744_pytorch_distributed_tutorial_tpu_torch.train import Trainer

    dev = mesh.rank_device(resolve_device(device), 0)
    own_group = not dist.is_initialized()
    if own_group:
        mesh.initialize(None, 1, 0, device=dev)
    try:
        world, _ = mesh.world()
        tr = Trainer(TrainConfig(model="resnet18", sync="auto", num_devices=world,
                                 global_batch_size=batch, compute_dtype="bfloat16",
                                 synthetic_data=True, device=device))
        ds = synthetic_cifar10(batch, 16, seed=0)
        x = torch.from_numpy(ds.train_images).to(tr.device)
        y = torch.from_numpy(ds.train_labels.astype("int64")).to(tr.device)
        yield tr, x, y
    finally:
        if own_group:
            mesh.shutdown()


def bench_at(batch: int, steps: int = MEASURE_STEPS, *, device: str = "cuda",
             warmup: int = WARMUP_STEPS) -> dict:
    """Train the headline configuration at global batch ``batch``:
    ``warmup`` steps, then ``steps`` timed. Returns the samples/s, the
    analytic gradient-sync bytes a step and the peak device memory
    (bytes; None on the CPU)."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.buckets import (
        sync_bytes_per_step,
    )

    with headline_trainer(batch, device) as (tr, x, y):
        wire = sync_bytes_per_step(tr.params, tr.cfg.sync, tr.world_size)
        if tr.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(tr.device)
        for _ in range(warmup):
            tr.train_step(x, y)
        _fence(tr.device)
        t0 = time.perf_counter()
        for _ in range(steps):
            tr.train_step(x, y)
        _fence(tr.device)
        seconds = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated(tr.device)
                if tr.device.type == "cuda" else None)
        return {"samples_per_sec": steps * batch / seconds / tr.world_size, "wire_bytes": wire,
                "peak_memory_bytes": peak, "device": tr.device}


def headline_record(big: dict, small: dict) -> dict:
    """The ``kind: "bench"`` record of the two measurements."""
    dev = big["device"]
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    flops = resnet18_cifar_train_flops_per_sample()
    achieved = mfu(big["samples_per_sec"] * flops, name)
    return {
        "kind": "bench",
        "time": time.time(),
        "metric": "cifar10_resnet18_train_samples_per_sec_per_chip",
        "value": round(big["samples_per_sec"], 1),
        "unit": "samples/sec/chip",
        "vs_baseline": None,
        "batch": GLOBAL_BATCH,
        "value_b1024": round(small["samples_per_sec"], 1),
        "vs_baseline_b1024": None,
        "flops_per_sample": flops,
        "grad_sync_bytes_per_step": big["wire_bytes"],
        "mfu": None if achieved is None else round(achieved, 4),
    }


def run_headline(device: str = "cuda") -> tuple[dict, dict[int, dict]]:
    """Both measurements and their record: ``(record, {batch: measured})``."""
    big = bench_at(GLOBAL_BATCH, device=device)
    small = bench_at(BATCH_SMALL, MEASURE_STEPS_SMALL, device=device)
    return headline_record(big, small), {GLOBAL_BATCH: big, BATCH_SMALL: small}


def _parse_args(argv: list[str] | None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="cs744-torch-bench",
        description="CIFAR-10 ResNet-18 training samples/s per card (the headline)",
    )
    p.add_argument("--metrics-dir", default=None,
                   help="also append the bench record to DIR/metrics.jsonl")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--sync-compare", action="store_true", help="not yet ported")
    p.add_argument("--phase-breakdown", action="store_true", help="not yet ported")
    p.add_argument("--serve", nargs=argparse.REMAINDER, default=None, help="not yet ported")
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = _parse_args(argv)
    for flag, why in _NOT_YET_PORTED.items():
        if getattr(args, flag) not in (None, False):
            raise SystemExit(f"bench: {why}, which is not yet ported")
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    sink = _make_sink(args.metrics_dir)
    try:
        record, measured = run_headline(args.device)
        for batch, m in measured.items():
            log.info("bench: batch %d, %.1f samples/s, peak memory %s bytes",
                     batch, m["samples_per_sec"], m["peak_memory_bytes"])
        sink.emit(record)
    finally:
        sink.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
