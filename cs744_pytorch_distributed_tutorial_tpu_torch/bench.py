"""Headline benchmark of the port: CIFAR-10 ResNet-18 training samples/s
per card, and its phase and sync modes.

    python -m cs744_pytorch_distributed_tutorial_tpu_torch.bench [--metrics-dir DIR]
    python -m cs744_pytorch_distributed_tutorial_tpu_torch.bench --phase-breakdown \
        [--batch 4096 --model resnet18 --sync auto --grad-compress none \
         --sync-overlap off --compute-dtype bfloat16 --phase-iters 3] [--metrics-dir DIR]
    python -m cs744_pytorch_distributed_tutorial_tpu_torch.bench --sync-compare
    python -m cs744_pytorch_distributed_tutorial_tpu_torch.bench [--metrics-dir DIR] \
        --serve [serve_cli flags]

The JAX package's root ``bench.py`` on PyTorch. The headline: ResNet-18
on synthetic CIFAR (``synthetic_cifar10(batch, 16, seed=0)``, one batch
trained on again and again, each rank its rows), bf16 autocast,
``sync="auto"`` (DDP) on a process group of one (or the caller's),
augmentation on, neither ``fast_conv`` nor ``fused_optimizer``. Global
batch 4096 (10 warm-up steps, then 30 timed) and 1024 (10, then 90),
each timed window fenced by a device synchronise at both ends. One
``kind: "bench"`` line goes to stdout (and to ``metrics.jsonl`` under
``--metrics-dir``) with the JAX headline's keys; ``mfu`` is against the
card's peak dense BF16 rate (``obs/flops.py``), null for a card without a
known peak. ``vs_baseline`` and ``vs_baseline_b1024`` are null: the
repo's only baseline was measured on another accelerator.

``--phase-breakdown`` runs the phase profiler (``obs/phases.py``) on one
configuration: per-phase (forward, backward, grad sync, optimizer)
device time, FLOPs, bytes (an unfused per-op count), MFU, roofline class
and ``sync_exposed_ms``, the segmented step held against the fused one.
Its ``kind: "phase"``/``"phase_summary"`` records and a ``kind: "bench"``
line go to the sink, the table to stderr, the records to
``DIR/phase_report.json``; it exits 1 when the parity check fails.
``--sync-compare`` reports samples/s and gradient wire bytes per step for
four wires (f32 per-tensor DDP, f32 bucketed allreduce, the int8 wire,
zero1's reduce-scatter), the bucketed ones also overlapped, then one
``kind: "sync_compare"`` record a wire comparing the fused and the
overlapped step; as in JAX, zero1's phase pair needs more than one rank
and raises at a world of one, after the other records.

``--serve`` hands every argument after it to the serving benchmark
(``serve_cli.main``), e.g. ``--serve --requests 32 --gate`` or ``--serve
--trace-dir /tmp/trace --window-every 0.25``; a ``--metrics-dir`` given
before ``--serve`` is forwarded, and the exit code is the serving CLI's.

``--device cuda`` (default) or ``cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
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
def headline_trainer(batch: int, device: str = "cuda", **overrides):
    """The headline configuration at global batch ``batch`` (``overrides``:
    other ``TrainConfig`` fields, such as the sync): ``(trainer, images,
    labels)``, this rank's rows of the batch on the device, inside a
    process group of one (or the caller's)."""
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
        world, rank = mesh.world()
        cfg = dict(model="resnet18", sync="auto", compute_dtype="bfloat16") | overrides
        tr = Trainer(TrainConfig(num_devices=world, global_batch_size=batch, synthetic_data=True,
                                 device=device, **cfg))
        ds = synthetic_cifar10(batch, 16, seed=0)
        rows = slice(rank * batch // world, (rank + 1) * batch // world)
        x = torch.from_numpy(ds.train_images[rows]).to(tr.device)
        y = torch.from_numpy(ds.train_labels[rows].astype("int64")).to(tr.device)
        yield tr, x, y
    finally:
        if own_group:
            mesh.shutdown()


def bench_at(batch: int, steps: int = MEASURE_STEPS, *, device: str = "cuda",
             warmup: int = WARMUP_STEPS, **overrides) -> dict:
    """Train the headline configuration (``overrides``: other
    ``TrainConfig`` fields) at global batch ``batch``: ``warmup`` steps,
    then ``steps`` timed. Returns the samples/s per card, the analytic
    gradient-sync bytes a step and the peak device memory (bytes; None on
    the CPU)."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.buckets import (
        sync_bytes_per_step,
    )

    with headline_trainer(batch, device, **overrides) as (tr, x, y):
        wire = sync_bytes_per_step(tr.params, "int8_allreduce" if tr._compress else tr.cfg.sync,
                                   tr.world_size, reverse=tr._overlap)
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


SYNC_COMPARE_ROWS = (  # label, sync, grad_compress, the overlapped mode (None: no overlap)
    ("f32_per_leaf_auto", "auto", "none", None),
    ("f32_bucketed_allreduce", "allreduce", "none", "bucket"),
    ("int8_bucketed_allreduce", "allreduce", "int8", "bucket+int8"),
    ("f32_zero1_scatter", "zero1", "none", "bucket"),
)


def sync_compare(sink, batch: int = BATCH_SMALL, steps: int = MEASURE_STEPS, *,
                 phase_iters: int = 3, device: str = "cuda", warmup: int = WARMUP_STEPS,
                 model: str = "resnet18") -> None:
    """The wire's modes (the JAX ``sync_compare``): samples/s per card and
    analytic gradient payload bytes sent per rank a step, one ``kind:
    "bench"`` record per wire of ``SYNC_COMPARE_ROWS`` (bf16, the headline
    configuration otherwise), the bucketed wires' with their overlapped
    throughput; then each overlapped wire's ``kind: "sync_compare"``
    record: the fused and the overlapped step's time and the
    ``sync_exposed_ms`` each leaves (``obs/phases.py``). zero1's pair
    raises ``ValueError`` at a world of one, as JAX's does."""
    for label, sync, compress, ov in SYNC_COMPARE_ROWS:
        kw = dict(device=device, warmup=warmup, model=model, sync=sync, grad_compress=compress)
        m = bench_at(batch, steps, **kw)
        rec = {
            "kind": "bench",
            "time": time.time(),
            "metric": f"cifar10_{model}_grad_sync",
            "sync": label,
            "batch": batch,
            "samples_per_sec_per_chip": round(m["samples_per_sec"], 1),
            "grad_sync_bytes_per_step": m["wire_bytes"],
        }
        if ov is not None:
            rec["sync_overlap"] = ov
            rec["samples_per_sec_per_chip_overlap"] = round(
                bench_at(batch, steps, sync_overlap=ov, **kw)["samples_per_sec"], 1)
        sink.emit(rec)
    for label, sync, compress, ov in SYNC_COMPARE_ROWS:
        if ov is None:
            continue
        kw = dict(model=model, sync=sync, grad_compress=compress, compute_dtype="bfloat16",
                  iters=phase_iters, device=device)
        rep_f, _ = _phase_report(batch, **kw)
        rep_o, _ = _phase_report(batch, sync_overlap=ov, **kw)
        sink.emit(
            {
                "kind": "sync_compare",
                "time": time.time(),
                "metric": f"cifar10_{model}_sync_overlap",
                "wire": label,
                "sync_overlap": ov,
                "batch": batch,
                "fused_step_ms": round(rep_f.fused_ms, 4),
                "overlap_step_ms": round(rep_o.fused_ms, 4),
                "sync_exposed_ms_fused": round(rep_f.sync_exposed_ms, 4),
                "sync_exposed_ms_overlap": round(rep_o.sync_exposed_ms, 4),
                "parity_ok": bool(rep_f.parity_ok and rep_o.parity_ok),
            }
        )


def _phase_report(batch: int, *, model: str = "resnet18", sync: str = "auto",
                  grad_compress: str = "none", compute_dtype: str = "bfloat16",
                  sync_overlap: str = "off", iters: int = 3, device: str = "cuda"):
    """Build a trainer of the given configuration and run the phase
    profiler on it: ``(PhaseReport, world size)``; shared by
    ``--phase-breakdown`` and ``--sync-compare``."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.obs.phases import profile_phases

    with headline_trainer(batch, device, model=model, sync=sync, grad_compress=grad_compress,
                          compute_dtype=compute_dtype, sync_overlap=sync_overlap) as (tr, x, y):
        return profile_phases(tr, x, y, iters=iters), tr.world_size


def phase_breakdown(sink, batch: int = GLOBAL_BATCH, *, model: str = "resnet18",
                    sync: str = "auto", grad_compress: str = "none",
                    compute_dtype: str = "bfloat16", sync_overlap: str = "off", iters: int = 3,
                    metrics_dir: str | None = None, device: str = "cuda") -> bool:
    """The phase profiler's mode (the JAX ``phase_breakdown``): its
    ``kind="phase"`` and ``"phase_summary"`` records, then a ``kind:
    "bench"`` line whose ``value`` is the fused step's samples/s per card;
    the table to stderr; the records to ``metrics_dir/phase_report.json``.
    Returns ``parity_ok``: the attribution of a step that computes
    something else is not a benchmark."""
    report, n_chips = _phase_report(batch, model=model, sync=sync, grad_compress=grad_compress,
                                    compute_dtype=compute_dtype, sync_overlap=sync_overlap,
                                    iters=iters, device=device)
    now = time.time()
    for rec in report.records(run=f"bench_{model}"):
        sink.emit({**rec, "time": now})
    sink.emit(
        {
            "kind": "bench",
            "time": now,
            "metric": f"cifar10_{model}_phase_breakdown",
            "value": round(batch / (report.fused_ms / 1e3) / n_chips, 1),
            "unit": "samples/sec/chip",
            "batch": batch,
            "sync_overlap": sync_overlap,
            "sync_exposed_ms": round(report.sync_exposed_ms, 4),
            "parity_ok": report.parity_ok,
        }
    )
    print(report.table(), file=sys.stderr)
    if metrics_dir:
        with open(os.path.join(metrics_dir, "phase_report.json"), "w") as f:
            json.dump(report.records(run=f"bench_{model}"), f, indent=1)
    return report.parity_ok


def _parse_args(argv: list[str] | None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="cs744-torch-bench",
        description="CIFAR-10 ResNet-18 training samples/s per card (the headline), its phase "
                    "breakdown and its sync wires",
    )
    p.add_argument("--sync-compare", action="store_true",
                   help="report samples/s per card and gradient bytes on the wire a step for "
                        "f32 per-tensor / f32 bucketed / int8 bucketed / zero1 sync instead of "
                        "the headline")
    p.add_argument("--phase-breakdown", action="store_true",
                   help="per-phase (forward/backward/grad-sync/optimizer) device time, flops, "
                        "bytes, MFU, roofline class and sync_exposed_ms, the segmented step "
                        "checked against the fused one")
    p.add_argument("--batch", type=int, default=GLOBAL_BATCH,
                   help="global batch size for --phase-breakdown (default %(default)s)")
    p.add_argument("--model", default="resnet18",
                   help="model for --phase-breakdown (default %(default)s)")
    p.add_argument("--sync", default="auto",
                   help="sync strategy for --phase-breakdown (default %(default)s)")
    p.add_argument("--grad-compress", default="none", choices=("none", "int8"),
                   help="gradient compression for --phase-breakdown")
    p.add_argument("--sync-overlap", default="off", choices=("off", "bucket", "bucket+int8"),
                   help="overlapped bucket sync schedule for --phase-breakdown ('bucket' needs "
                        "--grad-compress none, 'bucket+int8' needs --grad-compress int8)")
    p.add_argument("--compute-dtype", default="bfloat16",
                   help="compute dtype for --phase-breakdown (default %(default)s; float32 "
                        "keeps the parity check at the strict f32 tolerance)")
    p.add_argument("--phase-iters", type=int, default=3,
                   help="timed iterations per segment for --phase-breakdown")
    p.add_argument("--metrics-dir", default=None,
                   help="also append the result records to DIR/metrics.jsonl")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--serve", nargs=argparse.REMAINDER, default=None,
                   help="delegate to the continuous-batching serving benchmark (serve_cli): "
                        "every argument after --serve passes through, e.g. --serve "
                        "--requests 32 --gate; a --metrics-dir given before --serve is "
                        "forwarded")
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = _parse_args(argv)
    if args.serve is not None:
        from cs744_pytorch_distributed_tutorial_tpu_torch.serve_cli import main as serve_main

        serve_argv = list(args.serve)
        if args.metrics_dir and "--metrics-dir" not in serve_argv:
            serve_argv += ["--metrics-dir", args.metrics_dir]
        return serve_main(serve_argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    sink = _make_sink(args.metrics_dir)
    try:
        if args.phase_breakdown:
            ok = phase_breakdown(
                sink, args.batch, model=args.model, sync=args.sync,
                grad_compress=args.grad_compress, compute_dtype=args.compute_dtype,
                sync_overlap=args.sync_overlap, iters=args.phase_iters,
                metrics_dir=args.metrics_dir, device=args.device,
            )
            return 0 if ok else 1
        if args.sync_compare:
            sync_compare(sink, device=args.device)
            return 0
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
