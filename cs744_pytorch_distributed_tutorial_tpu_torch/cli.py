"""One CLI entry point for all parts, on PyTorch.

    python -m cs744_pytorch_distributed_tutorial_tpu_torch.cli --part 1 --fused-optimizer
    python -m cs744_pytorch_distributed_tutorial_tpu_torch.cli --part 1 --model resnet18 \\
        --fast-conv --fused-optimizer
    python -m cs744_pytorch_distributed_tutorial_tpu_torch.cli --part 2b \\
        --coordinator 10.0.0.1:29500 --num-processes 4 --process-id 0
    python -m cs744_pytorch_distributed_tutorial_tpu_torch.cli --part 2b \\
        --grad-compress int8 --sync-overlap bucket+int8 ...
    python -m cs744_pytorch_distributed_tutorial_tpu_torch.cli --part 2b --sync zero1 ...
    python -m cs744_pytorch_distributed_tutorial_tpu_torch.cli --part 1 --optimizer lion \\
        --lr-schedule cosine --total-steps 196
    python -m cs744_pytorch_distributed_tutorial_tpu_torch.cli --part 1 --checkpoint-dir ckpt \\
        --checkpoint-every 50 --metrics-dir metrics --max-restarts 1
    python -m cs744_pytorch_distributed_tutorial_tpu_torch.cli --part 1 --checkpoint-dir ckpt \\
        --eval-only --json
    python -m cs744_pytorch_distributed_tutorial_tpu_torch.cli --part 1 --model vit_tiny \\
        --dropout 0.1

The flags are the JAX package's (``cli.py``) for the options the port
runs. A run of several ranks starts one process per rank, as the
reference does (``--master-ip``/``--num-nodes``/``--rank`` at
``master/part2a/part2a.py:136-143``): ``--coordinator host:port``,
``--num-processes`` (the world size) and ``--process-id`` (the rank).
A world of one needs no coordinator. ``--device`` picks ``cuda``
(default; one card per rank, NCCL) or ``cpu`` (Gloo). ``--distributed``
reads torchrun's environment instead (``init_method="env://"``: the
JAX package's ``jax.distributed.initialize()``; the card is
``cuda:LOCAL_RANK``). Under the elastic launcher (``launch.py``) the
coordinates arrive in the ``GRAFT_ELASTIC_*`` environment and the worker
attaches through ``parallel/multihost.py::attach`` (heartbeats, the
process group, the identity labels), unless ``--coordinator`` or
``--distributed`` is given.
"""

from __future__ import annotations

import argparse
import json
import logging

from cs744_pytorch_distributed_tutorial_tpu_torch.config import (
    PART_PRESETS,
    TrainConfig,
    config_for_part,
    resolve_device,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cs744-torch",
        description="PyTorch/CUDA data-parallel training (CS744 tutorial capabilities)",
    )
    p.add_argument("--part", choices=sorted(PART_PRESETS), default=None,
                   help="reference part preset: sync strategy + world size")
    p.add_argument("--sync", default=None,
                   help="gradient sync strategy (overrides --part): none, allreduce, "
                        "gather_scatter, p2p_star, ring, auto, int8_allreduce, int8_ring, "
                        "zero1 (sharded momentum), fsdp (sharded parameters and momentum)")
    p.add_argument("--grad-compress", choices=["none", "int8"], default=None,
                   help="compress gradient sync traffic: int8 quantizes "
                        "each bucket (per-chunk scales) with error feedback "
                        "(~3.9x fewer gradient bytes; allreduce/ring syncs)")
    p.add_argument("--sync-bucket-mb", type=float, default=None,
                   help="bucket size (MiB) for coalesced gradient sync; "
                        "0 = per-tensor collectives (default 4)")
    p.add_argument("--sync-overlap", choices=["off", "bucket", "bucket+int8"],
                   default=None,
                   help="overlapped gradient sync (parallel/overlap.py, "
                        "parallel/zero.py): reverse-order buckets, each one's "
                        "collective fired as backward completes it, the optimizer "
                        "applied a bucket at a time; 'bucket' overlaps the float "
                        "wire (allreduce/ring/zero1/fsdp), 'bucket+int8' the "
                        "int8+EF wire (allreduce/ring/zero1)")
    p.add_argument("--model", default=None, help="model name (default vgg11)")
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("--imagenet-stem", action="store_true", default=None,
                   help="force the 7x7/stride-2 + maxpool ResNet stem")
    p.add_argument("--sync-bn", action="store_true", default=None,
                   help="cross-replica BatchNorm statistics (default: the "
                        "reference's per-replica BN)")
    p.add_argument("--dropout", dest="dropout_rate", type=float, default=None,
                   help="dropout rate (ViT family)")
    p.add_argument("--num-devices", type=int, default=None,
                   help="data-parallel world size")
    p.add_argument("--global-batch-size", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--momentum", type=float, default=None)
    p.add_argument("--weight-decay", type=float, default=None)
    p.add_argument("--optimizer", choices=["sgd", "adamw", "lion"], default=None)
    p.add_argument("--lr-schedule",
                   choices=["constant", "cosine", "warmup_cosine"], default=None)
    p.add_argument("--warmup-steps", type=int, default=None)
    p.add_argument("--total-steps", type=int, default=None,
                   help="decay horizon for cosine schedules")
    p.add_argument("--grad-clip-norm", type=float, default=None,
                   help="clip the global gradient norm before the optimizer")
    p.add_argument("--label-smoothing", type=float, default=None,
                   help="smoothed CE target: (1-s) one-hot + s/num_classes")
    p.add_argument("--accum-steps", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--data-root", default=None)
    p.add_argument("--synthetic-data", action="store_true", default=None,
                   help="force the synthetic CIFAR-10 stand-in")
    p.add_argument("--synthetic-train-size", type=int, default=None)
    p.add_argument("--synthetic-test-size", type=int, default=None)
    p.add_argument("--compute-dtype", choices=["float32", "bfloat16"], default=None)
    p.add_argument("--fused-optimizer", action="store_true", default=None,
                   help="use the CUDA fused SGD kernel (ops/fused_sgd.py)")
    p.add_argument("--fast-conv", action="store_true", default=None,
                   help="CUDA wgrad kernel for the wide stride-1 ResNet 3x3 "
                        "convs (ops/fused_conv.py)")
    p.add_argument("--no-augment", action="store_false", dest="augment",
                   default=None,
                   help="disable train-time crop/flip (deterministic inputs)")
    p.add_argument("--log-every", type=int, default=None)
    p.add_argument("--prefetch-depth", type=int, default=None,
                   help="batches staged ahead by the input pipeline (0 disables)")
    p.add_argument("--debug-sync-check", action="store_true", default=None,
                   help="all-gather per-rank grad checksums every step and fail on "
                        "divergence")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=None,
                   help="checkpoint every N steps (0 = only at end)")
    p.add_argument("--snapshot-every", type=int, default=None,
                   help="keep in-memory state snapshots every N steps "
                        "(utils/memstore.py): restart recovery with no file "
                        "read (0 disables)")
    p.add_argument("--snapshot-keep", type=int, default=None,
                   help="in-memory snapshots retained (default 2)")
    p.add_argument("--step-timeout-s", type=float, default=None,
                   help="arm a hang watchdog per training step (utils/failure.py)")
    p.add_argument("--hang-action", choices=["log", "abort", "escalate"], default=None,
                   help="watchdog action after reporting a hang: 'log' (observe), "
                        "'abort' (exit so a supervisor restarts the job from the "
                        "newest checkpoint), or 'escalate' (warn -> dump -> abort "
                        "across successive expiries)")
    p.add_argument("--no-halt-on-nonfinite", dest="halt_on_nonfinite",
                   action="store_false", default=None,
                   help="keep training through NaN/inf losses instead of raising "
                        "NonFiniteLossError")
    p.add_argument("--metrics-dir", default=None,
                   help="write manifest.json + per-step metrics.jsonl here (obs/; "
                        "rank 0 only)")
    p.add_argument("--metrics-every", type=int, default=None,
                   help="metric emission cadence in steps (default: ride "
                        "--log-every)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace of a few steps here")
    p.add_argument("--profile-start-step", type=int, default=None)
    p.add_argument("--profile-num-steps", type=int, default=None)
    p.add_argument("--max-restarts", type=int, default=0,
                   help="restart from the newest recoverable state on detected "
                        "training failures (needs --checkpoint-dir or "
                        "--snapshot-every)")
    p.add_argument("--restart-backoff-s", type=float, default=0.0,
                   help="exponential backoff base between restarts (attempt n "
                        "sleeps backoff * 2^(n-1), capped 60s)")
    p.add_argument("--restart-jitter", choices=("none", "decorrelated"), default="none",
                   help="decorrelate restart backoff across ranks (seeded per rank)")
    # init_process mirror (master/part2a/part2a.py:80-85)
    p.add_argument("--coordinator", dest="coordinator_address", default=None,
                   help="rendezvous address host:port (the --master-ip analog)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="the --num-nodes analog: world size")
    p.add_argument("--process-id", type=int, default=None,
                   help="the --rank analog")
    p.add_argument("--distributed", action="store_true",
                   help="rendezvous from torchrun's environment (init_method='env://': "
                        "MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE; the card is "
                        "cuda:LOCAL_RANK)")
    p.add_argument("--device", choices=["cuda", "cpu"], default=None,
                   help="cuda (default, NCCL between ranks) or cpu (Gloo)")
    p.add_argument("--eval-only", action="store_true",
                   help="restore --checkpoint-dir's newest checkpoint and evaluate; "
                        "no training")
    p.add_argument("--json", action="store_true",
                   help="print a final JSON summary line")
    return p


_ARG_TO_FIELD = {
    "sync": "sync",
    "grad_compress": "grad_compress",
    "sync_bucket_mb": "sync_bucket_mb",
    "sync_overlap": "sync_overlap",
    "model": "model",
    "augment": "augment",
    "image_size": "image_size",
    "num_classes": "num_classes",
    "sync_bn": "sync_bn",
    "dropout_rate": "dropout_rate",
    "num_devices": "num_devices",
    "global_batch_size": "global_batch_size",
    "epochs": "epochs",
    "lr": "learning_rate",
    "momentum": "momentum",
    "weight_decay": "weight_decay",
    "optimizer": "optimizer",
    "lr_schedule": "lr_schedule",
    "warmup_steps": "warmup_steps",
    "total_steps": "total_steps",
    "grad_clip_norm": "grad_clip_norm",
    "label_smoothing": "label_smoothing",
    "accum_steps": "accum_steps",
    "seed": "seed",
    "data_root": "data_root",
    "synthetic_data": "synthetic_data",
    "synthetic_train_size": "synthetic_train_size",
    "synthetic_test_size": "synthetic_test_size",
    "compute_dtype": "compute_dtype",
    "fused_optimizer": "fused_optimizer",
    "fast_conv": "fast_conv",
    "imagenet_stem": "imagenet_stem",
    "log_every": "log_every",
    "prefetch_depth": "prefetch_depth",
    "debug_sync_check": "debug_sync_check",
    "checkpoint_dir": "checkpoint_dir",
    "checkpoint_every": "checkpoint_every",
    "snapshot_every": "snapshot_every",
    "snapshot_keep": "snapshot_keep",
    "step_timeout_s": "step_timeout_s",
    "hang_action": "hang_action",
    "halt_on_nonfinite": "halt_on_nonfinite",
    "metrics_dir": "metrics_dir",
    "metrics_every": "metrics_every",
    "profile_dir": "profile_dir",
    "profile_start_step": "profile_start_step",
    "profile_num_steps": "profile_num_steps",
    "coordinator_address": "coordinator_address",
    "num_processes": "num_processes",
    "process_id": "process_id",
    "device": "device",
}


def config_from_args(args: argparse.Namespace) -> TrainConfig:
    overrides = {
        field: getattr(args, arg)
        for arg, field in _ARG_TO_FIELD.items()
        if getattr(args, arg) is not None
    }
    if args.part is not None:
        return config_for_part(args.part, **overrides)
    return TrainConfig(**overrides)


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    import torch
    import torch.distributed as dist

    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import mesh
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.multihost import (
        attach,
        env_context,
    )
    from cs744_pytorch_distributed_tutorial_tpu_torch.train import Trainer

    device = resolve_device(cfg.device)
    # Under the elastic supervisor: its coordinates, heartbeats and labels.
    elastic_ctx = (env_context() if cfg.coordinator_address is None and not args.distributed
                   else None)
    if args.distributed:
        world_size, rank = mesh.initialize_from_env(device)
        if device.type == "cuda":
            cfg = cfg.replace(device=f"cuda:{torch.cuda.current_device()}")
    elif elastic_ctx is not None:
        world_size, rank = elastic_ctx.num_processes, elastic_ctx.process_id
    else:
        world_size, rank = cfg.world_size, cfg.process_id or 0
    if cfg.num_devices is not None and world_size != cfg.num_devices:
        raise ValueError(
            f"--num-processes {world_size} disagrees with --num-devices "
            f"{cfg.num_devices}; one process drives one device"
        )
    if elastic_ctx is not None:
        attach(elastic_ctx, mesh.rank_device(device, rank))
    # part1 at a world of one needs no process group; every other
    # strategy communicates through one, even alone.
    elif not args.distributed and (cfg.sync != "none" or world_size > 1):
        mesh.initialize(
            cfg.coordinator_address,
            world_size,
            rank,
            device=mesh.rank_device(device, rank),
        )
    restarts = 0
    try:
        trainer = Trainer(cfg)
        backend = dist.get_backend() if dist.is_initialized() else None
        if args.eval_only:
            metrics = trainer.evaluate_only()
        elif args.max_restarts > 0:
            from cs744_pytorch_distributed_tutorial_tpu_torch.utils.failure import (
                run_with_recovery,
            )

            _, history, restarts = run_with_recovery(
                trainer, max_restarts=args.max_restarts, backoff_s=args.restart_backoff_s,
                backoff_jitter=args.restart_jitter, jitter_seed=cfg.seed,
            )
            if restarts:
                print(f"recovered after {restarts} restart(s)")
        else:
            _, history = trainer.fit()
    finally:
        mesh.shutdown()

    if args.eval_only:
        if args.json and rank == 0:
            print(json.dumps({
                "sync": cfg.sync,
                "model": cfg.model,
                "num_devices": trainer.world_size,
                "final_eval_loss": metrics["avg_loss"],
                "final_eval_accuracy": metrics["accuracy"],
            }))
        return 0
    if args.json and history["eval"] and rank == 0:
        last = history["eval"][-1]
        print(json.dumps({
            "sync": cfg.sync,
            "model": cfg.model,
            "num_devices": trainer.world_size,
            "final_eval_loss": last["avg_loss"],
            "final_eval_accuracy": last["accuracy"],
            "avg_batch_time_s": history["avg_batch_time"],
            "final_train_loss": history["train_loss"][-1][2],
            "steps": trainer.state.step,
            "device": str(trainer.device),
            "backend": backend,
            "native_batches": trainer.native_batches,
            "restarts": restarts,
        }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
