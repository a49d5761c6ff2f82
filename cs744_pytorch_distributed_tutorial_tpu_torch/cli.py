"""One CLI entry point for all parts, on PyTorch.

    python -m cs744_pytorch_distributed_tutorial_tpu_torch.cli --part 1 --fused-optimizer
    python -m cs744_pytorch_distributed_tutorial_tpu_torch.cli --part 1 --model resnet18 \\
        --fast-conv --fused-optimizer
    python -m cs744_pytorch_distributed_tutorial_tpu_torch.cli --part 2b \\
        --coordinator 10.0.0.1:29500 --num-processes 4 --process-id 0

The flags are the JAX package's (``cli.py``) for the options the port
runs. A run of several ranks starts one process per rank, as the
reference does (``--master-ip``/``--num-nodes``/``--rank`` at
``master/part2a/part2a.py:136-143``): ``--coordinator host:port``,
``--num-processes`` (the world size) and ``--process-id`` (the rank).
A world of one needs no coordinator. ``--device`` picks ``cuda``
(default; one card per rank, NCCL) or ``cpu`` (Gloo).
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
                   help="gradient sync strategy (overrides --part)")
    p.add_argument("--model", default=None, help="model name (default vgg11)")
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("--imagenet-stem", action="store_true", default=None,
                   help="force the 7x7/stride-2 + maxpool ResNet stem")
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
    p.add_argument("--grad-clip-norm", type=float, default=None)
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
    # init_process mirror (master/part2a/part2a.py:80-85)
    p.add_argument("--coordinator", dest="coordinator_address", default=None,
                   help="rendezvous address host:port (the --master-ip analog)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="the --num-nodes analog: world size")
    p.add_argument("--process-id", type=int, default=None,
                   help="the --rank analog")
    p.add_argument("--device", choices=["cuda", "cpu"], default=None,
                   help="cuda (default, NCCL between ranks) or cpu (Gloo)")
    p.add_argument("--json", action="store_true",
                   help="print a final JSON summary line")
    return p


_ARG_TO_FIELD = {
    "sync": "sync",
    "model": "model",
    "augment": "augment",
    "image_size": "image_size",
    "num_classes": "num_classes",
    "num_devices": "num_devices",
    "global_batch_size": "global_batch_size",
    "epochs": "epochs",
    "lr": "learning_rate",
    "momentum": "momentum",
    "weight_decay": "weight_decay",
    "optimizer": "optimizer",
    "lr_schedule": "lr_schedule",
    "warmup_steps": "warmup_steps",
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

    import torch.distributed as dist

    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import mesh
    from cs744_pytorch_distributed_tutorial_tpu_torch.train import Trainer

    device = resolve_device(cfg.device)
    world_size, rank = cfg.world_size, cfg.process_id or 0
    if cfg.num_devices is not None and world_size != cfg.num_devices:
        raise ValueError(
            f"--num-processes {world_size} disagrees with --num-devices "
            f"{cfg.num_devices}; one process drives one device"
        )
    # part1 at a world of one needs no process group; every other
    # strategy communicates through one, even alone.
    if cfg.sync != "none" or world_size > 1:
        mesh.initialize(
            cfg.coordinator_address,
            world_size,
            rank,
            device=mesh.rank_device(device, rank),
        )
    try:
        trainer = Trainer(cfg)
        backend = dist.get_backend() if dist.is_initialized() else None
        _, history = trainer.fit()
    finally:
        mesh.shutdown()

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
        }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
