"""The elastic launcher: supervised multi-process runs that survive losing
a rank (a port of the JAX package's ``launch.py``).

The reference's launch story is "start 4 processes by hand and hope none
dies" (``init_process`` pins ``MASTER_ADDR``/``MASTER_PORT``). This
command line is the replacement: a supervisor
(``parallel/multihost.py::launch_local``) spawns N workers, watches
their heartbeats and exit codes, and re-execs the survivors into
generation g+1, under a re-elected coordinator, when a rank dies.

Supervise any worker command (it learns its coordinates from the
``GRAFT_ELASTIC_*`` environment, or takes its own ``--coordinator``
flags)::

    python -m cs744_pytorch_distributed_tutorial_tpu_torch.launch \\
        --nprocs 4 --store /tmp/elastic -- \\
        python -m cs744_pytorch_distributed_tutorial_tpu_torch.cli --part 2b

Or run the built-in demo worker, a tiny-CNN data-parallel loop with a
checkpoint every step and a scheduled kill::

    python -m cs744_pytorch_distributed_tutorial_tpu_torch.launch \\
        --nprocs 4 --store /tmp/elastic --steps 8 --kill 4:2 --platform cpu

``--platform inherit`` (the default) runs each worker on
``cuda:<process id mod visible cards>`` over NCCL, and refuses more
workers than visible cards; ``--platform cpu`` runs them on the CPU over
Gloo and hides the cards from them. ``--kill STEP:RANK`` SIGKILLs the
GLOBAL rank at the cumulative step (rank 0, the coordinator, exercises
re-election). ``--slow RANK:MS`` stalls that global rank for MS
milliseconds before every step: a seeded straggler whose late collective
arrivals the fleet view must name. The demo checkpoints every step and is
layout-invariant (synchronized BatchNorm, no augmentation, one fixed
global batch), so the resumed generation's losses match an uninterrupted
run at the shrunk world at rtol 1e-6. Each rank's output lands in
``<store>/logs/``, the supervisor's and the workers' events in
``<store>/events.jsonl``, each rank's step stamps in ``<store>/fleet/``,
and at exit the supervisor merges them into ``<store>/fleet_trace.json``
(Perfetto) and ``fleet_report.json`` (``obs/fleet.py``; re-render or audit
with ``python -m cs744_pytorch_distributed_tutorial_tpu_torch.obs
fleet-report <store> --check``).
"""

from __future__ import annotations

import argparse
import os
import sys

from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.multihost import (
    CollectiveWatchdog,
    RendezvousStore,
    attach,
    env_context,
    launch_local,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.utils.logging import get_logger


class _StoreTelemetry:
    """``emit_event``-shaped telemetry that appends to the rendezvous
    store's shared ``events.jsonl``: chaos injections from any rank land
    on the supervisor's timeline, durably before a self-SIGKILL."""

    def __init__(self, store: RendezvousStore):
        self.store = store

    def emit_event(self, event: str, **fields) -> None:
        self.store.append_event(event, **fields)


def _parse_kill(spec: str) -> tuple[int, int]:
    try:
        step_s, rank_s = spec.split(":")
        return int(step_s), int(rank_s)
    except ValueError as e:
        raise SystemExit(f"--kill expects STEP:RANK, got {spec!r}") from e


def _parse_slow(spec: str) -> tuple[int, float]:
    try:
        rank_s, ms_s = spec.split(":")
        return int(rank_s), float(ms_s)
    except ValueError as e:
        raise SystemExit(f"--slow expects RANK:MS, got {spec!r}") from e


def _worker_train(args: argparse.Namespace) -> int:
    """The demo worker: one elastic data-parallel tiny-CNN loop.

    Layout-invariant, so the rtol 1e-6 bar measures elasticity:
    ``sync_bn=True`` (the global batch's BatchNorm statistics at any world
    size), ``augment=False``, one fixed synthetic global batch divisible
    by every world it will see, parameters drawn from the seed alone. A
    checkpoint every step; after a re-exec the newest is re-cut for the
    new world (``Trainer.elastic_state``)."""
    ctx = env_context()
    if ctx is None:
        raise SystemExit(
            "--worker-train needs the GRAFT_ELASTIC_* environment "
            "(it is spawned by the supervisor, not run by hand)"
        )
    import torch

    from cs744_pytorch_distributed_tutorial_tpu_torch.config import TrainConfig
    from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_cifar10
    from cs744_pytorch_distributed_tutorial_tpu_torch.obs.fleet import FleetStamper, stamp_pair
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import mesh
    from cs744_pytorch_distributed_tutorial_tpu_torch.train import Trainer
    from cs744_pytorch_distributed_tutorial_tpu_torch.utils.chaos import ChaosMonkey, FaultSchedule
    from cs744_pytorch_distributed_tutorial_tpu_torch.utils.checkpoint import Checkpointer

    device = mesh.rank_device(torch.device(args.device), ctx.process_id)
    store = RendezvousStore(ctx.store_dir)
    hb = attach(ctx, device)  # heartbeats, the process group, the labels
    log = get_logger()
    torch.set_num_threads(1)
    # fp32 convolutions on a card (cuDNN's TF32 default rounds inputs to 10
    # mantissa bits): the cross-world bar is about the layout, not TF32.
    torch.backends.cudnn.allow_tf32 = False
    cfg = TrainConfig(
        model="tiny_cnn",
        sync="allreduce",
        sync_bn=True,
        augment=False,
        num_devices=ctx.num_processes,
        global_batch_size=args.global_batch,
        synthetic_data=True,
        synthetic_train_size=args.global_batch,
        synthetic_test_size=8,
        seed=0,
        # A modest lr keeps the losses O(1) for the whole run, so the
        # cross-world rtol-1e-6 bar is not float noise amplified by a
        # near-zero loss (the reduction order differs across worlds).
        learning_rate=args.lr,
        device=args.device,
    )
    trainer = Trainer(cfg)
    ckpt = Checkpointer(os.path.join(store.root, "ckpt"))
    start = 0
    if ckpt.latest_step() is not None:
        # After a re-exec only the disk tier survives (the in-memory
        # snapshot died with the old process).
        trainer.restore_state(ckpt.restore_latest(adapt=trainer.elastic_state))
        start = trainer.state.step
        store.append_event("recovery_resume", step=start, tier="disk",
                           world_size=ctx.num_processes, files_read=len(ckpt.last_read))
        log.info("graftelastic demo: resumed from disk at step %d (generation %d, world %d)",
                 start, ctx.generation, ctx.num_processes)

    # Arrival stamps (obs/fleet.py): sync_enter is taken right before the
    # step runs. Gloo's collectives block inside the step; NCCL's are
    # enqueued and the host blocks at the loss fetch; the window from
    # here to the fetch's return brackets the wait either way. A chaos
    # stall installed outside this wrapper delays the arrival, so the
    # monkeys below must wrap it: install it first.
    arrival: dict[str, tuple[float, float]] = {}
    unstamped_step = trainer.train_step

    def stamped_step(*step_args, **step_kwargs):
        arrival["sync_enter"] = stamp_pair()
        return unstamped_step(*step_args, **step_kwargs)

    trainer.train_step = stamped_step
    if args.kill:
        kill_step, kill_rank = _parse_kill(args.kill)
        # first_call=start keeps the keys absolute steps across
        # generations; the global-rank target makes a re-parsed spec
        # inert once that rank is dead.
        ChaosMonkey(FaultSchedule({kill_step: {"kind": "process_kill", "rank": kill_rank}}),
                    telemetry=_StoreTelemetry(store), rank=ctx.global_rank,
                    first_call=start).install(trainer)
    if args.slow:
        slow_rank, slow_ms = _parse_slow(args.slow)
        # A stall at every step, on the same global rank in every
        # generation; wrapping --kill's monkey, so it precedes the kill.
        ChaosMonkey(FaultSchedule({s: {"kind": "slow_step", "rank": slow_rank,
                                       "stall_s": slow_ms / 1e3}
                                   for s in range(args.steps)}),
                    telemetry=_StoreTelemetry(store), rank=ctx.global_rank,
                    first_call=start).install(trainer)

    watchdog = CollectiveWatchdog(store, ctx, deadline_s=args.collective_deadline_s)
    stamper = FleetStamper(store.root, ctx.generation, ctx.global_rank, ctx.process_id)
    ds = synthetic_cifar10(args.global_batch, 8, seed=0)
    per = args.global_batch // ctx.num_processes
    rows = slice(ctx.process_id * per, (ctx.process_id + 1) * per)
    x = torch.as_tensor(ds.train_images[rows]).to(device)
    y = torch.as_tensor(ds.train_labels[rows]).long().to(device)
    for step in range(start, args.steps):
        watchdog.check()
        step_enter = stamp_pair()
        with watchdog.watch():
            # The step, the fetch and the durable save are one watched
            # section: each can block on a dead peer (the all-reduce,
            # the fetch behind it on NCCL, the checkpoint's barrier).
            loss = trainer.global_mean(trainer.train_step(x, y))
            sync_exit = stamp_pair()
            ckpt.save(trainer.capture_state(), force=True, wait=True)
        step_exit = stamp_pair()
        stamper.stamp_step(step, step_enter=step_enter,
                           sync_enter=arrival.get("sync_enter", step_enter),
                           sync_exit=sync_exit, step_exit=step_exit)
        hb.step = step
        print(f"[graftelastic] gen={ctx.generation} grank={ctx.global_rank} "
              f"step={step} loss={loss:.8f}", flush=True)
    watchdog.close()
    stamper.close()
    ckpt.close()
    hb.stop()
    mesh.shutdown()
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m cs744_pytorch_distributed_tutorial_tpu_torch.launch",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--nprocs", type=int, default=4,
                   help="workers in generation 0 (default 4)")
    p.add_argument("--store", required=False, default=None,
                   help="rendezvous store directory (shared filesystem); "
                        "required in supervisor mode")
    p.add_argument("--max-generations", type=int, default=4,
                   help="give up after this many re-exec generations")
    p.add_argument("--heartbeat-deadline-s", type=float, default=15.0,
                   help="a running rank whose heartbeat is older than "
                        "this is declared dead")
    p.add_argument("--startup-grace-s", type=float, default=180.0,
                   help="allowance for a rank's first heartbeat "
                        "(imports + rendezvous)")
    p.add_argument("--exit-grace-s", type=float, default=30.0,
                   help="teardown: how long survivors get to exit on "
                        "their own (via their collective watchdog) "
                        "before SIGTERM/SIGKILL escalation")
    p.add_argument("--platform", choices=("cpu", "inherit"), default="inherit",
                   help="'inherit' (default): each worker drives cuda:<process id mod "
                        "visible cards> over NCCL; 'cpu': workers run on the CPU over "
                        "Gloo, the cards hidden from them")
    # Demo-worker knobs (also forwarded by the supervisor when no
    # explicit worker command is given after `--`).
    p.add_argument("--steps", type=int, default=8,
                   help="demo worker: total train steps")
    p.add_argument("--global-batch", type=int, default=12,
                   help="demo worker: fixed global batch — keep it "
                        "divisible by every world size the run may "
                        "shrink to")
    p.add_argument("--lr", type=float, default=0.002,
                   help="demo worker: SGD learning rate")
    p.add_argument("--kill", default=None, metavar="STEP:RANK",
                   help="demo worker: SIGKILL global rank RANK at "
                        "cumulative step STEP (0 = coordinator)")
    p.add_argument("--slow", default=None, metavar="RANK:MS",
                   help="demo worker: stall global rank RANK for MS "
                        "milliseconds before every step (seeded "
                        "straggler for fleet skew attribution)")
    p.add_argument("--collective-deadline-s", type=float, default=8.0,
                   help="demo worker: watchdog deadline for a step "
                        "blocked on a dead peer")
    p.add_argument("--worker-train", action="store_true",
                   help=argparse.SUPPRESS)  # internal: demo worker mode
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help=argparse.SUPPRESS)  # internal: the demo worker's device
    p.add_argument("cmd", nargs=argparse.REMAINDER,
                   help="worker command after `--` (default: the "
                        "built-in demo worker)")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.worker_train:
        return _worker_train(args)
    if not args.store:
        raise SystemExit("supervisor mode requires --store DIR")
    if args.platform == "inherit":
        import torch

        cards = torch.cuda.device_count()
        if args.nprocs > cards:
            raise ValueError(
                f"--platform inherit puts one worker on each card and NCCL cannot put two "
                f"ranks on one card: --nprocs {args.nprocs} > {cards} visible card(s); "
                "use --platform cpu for CPU workers"
            )

    cmd = list(args.cmd)
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        cmd = [
            sys.executable,
            "-m",
            "cs744_pytorch_distributed_tutorial_tpu_torch.launch",
            "--worker-train",
            "--device", "cpu" if args.platform == "cpu" else "cuda",
            "--steps", str(args.steps),
            "--global-batch", str(args.global_batch),
            "--lr", str(args.lr),
            "--collective-deadline-s", str(args.collective_deadline_s),
        ]
        if args.kill:
            cmd += ["--kill", args.kill]
        if args.slow:
            cmd += ["--slow", args.slow]

    env = None
    if args.platform == "cpu":
        # CPU workers: no card is visible to them, and one intra-op
        # thread each, so N workers share the host's cores evenly.
        env = {"CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}

    run = launch_local(
        args.nprocs,
        cmd,
        store_dir=args.store,
        env=env,
        max_generations=args.max_generations,
        heartbeat_deadline_s=args.heartbeat_deadline_s,
        startup_grace_s=args.startup_grace_s,
        exit_grace_s=args.exit_grace_s,
    )
    log = get_logger()
    for world in run.generations:
        log.info(
            "generation %d: world %s exit codes %s dead %s",
            world["generation"],
            world["ranks"],
            world.get("exit_codes", {}),
            world.get("dead", []),
        )
    log.info(
        "graftelastic: %s after %d generation(s); events at %s",
        "completed" if run.success else "FAILED",
        len(run.generations),
        run.store.events_path,
    )
    # Merge what the run left behind into the fleet artifacts (Perfetto
    # timeline + skew/incident report). A merge failure never changes the
    # run's exit code.
    try:
        from cs744_pytorch_distributed_tutorial_tpu_torch.obs.fleet import write_fleet_artifacts

        artifacts = write_fleet_artifacts(run.store.root)
        log.info(
            "graftfleet: merged timeline at %s (%d audit problem(s))",
            artifacts["trace"],
            len(artifacts["problems"]),
        )
    except Exception:
        log.warning("graftfleet: artifact merge failed", exc_info=True)
    return 0 if run.success else 1


if __name__ == "__main__":
    raise SystemExit(main())
