"""Supervised multi-process runs with generations: the elastic runtime.

A port of the JAX package's ``parallel/multihost.py``. The reference pins
a static world (``init_process()`` sets ``MASTER_ADDR``/``MASTER_PORT``)
and any rank's death kills or hangs the whole job
(``master/part2a/part2a.py:80-85``). This module is the torchelastic-shaped
answer, in four layers:

1. **Rendezvous store** (``RendezvousStore``): a generation-numbered
   membership database on a file system every process shares. World
   specs are atomic JSON (tmp + rename); heartbeats are one file a
   (generation, rank); death notes accumulate a generation; every
   supervisor and worker transition lands in one append-only
   ``events.jsonl`` (``kind:"event"`` records, the schema of
   ``utils/failure.py``'s recovery events). Its files and JSON are the
   JAX package's, so either package's fleet view (``obs/fleet.py``) reads
   the other's store.
2. **Worker membership** (``WorkerContext``, ``HeartbeatThread``): a
   worker learns its coordinates from the ``GRAFT_ELASTIC_*`` environment
   the supervisor writes and beats on a daemon thread, so a survivor
   blocked in a dead collective keeps beating (hung but alive) while a
   SIGKILLed rank goes silent (dead).
3. **Collective watchdog** (``CollectiveWatchdog``): armed around every
   section that can block on a dead peer (the step, the loss fetch
   behind it, the checkpoint barrier). When a section outlives its
   deadline and the store shows a dead peer, it calls ``on_loss`` from
   its monitor thread; the default is ``os._exit(EXIT_PROCESS_LOSS)``.
   On Gloo a dead peer usually raises at once in the survivors
   ("Connection closed by peer"); on NCCL the collective is enqueued
   asynchronously and the host blocks later, at the loss fetch or a
   stream sync, where nothing can be raised into it, and tearing down a
   communicator whose peer died can hang: the exit code is the honest
   way out. ``check()`` between steps raises ``ProcessLossError``.
4. **Supervisor** (``launch_local``): spawns N workers, classifies exits
   (SIGKILL or a stale heartbeat: dead; ``EXIT_PROCESS_LOSS``, SIGTERM,
   SIGABRT from torch's own NCCL watchdog, an exception, a teardown
   casualty: survivors), tears the generation down, elects the lowest
   surviving global rank as the new coordinator (``plan_next_generation``)
   and re-execs the survivors into generation g+1 on the shrunk world.
   They resume from the newest checkpoint on disk (the in-memory snapshot
   dies with the process), re-cut for the new world
   (``utils/checkpoint.py``'s elastic restore).

``launch.py`` is the command line over ``launch_local`` and the demo
worker the kill and re-election runs drive.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import signal
import socket
import subprocess
import threading
import time
from typing import Any, Callable, Mapping, Sequence

from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.mesh import free_port
from cs744_pytorch_distributed_tutorial_tpu_torch.utils.logging import get_logger

# Environment contract between the supervisor and its workers. The same
# variables name a worker's coordinates on a cluster (written by whatever
# launches the containers): `cli.py`/`lm_cli.py` pick them up through
# ``env_context``, so one worker command serves both paths.
ENV_STORE = "GRAFT_ELASTIC_STORE"
ENV_GENERATION = "GRAFT_ELASTIC_GENERATION"
ENV_RANK = "GRAFT_ELASTIC_RANK"  # process_id within this generation
ENV_WORLD = "GRAFT_ELASTIC_WORLD"  # num_processes in this generation
ENV_COORDINATOR = "GRAFT_ELASTIC_COORDINATOR"  # host:port
ENV_GLOBAL_RANK = "GRAFT_ELASTIC_GLOBAL_RANK"  # stable across generations

# A worker that detected a dead peer exits with this code: the
# supervisor classifies it as a SURVIVOR (restart into g+1), never as a
# death. Chosen clear of signal codes (negative), 0 (done) and 1
# (generic crash).
EXIT_PROCESS_LOSS = 17


# --------------------------------------------------------------- labels
# Process identity labels for log prefixes and event records. Explicit
# (set after each process group is formed) beats the environment beats
# the torch.distributed process group, consulted only when one exists.
_EXPLICIT: dict[str, int | None] = {
    "process_id": None,
    "process_count": None,
    "generation": None,
    "global_rank": None,
}
_LABELS_LOCK = threading.Lock()


def set_runtime_labels(
    process_id: int | None = None,
    process_count: int | None = None,
    generation: int | None = None,
    global_rank: int | None = None,
) -> None:
    """Pin identity labels explicitly: call after every process group is
    formed (a re-mesh forms a new one) so log prefixes and event records
    name the current generation's coordinates."""
    with _LABELS_LOCK:
        _EXPLICIT.update(
            process_id=process_id,
            process_count=process_count,
            generation=generation,
            global_rank=global_rank,
        )


def reset_runtime_labels() -> None:
    with _LABELS_LOCK:
        for k in _EXPLICIT:
            _EXPLICIT[k] = None


def _group_labels() -> tuple[int, int]:
    """(rank, world size) of the torch.distributed process group; (0, 1)
    without one."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.utils import logging as _logging

    return _logging._rank_and_world()


def _env_int(name: str) -> int | None:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return None
    try:
        return int(raw)
    except ValueError:
        return None


def runtime_labels() -> dict[str, int]:
    """Resolve the current process identity: explicit > environment >
    the process group (if one exists) > single-process defaults. Always
    returns all four keys as ints."""
    with _LABELS_LOCK:
        explicit = dict(_EXPLICIT)
    pid = explicit["process_id"]
    count = explicit["process_count"]
    if pid is None:
        pid = _env_int(ENV_RANK)
    if count is None:
        count = _env_int(ENV_WORLD)
    if pid is None or count is None:
        gpid, gcount = _group_labels()
        pid = gpid if pid is None else pid
        count = gcount if count is None else count
    pid = 0 if pid is None else int(pid)
    count = 1 if count is None else int(count)
    gen = explicit["generation"]
    if gen is None:
        gen = _env_int(ENV_GENERATION)
    grank = explicit["global_rank"]
    if grank is None:
        grank = _env_int(ENV_GLOBAL_RANK)
    return {
        "process_id": pid,
        "process_count": count,
        "generation": 0 if gen is None else int(gen),
        "global_rank": pid if grank is None else int(grank),
    }


# -------------------------------------------------------------- context
@dataclasses.dataclass(frozen=True)
class WorkerContext:
    """One worker's coordinates in one generation, as handed down by the
    supervisor (or a cluster's launcher) through the ``GRAFT_ELASTIC_*``
    environment."""

    store_dir: str
    generation: int
    process_id: int
    num_processes: int
    coordinator: str
    global_rank: int

    def env(self) -> dict[str, str]:
        return {
            ENV_STORE: self.store_dir,
            ENV_GENERATION: str(self.generation),
            ENV_RANK: str(self.process_id),
            ENV_WORLD: str(self.num_processes),
            ENV_COORDINATOR: self.coordinator,
            ENV_GLOBAL_RANK: str(self.global_rank),
        }


def env_context(environ: Mapping[str, str] | None = None) -> WorkerContext | None:
    """Build a ``WorkerContext`` from the environment; None when the
    ``GRAFT_ELASTIC_*`` contract is absent (single-process runs)."""
    e = os.environ if environ is None else environ
    if not e.get(ENV_STORE):
        return None
    return WorkerContext(
        store_dir=e[ENV_STORE],
        generation=int(e.get(ENV_GENERATION, "0")),
        process_id=int(e.get(ENV_RANK, "0")),
        num_processes=int(e.get(ENV_WORLD, "1")),
        coordinator=e.get(ENV_COORDINATOR, ""),
        global_rank=int(e.get(ENV_GLOBAL_RANK, e.get(ENV_RANK, "0"))),
    )


def attach(ctx: WorkerContext, device: Any = "cpu") -> "HeartbeatThread":
    """Worker-side rendezvous for one generation: start beating, join the
    process group at the context's coordinator (``parallel/mesh.py::
    initialize``: NCCL for a ``cuda`` device, Gloo for the CPU), stamp the
    rendezvous barrier once the group exists, and pin the identity
    labels. Returns the heartbeat thread (a daemon: callers may drop it;
    ``stop()`` is for a tidy shutdown)."""
    import torch

    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.mesh import initialize

    store = RendezvousStore(ctx.store_dir)
    hb = HeartbeatThread(store, ctx.generation, ctx.global_rank)
    hb.start()
    initialize(ctx.coordinator, ctx.num_processes, ctx.process_id,
               device=torch.device(device))
    # initialize() returns only after every rank reached the rendezvous:
    # the closest thing to a simultaneous instant the fleet has. Stamp
    # (wall, monotonic) here so obs/fleet.py can align each rank's
    # monotonic clock against a common reference.
    with contextlib.suppress(OSError):
        store.barrier_stamp(ctx.generation, ctx.global_rank)
    set_runtime_labels(
        process_id=ctx.process_id,
        process_count=ctx.num_processes,
        generation=ctx.generation,
        global_rank=ctx.global_rank,
    )
    return hb


# ---------------------------------------------------------------- store
def _atomic_write_json(path: str, payload: dict[str, Any]) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)  # atomic on POSIX: readers see old or new


class RendezvousStore:
    """Generation-numbered membership on a shared filesystem.

    Layout under ``root``::

        world_g000000.json   # one per generation: ranks, coordinator
        hb_g000000_r3.json   # per-(generation, global-rank) heartbeat
        dead_g000000.json    # accumulated death notes for a generation
        sync_g000000_r3.json # rendezvous-barrier clock anchor per rank
        events.jsonl         # append-only kind:"event" stream
        fleet/               # per-rank fleet_stamp streams (obs/fleet)
        logs/g000000_r3.log  # per-rank stdout+stderr (supervisor-owned)

    All writes are atomic (tmp + rename) except ``events.jsonl``, which
    relies on O_APPEND single-``write`` atomicity — every writer builds
    the full line first and hands it to the kernel in ONE ``os.write``
    (retried only on the no-bytes-written edge), so concurrent
    supervisor/worker events interleave but never tear. ``read_events``
    still tolerates a torn tail (a writer crashing mid-record) and
    reports it instead of silently dropping arbitrary interior lines.
    """

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        os.makedirs(os.path.join(self.root, "logs"), exist_ok=True)
        self.events_path = os.path.join(self.root, "events.jsonl")

    # -- world specs
    def _world_path(self, generation: int) -> str:
        return os.path.join(self.root, f"world_g{generation:06d}.json")

    def write_world(self, spec: dict[str, Any]) -> None:
        _atomic_write_json(self._world_path(int(spec["generation"])), spec)

    def read_world(self, generation: int) -> dict[str, Any] | None:
        try:
            with open(self._world_path(generation), encoding="utf-8") as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def latest_generation(self) -> int | None:
        gens = [
            int(name[len("world_g"):-len(".json")])
            for name in os.listdir(self.root)
            if name.startswith("world_g") and name.endswith(".json")
        ]
        return max(gens) if gens else None

    # -- heartbeats
    def _hb_path(self, generation: int, global_rank: int) -> str:
        return os.path.join(
            self.root, f"hb_g{generation:06d}_r{global_rank}.json"
        )

    def heartbeat(
        self, generation: int, global_rank: int, step: int | None = None
    ) -> None:
        _atomic_write_json(
            self._hb_path(generation, global_rank),
            {
                "rank": global_rank,
                "step": step,
                "time": time.time(),
                "monotonic": time.monotonic(),
                "host": socket.gethostname(),
            },
        )

    def heartbeat_age(
        self,
        generation: int,
        global_rank: int,
        now: float | None = None,
        now_mono: float | None = None,
    ) -> float | None:
        """Seconds since the rank's newest beat in this generation; None
        if it has never beaten (still importing/attaching — the
        supervisor's startup grace covers that window).

        When the beat carries a ``monotonic`` stamp from THIS host, the
        age is the monotonic difference — immune to wall-clock steps
        (NTP slews during a run would otherwise fake staleness or hide
        it). Cross-host beats fall back to wall time: CLOCK_MONOTONIC is
        per-boot and meaningless between machines. Passing ``now``
        explicitly forces the wall path (tests pin time that way)."""
        try:
            with open(
                self._hb_path(generation, global_rank), encoding="utf-8"
            ) as f:
                rec = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None
        mono = rec.get("monotonic")
        if (
            now is None
            and isinstance(mono, (int, float))
            and rec.get("host") == socket.gethostname()
        ):
            now_mono = time.monotonic() if now_mono is None else now_mono
            return now_mono - float(mono)
        beat = rec.get("time")
        if not isinstance(beat, (int, float)):
            return None
        # graftlint: disable=GR004 -- deliberate cross-host wall path:
        # CLOCK_MONOTONIC is per-boot, so beats from another machine can
        # only be aged against wall time (documented above).
        return (time.time() if now is None else now) - float(beat)

    # -- death notes
    def _dead_path(self, generation: int) -> str:
        return os.path.join(self.root, f"dead_g{generation:06d}.json")

    def mark_dead(self, generation: int, ranks: Sequence[int]) -> None:
        merged = sorted(set(self.dead(generation)) | set(int(r) for r in ranks))
        _atomic_write_json(
            self._dead_path(generation),
            {
                "generation": generation,
                "dead": merged,
                "time": time.time(),
                "monotonic": time.monotonic(),
            },
        )

    def dead(self, generation: int) -> set[int]:
        try:
            with open(self._dead_path(generation), encoding="utf-8") as f:
                return set(json.load(f).get("dead", ()))
        except (FileNotFoundError, json.JSONDecodeError):
            return set()

    # -- rendezvous-barrier clock anchors
    def _sync_path(self, generation: int, global_rank: int) -> str:
        return os.path.join(
            self.root, f"sync_g{generation:06d}_r{global_rank}.json"
        )

    def barrier_stamp(self, generation: int, global_rank: int) -> None:
        """Record this rank's (wall, monotonic) the moment the
        generation's rendezvous barrier released: ``attach()`` calls it
        right after ``mesh.initialize`` returns, which every rank leaves
        near-simultaneously. ``obs/fleet.py`` uses these anchors to map
        each rank's monotonic clock onto one shared timeline."""
        _atomic_write_json(
            self._sync_path(generation, global_rank),
            {
                "generation": generation,
                "global_rank": global_rank,
                "wall": time.time(),
                "mono": time.monotonic(),
                "host": socket.gethostname(),
            },
        )

    def read_barrier_stamps(
        self, generation: int
    ) -> dict[int, dict[str, Any]]:
        prefix = f"sync_g{generation:06d}_r"
        out: dict[int, dict[str, Any]] = {}
        for name in os.listdir(self.root):
            if not (name.startswith(prefix) and name.endswith(".json")):
                continue
            try:
                with open(
                    os.path.join(self.root, name), encoding="utf-8"
                ) as f:
                    rec = json.load(f)
                out[int(name[len(prefix):-len(".json")])] = rec
            except (OSError, ValueError, json.JSONDecodeError):
                continue
        return out

    # -- events + logs
    def append_event(self, event: str, **fields: Any) -> None:
        """One ``kind:"event"`` line, stamped with the runtime labels
        (same schema as ``utils/failure.py::emit_event``). O_APPEND with
        ONE full-line ``os.write`` keeps concurrent writers line-atomic;
        the loop only re-enters when the kernel accepted zero bytes
        (EINTR-style edge) — a partial count would mean an interleaving
        hazard, so it raises instead of retrying the remainder."""
        record = {
            "kind": "event",
            "event": event,
            "time": time.time(),
            "monotonic": time.monotonic(),
            **runtime_labels(),
            **fields,
        }
        data = (json.dumps(record, default=str) + "\n").encode("utf-8")
        fd = os.open(
            self.events_path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644
        )
        try:
            while True:
                written = os.write(fd, data)
                if written == len(data):
                    return
                if written == 0:
                    continue
                raise OSError(
                    f"torn event append: {written}/{len(data)} bytes"
                )
        finally:
            os.close(fd)

    def events(self) -> list[dict[str, Any]]:
        records, _ = read_events(self.events_path)
        return records

    def events_with_torn(self) -> tuple[list[dict[str, Any]], int]:
        return read_events(self.events_path)

    def log_path(self, generation: int, global_rank: int) -> str:
        return os.path.join(
            self.root, "logs", f"g{generation:06d}_r{global_rank}.log"
        )


def read_events(path: str) -> tuple[list[dict[str, Any]], int]:
    """Torn-tolerant JSONL reader for event streams: parse every intact
    line, count the ones that don't parse instead of silently dropping
    them. A single unparsable FINAL line is the expected signature of a
    writer that died mid-record; unparsable interior lines indicate real
    interleaving corruption — both are surfaced through the torn count
    so ``obs fleet-report`` can say so."""
    records: list[dict[str, Any]] = []
    torn = 0
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    records.append(json.loads(line))
                except json.JSONDecodeError:
                    torn += 1
    except FileNotFoundError:
        pass
    return records, torn


class HeartbeatThread(threading.Thread):
    """Beat ``(generation, global_rank)`` into the store every
    ``interval_s`` on a daemon thread.

    Daemon is the point: the MAIN thread may be blocked inside a dead
    collective (C code — unreachable by Python signals), yet the beats
    keep landing, which is exactly what distinguishes a hung-but-alive
    survivor (restartable) from a SIGKILLed rank (dead machine) in the
    supervisor's classification.
    """

    def __init__(
        self,
        store: RendezvousStore,
        generation: int,
        global_rank: int,
        interval_s: float = 1.0,
    ):
        super().__init__(name="graftelastic-heartbeat", daemon=True)
        self.store = store
        self.generation = generation
        self.global_rank = global_rank
        self.interval_s = interval_s
        self.step: int | None = None  # loop-updated, best effort
        self._stop = threading.Event()

    def run(self) -> None:
        while not self._stop.is_set():
            with contextlib.suppress(OSError):
                self.store.heartbeat(
                    self.generation, self.global_rank, self.step
                )
            self._stop.wait(self.interval_s)

    def stop(self) -> None:
        self._stop.set()


# ------------------------------------------------------------- watchdog
def _exit_process_loss(err: Exception) -> None:
    """Default in-collective escape hatch: the blocked thread cannot be
    raised into, so leave with the survivor exit code the supervisor
    re-execs. ``os._exit`` skips atexit handlers and finalizers on
    purpose: the process state behind a dead collective is not worth
    unwinding (tearing down an NCCL communicator whose peer died can
    hang), and ``utils/checkpoint.py`` commits a step by a rename, so a
    death mid-save never leaves a readable half-checkpoint."""
    os._exit(EXIT_PROCESS_LOSS)


class CollectiveWatchdog:
    """Convert "blocked forever on a dead peer" into a bounded exit.

    Usage (the demo worker in ``launch.py`` is the canonical loop)::

        wd = CollectiveWatchdog(store, ctx, deadline_s=5.0)
        for s in range(start, steps):
            wd.check()            # between steps: raises ProcessLossError
            with wd.watch():      # around anything that can block on a
                ...train_step...  # peer: step, fetch, checkpoint barrier
        wd.close()

    A watched section that outlives ``deadline_s`` triggers a membership
    probe: death notes for this generation plus peers whose heartbeat is
    older than ``stale_after_s``. With evidence of a dead peer the
    watchdog calls ``on_loss(ProcessLossError)`` from its monitor thread
    — by default ``os._exit(EXIT_PROCESS_LOSS)``, because the blocked
    main thread is in C and cannot catch anything (tests inject a
    recording callback instead). With NO dead peer the section is merely
    slow: log a warning and re-arm. ``check()`` is the synchronous twin
    for between-steps use — it raises ``ProcessLossError`` on the
    calling thread, the catchable path into ``run_with_recovery``.
    """

    def __init__(
        self,
        store: RendezvousStore,
        ctx: WorkerContext,
        deadline_s: float,
        *,
        on_loss: Callable[[Exception], None] | None = None,
        stale_after_s: float | None = None,
        poll_s: float = 0.2,
        telemetry: Any = None,
    ):
        self.store = store
        self.ctx = ctx
        self.deadline_s = deadline_s
        self.stale_after_s = (
            deadline_s if stale_after_s is None else stale_after_s
        )
        self.on_loss = _exit_process_loss if on_loss is None else on_loss
        self.poll_s = poll_s
        self.telemetry = telemetry
        self.fired = 0
        self._log = get_logger()
        self._lock = threading.Lock()
        self._armed_at: float | None = None
        self._closed = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="graftelastic-watchdog", daemon=True
        )
        self._thread.start()

    def _peers(self) -> list[int]:
        world = self.store.read_world(self.ctx.generation)
        ranks = (
            world.get("ranks", [])
            if world
            else list(range(self.ctx.num_processes))
        )
        return [int(r) for r in ranks if int(r) != self.ctx.global_rank]

    def dead_peers(self) -> list[int]:
        """Current evidence of dead peers in this generation: death
        notes, plus peers whose heartbeat has gone stale (they beat at
        least once, then went silent past ``stale_after_s``)."""
        gen = self.ctx.generation
        dead = set(self.store.dead(gen))
        now_mono = time.monotonic()
        for r in self._peers():
            if r in dead:
                continue
            age = self.store.heartbeat_age(gen, r, now_mono=now_mono)
            if age is not None and age > self.stale_after_s:
                dead.add(r)
        return sorted(dead)

    def check(self) -> None:
        """Synchronous membership probe for between-steps callsites —
        raises ``ProcessLossError`` (catchable; ``run_with_recovery``'s
        ladder) instead of exiting."""
        from cs744_pytorch_distributed_tutorial_tpu_torch.utils.failure import (
            ProcessLossError,
        )

        dead = self.dead_peers()
        if dead:
            raise ProcessLossError(
                generation=self.ctx.generation, dead=dead
            )

    @contextlib.contextmanager
    def watch(self):
        with self._lock:
            self._armed_at = time.monotonic()
        try:
            yield self
        finally:
            with self._lock:
                self._armed_at = None

    def close(self) -> None:
        self._closed.set()
        self._thread.join(timeout=5)

    def _run(self) -> None:
        from cs744_pytorch_distributed_tutorial_tpu_torch.utils.failure import (
            ProcessLossError,
            emit_event,
        )

        while not self._closed.wait(self.poll_s):
            with self._lock:
                armed_at = self._armed_at
            if armed_at is None:
                continue
            elapsed = time.monotonic() - armed_at
            if elapsed < self.deadline_s:
                continue
            dead = self.dead_peers()
            if not dead:
                # Slow but nobody is dead: not a loss, re-arm and keep
                # waiting (compile or a straggling save).
                self._log.warning(
                    "collective watchdog: section past %.1fs with no dead "
                    "peer — re-arming",
                    self.deadline_s,
                )
                with self._lock:
                    if self._armed_at == armed_at:
                        self._armed_at = time.monotonic()
                continue
            self.fired += 1
            err = ProcessLossError(
                generation=self.ctx.generation, dead=dead
            )
            self._log.critical(
                "collective watchdog: blocked %.1fs (> %.1fs deadline) with "
                "dead peer(s) %s — converting to process loss",
                elapsed,
                self.deadline_s,
                dead,
            )
            emit_event(
                self.telemetry,
                "process_loss",
                dead=list(dead),
                elapsed_s=elapsed,
                deadline_s=self.deadline_s,
            )
            with contextlib.suppress(OSError):
                self.store.append_event(
                    "process_loss",
                    dead=list(dead),
                    elapsed_s=elapsed,
                    deadline_s=self.deadline_s,
                )
            with self._lock:
                self._armed_at = None  # fire once per section
            self.on_loss(err)


# ------------------------------------------------------------- election
def plan_next_generation(
    world: Mapping[str, Any], dead: Sequence[int]
) -> dict[str, Any]:
    """Deterministic re-election: survivors keep their GLOBAL ranks,
    process ids are reassigned by ascending global rank, and the lowest
    surviving global rank is the new coordinator (process_id 0). Every
    survivor — and the supervisor — computes the identical plan from the
    same (world, dead) inputs; there is no negotiation step to race."""
    dead_set = set(int(r) for r in dead)
    survivors = [int(r) for r in world["ranks"] if int(r) not in dead_set]
    return {
        "generation": int(world["generation"]) + 1,
        "ranks": survivors,  # ascending == new process_id order
        "coordinator_rank": survivors[0] if survivors else None,
        "parent_generation": int(world["generation"]),
        "dead": sorted(dead_set),
    }


# ----------------------------------------------------------- supervisor
@dataclasses.dataclass
class ElasticRun:
    """What ``launch_local`` hands back: did the job finish, and the full
    generation history (each entry a world spec extended post-hoc with
    ``exit_codes``/``dead``). ``store`` keeps the event stream and
    per-rank logs for post-mortems and CI artifacts."""

    success: bool
    generations: list[dict[str, Any]]
    store: RendezvousStore

    @property
    def final_generation(self) -> int:
        return int(self.generations[-1]["generation"])


def launch_local(
    num_processes: int,
    cmd: Sequence[str],
    *,
    store_dir: str,
    env: Mapping[str, str] | None = None,
    max_generations: int = 4,
    heartbeat_deadline_s: float = 15.0,
    startup_grace_s: float = 180.0,
    exit_grace_s: float = 30.0,
    term_grace_s: float = 10.0,
    poll_s: float = 0.2,
    coordinator_host: str = "127.0.0.1",
) -> ElasticRun:
    """Supervise ``num_processes`` copies of ``cmd`` through elastic
    generations. Worker coordinates ride the ``GRAFT_ELASTIC_*``
    environment; stdout+stderr land in per-rank log files under the
    store. The CPU workers and one host of cards are the same code; on
    a cluster, run one supervisor per host with ``cmd`` attaching via
    ``--coordinator/--process-id`` or ``env_context``.

    Death classification per generation:

    - returncode ``-SIGKILL`` => dead (OOM-killer / chaos SIGKILL);
    - heartbeat stale past ``heartbeat_deadline_s`` (or never beaten
      within ``startup_grace_s``) while still running => wedged machine:
      SIGKILL it ourselves, dead;
    - ``EXIT_PROCESS_LOSS`` (collective watchdog), SIGTERM, SIGABRT
      (torch's NCCL watchdog), nonzero exits (Gloo's "Connection closed
      by peer"), and teardown casualties => survivors.

    On any death the generation is torn down: dead ranks are noted in
    the store (so survivor watchdogs convert their hung collectives into
    exits within their own deadline), survivors get ``exit_grace_s`` to
    leave on their own, then SIGTERM, then SIGKILL. Survivors re-exec
    into generation g+1 on ``plan_next_generation``'s world — lowest
    surviving global rank becomes coordinator at a fresh port — and
    resume from the newest durable checkpoint. A generation where every
    rank exits 0 ends the run successfully; ``max_generations``
    restarts, an empty survivor set, or a death in the final allowed
    generation end it unsuccessfully.
    """
    if num_processes < 1:
        raise ValueError(f"num_processes must be >= 1, got {num_processes}")
    log = get_logger()
    store = RendezvousStore(store_dir)
    cmd = list(cmd)
    ranks = list(range(num_processes))
    generation = 0
    history: list[dict[str, Any]] = []

    while True:
        # Free on every address: rank 0's TCP store listens on all of them.
        coordinator = f"{coordinator_host}:{free_port()}"
        world = {
            "generation": generation,
            "ranks": list(ranks),
            "coordinator": coordinator,
            "coordinator_rank": ranks[0],
        }
        store.write_world(world)
        history.append(world)
        store.append_event(
            "generation_start",
            generation=generation,
            world_size=len(ranks),
            ranks=list(ranks),
            coordinator_rank=ranks[0],
        )
        log.info(
            "graftelastic: generation %d starting — world %s, coordinator "
            "rank %d at %s",
            generation,
            ranks,
            ranks[0],
            coordinator,
        )

        procs: dict[int, subprocess.Popen] = {}
        log_files = []
        for process_id, global_rank in enumerate(ranks):
            ctx = WorkerContext(
                store_dir=store.root,
                generation=generation,
                process_id=process_id,
                num_processes=len(ranks),
                coordinator=coordinator,
                global_rank=global_rank,
            )
            worker_env = {**os.environ, **(env or {}), **ctx.env()}
            logf = open(store.log_path(generation, global_rank), "ab")
            log_files.append(logf)
            procs[global_rank] = subprocess.Popen(
                cmd, env=worker_env, stdout=logf, stderr=subprocess.STDOUT
            )

        spawned = time.monotonic()
        exit_codes: dict[int, int] = {}
        dead: set[int] = set()

        # -- monitor until the generation completes or a death shows up
        while procs and not dead:
            time.sleep(poll_s)
            # One monotonic "now" per sweep (the watchdog's discipline):
            # every rank's age is measured against the same instant, so
            # staleness decisions within a sweep are mutually consistent.
            sweep_mono = time.monotonic()
            for global_rank, proc in list(procs.items()):
                rc = proc.poll()
                if rc is None:
                    age = store.heartbeat_age(
                        generation, global_rank, now_mono=sweep_mono
                    )
                    stale = (
                        age is not None and age > heartbeat_deadline_s
                    ) or (
                        age is None
                        and time.monotonic() - spawned > startup_grace_s
                    )
                    # graftlint: disable=GR001 -- the supervisor is ONE
                    # process observing all ranks, not a rank: its
                    # event appends cannot diverge across peers.
                    if stale:
                        proc.kill()
                        proc.wait()
                        procs.pop(global_rank)
                        exit_codes[global_rank] = -signal.SIGKILL
                        dead.add(global_rank)
                        store.append_event(
                            "worker_death",
                            generation=generation,
                            dead_rank=global_rank,
                            reason=(
                                "heartbeat_stale"
                                if age is not None
                                else "never_heartbeat"
                            ),
                            heartbeat_age_s=age,
                        )
                    continue
                procs.pop(global_rank)
                exit_codes[global_rank] = rc
                if rc == -signal.SIGKILL:
                    dead.add(global_rank)
                    store.append_event(
                        "worker_death",
                        generation=generation,
                        dead_rank=global_rank,
                        reason="sigkill",
                        returncode=rc,
                    )
                else:
                    store.append_event(
                        "worker_exit",
                        generation=generation,
                        exit_rank=global_rank,
                        returncode=rc,
                    )

        failure_rcs = [
            rc for rc in exit_codes.values() if rc != 0
        ]

        if not dead and not failure_rcs:
            world["exit_codes"] = dict(exit_codes)
            world["dead"] = []
            store.append_event(
                "run_complete", generation=generation, world_size=len(ranks)
            )
            return ElasticRun(True, history, store)

        # -- teardown: note deaths FIRST so survivor watchdogs can
        # convert their hung collectives into EXIT_PROCESS_LOSS exits
        # within their own deadline, then give them exit_grace_s before
        # escalating to SIGTERM and finally SIGKILL. Exits collected
        # here are teardown casualties — survivors, never deaths.
        if dead:
            store.mark_dead(generation, dead)
        deadline = time.monotonic() + exit_grace_s
        while procs and time.monotonic() < deadline:
            time.sleep(poll_s)
            for global_rank, proc in list(procs.items()):
                rc = proc.poll()
                if rc is None:
                    continue
                procs.pop(global_rank)
                exit_codes[global_rank] = rc
                store.append_event(
                    "worker_exit",
                    generation=generation,
                    exit_rank=global_rank,
                    returncode=rc,
                )
        for proc in procs.values():
            with contextlib.suppress(OSError):
                proc.terminate()
        deadline = time.monotonic() + term_grace_s
        while procs and time.monotonic() < deadline:
            time.sleep(poll_s)
            for global_rank, proc in list(procs.items()):
                if proc.poll() is not None:
                    procs.pop(global_rank)
                    exit_codes[global_rank] = proc.returncode
        for global_rank, proc in list(procs.items()):
            with contextlib.suppress(OSError):
                proc.kill()
            proc.wait()
            procs.pop(global_rank)
            exit_codes[global_rank] = proc.returncode
        for logf in log_files:
            with contextlib.suppress(OSError):
                logf.close()
        world["exit_codes"] = dict(exit_codes)
        world["dead"] = sorted(dead)

        plan = plan_next_generation(world, dead)
        survivors = plan["ranks"]
        # graftlint: disable=GR001 -- single-process supervisor: giveup
        # events are written once, not per rank.
        if not survivors:
            store.append_event(
                "recovery_giveup",
                generation=generation,
                reason="no survivors",
                dead=sorted(dead),
            )
            log.critical("graftelastic: no survivors — giving up")
            return ElasticRun(False, history, store)
        if generation + 1 > max_generations:
            store.append_event(
                "recovery_giveup",
                generation=generation,
                reason="max_generations",
                max_generations=max_generations,
            )
            log.critical(
                "graftelastic: exceeded max_generations=%d — giving up",
                max_generations,
            )
            return ElasticRun(False, history, store)
        store.append_event(
            "reelection",
            generation=plan["generation"],
            parent_generation=generation,
            dead=sorted(dead),
            survivors=list(survivors),
            coordinator_rank=plan["coordinator_rank"],
            world_size=len(survivors),
        )
        log.warning(
            "graftelastic: generation %d lost rank(s) %s — re-electing "
            "rank %d as coordinator, re-exec %d survivor(s) into "
            "generation %d",
            generation,
            sorted(dead),
            plan["coordinator_rank"],
            len(survivors),
            plan["generation"],
        )
        ranks = survivors
        generation = plan["generation"]
