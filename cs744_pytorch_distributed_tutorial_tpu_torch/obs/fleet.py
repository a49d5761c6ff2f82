"""The fleet view: one clock-aligned timeline of a multi-process run,
its collective skew, and an incident audit.

A port of the JAX package's ``obs/fleet.py`` (pure standard library; the
record schema and the files are the JAX package's, so either package's
fleet view reads the other's rendezvous store). Everything else in
``obs`` is per process; this module merges a whole rendezvous-store
directory (``parallel/multihost.py``) into one view:

- **Merged Perfetto timeline** (``merge_timeline``): one lane a process
  (global rank, stable across generations), a generation track, step and
  collective spans a rank, and instant markers for chaos injections,
  missed heartbeats, death notes, re-elections and re-execs.
- **Collective-skew attribution** (``collective_skew``): each rank stamps
  step-boundary and sync-entry/exit (wall, monotonic) pairs into its
  stream (``FleetStamper``; the engines' step records carry the same
  stamps on their existing fetch). The merger aligns the processes'
  clocks on the rendezvous-barrier anchors (``ClockAligner`` over
  ``RendezvousStore.barrier_stamp``), reports each step's
  ``collective_wait_ms`` a rank and names the straggler, the rank whose
  late arrival the others waited on.
- **Incident audit** (``fleet_check``): every death pairs with a
  re-election and a re-exec into g+1, no orphan generations, no step span
  crosses a generation's seal, stamps are internally ordered.

``python -m cs744_pytorch_distributed_tutorial_tpu_torch.obs fleet-report
<store_dir> [--check]`` is the command line; ``launch.py``'s supervisor
calls ``write_fleet_artifacts`` at exit, so every elastic run leaves
``fleet_trace.json`` and ``fleet_report.json`` behind.

Clock model: ``attach()`` stamps (wall, monotonic) on every rank the
moment the process group is formed; all ranks leave that rendezvous
near-simultaneously, so those stamps anchor each rank's monotonic clock
to one shared instant. A record stamped ``(wall, mono)`` on rank r in
generation g maps to the reference timeline as ``ref_anchor_wall + (mono
- anchor_mono[r])``: monotonic time since the barrier, laid onto the
reference rank's wall clock. Records without a monotonic stamp fall back
to wall time corrected by the anchors' wall offset.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Iterable, Mapping

FLEET_DIRNAME = "fleet"
TRACE_NAME = "fleet_trace.json"
REPORT_NAME = "fleet_report.json"

# Store events attributed to the supervisor process: rendered on the
# fleet lane (their runtime labels carry the supervisor's identity, not
# a worker's — placing them on "rank 0" would lie).
SUPERVISOR_EVENTS = frozenset(
    {
        "generation_start",
        "worker_death",
        "worker_exit",
        "reelection",
        "run_complete",
        "recovery_giveup",
    }
)


def stamp_pair() -> tuple[float, float]:
    """(wall, monotonic) sampled back-to-back — the unit every fleet
    stamp is made of."""
    return time.time(), time.monotonic()


# -------------------------------------------------------------- stamper
class FleetStamper:
    """Per-rank step/sync stamp stream under ``<store>/fleet/``.

    One writer per file (the rank itself), one JSON line per completed
    step carrying four (wall, mono) pairs::

        {"kind": "fleet_stamp", "generation": 0, "global_rank": 3,
         "step": 7,
         "step_enter_wall": …, "step_enter_mono": …,
         "sync_enter_wall": …, "sync_enter_mono": …,   # arrived at the
         "sync_exit_wall": …,  "sync_exit_mono": …,    # blocking fetch
         "step_exit_wall": …,  "step_exit_mono": …}

    ``sync_enter`` is the rank's ARRIVAL at the step's synchronous
    section — stamped after all per-rank host work (including any
    injected stall) and immediately before the first call that can
    block on peers — and ``sync_exit`` is taken right after the step's
    blocking fetch returns. Where the wait actually lands between those
    two varies by backend (cross-process CPU collectives block at
    dispatch; NCCL enqueues and the host blocks at the fetch), but the window
    brackets it either way. Aligned across ranks, the enter spread IS
    the collective skew: early ranks sit inside the window waiting for
    the straggler, and every rank leaves it near-simultaneously. A step
    that never completes (its rank died or exited mid-step) leaves no
    record — the audit counts on that.
    """

    def __init__(
        self,
        root: str,
        generation: int,
        global_rank: int,
        process_id: int | None = None,
    ):
        self.generation = int(generation)
        self.global_rank = int(global_rank)
        self.process_id = process_id
        fleet_dir = os.path.join(os.path.abspath(root), FLEET_DIRNAME)
        os.makedirs(fleet_dir, exist_ok=True)
        self.path = os.path.join(
            fleet_dir, f"g{self.generation:06d}_r{self.global_rank}.jsonl"
        )
        self._f = open(self.path, "a", encoding="utf-8")

    def stamp_step(
        self,
        step: int,
        *,
        step_enter: tuple[float, float],
        sync_enter: tuple[float, float],
        sync_exit: tuple[float, float],
        step_exit: tuple[float, float],
    ) -> None:
        record: dict[str, Any] = {
            "kind": "fleet_stamp",
            "generation": self.generation,
            "global_rank": self.global_rank,
            "step": int(step),
        }
        if self.process_id is not None:
            record["process_id"] = int(self.process_id)
        for name, (wall, mono) in (
            ("step_enter", step_enter),
            ("sync_enter", sync_enter),
            ("sync_exit", sync_exit),
            ("step_exit", step_exit),
        ):
            record[f"{name}_wall"] = wall
            record[f"{name}_mono"] = mono
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "FleetStamper":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


# --------------------------------------------------------------- ingest
@dataclasses.dataclass
class FleetData:
    """Everything a multi-process run left behind, parsed."""

    root: str
    worlds: dict[int, dict[str, Any]]
    events: list[dict[str, Any]]
    stamps: list[dict[str, Any]]
    barrier_stamps: dict[int, dict[int, dict[str, Any]]]
    heartbeats: dict[tuple[int, int], dict[str, Any]]
    dead_notes: dict[int, dict[str, Any]]
    torn_lines: dict[str, int]
    sources: list[str]

    @property
    def generations(self) -> list[int]:
        gens = set(self.worlds)
        gens.update(
            int(e["generation"])
            for e in self.events
            if e.get("event") == "generation_start"
            and isinstance(e.get("generation"), int)
        )
        gens.update(
            int(s["generation"])
            for s in self.stamps
            if isinstance(s.get("generation"), int)
        )
        return sorted(gens)

    @property
    def ranks(self) -> list[int]:
        out: set[int] = set()
        for world in self.worlds.values():
            out.update(int(r) for r in world.get("ranks", ()))
        out.update(
            int(s["global_rank"])
            for s in self.stamps
            if isinstance(s.get("global_rank"), int)
        )
        out.update(rank for _, rank in self.heartbeats)
        return sorted(out)


def _read_jsonl_tolerant(path: str) -> tuple[list[dict[str, Any]], int]:
    """Parse every intact line; count torn ones (a writer SIGKILLed
    mid-record leaves at most one, at the tail)."""
    records: list[dict[str, Any]] = []
    torn = 0
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    torn += 1
                    continue
                if isinstance(rec, dict):
                    records.append(rec)
    except OSError:
        pass
    return records, torn


def _num(rec: Mapping[str, Any], key: str) -> float | None:
    val = rec.get(key)
    return float(val) if isinstance(val, (int, float)) else None


def _stamp_from_step_record(rec: Mapping[str, Any]) -> dict[str, Any] | None:
    """Engine ``kind:"step"`` records carry the same sync stamps when
    telemetry was due — adapt them so multi-process training runs with
    per-rank ``--metrics-dir`` streams feed skew attribution without a
    dedicated stamper."""
    if _num(rec, "sync_enter_wall") is None:
        return None
    out: dict[str, Any] = {
        "kind": "fleet_stamp",
        "source": "step_record",
        "step": rec.get("step"),
        "generation": int(rec.get("generation", 0)),
        "global_rank": int(rec.get("global_rank", rec.get("process_id", 0))),
    }
    for key in (
        "sync_enter_wall",
        "sync_enter_mono",
        "sync_exit_wall",
        "sync_exit_mono",
        "step_enter_wall",
        "step_enter_mono",
        "step_exit_wall",
        "step_exit_mono",
    ):
        if _num(rec, key) is not None:
            out[key] = float(rec[key])
    return out


def _scan_store_json(
    root: str,
) -> tuple[
    dict[int, dict[str, Any]],
    dict[int, dict[int, dict[str, Any]]],
    dict[tuple[int, int], dict[str, Any]],
    dict[int, dict[str, Any]],
]:
    worlds: dict[int, dict[str, Any]] = {}
    barriers: dict[int, dict[int, dict[str, Any]]] = {}
    heartbeats: dict[tuple[int, int], dict[str, Any]] = {}
    dead_notes: dict[int, dict[str, Any]] = {}
    for name in sorted(os.listdir(root)):
        path = os.path.join(root, name)
        if not name.endswith(".json") or not os.path.isfile(path):
            continue
        kind = None
        for prefix in ("world_g", "sync_g", "hb_g", "dead_g"):
            if name.startswith(prefix):
                kind = prefix
                break
        if kind is None:
            continue
        stem = name[len(kind):-len(".json")]
        try:
            if "_r" in stem:
                gen_s, rank_s = stem.split("_r", 1)
                gen, rank = int(gen_s), int(rank_s)
            else:
                gen, rank = int(stem), None
            with open(path, encoding="utf-8") as f:
                rec = json.load(f)
        except (OSError, ValueError, json.JSONDecodeError):
            continue
        if kind == "world_g":
            worlds[gen] = rec
        elif kind == "sync_g" and rank is not None:
            barriers.setdefault(gen, {})[rank] = rec
        elif kind == "hb_g" and rank is not None:
            heartbeats[(gen, rank)] = rec
        elif kind == "dead_g":
            dead_notes[gen] = rec
    return worlds, barriers, heartbeats, dead_notes


def load_fleet_dir(root: str) -> FleetData:
    """Ingest a rendezvous-store directory (or any run dir that follows
    its layout): world/heartbeat/death-note/barrier files, the
    ``events.jsonl`` stream, per-rank ``fleet/`` stamp streams, and any
    other ``*.jsonl`` telemetry found below the root (per-rank metrics
    dirs, flight-recorder dumps) — classified per record, never per
    file."""
    root = os.path.abspath(root)
    if not os.path.isdir(root):
        raise FileNotFoundError(f"{root}: not a directory")
    worlds, barriers, heartbeats, dead_notes = _scan_store_json(root)
    events: list[dict[str, Any]] = []
    stamps: list[dict[str, Any]] = []
    torn_lines: dict[str, int] = {}
    sources: list[str] = []

    jsonl_paths: list[str] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in sorted(dirnames) if d != "logs"]
        for name in sorted(filenames):
            if name.endswith(".jsonl"):
                jsonl_paths.append(os.path.join(dirpath, name))

    for path in jsonl_paths:
        records, torn = _read_jsonl_tolerant(path)
        rel = os.path.relpath(path, root)
        if torn:
            torn_lines[rel] = torn
        used = False
        for rec in records:
            kind = rec.get("kind")
            if kind == "fleet_stamp":
                stamps.append(rec)
                used = True
            elif kind == "event":
                events.append(rec)
                used = True
            elif kind == "step":
                adapted = _stamp_from_step_record(rec)
                if adapted is not None:
                    stamps.append(adapted)
                    used = True
        if used or torn:
            sources.append(rel)

    events.sort(key=lambda e: _num(e, "time") or 0.0)
    stamps.sort(
        key=lambda s: (
            s.get("generation", 0) or 0,
            s.get("step", 0) or 0,
            s.get("global_rank", 0) or 0,
        )
    )
    return FleetData(
        root=root,
        worlds=worlds,
        events=events,
        stamps=stamps,
        barrier_stamps=barriers,
        heartbeats=heartbeats,
        dead_notes=dead_notes,
        torn_lines=torn_lines,
        sources=sources,
    )


# ------------------------------------------------------ clock alignment
class ClockAligner:
    """Map every rank's stamps onto one shared timeline using the
    rendezvous-barrier anchors (see module docstring for the model).
    The reference is the lowest-ranked anchor of each generation; a
    (generation, rank) without an anchor passes wall time through
    uncorrected and is counted in ``unanchored``."""

    def __init__(
        self, barrier_stamps: Mapping[int, Mapping[int, Mapping[str, Any]]]
    ):
        self._anchors: dict[tuple[int, int], dict[str, float]] = {}
        self._refs: dict[int, int] = {}
        for gen, per_rank in barrier_stamps.items():
            usable = {
                int(rank): rec
                for rank, rec in per_rank.items()
                if _num(rec, "wall") is not None
            }
            if not usable:
                continue
            self._refs[int(gen)] = min(usable)
            for rank, rec in usable.items():
                anchor = {"wall": float(rec["wall"])}
                mono = _num(rec, "mono")
                if mono is not None:
                    anchor["mono"] = mono
                self._anchors[(int(gen), rank)] = anchor
        self.unanchored: set[tuple[int, int]] = set()

    def reference_rank(self, generation: int) -> int | None:
        return self._refs.get(int(generation))

    def wall_offset(self, generation: int, rank: int) -> float | None:
        """Rank's barrier wall minus the reference's — the correction
        subtracted from the rank's wall stamps (0.0 for the reference,
        sub-millisecond between synced clocks on one machine)."""
        ref = self._refs.get(int(generation))
        if ref is None:
            return None
        anchor = self._anchors.get((int(generation), int(rank)))
        ref_anchor = self._anchors[(int(generation), ref)]
        if anchor is None:
            return None
        return anchor["wall"] - ref_anchor["wall"]

    def aligned(
        self,
        generation: int,
        rank: int,
        *,
        wall: float | None = None,
        mono: float | None = None,
    ) -> float | None:
        """A (wall, mono) stamp from ``rank`` in ``generation`` on the
        reference timeline; None only when no time is recoverable."""
        gen, rank = int(generation), int(rank)
        ref = self._refs.get(gen)
        anchor = self._anchors.get((gen, rank))
        if ref is not None and anchor is not None:
            ref_anchor = self._anchors[(gen, ref)]
            if (
                mono is not None
                and "mono" in anchor
                and "mono" in ref_anchor
            ):
                return ref_anchor["wall"] + (mono - anchor["mono"])
            if wall is not None:
                return wall - (anchor["wall"] - ref_anchor["wall"])
        if wall is not None:
            self.unanchored.add((gen, rank))
            return wall
        return None

    def aligned_record(
        self,
        rec: Mapping[str, Any],
        wall_key: str,
        mono_key: str,
    ) -> float | None:
        return self.aligned(
            int(rec.get("generation", 0)),
            int(rec.get("global_rank", 0)),
            wall=_num(rec, wall_key),
            mono=_num(rec, mono_key),
        )


# ------------------------------------------------------ skew attribution
def collective_skew(
    data: FleetData, aligner: ClockAligner | None = None
) -> list[dict[str, Any]]:
    """Per-(generation, step) collective arrival analysis.

    For every step at least two ranks completed, align each rank's
    ``sync_enter`` stamp (its arrival at the blocking fetch), name the
    straggler (latest arrival), and charge every earlier rank the wait
    it spent inside the collective: ``collective_wait_ms[r] =
    latest_arrival - arrival[r]``. The first stamped step of each
    generation is flagged ``warmup`` (it pays compilation, so its
    spread is noise, not a straggler signal); ``full_coverage`` says
    every rank of the generation's world reported."""
    aligner = ClockAligner(data.barrier_stamps) if aligner is None else aligner
    groups: dict[tuple[int, int], dict[int, dict[str, Any]]] = {}
    for rec in data.stamps:
        step = rec.get("step")
        gen = rec.get("generation")
        rank = rec.get("global_rank")
        if (
            not isinstance(step, int)
            or not isinstance(gen, int)
            or not isinstance(rank, int)
            or _num(rec, "sync_enter_wall") is None
            and _num(rec, "sync_enter_mono") is None
        ):
            continue
        groups.setdefault((gen, step), {})[rank] = rec

    first_step: dict[int, int] = {}
    for gen, step in groups:
        if gen not in first_step or step < first_step[gen]:
            first_step[gen] = step

    rows: list[dict[str, Any]] = []
    for (gen, step), per_rank in sorted(groups.items()):
        if len(per_rank) < 2:
            continue
        arrivals: dict[int, float] = {}
        for rank, rec in per_rank.items():
            t = aligner.aligned_record(rec, "sync_enter_wall", "sync_enter_mono")
            if t is not None:
                arrivals[rank] = t
        if len(arrivals) < 2:
            continue
        latest = max(arrivals.values())
        straggler = max(arrivals, key=lambda r: (arrivals[r], r))
        world = data.worlds.get(gen, {})
        world_ranks = {int(r) for r in world.get("ranks", ())}
        rows.append(
            {
                "kind": "fleet_skew",
                "generation": gen,
                "step": step,
                "ranks": sorted(arrivals),
                "straggler": straggler,
                "skew_ms": (latest - min(arrivals.values())) * 1e3,
                "collective_wait_ms": {
                    str(r): (latest - t) * 1e3
                    for r, t in sorted(arrivals.items())
                },
                "warmup": step == first_step.get(gen),
                "full_coverage": bool(world_ranks)
                and set(arrivals) == world_ranks,
            }
        )
    return rows


# ------------------------------------------------------ merged timeline
def _event_rank(event: Mapping[str, Any]) -> int | None:
    """Which rank's lane an event instant belongs on: explicit victim /
    exiter fields first, then the writer's own runtime label — except
    for supervisor-authored events, whose labels describe the
    supervisor, not a worker."""
    for key in ("dead_rank", "exit_rank"):
        if isinstance(event.get(key), int):
            return int(event[key])
    if event.get("event") in SUPERVISOR_EVENTS:
        return None
    rank = event.get("global_rank")
    return int(rank) if isinstance(rank, int) else None


def _event_name(event: Mapping[str, Any]) -> str:
    name = str(event.get("event", "event"))
    if name == "worker_death":
        reason = event.get("reason")
        if reason in ("heartbeat_stale", "never_heartbeat"):
            return f"missed heartbeat r{event.get('dead_rank')}"
        return f"death r{event.get('dead_rank')} ({reason})"
    if name == "reelection":
        return (
            f"re-election g{event.get('parent_generation')}"
            f"->g{event.get('generation')}"
        )
    if name == "generation_start":
        gen = event.get("generation")
        return f"re-exec g{gen}" if gen else f"start g{gen}"
    if name == "chaos_inject":
        return f"chaos {event.get('fault', '?')}"
    return name.replace("_", " ")


def merge_timeline(
    data: FleetData,
    aligner: ClockAligner | None = None,
    skew: Iterable[Mapping[str, Any]] | None = None,
) -> dict[str, Any]:
    """One Chrome/Perfetto trace for the whole run: pid 0 is the fleet
    lane (generation track + supervisor instants), pid r+1 is global
    rank r (stable across generations — a survivor's lane continues
    into g+1). Per rank, tid 0 carries step spans and tid 1 the
    collective window (sync-enter → sync-exit), annotated with the
    attributed wait when ``skew`` rows are supplied."""
    aligner = ClockAligner(data.barrier_stamps) if aligner is None else aligner
    wait_by_step: dict[tuple[int, int], Mapping[str, Any]] = {
        (int(row["generation"]), int(row["step"])): row
        for row in (skew or ())
    }

    # Pass 1: aligned times for every drawable item, to fix t0.
    drawables: list[tuple[float, str, Any]] = []  # (t, kind, payload)
    for event in data.events:
        gen = event.get("generation")
        rank = _event_rank(event)
        t = None
        if event.get("event") not in SUPERVISOR_EVENTS and rank is not None:
            t = aligner.aligned(
                int(gen) if isinstance(gen, int) else 0,
                rank,
                wall=_num(event, "time"),
                mono=_num(event, "monotonic"),
            )
        if t is None:
            t = _num(event, "time")
        if t is not None:
            drawables.append((t, "event", event))
    for gen, note in data.dead_notes.items():
        t = _num(note, "time")
        if t is not None:
            drawables.append((t, "dead_note", (gen, note)))
    spans: list[tuple[int, int, int, float, float, float | None]] = []
    # (rank, gen, step, step_enter, step_exit, sync bounds via lookup)
    stamp_times: list[tuple[float, float, dict[str, Any]]] = []
    for rec in data.stamps:
        rank = rec.get("global_rank")
        if not isinstance(rank, int):
            continue
        enter = aligner.aligned_record(rec, "step_enter_wall", "step_enter_mono")
        exit_ = aligner.aligned_record(rec, "step_exit_wall", "step_exit_mono")
        s_in = aligner.aligned_record(rec, "sync_enter_wall", "sync_enter_mono")
        s_out = aligner.aligned_record(rec, "sync_exit_wall", "sync_exit_mono")
        if enter is None:
            enter = s_in
        if exit_ is None:
            exit_ = s_out
        if enter is None or exit_ is None:
            continue
        stamp_times.append((enter, exit_, rec))
        drawables.append((enter, "stamp", (rec, enter, exit_, s_in, s_out)))

    if not drawables:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t0 = min(t for t, _, _ in drawables)

    def us(t: float) -> int:
        return int(round((t - t0) * 1e6))

    trace: list[dict[str, Any]] = []
    ranks = data.ranks

    # Process/thread metadata: fleet lane first, then one pid per rank.
    trace.append(
        {
            "ph": "M",
            "pid": 0,
            "tid": 0,
            "name": "process_name",
            "args": {"name": "fleet"},
        }
    )
    trace.append(
        {
            "ph": "M",
            "pid": 0,
            "tid": 0,
            "name": "process_sort_index",
            "args": {"sort_index": -1},
        }
    )
    for rank in ranks:
        pid = rank + 1
        trace.append(
            {
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "name": "process_name",
                "args": {"name": f"rank {rank}"},
            }
        )
        trace.append(
            {
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "name": "thread_name",
                "args": {"name": "steps"},
            }
        )
        trace.append(
            {
                "ph": "M",
                "pid": pid,
                "tid": 1,
                "name": "thread_name",
                "args": {"name": "collective"},
            }
        )

    # Generation track: one span per generation on the fleet lane, from
    # its generation_start to the next one (or the last drawable).
    t_end = max(
        max((t for t, _, _ in drawables)),
        max((e for _, e, _ in stamp_times), default=t0),
    )
    gen_starts: dict[int, float] = {}
    for t, kind, payload in drawables:
        if kind == "event" and payload.get("event") == "generation_start":
            gen = payload.get("generation")
            if isinstance(gen, int) and gen not in gen_starts:
                gen_starts[gen] = t
    for gen, start in sorted(gen_starts.items()):
        seal = gen_starts.get(gen + 1, t_end)
        trace.append(
            {
                "ph": "X",
                "pid": 0,
                "tid": 0,
                "name": f"generation {gen}",
                "cat": "generation",
                "ts": us(start),
                "dur": max(us(seal) - us(start), 1),
                "args": {"generation": gen},
            }
        )

    # Step + collective spans per rank.
    for t, kind, payload in drawables:
        if kind != "stamp":
            continue
        rec, enter, exit_, s_in, s_out = payload
        rank = int(rec["global_rank"])
        gen = int(rec.get("generation", 0))
        step = rec.get("step")
        args: dict[str, Any] = {"step": step, "generation": gen}
        trace.append(
            {
                "ph": "X",
                "pid": rank + 1,
                "tid": 0,
                "name": f"step {step}",
                "cat": "step",
                "ts": us(enter),
                "dur": max(us(exit_) - us(enter), 1),
                "args": args,
            }
        )
        if s_in is not None and s_out is not None:
            c_args = dict(args)
            row = wait_by_step.get((gen, step)) if isinstance(step, int) else None
            if row is not None:
                wait = row.get("collective_wait_ms", {}).get(str(rank))
                if wait is not None:
                    c_args["collective_wait_ms"] = round(float(wait), 3)
                c_args["straggler"] = row.get("straggler")
            trace.append(
                {
                    "ph": "X",
                    "pid": rank + 1,
                    "tid": 1,
                    "name": "collective",
                    "cat": "collective",
                    "ts": us(s_in),
                    "dur": max(us(s_out) - us(s_in), 1),
                    "args": c_args,
                }
            )

    # Instant markers.
    for t, kind, payload in drawables:
        if kind == "event":
            event = payload
            rank = _event_rank(event)
            trace.append(
                {
                    "ph": "i",
                    "pid": 0 if rank is None else rank + 1,
                    "tid": 0,
                    "name": _event_name(event),
                    "cat": "incident",
                    "ts": us(t),
                    "s": "g" if rank is None else "p",
                    "args": {
                        k: v
                        for k, v in event.items()
                        if k not in ("kind", "time", "monotonic")
                        and isinstance(v, (str, int, float, bool, list))
                    },
                }
            )
        elif kind == "dead_note":
            gen, note = payload
            trace.append(
                {
                    "ph": "i",
                    "pid": 0,
                    "tid": 0,
                    "name": f"death note g{gen} {note.get('dead')}",
                    "cat": "incident",
                    "ts": us(t),
                    "s": "g",
                    "args": {"generation": gen, "dead": note.get("dead")},
                }
            )

    trace.sort(key=lambda e: (e.get("ts", 0), e["pid"], e["tid"]))
    return {"traceEvents": trace, "displayTimeUnit": "ms"}


# ---------------------------------------------------------------- audit
def fleet_check(
    data: FleetData,
    aligner: ClockAligner | None = None,
    *,
    tolerance_s: float = 0.75,
) -> list[str]:
    """Incident-consistency audit over one run directory. Returns
    human-readable problems (empty = consistent):

    - every generation g>0 has a parent world AND a re-election event
      naming it (no orphan generations);
    - every death note / worker_death pairs with a re-election out of
      that generation and a re-exec (``generation_start``) into g+1
      whose world is exactly the survivors — unless the supervisor
      recorded ``recovery_giveup``;
    - kill → death → re-election → re-exec appear in causal order on
      the aligned timeline (within ``tolerance_s``);
    - no completed step span crosses its generation's seal (the next
      generation's start) — a span that straddles the seal means a rank
      kept stepping in a world that no longer existed;
    - stamps are internally ordered (enter ≤ sync-enter ≤ sync-exit ≤
      exit).
    """
    aligner = ClockAligner(data.barrier_stamps) if aligner is None else aligner
    problems: list[str] = []
    events = data.events
    worlds = data.worlds

    def evs(name: str, **match: Any) -> list[dict[str, Any]]:
        out = []
        for e in events:
            if e.get("event") != name:
                continue
            if all(e.get(k) == v for k, v in match.items()):
                out.append(e)
        return out

    # -- orphan generations
    for gen in sorted(worlds):
        if gen == 0:
            continue
        if gen - 1 not in worlds:
            problems.append(
                f"orphan generation {gen}: no world spec for parent "
                f"generation {gen - 1}"
            )
        if not evs("reelection", generation=gen):
            problems.append(
                f"orphan generation {gen}: no re-election event elected it"
            )

    # -- deaths pair with re-election + re-exec into g+1
    deaths_by_gen: dict[int, set[int]] = {}
    for e in evs("worker_death"):
        gen = e.get("generation")
        rank = e.get("dead_rank")
        if isinstance(gen, int) and isinstance(rank, int):
            deaths_by_gen.setdefault(gen, set()).add(rank)
    for gen, note in data.dead_notes.items():
        deaths_by_gen.setdefault(int(gen), set()).update(
            int(r) for r in note.get("dead", ())
        )

    for gen, dead in sorted(deaths_by_gen.items()):
        if evs("recovery_giveup", generation=gen):
            continue
        reelections = evs("reelection", parent_generation=gen)
        if not reelections:
            problems.append(
                f"death of rank(s) {sorted(dead)} in generation {gen} has "
                f"no re-election out of it (and no giveup)"
            )
            continue
        child = gen + 1
        if not evs("generation_start", generation=child):
            problems.append(
                f"re-election g{gen}->g{child} was never re-exec'd "
                f"(no generation_start for {child})"
            )
        child_world = worlds.get(child)
        parent_world = worlds.get(gen)
        if child_world is None:
            problems.append(
                f"re-election g{gen}->g{child} left no world spec for "
                f"generation {child}"
            )
        elif parent_world is not None:
            survivors = {
                int(r) for r in parent_world.get("ranks", ())
            } - dead
            child_ranks = {int(r) for r in child_world.get("ranks", ())}
            if child_ranks != survivors:
                problems.append(
                    f"generation {child} world {sorted(child_ranks)} != "
                    f"survivors {sorted(survivors)} of generation {gen}"
                )

    # -- causal order on the aligned timeline
    def ev_time(e: Mapping[str, Any]) -> float | None:
        rank = _event_rank(e)
        if e.get("event") not in SUPERVISOR_EVENTS and rank is not None:
            gen = e.get("generation")
            t = aligner.aligned(
                int(gen) if isinstance(gen, int) else 0,
                rank,
                wall=_num(e, "time"),
                mono=_num(e, "monotonic"),
            )
            if t is not None:
                return t
        return _num(e, "time")

    for gen, dead in sorted(deaths_by_gen.items()):
        chain: list[tuple[str, float]] = []
        kills = [
            e
            for e in evs("chaos_inject", generation=gen)
            if e.get("fault") == "process_kill"
        ]
        kill_times = [t for t in (ev_time(e) for e in kills) if t is not None]
        if kill_times:
            chain.append(("chaos kill", min(kill_times)))
        death_times = [
            t
            for t in (ev_time(e) for e in evs("worker_death", generation=gen))
            if t is not None
        ]
        if death_times:
            chain.append(("death", min(death_times)))
        note = data.dead_notes.get(gen)
        if note is not None and _num(note, "time") is not None:
            chain.append(("death note", float(note["time"])))
        for e in evs("reelection", parent_generation=gen):
            t = ev_time(e)
            if t is not None:
                chain.append(("re-election", t))
        for e in evs("generation_start", generation=gen + 1):
            t = ev_time(e)
            if t is not None:
                chain.append(("re-exec", t))
        for (name_a, t_a), (name_b, t_b) in zip(chain, chain[1:]):
            if t_b < t_a - tolerance_s:
                problems.append(
                    f"generation {gen}: {name_b} at {t_b:.3f} precedes "
                    f"{name_a} at {t_a:.3f} (aligned) — causality violated"
                )

    # -- seals and stamp sanity
    gen_start_times: dict[int, float] = {}
    for e in evs("generation_start"):
        gen = e.get("generation")
        t = ev_time(e)
        if isinstance(gen, int) and t is not None and gen not in gen_start_times:
            gen_start_times[gen] = t
    for rec in data.stamps:
        gen = rec.get("generation")
        rank = rec.get("global_rank")
        step = rec.get("step")
        if not isinstance(gen, int) or not isinstance(rank, int):
            continue
        order = [
            _num(rec, f"{k}_mono")
            for k in ("step_enter", "sync_enter", "sync_exit", "step_exit")
        ]
        present = [t for t in order if t is not None]
        if present != sorted(present):
            problems.append(
                f"stamp g{gen} r{rank} step {step}: timestamps out of "
                f"order {present}"
            )
        seal = gen_start_times.get(gen + 1)
        if seal is None:
            continue
        exit_t = aligner.aligned_record(rec, "step_exit_wall", "step_exit_mono")
        if exit_t is not None and exit_t > seal + tolerance_s:
            problems.append(
                f"stamp g{gen} r{rank} step {step}: step exit at "
                f"{exit_t:.3f} crosses the generation seal at {seal:.3f}"
            )

    return problems


# --------------------------------------------------------------- report
def fleet_report_records(
    data: FleetData,
    skew: list[dict[str, Any]],
    problems: list[str],
) -> list[dict[str, Any]]:
    """Flat records: the skew rows plus one ``fleet_incident`` per
    lifecycle event and a summary (the JAX package's
    ``benchmarks/metrics_summary.py`` reads them)."""
    records: list[dict[str, Any]] = []
    incident_names = (
        "chaos_inject",
        "worker_death",
        "reelection",
        "generation_start",
        "recovery_giveup",
        "process_loss",
        "run_complete",
    )
    for e in data.events:
        if e.get("event") in incident_names:
            records.append(
                {
                    "kind": "fleet_incident",
                    "event": e.get("event"),
                    "generation": e.get("generation"),
                    "time": e.get("time"),
                    "rank": _event_rank(e),
                }
            )
    records.extend(skew)
    post = [r for r in skew if not r["warmup"]]
    records.append(
        {
            "kind": "fleet_summary",
            "generations": data.generations,
            "ranks": data.ranks,
            "steps_attributed": len(skew),
            "max_skew_ms": max((r["skew_ms"] for r in post), default=None),
            "problems": len(problems),
            "torn_lines": sum(data.torn_lines.values()),
        }
    )
    return records


def render_fleet_report(
    data: FleetData,
    skew: list[dict[str, Any]],
    problems: list[str],
    aligner: ClockAligner | None = None,
) -> str:
    aligner = ClockAligner(data.barrier_stamps) if aligner is None else aligner
    lines = [f"graftfleet report — {data.root}"]
    for gen in data.generations:
        world = data.worlds.get(gen, {})
        ranks = [int(r) for r in world.get("ranks", ())]
        dead = sorted(data.dead_notes.get(gen, {}).get("dead", ()))
        ref = aligner.reference_rank(gen)
        parts = [f"g{gen}: ranks {ranks or '?'}"]
        if world.get("coordinator_rank") is not None:
            parts.append(f"coordinator r{world['coordinator_rank']}")
        if ref is not None:
            offsets = [
                f"r{r}{(aligner.wall_offset(gen, r) or 0) * 1e3:+.1f}ms"
                for r in ranks
                if aligner.wall_offset(gen, r) is not None and r != ref
            ]
            parts.append(
                f"clock ref r{ref}" + (f" ({' '.join(offsets)})" if offsets else "")
            )
        if dead:
            parts.append(f"dead {dead}")
        lines.append("  " + " | ".join(parts))

    incidents = [
        e
        for e in data.events
        if e.get("event")
        in (
            "chaos_inject",
            "worker_death",
            "reelection",
            "generation_start",
            "recovery_giveup",
            "process_loss",
            "run_complete",
        )
    ]
    if incidents:
        t0 = min(_num(e, "time") or 0.0 for e in incidents)
        lines.append(f"  incidents ({len(incidents)}):")
        for e in incidents:
            t = (_num(e, "time") or 0.0) - t0
            lines.append(f"    +{t:7.3f}s  {_event_name(e)}")

    post = [r for r in skew if not r["warmup"]]
    if skew:
        named: dict[int, int] = {}
        for row in post:
            named[row["straggler"]] = named.get(row["straggler"], 0) + 1
        top = sorted(named.items(), key=lambda kv: -kv[1])
        lines.append(
            f"  collective skew: {len(skew)} steps attributed "
            f"({len(post)} post-warmup)"
        )
        if post:
            skews = sorted(r["skew_ms"] for r in post)
            lines.append(
                f"    skew_ms median {skews[len(skews) // 2]:.1f} "
                f"max {skews[-1]:.1f}"
            )
        if top:
            lines.append(
                "    stragglers: "
                + ", ".join(f"r{r} x{n}" for r, n in top)
            )
    else:
        lines.append("  collective skew: no stamped steps found")

    if data.torn_lines:
        for rel, n in sorted(data.torn_lines.items()):
            lines.append(f"  torn lines: {n} in {rel}")
    if problems:
        lines.append(f"  audit: {len(problems)} problem(s)")
        for prob in problems:
            lines.append(f"    !! {prob}")
    else:
        lines.append("  audit: OK")
    return "\n".join(lines)


def write_fleet_artifacts(
    root: str, out_dir: str | None = None
) -> dict[str, Any]:
    """Load a run dir and leave ``fleet_trace.json`` (Perfetto) +
    ``fleet_report.json`` next to it. Returns paths, problems, and the
    rendered text report: the supervisor logs the text, a check gates on
    the problems."""
    data = load_fleet_dir(root)
    aligner = ClockAligner(data.barrier_stamps)
    skew = collective_skew(data, aligner)
    problems = fleet_check(data, aligner)
    trace = merge_timeline(data, aligner, skew)
    out_dir = data.root if out_dir is None else os.path.abspath(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    trace_path = os.path.join(out_dir, TRACE_NAME)
    with open(trace_path, "w", encoding="utf-8") as f:
        json.dump(trace, f)
    report_path = os.path.join(out_dir, REPORT_NAME)
    report = {
        "kind": "fleet_report",
        "root": data.root,
        "generations": data.generations,
        "ranks": data.ranks,
        "problems": problems,
        "records": fleet_report_records(data, skew, problems),
    }
    with open(report_path, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=1)
    return {
        "trace": trace_path,
        "report": report_path,
        "problems": problems,
        "text": render_fleet_report(data, skew, problems, aligner),
    }
