"""Summarize an elastic run's rendezvous store: how the survivors of each
lost generation left, how long recovery took, the fleet audit and the
straggler, and the stitched losses against an uninterrupted run.

    python scripts/elastic_report.py STORE [--clean CLEAN_STORE] [--steps N]

prints one JSON object. STORE is what ``python -m
cs744_pytorch_distributed_tutorial_tpu_torch.launch --store STORE``
left (the demo worker's logs print one ``[graftelastic] ... loss=`` line a
step); CLEAN_STORE an uninterrupted run at the shrunk world. Each
survivor's exit is classified by its code: 17 is the collective
watchdog's ``EXIT_PROCESS_LOSS``, -6 a SIGABRT (torch's NCCL watchdog),
any other nonzero code an exception (its log's last lines say which);
a survivor with no exit event was still running when the supervisor's
grace ran out and was ended by its SIGTERM or SIGKILL. ``chip_smoke.py``
and ``scripts/elastic_cards.sh`` use it.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
import sys

_LOSS_RE = re.compile(r"\[graftelastic\] gen=(\d+) grank=(\d+) step=(\d+) loss=([0-9.eE+-]+)")
_WHY = ("collective watchdog", "DistBackendError", "Connection closed", "Connection reset",
        "NCCL", "Watchdog caught", "Traceback", "Error", "SIGABRT", "Aborted")


def _exit_kind(rc: int) -> str:
    if rc == 17:
        return "watchdog EXIT_PROCESS_LOSS (17)"
    if rc == -signal.SIGABRT:
        return "SIGABRT"
    if rc == -signal.SIGTERM:
        return "SIGTERM"
    if rc == -signal.SIGKILL:
        return "SIGKILL"
    return f"exception (exit {rc})" if rc else "exit 0"


def _log_reason(path: str) -> list[str]:
    """The lines of a rank's log that say what ended it (at most 4)."""
    try:
        with open(path, encoding="utf-8", errors="replace") as f:
            lines = [ln.strip() for ln in f if ln.strip()]
    except OSError:
        return []
    hits = [ln[:240] for ln in lines if any(w in ln for w in _WHY)]
    return hits[-4:] if hits else [ln[:240] for ln in lines[-2:]]


def trajectory(store: str) -> dict[int, float]:
    """Each step's loss from the ranks' logs (the newest generation wins a
    step; every rank of a generation prints the same world mean)."""
    by_step: dict[tuple[int, int], set] = {}
    logdir = os.path.join(store, "logs")
    for name in sorted(os.listdir(logdir)):
        with open(os.path.join(logdir, name), encoding="utf-8", errors="replace") as f:
            for m in _LOSS_RE.finditer(f.read()):
                by_step.setdefault((int(m[1]), int(m[3])), set()).add(float(m[4]))
    best: dict[int, tuple[int, float]] = {}
    for (gen, step), losses in by_step.items():
        if len(losses) != 1:
            raise ValueError(f"ranks disagree at generation {gen} step {step}: {losses}")
        if step not in best or gen > best[step][0]:
            best[step] = (gen, next(iter(losses)))
    return {s: best[s][1] for s in sorted(best)}


def summarize(store: str, clean: str | None = None) -> dict:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from cs744_pytorch_distributed_tutorial_tpu_torch.obs import fleet as F
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.multihost import RendezvousStore

    rs = RendezvousStore(store)
    events = rs.events()
    data = F.load_fleet_dir(store)
    aligner = F.ClockAligner(data.barrier_stamps)
    skew = F.collective_skew(data, aligner)
    named: dict[int, int] = {}
    for row in skew:
        if not row["warmup"]:
            named[row["straggler"]] = named.get(row["straggler"], 0) + 1
    out: dict = {
        "generations": data.generations,
        "worlds": {g: data.worlds[g].get("ranks") for g in data.generations if g in data.worlds},
        "coordinators": {g: data.worlds[g].get("coordinator_rank")
                         for g in data.generations if g in data.worlds},
        "fleet_check": F.fleet_check(data, aligner),
        "stragglers": named,
        "straggler": max(named, key=lambda r: (named[r], -r)) if named else None,
        "max_skew_ms": max((r["skew_ms"] for r in skew if not r["warmup"]), default=None),
        "losses": trajectory(store),
        "incidents": [],
    }
    for gen in data.generations:
        kills = [e for e in events if e.get("event") == "chaos_inject"
                 and e.get("fault") == "process_kill" and e.get("generation") == gen]
        deaths = [e for e in events if e.get("event") == "worker_death"
                  and e.get("generation") == gen]
        if not deaths:
            continue
        t_kill = min(e["time"] for e in kills) if kills else min(e["time"] for e in deaths)
        dead = {e["dead_rank"] for e in deaths}
        exits = {e["exit_rank"]: e for e in events if e.get("event") == "worker_exit"
                 and e.get("generation") == gen}
        survivors = {}
        for rank in data.worlds.get(gen, {}).get("ranks", []):
            if rank in dead:
                continue
            ev = exits.get(rank)
            log = rs.log_path(gen, rank)
            survivors[rank] = {
                "ended_by": _exit_kind(ev["returncode"]) if ev else
                "no exit in the grace: the supervisor's SIGTERM/SIGKILL",
                "returncode": ev["returncode"] if ev else None,
                "s_after_kill": round(ev["time"] - t_kill, 3) if ev else None,
                "log": _log_reason(log),
            }
        nxt = [e for e in events if e.get("event") == "generation_start"
               and e.get("generation") == gen + 1]
        firsts = [s for s in data.stamps if s.get("generation") == gen + 1]
        first_step = min((s["step"] for s in firsts), default=None)
        first_exit = min((s["step_exit_wall"] for s in firsts if s["step"] == first_step),
                         default=None)
        exit_times = [v["s_after_kill"] for v in survivors.values()
                      if v["s_after_kill"] is not None]
        out["incidents"].append({
            "generation": gen,
            "dead": sorted(dead),
            "death_reasons": sorted({e.get("reason") for e in deaths}),
            "survivors": survivors,
            "s_kill_to_last_survivor_exit": max(exit_times) if exit_times else None,
            "s_kill_to_reexec": round(nxt[0]["time"] - t_kill, 3) if nxt else None,
            "s_reexec_to_first_resumed_step": (round(first_exit - nxt[0]["time"], 3)
                                               if nxt and first_exit else None),
            "s_kill_to_first_resumed_step": (round(first_exit - t_kill, 3)
                                             if first_exit else None),
            "first_resumed_step": first_step,
        })
    if clean is not None:
        want = trajectory(clean)
        got = out["losses"]
        rel = max((abs(got[s] - want[s]) / abs(want[s]) for s in want if s in got),
                  default=None)
        out["clean_losses"] = want
        out["max_rel_gap_vs_clean"] = rel
        out["same_steps_as_clean"] = sorted(got) == sorted(want)
    return out


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("store")
    p.add_argument("--clean", default=None, help="an uninterrupted run's store")
    args = p.parse_args(argv)
    print(json.dumps(summarize(args.store, args.clean), default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
