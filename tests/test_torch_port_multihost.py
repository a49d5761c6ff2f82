"""The elastic runtime (``parallel/multihost.py``, ``launch.py``) and the
CIFAR CLI's ``--distributed`` against the JAX package's.

- ``plan_next_generation`` gives JAX's plan on the same worlds, the
  coordinator's death and a total loss included.
- A store written by the port's ``RendezvousStore`` is read by JAX's
  (worlds, heartbeats, death notes, barrier stamps, ``read_events``),
  and the other way round: the files and the JSON are one format.
- The runtime labels resolve explicit > ``GRAFT_ELASTIC_*`` environment >
  process group > defaults; log prefixes re-resolve a record at a time;
  the decorrelated restart jitter draws JAX's stream for (seed, process
  id, generation), so it follows a re-exec.
- The collective watchdog fires within its deadline only when a peer is
  dead (a death note or a stale heartbeat), and re-arms otherwise.
- The launcher on 4 Gloo CPU workers: ``--kill 3:1`` re-execs the three
  survivors into generation 1 and the stitched losses equal an
  uninterrupted 3-worker run at rtol 1e-6 (JAX's bar); ``--platform
  inherit`` refuses more workers than visible cards before it spawns.
  The coordinator kill with a straggler (rank 0 killed at step 3, rank 2
  stalled 100 ms a step) is marked slow, as JAX's is; ``chip_smoke.py``
  runs it on every chip run.
- ``cli --distributed`` under torchrun's variables at a world of one and
  of two Gloo ranks.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from cs744_pytorch_distributed_tutorial_tpu.parallel import multihost as JM
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import multihost as M

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def clean_labels():
    M.reset_runtime_labels()
    JM.reset_runtime_labels()
    yield
    M.reset_runtime_labels()
    JM.reset_runtime_labels()


@pytest.mark.parametrize("world,dead", [
    ({"generation": 0, "ranks": [0, 1, 2, 3], "coordinator_rank": 0}, [2]),
    ({"generation": 0, "ranks": [0, 1, 2, 3], "coordinator_rank": 0}, [0]),
    ({"generation": 2, "ranks": [1, 3, 5], "coordinator_rank": 1}, [1, 5]),
    ({"generation": 1, "ranks": [0, 2], "coordinator_rank": 0}, [0, 2]),
])
def test_reelection_plan_is_jax(world, dead):
    plan = M.plan_next_generation(world, dead)
    assert plan == JM.plan_next_generation(world, dead)
    survivors = [r for r in world["ranks"] if r not in dead]
    assert plan["coordinator_rank"] == (survivors[0] if survivors else None)
    assert M.EXIT_PROCESS_LOSS == JM.EXIT_PROCESS_LOSS == 17


def _write_store(mod, root: str) -> None:
    store = mod.RendezvousStore(root)
    store.write_world({"generation": 0, "ranks": [0, 1, 2], "coordinator": "127.0.0.1:1",
                       "coordinator_rank": 0})
    store.heartbeat(0, 1, step=4)
    store.mark_dead(0, [2])
    store.mark_dead(0, [0])
    store.barrier_stamp(0, 1)
    store.append_event("generation_start", generation=0, world_size=3, ranks=[0, 1, 2])
    store.append_event("worker_death", generation=0, dead_rank=2, reason="sigkill")
    with open(store.events_path, "a", encoding="utf-8") as f:
        f.write('{"kind": "event", "event": "tor')  # a writer killed mid-record


def _read_store(mod, root: str) -> dict:
    store = mod.RendezvousStore(root)
    events, torn = mod.read_events(store.events_path)
    return {
        "world": store.read_world(0),
        "latest": store.latest_generation(),
        "dead": sorted(store.dead(0)),
        "age": store.heartbeat_age(0, 1) is not None and store.heartbeat_age(0, 1) < 60,
        "never": store.heartbeat_age(0, 2),
        "stamps": sorted(store.read_barrier_stamps(0)),
        "events": [(e["event"], e.get("generation"), e.get("process_id")) for e in events],
        "torn": torn,
    }


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_store_is_readable_by_either_package(tmp_path, clean_labels, writer, reader):
    mods = {"port": M, "jax": JM}
    root = str(tmp_path / "store")
    _write_store(mods[writer], root)
    got, same = _read_store(mods[reader], root), _read_store(mods[writer], root)
    assert got == same
    assert got["dead"] == [0, 2] and got["stamps"] == [1] and got["torn"] == 1
    assert got["events"] == [("generation_start", 0, 0), ("worker_death", 0, 0)]
    assert sorted(os.listdir(root)) == sorted(
        ["world_g000000.json", "hb_g000000_r1.json", "dead_g000000.json",
         "sync_g000000_r1.json", "events.jsonl", "logs"])


def test_worker_context_env_is_jax():
    kw = dict(store_dir="/s", generation=2, process_id=1, num_processes=3,
              coordinator="h:5", global_rank=3)
    ctx = M.WorkerContext(**kw)
    assert ctx.env() == JM.WorkerContext(**kw).env()
    assert M.env_context(ctx.env()) == ctx
    assert M.env_context({}) is None


def test_runtime_labels_resolution_order(clean_labels, monkeypatch, tmp_path):
    import torch.distributed as dist

    for k in (M.ENV_RANK, M.ENV_WORLD, M.ENV_GENERATION, M.ENV_GLOBAL_RANK):
        monkeypatch.delenv(k, raising=False)
    assert M.runtime_labels() == {"process_id": 0, "process_count": 1, "generation": 0,
                                  "global_rank": 0}
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}", world_size=1,
                            rank=0)
    try:
        assert M.runtime_labels()["process_count"] == 1  # the process group
        monkeypatch.setenv(M.ENV_RANK, "2")
        monkeypatch.setenv(M.ENV_WORLD, "3")
        monkeypatch.setenv(M.ENV_GENERATION, "1")
        monkeypatch.setenv(M.ENV_GLOBAL_RANK, "5")
        want = {"process_id": 2, "process_count": 3, "generation": 1, "global_rank": 5}
        assert M.runtime_labels() == want == JM.runtime_labels()  # the environment wins
        M.set_runtime_labels(process_id=0, process_count=2, generation=4, global_rank=1)
        assert M.runtime_labels() == {"process_id": 0, "process_count": 2, "generation": 4,
                                      "global_rank": 1}  # explicit wins
    finally:
        dist.destroy_process_group()


def test_log_prefix_and_event_stamps_re_resolve(clean_labels, tmp_path):
    from cs744_pytorch_distributed_tutorial_tpu_torch.obs.sinks import RingSink
    from cs744_pytorch_distributed_tutorial_tpu_torch.utils.failure import emit_event
    from cs744_pytorch_distributed_tutorial_tpu_torch.utils.logging import _RankPrefixFilter

    def prefix():
        rec = logging.LogRecord("x", logging.INFO, "", 0, "m", None, None)
        _RankPrefixFilter().filter(rec)
        return rec.rank_prefix

    assert prefix() == ""
    M.set_runtime_labels(process_id=2, process_count=4, generation=0, global_rank=2)
    assert prefix() == "[proc 2/4] "
    M.set_runtime_labels(process_id=1, process_count=3, generation=1, global_rank=2)
    assert prefix() == "[proc 1/3 g1] "
    ring = RingSink()
    emit_event(ring, "x")
    rec = ring.records()[-1]
    assert (rec["process_id"], rec["generation"]) == (1, 1)
    store = M.RendezvousStore(str(tmp_path / "s"))
    store.append_event("y")
    [ev] = store.events()
    assert (ev["process_id"], ev["process_count"], ev["generation"], ev["global_rank"]) == (
        1, 3, 1, 2)


def test_restart_jitter_follows_the_generation(clean_labels):
    from cs744_pytorch_distributed_tutorial_tpu.utils import failure as JF
    from cs744_pytorch_distributed_tutorial_tpu_torch.utils import failure as F

    class _Failing:
        cfg = type("C", (), {"checkpoint_dir": "x"})()

        def __init__(self, exc):
            self.exc = exc

        def fit(self):
            raise self.exc(0, float("nan"))

    def seq(mod):
        sleeps = []
        with pytest.raises(mod.NonFiniteLossError):
            mod.run_with_recovery(_Failing(mod.NonFiniteLossError), max_restarts=4,
                                  backoff_s=0.5, backoff_jitter="decorrelated", jitter_seed=3,
                                  sleep=sleeps.append)
        return sleeps

    out = {}
    for gen in (0, 1):
        M.set_runtime_labels(process_id=1, process_count=3, generation=gen, global_rank=2)
        JM.set_runtime_labels(process_id=1, process_count=3, generation=gen, global_rank=2)
        out[gen] = seq(F)
        assert out[gen] == seq(JF)
    assert out[0] != out[1]


# ------------------------------------------------------------- watchdog
def _ctx(tmp_path, world=2):
    return M.WorkerContext(store_dir=str(tmp_path / "store"), generation=0, process_id=0,
                           num_processes=world, coordinator="127.0.0.1:1", global_rank=0)


def test_watchdog_fires_within_its_deadline_on_a_dead_peer(tmp_path):
    from cs744_pytorch_distributed_tutorial_tpu_torch.utils.failure import ProcessLossError

    store = M.RendezvousStore(str(tmp_path / "store"))
    store.write_world({"generation": 0, "ranks": [0, 1], "coordinator_rank": 0})
    store.mark_dead(0, [1])
    losses = []
    wd = M.CollectiveWatchdog(store, _ctx(tmp_path), deadline_s=0.4, on_loss=losses.append,
                              poll_s=0.05)
    try:
        t0 = time.monotonic()
        with wd.watch():
            while not losses and time.monotonic() - t0 < 5:
                time.sleep(0.05)  # stands in for a host blocked in a collective
        elapsed = time.monotonic() - t0
        assert wd.fired == 1 and 0.4 <= elapsed < 3.0, elapsed
        [err] = losses
        assert isinstance(err, ProcessLossError) and err.dead == (1,)
        [ev] = [e for e in store.events() if e["event"] == "process_loss"]
        assert ev["dead"] == [1] and ev["elapsed_s"] >= 0.4
    finally:
        wd.close()


def test_watchdog_rearms_without_a_dead_peer(tmp_path):
    store = M.RendezvousStore(str(tmp_path / "store"))
    store.write_world({"generation": 0, "ranks": [0, 1], "coordinator_rank": 0})
    losses = []
    wd = M.CollectiveWatchdog(store, _ctx(tmp_path), deadline_s=0.2, on_loss=losses.append,
                              poll_s=0.05, stale_after_s=60.0)
    try:
        deadline = time.monotonic() + 0.8
        with wd.watch():
            while time.monotonic() < deadline:
                store.heartbeat(0, 1)  # slow, not dead
                time.sleep(0.05)
        assert wd.fired == 0 and losses == []
    finally:
        wd.close()


def test_watchdog_evidence_is_notes_and_stale_heartbeats(tmp_path):
    from cs744_pytorch_distributed_tutorial_tpu_torch.utils.failure import ProcessLossError

    store = M.RendezvousStore(str(tmp_path / "store"))
    store.write_world({"generation": 0, "ranks": [0, 1, 2, 3], "coordinator_rank": 0})
    wd = M.CollectiveWatchdog(store, _ctx(tmp_path, 4), deadline_s=30.0,
                              on_loss=lambda e: None, stale_after_s=0.1, poll_s=5.0)
    try:
        store.heartbeat(0, 2)
        assert wd.dead_peers() == []  # rank 3 never beat: still starting
        time.sleep(0.3)
        store.mark_dead(0, [1])
        assert wd.dead_peers() == [1, 2]
        with pytest.raises(ProcessLossError) as exc:
            wd.check()
        assert exc.value.dead == (1, 2)
    finally:
        wd.close()


# ------------------------------------------------------------ launcher
def _launch(store: str, *extra: str) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.Popen(
        [sys.executable, "-m", "cs744_pytorch_distributed_tutorial_tpu_torch.launch",
         "--platform", "cpu", "--store", store, "--collective-deadline-s", "6", *extra],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _trajectory(store: str, steps: int) -> list[float]:
    """Each step's loss from the ranks' logs (``scripts/elastic_report.py``:
    every rank of a generation prints the same world mean; the newest
    generation wins a step)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "elastic_report", os.path.join(REPO, "scripts", "elastic_report.py"))
    report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report)
    losses = report.trajectory(store)
    assert sorted(losses) == list(range(steps)), sorted(losses)
    return [losses[s] for s in range(steps)]


def _check_run(store, *, steps, killed, kill_step, survivors, coordinator):
    evs = M.RendezvousStore(store).events()
    deaths = [e for e in evs if e["event"] == "worker_death"]
    assert {e["dead_rank"] for e in deaths} == {killed}
    assert all(e["reason"] == "sigkill" for e in deaths)
    [inject] = [e for e in evs if e["event"] == "chaos_inject" and e["fault"] == "process_kill"]
    assert inject["global_rank"] == killed and inject["call"] == kill_step
    [reelection] = [e for e in evs if e["event"] == "reelection"]
    assert (reelection["survivors"], reelection["coordinator_rank"], reelection["dead"],
            reelection["generation"]) == (survivors, coordinator, [killed], 1)
    gens = [e for e in evs if e["event"] == "generation_start"]
    assert [(e["generation"], e["world_size"]) for e in gens] == [(0, 4), (1, 3)]
    resumes = [e for e in evs if e["event"] == "recovery_resume"]
    assert len(resumes) == len(survivors)
    assert all((e["step"], e["tier"], e["generation"], e["files_read"]) == (kill_step, "disk",
                                                                           1, 4)
               for e in resumes)
    # every survivor of generation 0 left with a nonzero code: a survivor
    world0 = M.RendezvousStore(store).read_world(0)
    exits = [e for e in evs if e["event"] == "worker_exit" and e["generation"] == 0]
    assert {e["exit_rank"] for e in exits} == set(world0["ranks"]) - {killed}
    assert all(e["returncode"] not in (0, -signal.SIGKILL) for e in exits)
    assert [e for e in evs if e["event"] == "run_complete"]
    return _trajectory(store, steps)


def _run_pair(tmp_path, steps, kill, slow=()):
    """The kill run at 4 workers and the uninterrupted run at 3, together."""
    runs = {"kill": _launch(str(tmp_path / "kill"), "--nprocs", "4", "--steps", str(steps),
                            "--kill", kill, *slow),
            "clean": _launch(str(tmp_path / "clean"), "--nprocs", "3", "--steps", str(steps))}
    out = {}
    for name, proc in runs.items():
        out[name] = proc.communicate(timeout=240)[0]
        assert proc.returncode == 0, out[name]
    return out


def test_launch_survives_a_worker_kill_and_matches_the_shrunk_world(tmp_path):
    t0 = time.monotonic()
    _run_pair(tmp_path, 6, "3:1")
    got = _check_run(str(tmp_path / "kill"), steps=6, killed=1, kill_step=3,
                     survivors=[0, 2, 3], coordinator=0)
    np.testing.assert_allclose(got, _trajectory(str(tmp_path / "clean"), 6), rtol=1e-6)
    with open(tmp_path / "kill" / "fleet_report.json", encoding="utf-8") as f:
        assert json.load(f)["problems"] == []
    assert time.monotonic() - t0 < 45


@pytest.mark.slow  # chip_smoke.py's elastic phase runs it on every chip run
def test_launch_survives_a_coordinator_kill_and_names_the_straggler(tmp_path):
    from cs744_pytorch_distributed_tutorial_tpu_torch.obs import fleet as F

    _run_pair(tmp_path, 6, "3:0", ("--slow", "2:100"))
    got = _check_run(str(tmp_path / "kill"), steps=6, killed=0, kill_step=3,
                     survivors=[1, 2, 3], coordinator=1)
    np.testing.assert_allclose(got, _trajectory(str(tmp_path / "clean"), 6), rtol=1e-6)
    data = F.load_fleet_dir(str(tmp_path / "kill"))
    assert F.fleet_check(data) == []
    post = [r for r in F.collective_skew(data) if not r["warmup"]]
    assert post and all(r["straggler"] == 2 for r in post)


def test_cli_workers_attach_under_the_supervisor(tmp_path):
    """The CIFAR CLI as the worker command: it attaches through the
    GRAFT_ELASTIC_* environment (heartbeats, barrier stamps, labels) and
    trains on the supervisor's world."""
    store = tmp_path / "cli"
    proc = _launch(str(store), "--nprocs", "2", "--", sys.executable, "-m",
                   "cs744_pytorch_distributed_tutorial_tpu_torch.cli", "--part", "2b",
                   "--num-devices", "2", "--model", "tiny_cnn", "--synthetic-data",
                   "--synthetic-train-size", "32", "--synthetic-test-size", "16",
                   "--global-batch-size", "8", "--device", "cpu", "--json")
    out = proc.communicate(timeout=120)[0]
    assert proc.returncode == 0, out
    assert sorted(p.name for p in store.glob("sync_g000000_r*.json")) == [
        "sync_g000000_r0.json", "sync_g000000_r1.json"]
    assert [e["event"] for e in M.RendezvousStore(str(store)).events()][-1] == "run_complete"
    log = (store / "logs" / "g000000_r0.log").read_text()
    summary = json.loads([ln for ln in log.splitlines() if ln.startswith("{")][-1])
    assert (summary["num_devices"], summary["backend"], summary["steps"]) == (2, "gloo", 4)
    assert "Test set: Average loss" in (store / "logs" / "g000000_r1.log").read_text()


def test_free_port_is_free_on_every_address(monkeypatch):
    """The rendezvous port is picked on every local address (the TCP store
    listens on all of them): one picked on the loopback alone could be an
    outgoing connection's port on another address, and the store's listen
    then failed with EADDRINUSE."""
    import socket

    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import mesh

    bound = []
    real = socket.socket.bind
    monkeypatch.setattr(socket.socket, "bind", lambda self, addr: (bound.append(addr),
                                                                   real(self, addr))[1])
    port = mesh.free_port()
    assert bound == [("", 0)]
    with socket.socket() as s:  # free where the store will listen
        s.bind(("0.0.0.0", port))


def test_inherit_refuses_more_workers_than_cards(tmp_path):
    import torch

    from cs744_pytorch_distributed_tutorial_tpu_torch.launch import main

    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match="NCCL cannot put two ranks on one card"):
        main(["--nprocs", str(n), "--store", str(tmp_path / "s")])
    assert not (tmp_path / "s").exists()  # refused before anything was spawned


# ------------------------------------------------------- cli --distributed
@pytest.mark.parametrize("world", [1, 2])
def test_cli_distributed_reads_torchruns_environment(tmp_path, world):
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.mesh import free_port

    port = str(free_port())
    procs = []
    for rank in range(world):
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", MASTER_ADDR="localhost",
                   MASTER_PORT=port, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "cs744_pytorch_distributed_tutorial_tpu_torch.cli",
             "--part", "2b", "--num-devices", str(world), "--model", "tiny_cnn",
             "--synthetic-data", "--synthetic-train-size", "32", "--synthetic-test-size", "16",
             "--global-batch-size", "8", "--device", "cpu", "--distributed", "--json"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    summary = json.loads([ln for ln in outs[0].splitlines() if ln.startswith("{")][-1])
    assert (summary["num_devices"], summary["backend"], summary["steps"]) == (world, "gloo", 4)
    env = dict(os.environ, PYTHONPATH=REPO)
    for k in ("MASTER_ADDR", "RANK"):
        env.pop(k, None)
    bad = subprocess.run([sys.executable, "-m", "cs744_pytorch_distributed_tutorial_tpu_torch.cli",
                          "--part", "1", "--device", "cpu", "--distributed"],
                         env=env, capture_output=True, text=True, timeout=60)
    assert bad.returncode != 0 and "torchrun's environment" in bad.stderr
