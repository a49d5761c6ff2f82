"""The fleet view (``obs/fleet.py``) and ``obs fleet-report`` against the
JAX package's, on the same store directories.

The stores are built from records, as JAX's ``tests/test_fleet_obs.py``
builds them (its helpers: hand-picked clocks, ranks whose monotonic
origins differ by hours and whose wall clocks are skewed by seconds), or
written by the port's ``RendezvousStore`` and ``FleetStamper``. On each,
``merge_timeline``, ``collective_skew``, ``fleet_check``,
``fleet_report_records`` and ``render_fleet_report`` give what JAX's
give (JSON equal), and ``obs fleet-report [--check]`` exits as JAX's
does.
"""

from __future__ import annotations

import json
import os

import pytest
import test_fleet_obs as J

from cs744_pytorch_distributed_tutorial_tpu.obs import fleet as JF
from cs744_pytorch_distributed_tutorial_tpu_torch.obs import fleet as F
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.multihost import RendezvousStore


def _coordinator_kill_store(root: str) -> None:
    """A two-generation run as the port's supervisor and workers write it:
    rank 0 (the coordinator) killed at step 2 of 4, rank 2 a straggler,
    rank 1 re-elected."""
    store = RendezvousStore(root)
    t0 = J.T0
    store.write_world({"generation": 0, "ranks": [0, 1, 2], "coordinator": "h:1",
                       "coordinator_rank": 0})
    J._event_line(root, "generation_start", t0, generation=0, world_size=3, ranks=[0, 1, 2],
                  coordinator_rank=0)
    for rank in (0, 1, 2):
        J._anchor(root, 0, rank)
        with F.FleetStamper(root, 0, rank, rank) as st:
            for step in range(2):
                enter = t0 + 1.0 + step
                arrive = enter + 0.01 + (0.2 if rank == 2 else 0.0)
                leave = enter + 0.22
                st.stamp_step(step, step_enter=J._pair(rank, enter),
                              sync_enter=J._pair(rank, arrive), sync_exit=J._pair(rank, leave),
                              step_exit=J._pair(rank, leave + 0.001))
    J._event_line(root, "chaos_inject", t0 + 3.0, fault="process_kill", call=2, generation=0,
                  global_rank=0, process_id=0)
    J._event_line(root, "worker_death", t0 + 3.1, generation=0, dead_rank=0, reason="sigkill")
    J._write_json(os.path.join(root, "dead_g000000.json"),
                  {"generation": 0, "dead": [0], "time": t0 + 3.15})
    J._event_line(root, "worker_exit", t0 + 3.3, generation=0, exit_rank=1, returncode=17)
    J._event_line(root, "reelection", t0 + 3.5, parent_generation=0, generation=1,
                  survivors=[1, 2], dead=[0], coordinator_rank=1, world_size=2)
    store.write_world({"generation": 1, "ranks": [1, 2], "coordinator": "h:2",
                       "coordinator_rank": 1})
    J._event_line(root, "generation_start", t0 + 3.6, generation=1, world_size=2, ranks=[1, 2],
                  coordinator_rank=1)
    for rank in (1, 2):
        J._anchor(root, 1, rank, t0 + 4.0)
        with F.FleetStamper(root, 1, rank, rank - 1) as st:
            for step in (2, 3):
                enter = t0 + 5.0 + step
                arrive = enter + 0.01 + (0.2 if rank == 2 else 0.0)
                st.stamp_step(step, step_enter=J._pair(rank, enter),
                              sync_enter=J._pair(rank, arrive),
                              sync_exit=J._pair(rank, enter + 0.22),
                              step_exit=J._pair(rank, enter + 0.23))
    J._event_line(root, "run_complete", t0 + 9.0, generation=1, world_size=2)


def _broken_store(root: str) -> None:
    J._two_generation_store(root)
    with F.FleetStamper(root, 0, 0) as st:  # a g0 step that exits after g1 began
        st.stamp_step(2, step_enter=J._pair(0, J.T0 + 1.0), sync_enter=J._pair(0, J.T0 + 1.01),
                      sync_exit=J._pair(0, J.T0 + 6.0), step_exit=J._pair(0, J.T0 + 6.2))
    with F.FleetStamper(root, 1, 0) as st:  # out of order
        st.stamp_step(9, step_enter=J._pair(0, J.T0 + 9.0), sync_enter=J._pair(0, J.T0 + 8.0),
                      sync_exit=J._pair(0, J.T0 + 9.1), step_exit=J._pair(0, J.T0 + 9.2))


STORES = {
    "straggler": lambda root: J._synthetic_store(root, steps=5, stall_s=0.15),
    "two_generations": J._two_generation_store,
    "coordinator_kill": _coordinator_kill_store,
    "broken": _broken_store,
}


def _views(mod, root: str) -> dict:
    data = mod.load_fleet_dir(root)
    aligner = mod.ClockAligner(data.barrier_stamps)
    skew = mod.collective_skew(data, aligner)
    problems = mod.fleet_check(data, aligner)
    return {
        "generations": data.generations,
        "ranks": data.ranks,
        "skew": skew,
        "problems": problems,
        "timeline": mod.merge_timeline(data, aligner, skew),
        "records": mod.fleet_report_records(data, skew, problems),
        "text": mod.render_fleet_report(data, skew, problems, aligner),
    }


@pytest.mark.parametrize("name", list(STORES))
def test_fleet_views_are_jax(tmp_path, name):
    root = str(tmp_path / name)
    STORES[name](root)
    got, want = _views(F, root), _views(JF, root)
    for key in want:
        assert json.dumps(got[key], sort_keys=True) == json.dumps(want[key], sort_keys=True), key


def test_fleet_names_the_straggler_and_the_reelection(tmp_path):
    root = str(tmp_path / "ck")
    _coordinator_kill_store(root)
    v = _views(F, root)
    assert v["problems"] == []
    post = [r for r in v["skew"] if not r["warmup"]]
    assert post and all(r["straggler"] == 2 for r in post)
    assert "re-election g0->g1" in v["text"] and "stragglers: r2" in v["text"]
    lanes = {e["args"]["name"] for e in v["timeline"]["traceEvents"]
             if e.get("name") == "process_name"}
    assert lanes == {"fleet", "rank 0", "rank 1", "rank 2"}
    problems = _views(F, str(_broken(tmp_path)))["problems"]
    assert any("crosses the generation seal" in p for p in problems)
    assert any("out of order" in p for p in problems)


def _broken(tmp_path):
    root = tmp_path / "broken"
    _broken_store(str(root))
    return root


def test_write_fleet_artifacts_match_jax(tmp_path):
    root = str(tmp_path / "ck")
    _coordinator_kill_store(root)
    got = F.write_fleet_artifacts(root, out_dir=str(tmp_path / "port"))
    want = JF.write_fleet_artifacts(root, out_dir=str(tmp_path / "jax"))
    assert got["problems"] == want["problems"] and got["text"] == want["text"]
    for key in ("trace", "report"):
        with open(got[key], encoding="utf-8") as a, open(want[key], encoding="utf-8") as b:
            assert json.load(a) == json.load(b)


@pytest.mark.parametrize("name,args", [
    ("straggler", ["--check"]),
    ("coordinator_kill", ["--check", "--no-artifacts"]),
    ("broken", ["--check"]),
    ("broken", ["--check", "--no-artifacts"]),
    ("empty", ["--check"]),
    ("broken", []),
])
def test_fleet_report_cli_exits_as_jax(tmp_path, capsys, name, args):
    from cs744_pytorch_distributed_tutorial_tpu.obs.__main__ import main as jmain
    from cs744_pytorch_distributed_tutorial_tpu_torch.obs.__main__ import main

    outs = {}
    for side, fn in (("port", main), ("jax", jmain)):
        root = tmp_path / side / name
        root.mkdir(parents=True)
        if name != "empty":
            STORES[name](str(root))
        rc = fn(["fleet-report", str(root), *args])
        out = capsys.readouterr()
        outs[side] = (rc, out.out.replace(str(root), "<root>"),
                      out.err.replace(str(root), "<root>"),
                      (root / "fleet_trace.json").exists())
    assert outs["port"] == outs["jax"]
    assert outs["port"][0] == (1 if name == "broken" and "--check" in args else 0)


def test_fleet_report_on_a_missing_store_fails_as_jax(tmp_path):
    from cs744_pytorch_distributed_tutorial_tpu.obs.__main__ import main as jmain
    from cs744_pytorch_distributed_tutorial_tpu_torch.obs.__main__ import main

    missing = str(tmp_path / "nowhere")
    for fn in (main, jmain):
        with pytest.raises(FileNotFoundError, match="not a directory"):
            fn(["fleet-report", missing, "--check"])
