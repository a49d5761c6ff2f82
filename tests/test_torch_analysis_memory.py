"""The port's memory audits (graftmem, TA007-TA010) held against the JAX
package.

- **Seeded fixtures.** TA007 (a budget regression, a missing entry, a
  rank-count mismatch), TA008 (a leaf declared sharded held whole) and
  TA010 (a broken in-place update, priced) each fire on a small bad step
  and stay silent on its fixed twin — the twins of JAX's
  ``test_memory_audit.py`` cases.
- **Sharded bytes.** At 4 Gloo ranks under zero1 and fsdp (the CIFAR
  trainer and the LM), each rank's bytes of every declared-sharded leaf
  equal the JAX package's per-device bytes for that leaf
  (``analysis/trace/memory.py::_leaf_bytes`` of the ``[n, chunk]`` rows
  sharded over the data axis), and TA008 finds nothing.
- **The ledger.** The CPU ``argument_bytes`` of ``cifar`` equal the summed
  ``nbytes`` of the JAX entry's argument leaves at one device, less the
  leaves torch keeps elsewhere (the step counter, the PRNG key) and plus
  its wider ones (int64 labels, BatchNorm's step counters), each named.
- **The budget file and CLI.** Sections a device, merge on write, the
  gate's lifecycle, and every builtin entry clean against the checked-in
  ``analysis/memory_budget.json`` on the CPU.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.trace import (
    TracedStep,
    get_entrypoints,
    load_builtin_entrypoints,
    register_entrypoint,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.trace.memory import (
    DEFAULT_BUDGET,
    MEMORY_RULES,
    audit_memory_entry,
    load_budget,
    main as memory_cli_main,
    measure_entry,
    run_memory_audits,
    write_budget,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.trace.registry import _REGISTRY
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.mesh import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
ENTRIES = ["cifar", "cifar-int8", "cifar-overlap", "cifar-overlap-zero1",
           "lm", "lm-overlap", "lm-overlap-fsdp", "lm-serve", "lm-serve-paged"]
SHARDED_RUNS = {"cifar-zero1": ("cifar", {"sync": "zero1"}),
                "cifar-fsdp": ("cifar", {"sync": "fsdp"}),
                "lm-zero1": ("lm", {"zero1": True}),
                "lm-fsdp": ("lm", {"fsdp": True})}


@pytest.fixture(autouse=True)
def _registry_guard():
    """Restore the registry, and leave no process group behind: the
    entries join a world of one when none exists, and later tests in this
    process start their own."""
    import torch.distributed as dist

    before, had_group = dict(_REGISTRY), dist.is_initialized()
    yield
    _REGISTRY.clear()
    _REGISTRY.update(before)
    if dist.is_initialized() and not had_group:
        dist.destroy_process_group()


def entry_for(step: TracedStep, name: str = "mem-fixture"):
    register_entrypoint(name, lambda device=None: step)
    return get_entrypoints([name])[0]


def audit(step: TracedStep, rules=None, budget=None, name: str = "mem-fixture"):
    return audit_memory_entry(entry_for(step, name), set(rules) if rules is not None else None,
                              budget, "cpu")


# ------------------------------------------------------------- fixtures
def _replication_step(shard: bool) -> TracedStep:
    """zero1's contract on a 4-rank axis: momentum of a [64, 64] weight
    declared sharded, held as this rank's [1024] row (clean) or whole
    (the TA008 seed)."""
    w = torch.ones(64, 64)
    m = torch.zeros(1024 if shard else 4096)

    def step():
        m.mul_(0.9)
        return w.sum()

    return TracedStep(name="mem-fixture", fn=step, state=lambda: {"momentum": [m]},
                      args={"w": [w]}, axis_sizes={"data": WORLD}, sync="zero1",
                      sharded_state={"momentum": [((64, 64), torch.float32)]})


def _inplace_step(broken: bool) -> TracedStep:
    """A 32x32 buffer (4096 B) promised in place: rebound to a new
    storage (the TA010 seed) or updated in place."""
    holder = [torch.ones(32, 32)]

    def step():
        if broken:
            holder[0] = holder[0] * 2.0
        else:
            holder[0].mul_(2.0)
        return holder[0].sum()

    return TracedStep(name="mem-fixture", fn=step, state=lambda: {"buf": [holder[0]]},
                      args={}, axis_sizes={})


def _budget_for(ledger: dict, **overrides) -> dict:
    keep = ("devices", "argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
            "total_bytes", "dropped_donation_bytes")
    entry = {k: ledger[k] for k in keep}
    entry.update(overrides.pop("entry_overrides", {}))
    budget = {"tolerance": 0.05, "floor_bytes": 0, "entries": {ledger["entry"]: entry}}
    budget.update(overrides)
    return budget


# ================================================================ TA008
def test_ta008_declared_sharded_leaf_held_whole():
    findings, ledger = audit(_replication_step(shard=False))
    assert [f.rule for f in findings] == ["TA008"]
    assert "WHOLE" in findings[0].message and "zero1" in findings[0].message
    assert ledger["replicated_leaves"] == 1


def test_ta008_sharded_row_is_clean():
    findings, ledger = audit(_replication_step(shard=True))
    assert findings == []
    assert ledger["sharded_leaves"] == [
        {"collection": "momentum", "index": 0, "bytes": 4096, "full_bytes": 16384}]


def test_ta008_undeclared_and_small_leaves_are_silent():
    import dataclasses

    step = dataclasses.replace(_replication_step(shard=False), sharded_state={})
    assert audit(step)[0] == []
    small = dataclasses.replace(_replication_step(shard=False),
                                sharded_state={"momentum": [((8, 8), torch.float32)]})
    assert audit(small, rules={"TA008"})[0] == []


# ================================================================ TA010
def test_ta010_dropped_in_place_update_priced():
    findings, ledger = audit(_inplace_step(broken=True))
    assert [f.rule for f in findings] == ["TA010"]
    assert "4096B" in findings[0].message and "dropped donation" in findings[0].message
    assert ledger["dropped_donation_bytes"] == 4096


def test_ta010_in_place_update_clean():
    findings, ledger = audit(_inplace_step(broken=False))
    assert findings == []
    assert ledger["dropped_donation_bytes"] == 0 and ledger["aliased_leaves"] == 1
    assert ledger["alias_saved_bytes"] == 4096


# ================================================================ TA007
def test_ta007_within_band_and_inflated_budget_pass():
    step = _inplace_step(broken=False)
    _f, ledger = audit(step, rules=set())
    assert audit(step, budget=_budget_for(ledger))[0] == []
    roomy = _budget_for(ledger, entry_overrides={"total_bytes": ledger["total_bytes"] * 10})
    assert audit(step, budget=roomy)[0] == []


def test_ta007_regression_past_tolerance_fires():
    step = _inplace_step(broken=False)
    _f, ledger = audit(step, rules=set())
    tight = _budget_for(ledger, tolerance=0.0,
                        entry_overrides={"total_bytes": ledger["total_bytes"] - 1})
    (f,) = audit(step, budget=tight)[0]
    assert f.rule == "TA007" and "exceeds the budget" in f.message


def test_ta007_missing_entry_and_rank_mismatch_fire():
    step = _inplace_step(broken=False)
    (f,) = audit(step, budget={"tolerance": 0.05, "floor_bytes": 0, "entries": {}})[0]
    assert f.rule == "TA007" and "no memory budget entry" in f.message
    _f, ledger = audit(step, rules=set())
    (f,) = audit(step, budget=_budget_for(ledger, entry_overrides={"devices": 4}))[0]
    assert "not comparable" in f.message


def test_ledger_fields_add_up():
    _f, lg = audit(_inplace_step(broken=False), rules=set())
    assert lg["total_bytes"] == (lg["argument_bytes"] + lg["output_bytes"] + lg["temp_bytes"]
                                 - lg["alias_bytes"])
    assert lg["argument_bytes"] == 4096 and lg["alias_bytes"] == 4096
    assert lg["cuda_peak_bytes"] is None  # the CPU has no allocator statistics


# ============================================================ budget IO
def test_budget_sections_merge_on_write(tmp_path):
    p = tmp_path / "budget.json"
    assert load_budget(p)["entries"] == {}
    step = _inplace_step(broken=False)
    ledger = measure_entry(entry_for(step), step)
    assert write_budget(p, [ledger], "cpu") == 1
    assert write_budget(p, [dict(ledger, entry="other")], "NVIDIA H100 80GB HBM3") == 1
    data = json.loads(p.read_text())
    assert sorted(data["devices"]) == ["NVIDIA H100 80GB HBM3", "cpu"]
    assert load_budget(p, "cpu")["entries"]["mem-fixture"]["total_bytes"] == ledger["total_bytes"]
    assert write_budget(p, [dict(ledger, entry="second")], "cpu") == 2
    bad = tmp_path / "bad.json"
    bad.write_text("[1, 2]")
    with pytest.raises(ValueError):
        load_budget(bad)


def test_memory_suppression_pragma_at_registration_site(tmp_path):
    mod = tmp_path / "seeded_mem_entry.py"
    mod.write_text(textwrap.dedent(
        """
        import torch
        from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.trace import (
            TracedStep,
            register_entrypoint,
        )

        def _factory(device=None):
            holder = [torch.ones(32, 32)]

            def step():
                holder[0] = holder[0] * 2.0
                return holder[0].sum()

            return TracedStep(name="seeded", fn=step, state=lambda: {"buf": [holder[0]]},
                              args={}, axis_sizes={})

        register_entrypoint("mem-suppressed", _factory)  # graftlint: disable=TA010
        register_entrypoint("mem-loud", _factory)
        """))
    exec(compile(mod.read_text(), str(mod), "exec"), {"__name__": "seeded", "__file__": str(mod)})
    findings, suppressed, _l, _s, errors = run_memory_audits(
        get_entrypoints(["mem-suppressed", "mem-loud"]), {"TA010"}, None, "cpu")
    assert errors == [] and suppressed == 1
    assert len(findings) == 1 and "[mem-loud]" in findings[0].message


# ================================================================== CLI
def test_memory_cli_rules_and_usage_errors(capsys):
    assert memory_cli_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rid in MEMORY_RULES:
        assert rid in out
    assert "TA009  implicit-reshard — not applicable" in out
    assert memory_cli_main(["--select", "GL", "--device", "cpu"]) == 2
    assert memory_cli_main(["no-such-entry", "--device", "cpu"]) == 2


def test_memory_cli_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        memory_cli_main(["--list-entrypoints"])


def test_memory_cli_budget_gate_lifecycle(tmp_path, capsys):
    step = _inplace_step(broken=False)
    register_entrypoint("mem-cli-fixture", lambda device=None: step)
    budget = tmp_path / "budget.json"
    base = ["mem-cli-fixture", "--device", "cpu", "--budget", str(budget)]
    assert memory_cli_main(base) == 1
    assert "no memory budget entry" in capsys.readouterr().out
    assert memory_cli_main(base + ["--write-budget"]) == 0
    assert "section 'cpu'" in capsys.readouterr().out
    assert memory_cli_main(base) == 0
    data = json.loads(budget.read_text())
    data["tolerance"], data["floor_bytes"] = 0.0, 0
    data["devices"]["cpu"]["entries"]["mem-cli-fixture"]["total_bytes"] -= 1
    budget.write_text(json.dumps(data))
    assert memory_cli_main(base) == 1
    assert "exceeds the budget" in capsys.readouterr().out
    assert memory_cli_main(base + ["--no-budget", "--format", "json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    (record,) = payload["records"]
    assert record["kind"] == "memory_ledger" and payload["device"] == "cpu"


# ======================================================= the builtin entries
def test_builtin_entries_clean_against_the_checked_in_budget():
    """The acceptance gate on the CPU: every entry within the ``cpu``
    section of ``analysis/memory_budget.json``, no finding."""
    load_builtin_entrypoints()
    budget = load_budget(DEFAULT_BUDGET, "cpu")
    assert sorted(budget["entries"]) == sorted(ENTRIES)
    findings, _sup, ledgers, _src, errors = run_memory_audits(
        get_entrypoints(ENTRIES), None, budget, "cpu")
    assert errors == [] and findings == []
    for lg in ledgers:
        assert lg["total_bytes"] > 0 and lg["dropped_donation_bytes"] == 0
        assert lg["devices"] == budget["entries"][lg["entry"]]["devices"] == 1


def test_cifar_argument_bytes_equal_the_jax_entry_leaves(devices, monkeypatch):
    """``argument_bytes`` of the port's ``cifar`` against the JAX entry's
    argument leaves at one device: parameters, momentum, batch statistics
    and images byte for byte; the labels element for element (int64 here,
    int32 there); the total exact once the named differences are taken."""
    import jax

    import cs744_pytorch_distributed_tutorial_tpu.train.engine as JE

    real = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a, **k: real(*a, **k)[:1])
    jstep = JE.make_trace_entry()
    monkeypatch.setattr(jax, "devices", real)
    state, x, y, key = jstep.args

    def nbytes(tree):
        return sum(int(leaf.nbytes) for leaf in jax.tree.leaves(tree))

    jax_total = nbytes(jstep.args)
    load_builtin_entrypoints()
    _f, ledger = audit_memory_entry(get_entrypoints(["cifar"])[0], set(), None, "cpu")
    parts = ledger["argument_breakdown"]
    assert parts["params"] == nbytes(state.params)
    assert parts["momentum"] == nbytes(state.opt_state)
    assert parts["images"] == nbytes(x)
    n_bn = len(jax.tree.leaves(state.batch_stats)) // 2
    assert parts["buffers"] == nbytes(state.batch_stats) + 8 * n_bn  # + num_batches_tracked
    assert parts["labels"] == 2 * nbytes(y)  # int64 labels, int32 in JAX
    assert ledger["argument_bytes"] == (jax_total - nbytes(state.step) - nbytes(key)
                                        + nbytes(y) + 8 * n_bn)


# ================================================================ 4 ranks
def _worker(rank: int, port: int, out_path: str) -> None:
    import torch.distributed as dist

    from cs744_pytorch_distributed_tutorial_tpu_torch.train.engine import make_trace_entry
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import make_lm_trace_entry

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank)
    res = {}
    for name, (kind, kw) in SHARDED_RUNS.items():
        make = make_trace_entry if kind == "cifar" else make_lm_trace_entry
        step = make("cpu", **kw)
        register_entrypoint(name, lambda device=None, s=step: s)
        findings, ledger = audit_memory_entry(get_entrypoints([name])[0], None, None, "cpu")
        full = {c: [list(shape) for shape, _ in shapes] for c, shapes in step.sharded_state.items()}
        res[name] = {"findings": [f.text() for f in findings], "sharded": ledger["sharded_leaves"],
                     "full": full, "devices": ledger["devices"]}
    every = [None] * WORLD
    dist.all_gather_object(every, res)
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(every, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("memory") / "ranks.json"
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(port),
                               str(out)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return json.loads(out.read_text())


@pytest.mark.parametrize("run", list(SHARDED_RUNS))
def test_sharded_bytes_equal_jax_per_device_bytes(ranks, run, mesh4):
    from jax.sharding import NamedSharding, PartitionSpec as P

    from cs744_pytorch_distributed_tutorial_tpu.analysis.trace.memory import _leaf_bytes

    sharding = NamedSharding(mesh4, P("data"))
    for rank, res in enumerate(ranks):
        got = res[run]
        assert got["findings"] == [] and got["devices"] == WORLD, (rank, got["findings"])
        assert sorted({row["collection"] for row in got["sharded"]}) == sorted(got["full"])
        for row in got["sharded"]:
            shape = got["full"][row["collection"]][row["index"]]
            chunk = -(-math.prod(shape) // WORLD)
            want = _leaf_bytes(np.zeros((WORLD, chunk), np.float32), sharding)
            assert row["bytes"] == want, (run, rank, row, want)
            assert row["full_bytes"] == 4 * math.prod(shape)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
