"""The port's trace audits (graftcheck, TA001-TA006) held against the JAX
package.

- **Contracts.** For every CIFAR strategy of the JAX trace-audit sweep
  (``tests/test_trace_audit.py``), the overlapped ``bucket`` and
  ``zero1`` entries and the three LM entries, the port's ``sync_units``
  and ``expected_collective_schedule`` equal the JAX package's on the same
  parameter tree; at 4 Gloo ranks the schedule the port's real step
  records (``analysis/trace/dispatch.py``'s mapping of c10d ops to JAX's
  classes) equals that contract and its bytes on the wire are within 1 %
  (512 B floor, JAX's TA003 tolerance) of JAX's ``sync_wire_bytes``; and
  no rule finds anything on those steps.
- **Seeded fixtures.** Each of TA001, TA002, TA003, TA005 and TA006 fires
  on a small bad step and stays silent on its fixed twin (the twins of
  JAX's ``test_trace_audit.py`` cases); TA003's and TA006's collectives
  run on the 4 ranks.
- **Contract tests.** The registry, suppressions, the CLI's device rule,
  ``--list-rules`` and ``--list-entrypoints``.

The 4 ranks run in one launch of this file as a script (Gloo, one thread
each) while the parent evaluates JAX's contract functions on numpy trees.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.trace import (
    TracedStep,
    get_entrypoints,
    load_builtin_entrypoints,
    register_entrypoint,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.trace import audits as A
from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.trace import dispatch as D
from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.trace.registry import _REGISTRY
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.mesh import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
ENTRIES = ["cifar", "cifar-int8", "cifar-overlap", "cifar-overlap-zero1",
           "lm", "lm-overlap", "lm-overlap-fsdp", "lm-serve", "lm-serve-paged"]

# The JAX sweep's CIFAR strategies (tests/test_trace_audit.py:74), then the
# overlapped entries; the LM entries' overrides.
CIFAR_RUNS = {s: {"sync": s} for s in (
    "allreduce", "ring", "int8_allreduce", "zero1", "fsdp", "gather_scatter", "p2p_star", "auto")}
CIFAR_RUNS["allreduce+bucket"] = {"sync": "allreduce", "sync_overlap": "bucket"}
CIFAR_RUNS["zero1+bucket"] = {"sync": "zero1", "sync_overlap": "bucket"}
LM_RUNS = {"lm": {}, "lm-overlap": {"optimizer": "sgd", "sync_overlap": "bucket"},
           "lm-overlap-fsdp": {"fsdp": True, "sync_overlap": "bucket"}}
LM_TINY = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=32, d_ff=64, max_seq_len=16)


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


def entry_for(step: TracedStep, name: str):
    register_entrypoint(name, lambda device=None: step)
    return get_entrypoints([name])[0]


def audit(step: TracedStep, rules=None, name: str = "fixture"):
    findings, _info = A.audit_entry(entry_for(step, name), set(rules or A.TRACE_RULES), "cpu")
    return findings


# ================================================================ 4 ranks
def _fixture_steps():
    """The collective fixtures run on every rank: a step that all-reduces
    under a ring contract (TA003) and its honest twin, and steps whose
    variants on a predicate lower different collectives (TA006)."""
    import torch.distributed as dist

    x = torch.ones(128)

    def psum():
        y = x.clone()
        dist.all_reduce(y)
        return y

    def scalar_psum():
        y = x.sum().reshape(1)
        dist.all_reduce(y)
        return x * y

    def skip():
        return x * 2.0

    def make(name, schedule=None, branches=None):
        return TracedStep(name=name, fn=psum, state=lambda: {}, args={"x": [x]},
                          axis_sizes={"data": WORLD}, expected_schedule=schedule,
                          check_donation=False, branches=branches or {})

    return {
        "ta003-mismatch": make("m", {"ppermute": 2 * (WORLD - 1)}),
        "ta003-match": make("m", {"psum": 1}),
        "ta006-divergent": make("d", branches={"psum": psum, "skip": skip}),
        "ta006-scalar": make("d", branches={"psum": scalar_psum, "skip": skip}),
        "ta006-matched": make("d", branches={"a": psum, "b": psum}),
    }


def _worker(rank: int, port: int, out_path: str) -> None:
    import torch.distributed as dist

    from cs744_pytorch_distributed_tutorial_tpu_torch.train.engine import make_trace_entry
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import make_lm_trace_entry

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank)
    res = {}
    runs = [(name, lambda kw=kw: make_trace_entry("cpu", **kw)) for name, kw in CIFAR_RUNS.items()]
    runs += [(name, lambda kw=kw: make_lm_trace_entry("cpu", **kw)) for name, kw in LM_RUNS.items()]
    runs += [(name, lambda s=s: s) for name, s in _fixture_steps().items()]
    for name, build in runs:
        step = build()
        register_entrypoint(name, lambda device=None, s=step: s)
        findings, summary = A.audit_entry(get_entrypoints([name])[0], set(A.TRACE_RULES), "cpu")
        res[name] = {
            "findings": [(f.rule, f.message) for f in findings],
            "schedule": summary.get("schedule"),
            "wire": summary.get("recorded_wire_bytes"),
            "expected_schedule": step.expected_schedule,
            "expected_wire": step.expected_wire_bytes,
            "donation": summary.get("donation"),
        }
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("trace") / "ranks.json"
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


def _cifar_tree():
    from cs744_pytorch_distributed_tutorial_tpu_torch.models import get_model

    return [p.detach().numpy() for p in get_model("tiny_cnn", num_classes=10).parameters()]


def _lm_tree():
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.transformer import TransformerLM

    return [p.detach().numpy() for p in TransformerLM(**LM_TINY).parameters()]


def _contracts(tree, sync, *, grad_compress="none", overlap=False, syncs=1, lm=False):
    """(port units, JAX units, port schedule, JAX schedule, JAX wire bytes)
    on one parameter tree."""
    from cs744_pytorch_distributed_tutorial_tpu.parallel import sync as JS

    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import sync as PS

    bucket = 4 * 2**20
    pairs = [(a.shape, torch.float32) for a in tree]
    effective = "allreduce" if sync in ("auto", "none") else sync
    pu = PS.sync_units(pairs, effective, WORLD, bucket_bytes=bucket,
                       grad_compress=grad_compress, overlap=overlap)
    ju = JS.sync_units(tree, effective, WORLD, bucket_bytes=bucket,
                       grad_compress=grad_compress, overlap=overlap)
    ps = PS.expected_collective_schedule(effective, WORLD, pu, grad_compress=grad_compress,
                                         syncs_per_step=syncs)
    js = JS.expected_collective_schedule(effective, WORLD, ju, grad_compress=grad_compress,
                                         syncs_per_step=syncs)
    jw = syncs * JS.sync_wire_bytes(tree, sync, WORLD, grad_compress, bucket_bytes=bucket,
                                    overlap=overlap)
    return pu, ju, ps, js, jw


@pytest.mark.parametrize("run", list(CIFAR_RUNS) + list(LM_RUNS))
def test_recorded_schedule_meets_jax_contract_on_four_ranks(ranks, run):
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.sync import lm_strategy

    got = ranks[run]
    if run in CIFAR_RUNS:
        kw = CIFAR_RUNS[run]
        tree, sync = _cifar_tree(), kw["sync"]
        compress = "int8" if sync.startswith("int8") else "none"
    else:
        kw = LM_RUNS[run]
        tree = _lm_tree()
        sync, compress = lm_strategy(kw.get("zero1", False), kw.get("fsdp", False)), "none"
    overlap = kw.get("sync_overlap", "off") != "off"
    pu, ju, ps, js, jw = _contracts(tree, sync, grad_compress=compress, overlap=overlap)
    assert pu == ju, (run, pu, ju)
    assert ps == js and js, (run, ps, js)
    assert got["expected_schedule"] == js, (run, got["expected_schedule"], js)
    assert got["schedule"] == {k: v for k, v in js.items() if v}, (run, got["schedule"], js)
    assert abs(got["wire"] - jw) <= max(0.01 * jw, 512.0), (run, got["wire"], jw)
    assert got["findings"] == [], (run, got["findings"])
    assert got["donation"]["aliased"] == got["donation"]["donated"] > 0


def test_ring_and_star_count_jax_ppermutes(ranks):
    """The hop-round mapping: the ring (every rank in every hop) and the
    star (rank 0 in every hop) each count 2(n-1) ppermutes a unit, the
    star's unit a tensor (10 of tiny_cnn)."""
    assert ranks["ring"]["schedule"] == {"ppermute": 2 * (WORLD - 1)}
    assert ranks["p2p_star"]["schedule"] == {"ppermute": 2 * (WORLD - 1) * 10}
    assert ranks["gather_scatter"]["schedule"] == {"all_gather": 10}


def test_ta003_flags_schedule_mismatch_on_four_ranks(ranks):
    """A step whose contract promises the ring but all-reduces is caught;
    its honest twin is clean."""
    assert [r for r, _ in ranks["ta003-mismatch"]["findings"]] == ["TA003"]
    assert "ppermute" in ranks["ta003-mismatch"]["findings"][0][1]
    assert ranks["ta003-match"]["findings"] == []


def test_ta006_flags_divergent_variants_on_four_ranks(ranks):
    """Variants of a step that all-reduce in one branch only (a scalar
    one too: unlike TA003, TA006 counts scalar collectives) are flagged;
    matched variants are fine."""
    for case in ("ta006-divergent", "ta006-scalar"):
        assert [r for r, _ in ranks[case]["findings"]] == ["TA006"], ranks[case]
        assert "psum" in ranks[case]["findings"][0][1]
    assert ranks["ta006-matched"]["findings"] == []


def test_rank_divergence_flags_other_sequences_and_unmatched_messages():
    """The cross-rank half of TA006 on synthetic recordings: a rank with
    an extra psum, and a send its peer does not receive."""
    seq = [("psum", 4, 128)]
    assert A.rank_divergence([(seq, {}), (seq, {})]) == []
    assert "ranks [1]" in A.rank_divergence([(seq, {}), (seq + seq, {})])[0]
    edges0 = {("send", 1): [512]}
    assert A.rank_divergence([([], edges0), ([], {("recv", 0): [512]})]) == []
    (msg,) = A.rank_divergence([([], edges0), ([], {})])
    assert "unmatched" in msg


# ================================================= seeded TA001 upcast
def _bf16_block(leak: bool) -> TracedStep:
    g = torch.Generator().manual_seed(0)
    w1 = torch.randn(16, 16, generator=g).bfloat16()
    w2 = torch.randn(16, 16, generator=g).bfloat16()
    x = torch.randn(8, 16, generator=g).bfloat16()

    def step():
        h = x @ w1  # bf16 x bf16 -> bf16: fine
        if leak:
            # The forgotten-cast bug TA001 hunts: the product runs in fp32.
            h = h.float() @ w2.float()
        else:
            h = h @ w2
        return h.float().sum()

    return TracedStep(name="leak", fn=step, state=lambda: {}, args={"x": [x]}, axis_sizes={},
                      compute_dtype="bfloat16", check_donation=False)


def test_ta001_flags_injected_f32_upcast():
    findings = audit(_bf16_block(leak=True))
    assert [f.rule for f in findings] == ["TA001"]
    assert "f32 mm" in findings[0].message


def test_ta001_clean_bf16_block():
    assert audit(_bf16_block(leak=False)) == []


def test_ta001_allowlists_loss_and_optimizer_frames():
    w = torch.ones(16, 16).bfloat16()
    x = torch.ones(8, 16).bfloat16()

    def cross_entropy_loss(h):
        return (h.float() @ torch.eye(16)).sum()

    step = TracedStep(name="allow", fn=lambda: cross_entropy_loss(x @ w), state=lambda: {},
                      args={"x": [x]}, axis_sizes={}, compute_dtype="bfloat16",
                      check_donation=False)
    assert audit(step) == []


# ================================================ seeded TA002 in place
def _inplace_step(broken: bool) -> TracedStep:
    holder = [torch.ones(8, 8)]

    def step():
        if broken:
            holder[0] = holder[0] + 1.0  # a new storage: the update is not in place
        else:
            holder[0].add_(1.0)
        return holder[0].sum()

    return TracedStep(name="inplace", fn=step, state=lambda: {"buf": [holder[0]]}, args={},
                      axis_sizes={})


def test_ta002_flags_dropped_in_place_update():
    findings = audit(_inplace_step(broken=True), rules={"TA002"})
    assert [f.rule for f in findings] == ["TA002"]
    assert "buf[0]" in findings[0].message and "256B" in findings[0].message


def test_ta002_clean_in_place_update():
    assert audit(_inplace_step(broken=False), rules={"TA002"}) == []


# ============================================== seeded TA005 dead matmul
def _matmul_step(dead: bool) -> TracedStep:
    x, w = torch.ones(32, 32), torch.ones(32, 32)

    def step():
        if dead:
            unused = x @ w  # computed, never used
            del unused
            return x.sum()
        return (x @ w).sum()

    return TracedStep(name="dead", fn=step, state=lambda: {}, args={"x": [x], "w": [w]},
                      axis_sizes={}, check_donation=False)


def test_ta005_flags_dead_matmul():
    findings = audit(_matmul_step(dead=True))
    assert [f.rule for f in findings] == ["TA005"]
    assert "dead mm" in findings[0].message


def test_ta005_live_matmul_is_fine():
    assert audit(_matmul_step(dead=False)) == []


def _fake_paged_step(gather: str) -> TracedStep:
    """A decode step whose attention is a fake hand-written kernel: its
    wrapper allocates the output and reports the launch to ``_cost.add``
    with its operands, as the real wrappers do on the card. ``gather``:
    ``"dead"`` leaves a dense gather of the pages alive in a local beside
    the launch, ``"operand"`` hands the gather to the kernel, ``"none"``
    makes none."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import _cost

    gen = torch.Generator().manual_seed(0)
    q = torch.randn(4, 8, 64, generator=gen)
    pages = torch.randn(64, 16, 8, 64, generator=gen)  # [pages, page, heads, D], 2 MiB
    table = torch.arange(64).reshape(4, 16)

    def kernel(*operands):
        out = torch.empty_like(q)
        _cost.add(2.0 * q.numel() * 16 * 16, 0.0, operands=(*operands, out))
        return out

    def step():
        if gather == "none":
            return kernel(q, pages, table).sum()
        dense = pages[table]  # [slots, pages a slot, page, heads, D], 2 MiB
        out = kernel(q, pages, table, dense) if gather == "operand" else kernel(q, pages, table)
        return out.sum()

    return TracedStep(name="paged", fn=step, state=lambda: {},
                      args={"q": [q], "pages": [pages], "table": [table]},
                      axis_sizes={}, check_donation=False)


@pytest.mark.parametrize("gather,flagged", [("dead", True), ("operand", False), ("none", False)])
def test_ta005_dead_gather_beside_a_kernel_launch(gather, flagged):
    """A tensor alive at a launch but not among its operands is not read by
    the kernel: the dead gather draws TA005, the gather the kernel takes
    and the step without one do not."""
    findings = audit(_fake_paged_step(gather), rules={"TA005"})
    assert [f.rule for f in findings] == (["TA005"] if flagged else [])
    if flagged:
        assert "dead index" in findings[0].message


# =============================================== the builtin entries, CPU
def test_builtin_entrypoints_load_the_jax_names():
    load_builtin_entrypoints()
    assert [e.name for e in get_entrypoints()][:len(ENTRIES)] == ENTRIES


def test_builtin_entries_audit_clean_on_cpu():
    """Every registered entry at a world of one, on the CPU: no finding,
    state fully in place, the serving pools 4 pools a layer of 2 layers."""
    load_builtin_entrypoints()
    findings, _sup, summaries, _src, errors = A.run_audits(get_entrypoints(ENTRIES), None, "cpu")
    assert errors == [] and findings == []
    assert [s["entry"] for s in summaries] == ENTRIES
    for s in summaries:
        assert s["donation"]["donated"] == s["donation"]["aliased"] > 0
        assert s["kernel_launches"] == {}  # the CPU takes the plain versions
    assert {s["entry"]: s["donation"]["donated"] for s in summaries}["lm-serve-paged"] == 4


# ========================================================= suppressions
def test_ta_suppression_pragma_at_registration_site(tmp_path):
    mod = tmp_path / "seeded_entry.py"
    mod.write_text(textwrap.dedent(
        """
        import torch
        from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.trace import (
            TracedStep,
            register_entrypoint,
        )

        x = torch.ones(8, 16).bfloat16()

        def _factory(device=None):
            return TracedStep(name="seeded", fn=lambda: (x.float() @ torch.eye(16)).sum(),
                              state=lambda: {}, args={"x": [x]}, axis_sizes={},
                              check_donation=False)

        register_entrypoint("seeded-suppressed", _factory)  # graftlint: disable=TA001
        register_entrypoint("seeded-loud", _factory)
        """))
    exec(compile(mod.read_text(), str(mod), "exec"), {"__name__": "seeded", "__file__": str(mod)})
    findings, suppressed, _s, _src, errors = A.run_audits(
        get_entrypoints(["seeded-suppressed", "seeded-loud"]), {"TA001"}, "cpu")
    assert errors == [] and suppressed == 1
    assert len(findings) == 1 and "[seeded-loud]" in findings[0].message


# ================================================================== CLI
def test_cli_lists_rules_with_reasons(capsys):
    from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.trace.cli import main

    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rid in A.TRACE_RULES:
        assert rid in out
    assert "TA004  large-trace-constant — not applicable" in out


def test_cli_lists_the_nine_entries_on_cpu(capsys):
    from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.trace.cli import main

    assert main(["--list-entrypoints", "--device", "cpu"]) == 0
    names = [line.split()[0] for line in capsys.readouterr().out.splitlines()]
    assert names == ENTRIES


def test_cli_without_a_card_raises():
    from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.trace.cli import main

    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        main(["cifar"])


def test_cli_unknown_rule_and_entry_are_usage_errors():
    from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.trace.cli import main

    assert main(["--select", "TA999", "--device", "cpu"]) == 2
    assert main(["no-such-entry", "--device", "cpu"]) == 2


def test_cli_json_report_roundtrip(tmp_path, capsys):
    from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.trace.cli import main

    report = tmp_path / "audit.json"
    rc = main(["cifar", "--device", "cpu", "--select", "TA003,TA005", "--format", "json",
               "--report", str(report)])
    assert rc == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload == json.loads(report.read_text())
    (summary,) = payload["entries"]
    assert summary["entry"] == "cifar" and summary["schedule"] == {}  # a world of one


def test_dispatch_maps_c10d_ops_to_jax_classes():
    assert D.COLLECTIVE_CLASS["allreduce_"] == "psum"
    assert D.COLLECTIVE_CLASS["_allgather_base_"] == D.COLLECTIVE_CLASS["allgather_"] == "all_gather"
    assert D.COLLECTIVE_CLASS["alltoall_base_"] == "all_to_all"
    assert D.COLLECTIVE_CLASS["_reduce_scatter_base_"] == "reduce_scatter"
    assert D.COLLECTIVE_CLASS["send"] == D.COLLECTIVE_CLASS["recv_"] == "ppermute"
    c = D.Collective("allreduce_", "psum", 4, 1024, 256)
    assert c.wire_bytes == 1536.0 and not c.trivial
    assert D.Collective("allreduce_", "psum", 4, 4, 1).trivial
    assert D.Collective("allreduce_", "psum", 1, 1024, 256).trivial


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
