"""The port's linter (graftlint GL001-GL010, graftrank GR001-GR005) held
against the JAX package's.

- The framework-neutral rules (GL006, GL008, GR002-GR005) give the same
  findings — rule, line and message — in both packages on the JAX test
  fixtures; the rank fixtures rewritten with ``dist.get_rank()`` and
  ``dist.all_reduce`` give the port the JAX findings at the same lines;
  ``fix_source`` gives byte-identical output in both packages.
- The PyTorch twins of the JAX-specific rules fire on a small bad source
  and stay silent on its fixed twin: GL001 and GL007 in compile and
  CUDA-graph capture scopes, GL002, GL005 on the port's mesh collectives,
  GL009 in step loops, GL010 on per-tensor specs.
- The port's own tree lints clean against its baseline, every baseline
  entry has a reason, and the port's graftlint pragmas still suppress.

The fixtures are source strings, copied from ``tests/test_lint.py`` and
``tests/test_rank_lint.py`` where they are shared; no JAX runs.
"""

from __future__ import annotations

import json
import pathlib
import textwrap

import pytest

from cs744_pytorch_distributed_tutorial_tpu.analysis import lint_source as jax_lint
from cs744_pytorch_distributed_tutorial_tpu.analysis.fix import fix_source as jax_fix
from cs744_pytorch_distributed_tutorial_tpu_torch.analysis import (
    ALL_RULES,
    NOT_APPLICABLE,
    Baseline,
    lint_paths,
    lint_source,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.cli import main as cli_main
from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.fix import fix_source

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "cs744_pytorch_distributed_tutorial_tpu_torch"


def run(src: str, rule: str, lint=lint_source) -> list:
    findings, _ = lint(textwrap.dedent(src))
    return [f for f in findings if f.rule == rule]


def keyed(src: str, prefix: str, lint) -> list[tuple]:
    findings, _ = lint(textwrap.dedent(src))
    return sorted((f.rule, f.line, f.message) for f in findings if f.rule.startswith(prefix))


# ============================================== framework-neutral, shared
NEUTRAL = {
    "gl006-mutable-default": """
        def collect(x, acc=[]):
            acc.append(x)
            return acc
        """,
    "gl006-clean": """
        def collect(x, acc=None):
            acc = [] if acc is None else acc
            acc.append(x)
            return acc
        """,
    "gl008-dead-import": """
        import os
        import sys

        print(sys.argv)
        """,
    "gl008-clean": """
        import os
        import _side_effect_module as _sem

        print(os.sep)
        """,
    "gr002-return": """
        def save(store, state, generation, rank):
            if state is None:
                return None
            store.barrier_stamp(generation, rank)
            return state
        """,
    "gr002-raise": """
        def save(store, state, generation, rank):
            if not state:
                raise ValueError("empty state")
            store.barrier_stamp(generation, rank)
        """,
    "gr002-clean": """
        def save(store, state, generation, rank):
            store.barrier_stamp(generation, rank)
            if state is None:
                return None
            return state
        """,
    "gr003-store-io": """
        import threading

        _IO_LOCK = threading.Lock()

        def emit(store, payload):
            with _IO_LOCK:
                store.append_event("evt", **payload)
        """,
    "gr003-clean": """
        import threading

        _IO_LOCK = threading.Lock()

        def emit(store, payload):
            with _IO_LOCK:
                payload = dict(payload)
            store.append_event("evt", **payload)
        """,
    "gr004-wall-age": """
        import time

        def heartbeat_age(beat):
            now = time.time()
            return now - beat["time"]
        """,
    "gr004-no-clock": """
        def sweep(store, generation, ranks):
            return [store.heartbeat_age(generation, r) for r in ranks]
        """,
    "gr004-clean": """
        import time

        def heartbeat_age(beat, now_mono):
            return now_mono - beat["monotonic"]

        def sweep(store, generation, ranks):
            now_mono = time.monotonic()
            return [
                store.heartbeat_age(generation, r, now_mono=now_mono)
                for r in ranks
            ]
        """,
    "gr005-unlocked": """
        import threading

        class Watchdog:
            def __init__(self):
                self._lock = threading.Lock()
                self._armed_at = None
                self._thread = threading.Thread(target=self._run, daemon=True)

            def _run(self):
                while True:
                    with self._lock:
                        armed = self._armed_at

            def arm(self, now):
                with self._lock:
                    self._armed_at = now

            def disarm(self):
                self._armed_at = None
        """,
}


@pytest.mark.parametrize("case", list(NEUTRAL))
def test_neutral_rules_match_jax(case):
    src = NEUTRAL[case]
    for prefix in ("GL006", "GL008", "GR"):
        assert keyed(src, prefix, lint_source) == keyed(src, prefix, jax_lint), (case, prefix)
    expect_hit = not case.endswith("clean")
    assert bool(keyed(src, "G", lint_source)) == expect_hit, case


# The JAX rank fixtures (left) and their torch.distributed rewrites
# (right), line for line.
RANK_PAIRS = {
    "gr001-rank-guarded": ("""
        import jax

        def sync(grads, rank):
            if rank == 0:
                return jax.lax.psum(grads, "data")
            return grads
        """, """
        import torch.distributed as dist

        def sync(grads, rank):
            if rank == 0:
                return dist.all_reduce(grads)
            return grads
        """),
    "gr001-helper-return": ("""
        import jax

        def my_rank():
            return jax.process_index()

        def sync(grads):
            if my_rank() == 0:
                return jax.lax.psum(grads, "data")
            return grads
        """, """
        import torch.distributed as dist

        def my_rank():
            return dist.get_rank()

        def sync(grads):
            if my_rank() == 0:
                return dist.all_reduce(grads)
            return grads
        """),
    "gr001-clean-both-sides": ("""
        import jax

        def sync(grads, rank):
            if rank == 0:
                return jax.lax.psum(grads, "data")
            return jax.lax.psum(grads * 1.0, "data")
        """, """
        import torch.distributed as dist

        def sync(grads, rank):
            if rank == 0:
                return dist.all_reduce(grads)
            return dist.all_reduce(grads * 1.0)
        """),
    "gr001-clean-untainted": ("""
        import jax

        def sync(grads, warmup):
            if warmup:
                return grads
            return jax.lax.psum(grads, "data")
        """, """
        import torch.distributed as dist

        def sync(grads, warmup):
            if warmup:
                return grads
            return dist.all_reduce(grads)
        """),
    "gr003-collective-under-lock": ("""
        import jax
        import threading

        class Syncer:
            def __init__(self):
                self._lock = threading.Lock()

            def sync(self, grads):
                with self._lock:
                    return jax.lax.psum(grads, "data")
        """, """
        import torch.distributed as dist
        import threading

        class Syncer:
            def __init__(self):
                self._lock = threading.Lock()

            def sync(self, grads):
                with self._lock:
                    return dist.all_reduce(grads)
        """),
}


@pytest.mark.parametrize("case", list(RANK_PAIRS))
def test_rank_fixtures_rewritten_for_torch_match_jax_lines(case):
    jax_src, torch_src = RANK_PAIRS[case]

    def rule_lines(src, lint):
        return sorted((r, ln) for r, ln, _ in keyed(src, "GR", lint))

    assert rule_lines(torch_src, lint_source) == rule_lines(jax_src, jax_lint), case
    assert bool(rule_lines(torch_src, lint_source)) == ("clean" not in case)


def test_port_collective_helpers_are_rank_schedule_keys():
    hits = run("""
        from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import collectives as C

        def hop(send, recv, rank):
            if rank == 0:
                C.ring_hop(send, recv)
            return recv
        """, "GR001")
    assert len(hits) == 1 and "ring_hop" in hits[0].message


FIX_CASES = {
    "dead": """
        import os
        import json

        print(json.dumps({}))
        """,
    "partial": """
        from os.path import join, basename

        print(join("a", "b"))
        """,
    "cascade": """
        import json
        import os

        x = json.dumps({})
        """,
    "exempt": """
        from __future__ import annotations

        import os as _side_effect
        import sys

        __all__ = ["sys"]
        """,
    "try-nested": """
        try:
            import fancy_dep
        except ImportError:
            fancy_dep = None
        """,
    "pragma": "import os  # graftlint: disable=GL008\n",
    "multiline": """
        from os.path import (
            join,
            basename,
        )

        print(basename("x"))
        """,
}


@pytest.mark.parametrize("case", list(FIX_CASES))
def test_fix_source_byte_identical_to_jax(case):
    src = textwrap.dedent(FIX_CASES[case])
    assert fix_source(src, "mod.py") == jax_fix(src, "mod.py")


# ========================================================== torch twins
@pytest.mark.parametrize("src,hit", [
    ("""
     import torch

     @torch.compile
     def f(x):
         y = torch.sum(x)
         return y.item()
     """, True),
    ("""
     import torch

     def body(x):
         return float(torch.sum(x))

     compiled = torch.compile(body)
     """, True),
    ("""
     import torch

     def capture(g, x):
         with torch.cuda.graph(g):
             y = x * 2
             torch.cuda.synchronize()
         return y
     """, True),
    ("""
     import torch

     @torch.compile
     def f(x):
         if x.shape[0] > 1 and x.dtype == torch.float32:
             return x * 2
         return x
     """, False),
    ("""
     import torch

     def host(x):
         return torch.sum(x).item()
     """, False),
])
def test_gl001_sync_in_compile_or_capture_scope(src, hit):
    assert bool(run(src, "GL001")) == hit


def test_gl002_compile_and_graph_built_in_a_loop():
    hits = run("""
        import torch

        def train(model, batches):
            for x in batches:
                step = torch.compile(model)
                g = torch.cuda.CUDAGraph()
                step(x)
        """, "GL002")
    assert len(hits) == 2
    assert not run("""
        import torch

        def train(model, batches):
            step = torch.compile(model)
            for x in batches:
                step(x)
        """, "GL002")


def test_gl003_gl004_not_applicable():
    assert set(NOT_APPLICABLE) == {"GL003", "GL004"}
    assert not run("""
        import torch

        def f(g):
            a = torch.randn(3, generator=g)
            b = torch.randn(3, generator=g)
            return a + b
        """, "GL004")


def test_gl005_axis_drift_on_the_port_collectives():
    src = """
        from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import collectives as C
        from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.mesh import DATA_AXIS

        def sync(x, mesh):
            y = C.axis_sum(x, mesh, "data", "seq")
            return C.axis_mean(y, mesh, "dta")
        """
    hits = run(src, "GL005")
    assert len(hits) == 1 and "'dta'" in hits[0].message
    assert not run(src.replace('"dta"', "DATA_AXIS"), "GL005")
    # a module declaring no mesh axes is skipped (its axes are parameters)
    assert not run("""
        from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import collectives as C

        def sync(x, mesh):
            return C.axis_sum(x, mesh, "anything")
        """, "GL005")


def test_gl007_clock_in_compiled_code():
    assert len(run("""
        import time
        import torch

        @torch.compile
        def f(x):
            t0 = time.perf_counter()
            return x + t0
        """, "GL007")) == 1
    assert not run("""
        import time
        import torch

        @torch.compile
        def f(x):
            return x * 2

        def bench(x):
            t0 = time.perf_counter()
            f(x)
            return time.perf_counter() - t0
        """, "GL007")


def test_gl009_host_syncs_in_step_loops():
    hits = run("""
        import torch

        def fit(trainer, batches):
            for x, y in batches:
                m = trainer.train_step(x, y)
                loss = float(m["loss"])
                torch.cuda.synchronize()
                tok = trainer._decode_step(x).cpu()
        """, "GL009")
    assert len(hits) == 3
    assert not run("""
        import torch

        def fit(trainer, batches, every):
            for i, (x, y) in enumerate(batches):
                m = trainer.train_step(x, y)
                if i % every == 0:
                    print(float(m["loss"]))
        """, "GL009")
    assert not run("""
        def eval_all(values):
            for v in values:
                print(v.item())
        """, "GL009")


def test_gl010_per_tensor_specs():
    src = """
        from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.mesh import TENSOR_AXIS

        def param_specs():
            return {"w": (None, "tensor"), "b": ("tensor", "tensor"), "e": ("expert", None)}
        """
    msgs = sorted(f.message.split(" — ")[0] for f in run(src, "GL010"))
    assert msgs == ["spec names axis 'expert' but this module's meshes declare "
                    "['data', 'pipe', 'seq', 'tensor']", "spec names axis 'tensor' twice"]
    assert len(run("""
        def lm_param_specs():
            return {"w": ("x", "x")}
        """, "GL010")) == 1  # twice is impossible on any mesh


# ============================================================ the tree
def test_port_tree_lints_clean_against_its_baseline(tmp_path, capsys, monkeypatch):
    """The CLI with no arguments lints the port's package against its
    checked-in baseline, from any directory; every entry has a reason; the
    port's own graftlint pragmas (the elastic supervisor's GR001/GR004)
    still suppress."""
    entries = json.loads((PORT / "analysis" / "graftlint_baseline.json").read_text())["entries"]
    assert entries and all(e["reason"] for e in entries)
    monkeypatch.chdir(tmp_path)
    assert cli_main(["--format", "json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["findings"] == [] and report["errors"] == []
    assert len(report["baselined"]) == len(entries)
    assert report["suppressed"] >= 3 and report["files"] > 90


def test_cli_lists_every_jax_rule_id(capsys):
    assert cli_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    ids = [f"GL{i:03d}" for i in range(1, 11)] + [f"GR{i:03d}" for i in range(1, 6)]
    assert ids == sorted(ALL_RULES)
    for rid in ids:
        assert rid in out
    na = [line for line in out.splitlines() if "not applicable" in line]
    assert [line.split()[0] for line in na] == ["GL003", "GL004"]


def test_cli_dispatches_trace_and_memory(capsys):
    assert cli_main(["trace", "--list-rules"]) == 0
    assert cli_main(["memory", "--list-rules"]) == 0
    out = capsys.readouterr().out
    for i in range(1, 11):
        assert f"TA{i:03d}" in out
    na = sorted(line.split()[0] for line in out.splitlines() if "not applicable" in line)
    assert na == ["TA004", "TA009"]


def test_baseline_keeps_reasons_on_rewrite(tmp_path):
    mod = tmp_path / "mod.py"
    mod.write_text("def f(x=[]):\n    return x\n")
    report = lint_paths([str(mod)])
    bl = tmp_path / "bl.json"
    Baseline.dump(report.findings, report.sources, bl)
    data = json.loads(bl.read_text())
    data["entries"][0]["reason"] = "kept on purpose"
    bl.write_text(json.dumps(data))
    Baseline.dump(report.findings, report.sources, bl)
    assert json.loads(bl.read_text())["entries"][0]["reason"] == "kept on purpose"
    assert lint_paths([str(mod)], baseline=Baseline.load(bl)).exit_code == 0
