"""The port's serving tracer (``obs/serve_trace.py``) against the JAX
package's (``tests/test_serve_trace.py`` mirrored).

Both engines serve one seeded trace from the same weights (the tiny LM of
``tests/test_torch_port_serve.py``, converted with ``lm_params_from_jax``;
the gather path, which the kernel's wrapper runs on CPU tensors) under
one deterministic clock that advances a fixed step a call, so spans,
SLO windows and request rows are compared exactly: every field equal,
floats included, the wall-clock ``time`` stamp of a window aside. Token
streams are exact too. The rest holds the port by structure: the audits
clean and catching corruption, the Chrome export, the windows against
``loadgen``'s summary on the wall clock (0.01 ms, the rounding of both),
``serve-report``'s exit codes, ``profile_serve_programs`` leaving the
engine as it was, the flight recorder's serve tail, and the untouched
``benchmarks/metrics_summary.py`` reading the port's records.
"""

from __future__ import annotations

import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import lm_params_from_jax
from cs744_pytorch_distributed_tutorial_tpu_torch.models.transformer import TransformerLM
from cs744_pytorch_distributed_tutorial_tpu_torch.obs.serve_trace import (
    PREFILL_KINDS,
    ServeTracer,
    check_spans,
    load_trace_dir,
    profile_serve_programs,
    reconcile,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.serve import (
    Request,
    ServeConfig,
    ServingEngine,
    make_poisson_workload,
    run_poisson,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
VOCAB = 61
TINY = dict(vocab_size=VOCAB, num_layers=2, num_heads=2, d_model=32, d_ff=64, max_seq_len=64,
            use_rope=True)
# 3 slots over 8 allocatable pages of 4 rows: preemption is forced.
TIGHT = dict(num_slots=3, page_size=4, num_pages=9, max_pages_per_slot=7,
             paged_attention_impl="gather")
TIGHT_CASES = [(6, 18), (10, 14), (8, 16), (5, 20), (12, 12)]


class _ListSink:
    def __init__(self):
        self.records = []

    def emit(self, record):
        self.records.append(dict(record))


class _Tick:
    """A clock that advances ``dt`` every call: both engines see the same
    floats if they read it in the same order."""

    def __init__(self, t: float = 100.0, dt: float = 0.001):
        self.t, self.dt = t, dt

    def __call__(self) -> float:
        self.t += self.dt
        return self.t


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny models: under the suite's
    parallel workers, every parallel region of a tiny op otherwise waits
    for its descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, JAX params, the port's model with the same weights)."""
    import jax
    import jax.numpy as jnp

    from cs744_pytorch_distributed_tutorial_tpu.models.transformer import TransformerLM as JaxLM

    jmodel = JaxLM(**TINY, attention_impl="dense")
    params = jmodel.init(jax.random.key(0), jnp.zeros((1, 4), jnp.int32))["params"]
    model = TransformerLM(**TINY, attention_impl="dense")
    model.load_state_dict(lm_params_from_jax(params))
    return jmodel, params, model


def _prompts(cases=TIGHT_CASES, seed=13):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, VOCAB, size=plen).astype(np.int32), budget)
            for plen, budget in cases]


def _streams(reqs):
    return [[int(t) for t in list(r.prompt[r.orig_prompt_len:]) + list(r.generated)]
            for r in reqs]


def _port_run(model, cfg=TIGHT, cases=TIGHT_CASES, tracer=None, sink=None, clock=None):
    kw = {} if clock is None else {"clock": clock}
    eng = ServingEngine(model, ServeConfig(**cfg), device="cpu", tracer=tracer, sink=sink, **kw)
    reqs = [eng.submit(Request(prompt=p, max_new_tokens=n)) for p, n in _prompts(cases)]
    eng.run()
    return eng, reqs


@pytest.fixture(scope="module")
def traced_pair(tiny):
    """The TIGHT trace through the JAX engine and the port's, each with a
    tracer (windows every 10 ms) and a sink, under the ticking clock."""
    from cs744_pytorch_distributed_tutorial_tpu.obs.serve_trace import ServeTracer as JaxTracer
    from cs744_pytorch_distributed_tutorial_tpu.serve import Request as JaxRequest
    from cs744_pytorch_distributed_tutorial_tpu.serve import ServeConfig as JaxConfig
    from cs744_pytorch_distributed_tutorial_tpu.serve import ServingEngine as JaxEngine

    jmodel, params, model = tiny
    out = {}
    jtracer, jsink = JaxTracer(TIGHT["num_slots"], window_every_s=0.01), _ListSink()
    jeng = JaxEngine(jmodel, params, JaxConfig(**TIGHT), sink=jsink, clock=_Tick(),
                     tracer=jtracer)
    jreqs = [jeng.submit(JaxRequest(prompt=p, max_new_tokens=n)) for p, n in _prompts()]
    jeng.run()
    jeng.finalize_trace()
    out["jax"] = (jeng, jreqs, jtracer, jsink)
    tracer, sink = ServeTracer(TIGHT["num_slots"], window_every_s=0.01), _ListSink()
    eng, reqs = _port_run(model, tracer=tracer, sink=sink, clock=_Tick())
    eng.finalize_trace()
    out["port"] = (eng, reqs, tracer, sink)
    return out


def _no_time(rows):
    return [{k: v for k, v in r.items() if k != "time"} for r in rows]


def test_spans_windows_and_requests_equal_jax_under_preemption(traced_pair):
    jeng, jreqs, jtracer, _ = traced_pair["jax"]
    eng, reqs, tracer, _ = traced_pair["port"]
    assert eng.stats()["preemptions"] == jeng.stats()["preemptions"] > 0
    assert _streams(reqs) == _streams(jreqs)
    assert tracer.all_spans() == jtracer.all_spans()
    assert len(tracer.windows) > 2
    assert _no_time(tracer.windows) == _no_time(jtracer.windows)
    assert tracer.requests == jtracer.requests
    for t in (tracer, jtracer):
        spans = t.all_spans()
        assert check_spans(spans) == [] and reconcile(spans, t.requests) == []


def test_spans_close_and_reconcile_under_preemption(traced_pair):
    eng, reqs, tracer, sink = traced_pair["port"]
    spans = tracer.all_spans()
    assert "recompute" in {s["name"] for s in spans}
    assert len([s for s in spans if s["name"] == "preempt"]) == eng.stats()["preemptions"]
    assert len([s for s in spans if s["name"] == "retire"]) == len(TIGHT_CASES)
    assert len(tracer.requests) == len(TIGHT_CASES)
    # queue and admission tile exactly: the same float at the boundary
    for rid in {s["req"] for s in spans}:
        sps = [s for s in spans if s["req"] == rid]
        queues = sorted((s for s in sps if s["name"] == "queue"), key=lambda s: s["t0"])
        admits = sorted((s for s in sps if s["name"] in PREFILL_KINDS), key=lambda s: s["t0"])
        assert len(queues) == len(admits) and all(q["t1"] == a["t0"]
                                                  for q, a in zip(queues, admits))
    emitted = [r for r in sink.records if r.get("kind") == "serve_window"]
    assert len(emitted) == len(tracer.windows)


def test_tracer_rejects_mismatched_slot_count(tiny):
    cfg = ServeConfig(num_slots=2, page_size=4, num_pages=17, max_pages_per_slot=8)
    with pytest.raises(ValueError, match="slots"):
        ServingEngine(tiny[2], cfg, device="cpu", tracer=ServeTracer(4))


def test_chrome_trace_is_structurally_valid(traced_pair):
    tracer = traced_pair["port"][2]
    trace = json.loads(json.dumps(tracer.to_chrome_trace()))
    events = trace["traceEvents"]
    assert trace["displayTimeUnit"] == "ms"
    lanes = {e["args"]["name"] for e in events if e["ph"] == "M" and e["name"] == "thread_name"}
    assert lanes == {"queue"} | {f"slot {s}" for s in range(TIGHT["num_slots"])}
    xs = [e for e in events if e["ph"] == "X"]
    assert xs and all(e["dur"] > 0 and 1 <= e["tid"] <= TIGHT["num_slots"] and e["ts"] >= 0
                      for e in xs)
    begins = sorted(e["id"] for e in events if e["ph"] == "b")
    assert begins and begins == sorted(e["id"] for e in events if e["ph"] == "e")
    assert {"kv_pages", "slots_active", "queue_depth"} <= {e["name"] for e in events
                                                           if e["ph"] == "C"}
    instants = [e["name"] for e in events if e["ph"] == "i"]
    assert any(n.startswith("retire") for n in instants)
    assert any(n.startswith("preempt") for n in instants)


def test_tracer_changes_no_decode_input(tiny, traced_pair):
    """The port's analog of JAX's "zero retraces with tracing on": greedy
    tokens with the tracer are those without it."""
    _, reqs = _port_run(tiny[2])
    assert _streams(reqs) == _streams(traced_pair["port"][1])


def test_check_spans_catches_synthetic_corruption():
    ok = [
        {"name": "queue", "req": 1, "slot": None, "t0": 0.0, "t1": 1.0},
        {"name": "prefill", "req": 1, "slot": 0, "bucket": 8, "t0": 1.0, "t1": 2.0},
        {"name": "decode_run", "req": 1, "slot": 0, "t0": 2.0, "t1": 3.0, "tokens": 4},
        {"name": "retire", "req": 1, "slot": 0, "t0": 3.0, "t1": 3.0},
    ]
    assert check_spans(ok) == []
    assert any("unclosed" in p for p in check_spans([dict(ok[0], t1=None)] + ok[1:]))
    overlap = ok[:2] + [dict(ok[2], t0=1.5), ok[3]]
    assert any("overlap" in p for p in check_spans(overlap))
    assert any("queue" in p for p in check_spans(ok[1:]))
    assert any("never retired" in p for p in check_spans(ok[:3]))
    assert check_spans(ok[:3], require_retired=False) == []
    assert any("retire instants" in p for p in check_spans(ok + [dict(ok[3])]))
    assert any("ends before" in p for p in check_spans([dict(ok[0], t0=1.0, t1=0.0)] + ok[1:]))


def test_reconcile_catches_ttft_drift():
    spans = [{"name": "queue", "req": 0, "slot": None, "t0": 0.0, "t1": 0.010},
             {"name": "prefill", "req": 0, "slot": 0, "bucket": 8, "t0": 0.010, "t1": 0.020}]
    good = [{"req": 0, "tokens": 4, "preemptions": 0, "recovered": False, "ttft_ms": 20.0}]
    assert reconcile(spans, good) == []
    drifted = [dict(good[0], ttft_ms=35.0)]
    assert any("TTFT" in p for p in reconcile(spans, drifted))
    assert reconcile(spans, [dict(drifted[0], recovered=True)]) == []


def test_windowed_percentiles_match_posthoc_summary(tiny):
    """On the wall clock: the last window's TTFT/ITL percentiles are the
    summary's, and the prefill counts add up to one an admission."""
    cfg = ServeConfig(num_slots=4, page_size=4, num_pages=33, max_pages_per_slot=8)
    tracer, sink = ServeTracer(cfg.num_slots, window_every_s=0.05), _ListSink()
    eng = ServingEngine(tiny[2], cfg, device="cpu", sink=sink, tracer=tracer)
    wl = make_poisson_workload(num_requests=12, rate_rps=200.0, prompt_len=(3, 10),
                               output_len=(4, 12), vocab_size=VOCAB, seed=5)
    summary = run_poisson(eng, wl, sink=sink)
    last = tracer.windows[-1]
    assert last["ttft_samples"] == len(wl)
    for key in ("ttft_p50_ms", "ttft_p99_ms", "itl_p50_ms", "itl_p99_ms"):
        assert last[key] == pytest.approx(summary[key], abs=0.01)
    emitted = [r for r in sink.records if r.get("kind") == "serve_window"]
    assert len(emitted) == len(tracer.windows)
    assert all(v is None or isinstance(v, (bool, int, float, str))
               for rec in emitted for v in rec.values())
    assert all(w["window_s"] >= tracer.window_every_s for w in tracer.windows[:-1])
    admits = sum(v for w in tracer.windows for k, v in w.items()
                 if k.startswith("prefill_bucket_"))
    assert admits == len(wl) + summary["preemptions"]


def _obs(path, *flags):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-m", "cs744_pytorch_distributed_tutorial_tpu_torch.obs",
                           "serve-report", str(path), *flags], capture_output=True, text=True,
                          env=env, timeout=120)


def test_write_and_serve_report_cli(traced_pair, tmp_path):
    """``write`` -> ``load_trace_dir`` -> ``python -m ...obs serve-report
    --check``: exit 0 on the clean dir, 1 once the retire spans are gone."""
    tracer = traced_pair["port"][2]
    good = tmp_path / "trace"
    paths = tracer.write(str(good))
    with open(paths["trace"], encoding="utf-8") as f:
        assert json.load(f)["traceEvents"]
    data = load_trace_dir(str(good))
    assert data["spans"] and data["requests"] and data["windows"]
    ok = _obs(good, "--check")
    assert ok.returncode == 0, ok.stderr
    assert "serve-trace check: OK" in ok.stdout and "span kinds" in ok.stdout
    spans_file = good / "serve_spans.jsonl"
    rows = [json.loads(line) for line in spans_file.read_text().splitlines() if line.strip()]
    spans_file.write_text("\n".join(json.dumps(r) for r in rows if r["name"] != "retire") + "\n")
    bad = _obs(good, "--check")
    assert bad.returncode == 1 and "never retired" in bad.stderr
    with pytest.raises(FileNotFoundError):
        load_trace_dir(str(tmp_path / "empty"))


# The fields of the JAX package's profile_serve_programs records.
JAX_PHASE_FIELDS = {"kind", "time", "phase", "impl", "clock", "device_ms", "wall_ms", "flops",
                    "bytes_accessed", "roofline", "iters"}
JAX_SUMMARY_FIELDS = {"kind", "time", "impl", "decode_step_ms", "decode_clock",
                      "decode_steps_observed", "decode_host_ms", "decode_host_exposed_ms"}


def test_profile_serve_programs_attributes_and_preserves_state(tiny):
    """A serve_phase record a program (decode, each prefill bucket used)
    with the JAX fields, FLOPs, bytes and a roofline class, and a summary
    with decode_host_exposed_ms; the pools, the launch counters and the
    later outputs are as they were."""
    cfg = ServeConfig(num_slots=2, page_size=4, num_pages=17, max_pages_per_slot=8)
    eng = ServingEngine(tiny[2], cfg, device="cpu")
    reqs = [eng.submit(Request(prompt=p, max_new_tokens=n))
            for p, n in _prompts([(4, 6), (9, 5)], seed=17)]
    eng.run()
    expect = _streams(reqs)
    pools = [(c.key.clone(), c.value.clone()) for c in eng._pages]
    counts = (eng.decode_steps_all, eng.prefills_all, eng.stats()["decode_steps"])

    records = profile_serve_programs(eng, iters=2)
    phases = [r for r in records if r["kind"] == "serve_phase"]
    assert {r["phase"] for r in phases} == {"decode", "prefill[bucket=8]",
                                            "prefill[bucket=16]"}
    for r in phases:
        assert JAX_PHASE_FIELDS <= set(r) and r["clock"] == "wall" and r["wall_ms"] > 0
        assert r["flops"] > 0 and r["bytes_accessed"] > 0 and r["roofline"] == "memory"
    (s,) = [r for r in records if r["kind"] == "serve_phase_summary"]
    assert set(s) == JAX_SUMMARY_FIELDS | {"profiled_decode_steps", "profiled_prefills"}
    assert s["decode_steps_observed"] == counts[2] > 0
    assert s["decode_host_ms"] >= s["decode_host_exposed_ms"] >= 0
    assert all(c.key.equal(k) and c.value.equal(v) for c, (k, v) in zip(eng._pages, pools))
    assert (eng.decode_steps_all, eng.prefills_all, eng.stats()["decode_steps"]) == counts
    # capture_device_profile: a warm-up and 2 timed calls; segment_costs: 1
    assert eng.profiled_decode_steps == s["profiled_decode_steps"] == 4
    assert eng.profiled_prefills == s["profiled_prefills"] == 8
    again = [eng.submit(Request(prompt=p, max_new_tokens=n))
             for p, n in _prompts([(4, 6), (9, 5)], seed=17)]
    eng.run()
    assert _streams(again) == expect


def test_flight_recorder_dumps_serve_tail(tiny):
    sink = _ListSink()
    eng, _ = _port_run(tiny[2], sink=sink)
    before = len(sink.records)
    eng.make_flight_recorder(hbm=False).dump("test")
    new = sink.records[before:]
    (header,) = [r for r in new if r.get("event") == "flight_dump"]
    assert header["kind"] == "event" and header["reason"] == "test"
    assert header["queue_depth"] == 0 and header["preemptions"] == eng.stats()["preemptions"]
    assert header["page_high_water"] == eng.pool.high_water and header["page_churn"] > 0
    assert header["trash_rows_written"] > 0
    tails = [r for r in new if r.get("event") == "flight_serve"]
    assert tails and all("serve_event" in r for r in tails)
    assert any(r["serve_event"] == "request" for r in tails)


def test_pool_counts_churn(tiny):
    cfg = ServeConfig(num_slots=2, page_size=4, num_pages=17, max_pages_per_slot=8)
    eng, _ = _port_run(tiny[2], cfg=dict(cfg.__dict__), cases=[(4, 6), (9, 8), (6, 10)])
    assert eng.pool.total_allocs == eng.pool.total_frees > 0
    stats = eng.stats()
    assert stats["page_churn"] == eng.pool.total_allocs + eng.pool.total_frees
    assert stats["trash_rows_written"] == eng._trash_rows > 0


def _metrics_summary():
    spec = importlib.util.spec_from_file_location("metrics_summary",
                                                  REPO / "benchmarks" / "metrics_summary.py")
    ms = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ms)
    return ms


def test_metrics_summary_reads_port_serve_windows_and_phases(traced_pair, tiny, tmp_path,
                                                            capsys):
    """The untouched ``benchmarks/metrics_summary.py`` aggregates the
    port's serve_window stream and its serve_phase rows, as JAX's
    ``test_metrics_summary_renders_serve_window_rows`` holds JAX's."""
    ms = _metrics_summary()
    windows = traced_pair["port"][2].windows
    eng = ServingEngine(tiny[2], ServeConfig(num_slots=2, page_size=4, num_pages=17,
                                             max_pages_per_slot=8), device="cpu")
    eng.submit(Request(prompt=np.arange(1, 6), max_new_tokens=3))
    eng.run()
    records = list(windows) + profile_serve_programs(eng, iters=1)
    summary = ms.summarize(records)
    sw = summary["serve_windows"]
    assert sw["count"] == len(windows)
    assert sw["ttft_p99_ms_last"] == windows[-1]["ttft_p99_ms"]
    assert sw["ttft_p99_ms_max"] == max(w["ttft_p99_ms"] for w in windows
                                        if w["ttft_p99_ms"] is not None)
    assert sw["live_pages_peak"] == max(w["live_pages"] for w in windows)
    assert sw["queue_depth_max"] == max(w["queue_depth_max"] for w in windows)
    exposed = records[-1]["decode_host_exposed_ms"]
    assert summary["serve_decode_host_exposed_ms"] == exposed
    assert summary["phases"]["serve decode"]["ms"] == records[-3]["wall_ms"]
    path = tmp_path / "metrics.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in records) + "\n")
    assert ms.main([str(path)]) == 0
    out = capsys.readouterr().out
    assert "serve windows" in out and "serve decode host exposed" in out
    assert "phase serve decode" in out
