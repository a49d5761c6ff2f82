"""The port's kill/resume (``ServingEngine.snapshot``/``resume``) against
the JAX package's (``tests/test_serve_recovery.py`` mirrored).

Exact throughout: a resumed engine's streams equal the uninterrupted
run's token for token, greedy and sampled (the draws are keyed by
(seed, request id, absolute token index), so the replay through
recompute draws what the dead engine would have); the snapshot's
request records equal the JAX engine's for the same state, field for
field (the same weights, the tiny LM of ``tests/test_torch_port_serve.py``,
the same trace and a clock that advances a fixed step a call). Also:
resume's guards, a snapshot leaving the live engine as it was, preempt
and recovered events against their counters, the recovered twin, the
kill gap left out of ITL, the tracer's spans across a resume, and the
untouched ``benchmarks/metrics_summary.py`` counting the port's rows.
"""

from __future__ import annotations

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import lm_params_from_jax
from cs744_pytorch_distributed_tutorial_tpu_torch.models.transformer import TransformerLM
from cs744_pytorch_distributed_tutorial_tpu_torch.obs.serve_trace import (
    ServeTracer,
    check_spans,
    reconcile,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.serve import (
    Request,
    ServeConfig,
    ServingEngine,
    make_poisson_workload,
    run_poisson,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.serve.loadgen import _summarize

REPO = pathlib.Path(__file__).resolve().parents[1]
VOCAB = 61
TINY = dict(vocab_size=VOCAB, num_layers=2, num_heads=2, d_model=32, d_ff=64, max_seq_len=64,
            use_rope=True)
CASES = [(3, 9), (7, 4), (12, 11), (5, 17)]


class _ListSink:
    def __init__(self):
        self.records = []

    def emit(self, record):
        self.records.append(dict(record))


class _Tick:
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


def _cfg(**kw):
    return ServeConfig(**{**dict(num_slots=2, page_size=4, num_pages=33, max_pages_per_slot=8,
                                 paged_attention_impl="gather"), **kw})


def _engine(tiny, cfg=None, **kw):
    return ServingEngine(tiny[2], cfg or _cfg(seed=3), device="cpu", **kw)


def _submit_cases(eng, data_seed=7, req=Request, cases=CASES):
    rng = np.random.default_rng(data_seed)
    return [eng.submit(req(prompt=rng.integers(1, VOCAB, size=p).astype(np.int32),
                           max_new_tokens=n)) for p, n in cases]


def _streams(reqs):
    return {r.req_id: [int(t) for t in list(r.prompt[r.orig_prompt_len:]) + list(r.generated)]
            for r in reqs}


def _killed(tiny, steps, cfg=None, **kw):
    victim = _engine(tiny, cfg, **kw)
    reqs = _submit_cases(victim)
    for _ in range(steps):
        victim.step()
    return victim, reqs


@pytest.mark.parametrize("sample", [dict(), dict(temperature=0.9, top_k=20)],
                         ids=["greedy", "sampled"])
def test_kill_resume_streams_token_identical(tiny, sample):
    cfg = _cfg(seed=3, **sample)
    ref = _engine(tiny, cfg)
    _submit_cases(ref)
    expect = _streams(ref.run())
    victim, victim_reqs = _killed(tiny, 5, cfg)
    assert any(r.generated for r in victim_reqs) and victim.busy
    snap = victim.snapshot()
    assert any(rec["in_flight"] for rec in snap.requests)
    assert any(rec["replayed_tokens"] > 0 for rec in snap.requests)
    finished_before = {r.req_id for r in victim._completed}
    del victim
    fresh = _engine(tiny, cfg)
    done = {r.req_id: r for r in fresh.resume(snap)}
    fresh.run()
    assert all(r.done_time is not None for r in done.values())
    assert _streams(done.values()) == {k: v for k, v in expect.items() if k in done}
    assert set(done) | finished_before == set(expect)


def test_snapshot_requests_equal_jax(tiny):
    """The same trace, weights and ticking clock, in a pool tight enough
    to preempt, two steps past the first preemption: every field of every
    snapshot record equals the JAX engine's."""
    from cs744_pytorch_distributed_tutorial_tpu.serve import Request as JaxRequest
    from cs744_pytorch_distributed_tutorial_tpu.serve import ServeConfig as JaxConfig
    from cs744_pytorch_distributed_tutorial_tpu.serve import ServingEngine as JaxEngine

    jmodel, params, _ = tiny
    cfg = dict(num_slots=3, page_size=4, num_pages=9, max_pages_per_slot=7, seed=3,
               paged_attention_impl="gather")
    cases = [(6, 18), (10, 14), (8, 16), (5, 20), (12, 12)]
    jeng = JaxEngine(jmodel, params, JaxConfig(**cfg), clock=_Tick())
    _submit_cases(jeng, req=JaxRequest, cases=cases)
    eng = _engine(tiny, ServeConfig(**cfg), clock=_Tick())
    _submit_cases(eng, cases=cases)
    extra = 2
    while extra:
        jeng.step()
        eng.step()
        extra -= eng.stats()["preemptions"] > 0
    assert eng.busy and eng.stats()["preemptions"] == jeng.stats()["preemptions"]
    want, got = jeng.snapshot(), eng.snapshot()
    assert (got.seed, got.next_id) == (want.seed, want.next_id) == (3, 5)
    assert any(r["in_flight"] for r in got.requests)
    assert any(r["preemptions"] for r in got.requests), "the pool was not tight enough"
    assert len(got.requests) == len(want.requests)
    for g, w in zip(got.requests, want.requests):
        assert set(g) == set(w)
        assert g["prompt"].dtype == w["prompt"].dtype and np.array_equal(g["prompt"], w["prompt"])
        assert {k: v for k, v in g.items() if k != "prompt"} == {
            k: v for k, v in w.items() if k != "prompt"}


def test_resume_counts_and_emits_recovered_events(tiny):
    victim, _ = _killed(tiny, 4)
    snap = victim.snapshot()
    in_flight = sum(rec["in_flight"] for rec in snap.requests)
    assert in_flight > 0
    sink = _ListSink()
    fresh = _engine(tiny, sink=sink)
    fresh.resume(snap)
    events = [r for r in sink.records if r.get("event") == "recovered"]
    assert len(events) == in_flight and all(e["kind"] == "serve" for e in events)
    assert fresh.stats()["recovered_requests"] == in_flight
    fresh.run()
    assert fresh.stats()["recovered_requests"] == in_flight


def test_resume_guards(tiny):
    snap = _killed(tiny, 3)[0].snapshot()
    busy = _engine(tiny)
    busy.submit(Request(prompt=np.ones((4,), np.int32), max_new_tokens=4))
    with pytest.raises(RuntimeError, match="idle engine"):
        busy.resume(snap)
    with pytest.raises(ValueError, match="seed"):
        _engine(tiny, _cfg(seed=4)).resume(snap)


def test_snapshot_does_not_disturb_live_engine(tiny):
    ref = _engine(tiny)
    ref_reqs = _submit_cases(ref)
    ref.run()
    eng, reqs = _killed(tiny, 4)
    eng.snapshot()
    eng.run()
    assert _streams(reqs) == _streams(ref_reqs)


def test_preempt_events_match_counter(tiny):
    sink = _ListSink()
    eng = _engine(tiny, ServeConfig(num_slots=3, page_size=4, num_pages=9, max_pages_per_slot=7),
                  sink=sink)
    rng = np.random.default_rng(13)
    for plen, budget in [(6, 18), (10, 14), (8, 16), (5, 20), (12, 12)]:
        eng.submit(Request(prompt=rng.integers(1, VOCAB, size=plen).astype(np.int32),
                           max_new_tokens=budget))
    eng.run()
    events = [r for r in sink.records if r.get("event") == "preempt"]
    assert len(events) == eng.stats()["preemptions"] > 0
    assert all(e["kind"] == "serve" and e["replayed_tokens"] >= 0 for e in events)


def test_loadgen_reports_recovered_twin(tiny):
    snap = _killed(tiny, 4)[0].snapshot()
    sink = _ListSink()
    fresh = _engine(tiny, sink=sink)
    fresh.resume(snap)
    recovered = fresh.stats()["recovered_requests"]
    assert recovered > 0
    wl = make_poisson_workload(num_requests=3, rate_rps=100.0, prompt_len=(3, 6),
                               output_len=(2, 4), vocab_size=VOCAB, seed=5)
    record = run_poisson(fresh, wl, sink=sink, warmup=False)
    assert record["recovered_requests"] == recovered
    assert record["recovered"] == len(snap.requests)
    twins = [r for r in sink.records if r.get("metric") == "serve_recovered"]
    assert len(twins) == 1 and twins[0]["value"] == recovered


def _timed_request(token_times, boundaries):
    r = Request(prompt=np.ones((3,), np.int32), max_new_tokens=4, req_id=0)
    r.orig_prompt_len, r.orig_max_new_tokens = 3, len(token_times)
    r.generated = [1] * len(token_times)
    r.arrival_time = r.submit_time = token_times[0] - 0.001
    r.first_token_time, r.done_time = token_times[0], token_times[-1]
    r.token_times, r.resume_boundaries = list(token_times), list(boundaries)
    r.recovered = bool(boundaries)
    return r


def test_summarize_itl_excludes_kill_gap():
    from cs744_pytorch_distributed_tutorial_tpu.serve.loadgen import _summarize as jax_summarize

    times = [0.0, 0.010, 5.010, 5.020, 5.030]  # 10 ms gaps, a 5 s kill gap
    clean = _summarize("continuous", [_timed_request(times, [2])], 1.0, {})
    assert clean["itl_p50_ms"] == pytest.approx(10.0, abs=0.01)
    assert clean["itl_p99_ms"] == pytest.approx(10.0, abs=0.01)
    assert _summarize("continuous", [_timed_request(times, [])], 1.0, {})["itl_p99_ms"] > 1000
    edge = _summarize("continuous", [_timed_request(times, [0, 2, 99])], 1.0, {})
    assert edge["itl_p99_ms"] == clean["itl_p99_ms"]
    assert clean["recovered"] == 1 and clean["completed"] == 0
    for boundaries in ([2], [], [0, 2, 99]):
        got = _summarize("continuous", [_timed_request(times, boundaries)], 1.0, {})
        want = jax_summarize("continuous", [_timed_request(times, boundaries)], 1.0, {})
        assert {k: v for k, v in got.items() if k != "time"} == {
            k: v for k, v in want.items() if k != "time"}


def test_resumed_requests_flag_recovered_and_bound_itl(tiny):
    snap = _killed(tiny, 4)[0].snapshot()
    for rec in snap.requests:  # a long outage: the kill gap is unmistakable
        rec["token_times"] = [t - 120.0 for t in rec["token_times"]]
        if rec.get("arrival_time") is not None:
            rec["arrival_time"] -= 120.0
    sink = _ListSink()
    fresh = _engine(tiny, sink=sink)
    resumed = fresh.resume(snap)
    fresh.run()
    assert any(r.resume_boundaries for r in resumed if len(r.token_times) > 1)
    assert all(r.recovered for r in resumed)
    recs = [r for r in sink.records if r.get("event") == "request"]
    assert recs and all(r["recovered"] and r["status"] == "recovered" for r in recs)
    assert _summarize("continuous", resumed, 1.0, {})["itl_p99_ms"] < 60_000.0


def test_spans_close_across_kill_resume(tiny):
    """A fresh engine's tracer: in-flight requests re-admit as
    resume-replay spans with their replayed counts, the request rows
    carry ``recovered`` (``reconcile`` skips them: their stamps are the
    dead engine's)."""
    victim, _ = _killed(tiny, 5)
    snap = victim.snapshot()
    in_flight = sum(rec["in_flight"] for rec in snap.requests)
    assert in_flight > 0
    tracer = ServeTracer(2)
    fresh = _engine(tiny, tracer=tracer)
    fresh.resume(snap)
    fresh.run()
    spans = tracer.all_spans()
    assert check_spans(spans) == [] and reconcile(spans, tracer.requests) == []
    replays = [s for s in spans if s["name"] == "resume-replay"]
    assert len(replays) == in_flight and all(s.get("replayed", 0) > 0 for s in replays)
    assert len([r for r in tracer.requests if r["recovered"]]) == len(snap.requests)


def test_metrics_summary_counts_port_chaos_rows(tiny):
    """The untouched ``benchmarks/metrics_summary.py`` tallies the port's
    preempt and recovered events and the summary's recovered count, as
    JAX's ``test_metrics_summary_counts_chaos_rows`` holds JAX's."""
    spec = importlib.util.spec_from_file_location("metrics_summary",
                                                  REPO / "benchmarks" / "metrics_summary.py")
    ms = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ms)
    sink = _ListSink()
    victim = _engine(tiny, ServeConfig(num_slots=3, page_size=4, num_pages=9,
                                       max_pages_per_slot=7, seed=3), sink=sink)
    _submit_cases(victim)
    for _ in range(6):
        victim.step()
    snap = victim.snapshot()
    fresh = _engine(tiny, sink=sink)
    fresh.resume(snap)
    wl = make_poisson_workload(num_requests=2, rate_rps=100.0, prompt_len=(3, 6),
                               output_len=(2, 4), vocab_size=VOCAB, seed=5)
    rec = run_poisson(fresh, wl, sink=sink, warmup=False)
    preempts = victim.stats()["preemptions"] + fresh.stats()["preemptions"]
    assert preempts > 0 and rec["recovered_requests"] > 0
    summary = ms.summarize(sink.records)
    assert summary["serve_preempt_replays"] == preempts
    assert summary["serve_recovered"] == rec["recovered_requests"]
    assert summary["serve"]["continuous"]["recovered_requests"] == rec["recovered_requests"]


@pytest.mark.parametrize("sample", [dict(), dict(temperature=0.9, top_k=20)],
                         ids=["greedy", "sampled"])
def test_decode_recompute_replays_the_first_pass(tiny, sample):
    """``recompute="decode"`` (a port option; the JAX engine has only the
    one-pass re-prefill): a preempted or resumed request re-runs its
    original prompt's pass and feeds its produced tokens back through
    decode steps, so each fed-back token is the one the step reproduces
    (``replay_mismatches`` 0) and the streams are those of a run without
    preemption or kill, exactly; the spans still audit clean."""
    tight = dict(num_slots=3, page_size=4, num_pages=9, max_pages_per_slot=7, seed=3,
                 paged_attention_impl="gather", **sample)
    ample = _engine(tiny, _cfg(num_slots=3, seed=3, **sample))
    _submit_cases(ample)
    expect = _streams(ample.run())
    tracer = ServeTracer(3)
    eng = _engine(tiny, ServeConfig(**tight, recompute="decode"), tracer=tracer)
    _submit_cases(eng)
    for _ in range(6):
        eng.step()
    snap = eng.snapshot()
    eng.run()
    assert eng.stats()["preemptions"] > 0 and eng.stats()["replay_mismatches"] == 0
    assert _streams(eng._completed) == expect
    spans = tracer.all_spans()
    assert check_spans(spans) == [] and reconcile(spans, tracer.requests) == []
    recomputes = [s for s in spans if s["name"] == "recompute"]
    assert recomputes and all(s["replayed"] > 0 for s in recomputes)
    fresh = _engine(tiny, ServeConfig(**tight, recompute="decode"))
    resumed = fresh.resume(snap)
    fresh.run()
    assert any(r["replayed_tokens"] for r in snap.requests)
    assert fresh.stats()["replay_mismatches"] == 0
    assert _streams(resumed) == {r.req_id: expect[r.req_id] for r in resumed}
    with pytest.raises(ValueError, match="recompute must be one of"):
        _engine(tiny, _cfg(recompute="replay"))
