"""The port's serving guard, chaos monkey and supervised recovery
(``serve/guard.py``, ``utils/chaos.py``) against the JAX package's
(``tests/test_serve_guard.py`` mirrored).

The JAX engine and the port's serve the same requests from the same
weights (the tiny LM of ``tests/test_torch_port_serve.py``, the gather
path) under the same manual clock, and their shed records, expiry
records and terminal statuses are compared exactly. ``GuardConfig``
raises JAX's exception types with JAX's messages. Token streams are
exact: a degrade trim is a prefix of the untrimmed output (greedy and
sampled), an ``engine_crash`` resumes token for token, and the overload
+ chaos run under ``run_serve_with_recovery`` gives the fault-free
streams and JAX's streams for the same schedule. The hung-step test
reads the watchdog's arm calls and fire count, not timings: the injected
stall re-arms the armed watchdog with a 1 ms timeout and waits for its
third fire (the abort). Pool accounting, loadgen's terminal counts and
the untouched ``benchmarks/metrics_summary.py`` reading the port's shed
and give-up records are held as the JAX tests hold them.
"""

from __future__ import annotations

import importlib.util
import pathlib
import time

import numpy as np
import pytest
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import lm_params_from_jax
from cs744_pytorch_distributed_tutorial_tpu_torch.models.transformer import TransformerLM
from cs744_pytorch_distributed_tutorial_tpu_torch.serve import (
    GuardConfig,
    PagePool,
    make_poisson_workload,
    run_poisson,
    run_serve_with_recovery,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.utils.chaos import (
    FaultSchedule,
    ServeChaosMonkey,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.utils.failure import (
    DecodeNanError,
    EngineCrashError,
    StepWatchdog,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
VOCAB = 61
TINY = dict(vocab_size=VOCAB, num_layers=2, num_heads=2, d_model=32, d_ff=64, max_seq_len=64,
            use_rope=True)


class _ListSink:
    def __init__(self):
        self.records = []

    def emit(self, record):
        self.records.append(dict(record))


class _Clock:
    """A manual clock: the guard's sweeps are deterministic."""

    def __init__(self, t: float = 100.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)


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
    return {**dict(num_slots=2, page_size=4, num_pages=33, max_pages_per_slot=8,
                   paged_attention_impl="gather"), **kw}


def _prompt(rng, n):
    return rng.integers(1, VOCAB, size=n).astype(np.int32)


def _produced(r):
    return [int(t) for t in list(r.prompt[r.orig_prompt_len:]) + list(r.generated)]


class _Side:
    """One framework's serving API: the JAX package's or the port's, so a
    scenario is written once and run on both."""

    def __init__(self, tiny, name):
        self.name = name
        jmodel, params, model = tiny
        if name == "jax":
            from cs744_pytorch_distributed_tutorial_tpu import serve as S
            from cs744_pytorch_distributed_tutorial_tpu.utils import chaos as C

            self.S, self.C = S, C
            self.engine = lambda cfg, **kw: S.ServingEngine(jmodel, params, S.ServeConfig(**cfg),
                                                            **kw)
        else:
            from cs744_pytorch_distributed_tutorial_tpu_torch import serve as S
            from cs744_pytorch_distributed_tutorial_tpu_torch.utils import chaos as C

            self.S, self.C = S, C
            self.engine = lambda cfg, **kw: S.ServingEngine(model, S.ServeConfig(**cfg),
                                                            device="cpu", **kw)

    def guard(self, **kw):
        return self.S.ServeGuard(cfg=self.S.GuardConfig(**kw))

    def request(self, prompt, n):
        return self.S.Request(prompt=prompt, max_new_tokens=n)


def _events(sink, kind, event=None):
    return [r for r in sink.records if r.get("kind") == kind
            and (event is None or r.get("event") == event)]


# ---------------------------------------------------------------- the pool
def test_pool_rejects_double_free():
    pool = PagePool(num_pages=9, page_size=4)
    pages = pool.alloc(3)
    pool.free(pages)
    with pytest.raises(ValueError, match="double free"):
        pool.free([pages[0]])
    assert pool.check_invariants()


def test_pool_rejects_duplicate_pages_in_one_free():
    pool = PagePool(num_pages=9, page_size=4)
    a = pool.alloc(2)
    with pytest.raises(ValueError, match="double free"):
        pool.free([a[0], a[0]])
    assert pool.allocated_pages == 2 and pool.check_invariants()
    pool.free(a)
    assert pool.free_pages == 8 and pool.check_invariants()


def test_pool_check_invariants_catches_corruption():
    pool = PagePool(num_pages=9, page_size=4)
    pool.alloc(2)
    pool._free.append(pool._free[0])  # a double free that slipped through
    with pytest.raises(AssertionError):
        pool.check_invariants()


# ------------------------------------------------------ admission control
@pytest.mark.parametrize("kw", [dict(shed_policy="drop"), dict(degrade_floor=0),
                                dict(pressure_free_frac=1.5)])
def test_guard_config_validates_as_jax(kw):
    from cs744_pytorch_distributed_tutorial_tpu.serve import GuardConfig as JaxGuardConfig

    with pytest.raises(Exception) as want:
        JaxGuardConfig(**kw)
    with pytest.raises(Exception) as got:
        GuardConfig(**kw)
    assert type(got.value) is type(want.value) is ValueError
    assert str(got.value) == str(want.value)


def _queue_full(side):
    sink = _ListSink()
    eng = side.engine(_cfg(), sink=sink, clock=_Clock(), guard=side.guard(max_queue_depth=2))
    rng = np.random.default_rng(3)
    reqs = [eng.submit(side.request(_prompt(rng, 4), 4)) for _ in range(5)]
    queued = len(eng._queue)
    while eng.busy:
        eng.step()
    return eng, reqs, sink, queued


def test_queue_full_sheds_terminally_as_jax(tiny):
    jeng, jreqs, jsink, _ = _queue_full(_Side(tiny, "jax"))
    eng, reqs, sink, queued = _queue_full(_Side(tiny, "port"))
    assert queued == 2
    assert [r.req_id for r in reqs if r.terminal_status == "rejected"] == [2, 3, 4]
    assert all(r.output_tokens == 0 for r in reqs[2:])
    assert [r.terminal_status for r in reqs] == [r.terminal_status for r in jreqs]
    assert [_produced(r) for r in reqs] == [_produced(r) for r in jreqs]
    sheds = [(e["id"], e["reason"], e["terminal"], e["queue_depth"])
             for e in _events(sink, "serve_shed")]
    assert sheds == [(e["id"], e["reason"], e["terminal"], e["queue_depth"])
                     for e in _events(jsink, "serve_shed")]
    assert sheds == [(2, "queue_full", True, 2), (3, "queue_full", True, 2),
                     (4, "queue_full", True, 2)]
    assert eng.guard.shed_counts == jeng.guard.shed_counts == {"queue_full": 3}
    assert eng.stats()["shed_requests"] == 3
    assert sorted(r.req_id for r in eng._completed) == [0, 1, 2, 3, 4]


@pytest.mark.parametrize("sample", [dict(), dict(temperature=0.9, top_k=20)],
                         ids=["greedy", "sampled"])
def test_degrade_trim_output_is_oracle_prefix(tiny, sample):
    """Bitwise prefix, greedy and sampled: the trim moves only
    max_new_tokens, and the draws are keyed by (seed, id, token index)."""
    side = _Side(tiny, "port")
    rng = np.random.default_rng(5)
    filler, prompt = _prompt(rng, 8), _prompt(rng, 6)
    oracle = side.engine(_cfg(**sample))
    oracle.submit(side.request(filler.copy(), 8))
    o = oracle.submit(side.request(prompt.copy(), 20))
    oracle.run()

    sink = _ListSink()
    guard = side.guard(shed_policy="degrade", degrade_floor=6, pressure_free_frac=1.0)
    eng = side.engine(_cfg(**sample), sink=sink, guard=guard)
    eng.submit(side.request(filler.copy(), 8))
    eng.step()  # the filler's pages put the (hair-trigger) pool under pressure
    r = eng.submit(side.request(prompt.copy(), 20))
    assert r.max_new_tokens == 6 and r.orig_max_new_tokens == 6
    eng.run()
    assert r.terminal_status == "completed" and r.generated == o.generated[:6]
    assert [(e["reason"], e["terminal"], e["tokens_shed"])
            for e in _events(sink, "serve_shed")] == [("degrade_trim", False, 14)]
    assert guard.shed_counts == {"degrade_trim": 1}


def _seeded_overload(side):
    clock, sink = _Clock(), _ListSink()
    eng = side.engine(_cfg(), sink=sink, clock=clock,
                      guard=side.guard(max_queue_depth=2, deadline_s=3.0))
    rng = np.random.default_rng(9)
    sizes = rng.integers(4, 9, size=(10, 2))
    reqs = []
    for k, (plen, budget) in enumerate(sizes):
        reqs.append(eng.submit(side.request(_prompt(rng, int(plen)), int(budget))))
        if k % 3 == 2:
            eng.step()
            clock.advance(0.5)
    while eng.busy:
        eng.step()
        clock.advance(0.5)
    sheds = [(e["id"], e["reason"], e["terminal"]) for e in _events(sink, "serve_shed")]
    expiries = [(e["id"], e["reason"], e["queued"])
                for e in _events(sink, "serve", "timed_out")]
    return sheds, expiries, [r.terminal_status for r in reqs], [_produced(r) for r in reqs]


def test_shed_and_expiry_events_equal_jax_on_seeded_trace(tiny):
    got = _seeded_overload(_Side(tiny, "port"))
    assert got[0], "the trace was not overloaded enough to shed"
    assert got[1], "the trace was not slow enough to expire deadlines"
    assert got == _seeded_overload(_Side(tiny, "jax"))


# -------------------------------------------------------------- deadlines
def _deadline_active(side):
    clock, sink = _Clock(), _ListSink()
    eng = side.engine(_cfg(), sink=sink, clock=clock, guard=side.guard(deadline_s=10.0))
    r = eng.submit(side.request(_prompt(np.random.default_rng(0), 6), 20))
    for _ in range(3):
        eng.step()
    started = r.first_token_time is not None and r.done_time is None
    clock.advance(11.0)
    eng.step()
    return eng, r, sink, started


def test_deadline_expires_active_slot_and_frees_pages(tiny):
    jeng, jr, jsink, _ = _deadline_active(_Side(tiny, "jax"))
    eng, r, sink, started = _deadline_active(_Side(tiny, "port"))
    assert started and r.terminal_status == jr.terminal_status == "timed_out"
    assert eng.pool.free_pages == eng.pool.num_pages - 1 and eng.pool.check_invariants()
    evs = [(e["id"], e["reason"], e["queued"]) for e in _events(sink, "serve", "timed_out")]
    assert evs == [(r.req_id, "deadline", False)]
    assert evs == [(e["id"], e["reason"], e["queued"])
                   for e in _events(jsink, "serve", "timed_out")]
    assert eng.stats()["timed_out_requests"] == 1
    (rec,) = _events(sink, "serve", "request")
    (jrec,) = _events(jsink, "serve", "request")
    assert rec["status"] == jrec["status"] == "timed_out" and rec["ttft_ms"] is not None
    assert {k: rec[k] for k in ("output_tokens", "ttft_ms", "decode_ms_per_token")} == {
        k: jrec[k] for k in ("output_tokens", "ttft_ms", "decode_ms_per_token")}
    assert _produced(r) == _produced(jr)


def test_queue_wait_expires_queued_request(tiny):
    def scenario(side):
        clock, sink = _Clock(), _ListSink()
        eng = side.engine(_cfg(num_slots=1), sink=sink, clock=clock,
                          guard=side.guard(max_queue_s=5.0))
        rng = np.random.default_rng(1)
        first = eng.submit(side.request(_prompt(rng, 6), 24))
        eng.step()  # first holds the only slot
        waiting = eng.submit(side.request(_prompt(rng, 6), 8))
        clock.advance(6.0)
        eng.step()
        mid = (waiting.terminal_status, waiting.first_token_time, waiting.output_tokens)
        while eng.busy:
            eng.step()
        rec = [e for e in _events(sink, "serve", "request") if e["id"] == waiting.req_id]
        evs = [(e["id"], e["reason"], e["queued"]) for e in _events(sink, "serve", "timed_out")]
        return (mid, rec[0]["ttft_ms"], rec[0]["decode_ms_per_token"], evs,
                first.terminal_status, first.output_tokens, _produced(first)), eng

    got, eng = scenario(_Side(tiny, "port"))
    assert got[:6] == (("timed_out", None, 0), None, None, [(1, "queue_wait", True)],
                       "completed", 24)
    assert eng.pool.check_invariants()
    assert got == scenario(_Side(tiny, "jax"))[0]


def test_preempted_victim_expires_at_queue_front(tiny):
    """A LIFO-preempted victim waits at the queue front with its pages
    freed, and its deadline lapses before re-admission: it resolves
    timed_out without touching the pool again, and nothing leaks."""
    def scenario(side):
        clock, sink = _Clock(), _ListSink()
        eng = side.engine(_cfg(num_slots=3, num_pages=9, max_pages_per_slot=7), sink=sink,
                          clock=clock, guard=side.guard())
        rng = np.random.default_rng(13)
        cases = [(6, 18), (10, 14), (8, 16), (5, 20), (12, 12)]
        reqs = [eng.submit(side.request(_prompt(rng, p), n)) for p, n in cases]
        victim = None
        while eng.busy:
            eng.step()
            if eng._queue and eng._queue[0].preemptions > 0:
                victim = eng._queue[0]
                break
        assert victim is not None, "the pool was not tight enough to preempt"
        victim.deadline_s = 1.0
        clock.advance(2.0)
        while eng.busy:
            eng.step()
        return eng, reqs, victim

    jeng, jreqs, jvictim = scenario(_Side(tiny, "jax"))
    eng, reqs, victim = scenario(_Side(tiny, "port"))
    assert victim.req_id == jvictim.req_id and victim.terminal_status == "timed_out"
    assert all(r.terminal_status == "completed" and r.output_tokens == r.orig_max_new_tokens
               for r in reqs if r is not victim)
    assert [r.terminal_status for r in reqs] == [r.terminal_status for r in jreqs]
    assert [_produced(r) for r in reqs] == [_produced(r) for r in jreqs]
    assert eng.pool.free_pages == eng.pool.num_pages - 1 and eng.pool.check_invariants()
    assert eng.stats()["timed_out_requests"] == 1 and len(eng._completed) == 5


# ------------------------------------------------------------------ chaos
def test_chaos_decode_nan_raises_and_fires_once(tiny):
    side = _Side(tiny, "port")
    eng = side.engine(_cfg())
    monkey = ServeChaosMonkey(FaultSchedule({2: "decode_nan"}))
    monkey.install(eng)
    eng.submit(side.request(_prompt(np.random.default_rng(17), 4), 8))
    with pytest.raises(DecodeNanError, match="decode step 2 produced out-of-vocab tokens "
                                             r"in slots \[0\]") as e:
        while eng.busy:
            eng.step()
    assert e.value.step == 2 and e.value.slots == (0,)
    assert 2 not in monkey.schedule.faults and monkey.injected == [(2, "decode_nan")]
    assert eng.stats()["decode_steps"] == 2  # raised before the step's bookkeeping


def test_chaos_engine_crash_is_snapshot_consistent(tiny):
    side = _Side(tiny, "port")
    prompt = _prompt(np.random.default_rng(19), 5)
    oracle = side.engine(_cfg())
    o = oracle.submit(side.request(prompt.copy(), 8))
    oracle.run()

    eng = side.engine(_cfg())
    monkey = ServeChaosMonkey(FaultSchedule({3: "engine_crash"}))
    monkey.install(eng)
    r = eng.submit(side.request(prompt.copy(), 8))
    with pytest.raises(EngineCrashError, match="engine crash at decode step 3"):
        while eng.busy:
            eng.step()
    snap = eng.snapshot()
    eng2 = side.engine(_cfg())
    monkey.install(eng2)
    eng2.resume(snap)
    eng2.run()
    rec = {q.req_id: q for q in eng2._completed}[r.req_id]
    assert rec.recovered and rec.terminal_status == "recovered"
    assert _produced(rec) == o.generated


def test_chaos_slow_step_stalls_via_injectable_sleep(tiny):
    side = _Side(tiny, "port")
    stalls = []
    eng = side.engine(_cfg())
    monkey = ServeChaosMonkey(FaultSchedule({1: {"kind": "slow_step", "stall_s": 0.25}}),
                              sleep=stalls.append)
    monkey.install(eng)
    assert eng._decode.__wrapped__ is not None
    r = eng.submit(side.request(_prompt(np.random.default_rng(23), 4), 6))
    eng.run()
    assert stalls == [0.25] and r.terminal_status == "completed" and r.output_tokens == 6


def test_fault_schedule_rejects_unknown_kinds():
    with pytest.raises(ValueError, match="fault kind must be one of"):
        FaultSchedule({3: "meteor"})
    # The training kinds share the schedule (as in JAX); a kill needs its target.
    assert FaultSchedule({3: "nan"}).pop(3) == {"kind": "nan"}
    with pytest.raises(ValueError, match="process_kill at call 3 needs a target"):
        FaultSchedule({3: "process_kill"})
    schedule = FaultSchedule({3: "decode_nan", 5: {"kind": "slow_step", "stall_s": 0.1}})
    assert len(schedule) == 2 and schedule.pop(5) == {"kind": "slow_step", "stall_s": 0.1}
    assert schedule.pop(5) is None and len(schedule) == 1


def test_tracer_shed_and_timeout_lifecycles_audit_clean(tiny):
    from cs744_pytorch_distributed_tutorial_tpu_torch.obs.serve_trace import (
        ServeTracer,
        check_spans,
        reconcile,
    )

    side = _Side(tiny, "port")
    clock, tracer = _Clock(), ServeTracer(1)
    eng = side.engine(_cfg(num_slots=1), clock=clock, tracer=tracer,
                      guard=side.guard(max_queue_depth=1, max_queue_s=2.0))
    rng = np.random.default_rng(29)
    a = eng.submit(side.request(_prompt(rng, 4), 6))
    eng.step()
    b = eng.submit(side.request(_prompt(rng, 4), 6))
    c = eng.submit(side.request(_prompt(rng, 4), 6))
    assert c.terminal_status == "rejected"
    clock.advance(3.0)
    eng.step()  # b expires queued, never admitted
    while eng.busy:
        eng.step()
        clock.advance(0.1)
    assert (a.terminal_status, b.terminal_status) == ("completed", "timed_out")
    eng.finalize_trace()
    assert check_spans(tracer.spans) == [] and reconcile(tracer.spans, tracer.requests) == []
    assert [(s["req"], s["reason"]) for s in tracer.spans if s["name"] == "shed"] == [
        (c.req_id, "queue_full")]
    recs = {r["req"]: r for r in tracer.requests}
    assert recs[b.req_id]["status"] == "timed_out" and recs[c.req_id]["status"] == "rejected"
    assert "status" not in recs[a.req_id]


def test_loadgen_counts_terminal_statuses(tiny):
    side = _Side(tiny, "port")
    sink = _ListSink()
    eng = side.engine(_cfg(), sink=sink, guard=side.guard(max_queue_depth=2))
    wl = make_poisson_workload(num_requests=10, rate_rps=5000.0, prompt_len=(4, 8),
                               output_len=(4, 8), vocab_size=VOCAB, seed=2)
    rec = run_poisson(eng, wl, sink=sink)
    assert rec["completed"] + rec["rejected"] + rec["timed_out"] + rec["recovered"] == 10
    assert rec["rejected"] >= 1, "the bounded queue never bit"
    twins = {r["metric"]: r["value"] for r in _events(sink, "bench")}
    assert twins["serve_rejected"] == rec["rejected"]
    assert twins["serve_timed_out"] == rec["timed_out"]
    assert twins["serve_recovered"] == rec["recovered_requests"] == 0


# ----------------------------------------------------- supervised recovery
OVERLOAD = dict(num_requests=16, rate_rps=200.0, prompt_len=(4, 10), output_len=(4, 10),
                vocab_size=VOCAB, seed=21)


def _chaos_run(side, sample):
    cfg = _cfg(num_slots=3, **sample)
    sink, engines = _ListSink(), []
    # A bound that never trips: ids stay those of the oracle run.
    guard = side.guard(max_queue_depth=64)
    monkey = side.C.ServeChaosMonkey(
        side.C.FaultSchedule({5: "decode_nan", 12: "engine_crash"}), telemetry=sink)

    def make_engine():
        engines.append(side.engine(cfg, sink=sink, guard=guard))
        return engines[-1]

    rec = side.S.run_serve_with_recovery(make_engine, make_poisson_workload(**OVERLOAD),
                                         monkey=monkey, max_restarts=4, telemetry=sink,
                                         sink=sink)
    done = {r.req_id: _produced(r) for e in engines for r in e._completed}
    return rec, done, engines, sink


@pytest.mark.parametrize("sample", [dict(), dict(temperature=0.9, top_k=20)],
                         ids=["greedy", "sampled"])
def test_overload_chaos_streams_token_identical_to_oracle(tiny, sample):
    """Arrivals past the sustainable rate, decode_nan and engine_crash
    mid-run: every request resolves once, no page leaks, and each stream
    is the fault-free run's, and (greedy) JAX's for the same schedule."""
    side = _Side(tiny, "port")
    wl = make_poisson_workload(**OVERLOAD)
    oracle = side.engine(_cfg(num_slots=3, **sample))
    orc = [oracle.submit(side.request(p.copy(), int(m)))
           for p, m in zip(wl.prompts, wl.max_new_tokens)]
    oracle.run()
    rec, done, engines, sink = _chaos_run(side, sample)
    assert rec["restarts"] == 2 and rec["requests"] == 16
    assert rec["rejected"] == rec["timed_out"] == 0
    assert rec["completed"] + rec["recovered"] == 16 and rec["recovered"] > 0
    assert done == {r.req_id: _produced(r) for r in orc}
    last = engines[-1]
    assert last.pool.free_pages == last.pool.num_pages - 1 and last.pool.check_invariants()
    events = [e["event"] for e in _events(sink, "event")]
    assert events.count("recovery_restart") == 2 and events.count("chaos_inject") == 2
    assert "recovery_complete" in events and "recovery_giveup" not in events
    if not sample:
        jrec, jdone, _, _ = _chaos_run(_Side(tiny, "jax"), sample)
        # The completed/recovered split depends on the wall clock (which
        # arrivals came before each fault), not on the engine.
        assert done == jdone
        assert (rec["restarts"], rec["requests"]) == (jrec["restarts"], jrec["requests"])


def test_hung_step_watchdog_triggers_restart(tiny, monkeypatch):
    """A stalled decode step climbs the watchdog's warn -> dump -> abort
    ladder; the supervisor turns the abort into HungStepError and
    restarts the engine. No real stall: the injected sleep re-arms the
    watchdog that is armed around the step (read from its arm calls) at
    1 ms and waits for its third fire."""
    side = _Side(tiny, "port")
    armed = []
    real_arm = StepWatchdog.arm

    def arm(self, timeout_s=None):
        armed.append(self)
        real_arm(self, timeout_s)

    monkeypatch.setattr(StepWatchdog, "arm", arm)
    stalls = []

    def stall(seconds):
        wd = armed[-1]
        stalls.append((seconds, wd._deadline is not None))
        wd.arm(0.001)
        deadline = time.monotonic() + 30
        while wd.fired < 3 and time.monotonic() < deadline:
            time.sleep(0.001)
        stalls.append(wd.last_stage)

    sink = _ListSink()
    wl = make_poisson_workload(num_requests=4, rate_rps=50.0, prompt_len=(4, 8),
                               output_len=(4, 6), vocab_size=VOCAB, seed=3)
    monkey = ServeChaosMonkey(FaultSchedule({2: {"kind": "slow_step", "stall_s": 7.0}}),
                              telemetry=sink, sleep=stall)
    rec = run_serve_with_recovery(lambda: side.engine(_cfg(), sink=sink), wl, monkey=monkey,
                                  max_restarts=2, step_timeout_s=30.0, telemetry=sink,
                                  sink=sink)
    assert stalls == [(7.0, True), "abort"]
    assert rec["restarts"] == 1 and rec["completed"] + rec["recovered"] == 4
    (restart,) = _events(sink, "event", "recovery_restart")
    assert "HungStepError" in restart["failure"]
    dumps = _events(sink, "event", "flight_dump")
    assert [d["reason"] for d in dumps] == ["watchdog", "watchdog"]  # dump, then abort


def _giveup(tiny):
    side = _Side(tiny, "port")
    sink = _ListSink()
    wl = make_poisson_workload(num_requests=2, rate_rps=100.0, prompt_len=(4, 6),
                               output_len=(3, 5), vocab_size=VOCAB, seed=31)
    monkey = ServeChaosMonkey(FaultSchedule({0: "decode_nan"}), telemetry=sink)
    with pytest.raises(DecodeNanError):
        run_serve_with_recovery(lambda: side.engine(_cfg(), sink=sink), wl, monkey=monkey,
                                max_restarts=0, telemetry=sink, sink=sink)
    return sink


def test_recovery_giveup_emits_traceback(tiny):
    (give,) = _events(_giveup(tiny), "event", "recovery_giveup")
    assert give["restarts"] == 0
    assert give["traceback"].startswith("Traceback")
    assert "DecodeNanError" in give["traceback"].strip().splitlines()[-1]


def test_metrics_summary_reads_port_giveup_and_shed_rows(tiny):
    """The untouched ``benchmarks/metrics_summary.py`` reads the port's
    give-up traceback, shed records and guarded summary, as JAX's
    ``test_metrics_summary_giveup_traceback_and_shed_rows`` holds JAX's."""
    spec = importlib.util.spec_from_file_location("metrics_summary",
                                                  REPO / "benchmarks" / "metrics_summary.py")
    ms = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ms)
    records = list(_giveup(tiny).records)
    side = _Side(tiny, "port")
    sink = _ListSink()
    eng = side.engine(_cfg(), sink=sink, guard=side.guard(max_queue_depth=2,
                                                          shed_policy="degrade",
                                                          pressure_free_frac=1.0))
    wl = make_poisson_workload(num_requests=8, rate_rps=5000.0, prompt_len=(4, 8),
                               output_len=(10, 12), vocab_size=VOCAB, seed=2)
    rec = run_poisson(eng, wl, sink=sink)
    records += sink.records
    s = ms.summarize(records)
    tail = s["chaos_events"]["recovery_giveup"]["traceback_tail"]
    assert tail.startswith("cs744_pytorch_distributed_tutorial_tpu_torch.utils.failure."
                           "DecodeNanError: decode step 0 produced out-of-vocab tokens")
    counts = eng.guard.shed_counts
    assert counts["queue_full"] >= 1 and counts["degrade_trim"] >= 1
    assert s["serve_shed"] == counts and s["serve_shed_terminal"] == counts["queue_full"]
    row = s["serve"]["continuous"]
    assert (row["completed"], row["rejected"], row["timed_out"]) == (
        rec["completed"], rec["rejected"], rec["timed_out"])


def test_overload_chaos_with_decode_recompute_replays_bitwise(tiny):
    """The overload + chaos run with ``recompute="decode"`` (sampled): the
    replays feed back exactly the tokens the steps reproduce
    (``replay_mismatches`` summed over the engine generations is 0) and the
    streams are the fault-free run's."""
    side = _Side(tiny, "port")
    sample = dict(temperature=0.9, top_k=20, recompute="decode")
    wl = make_poisson_workload(**OVERLOAD)
    oracle = side.engine(_cfg(num_slots=3, **sample))
    orc = [oracle.submit(side.request(p.copy(), int(m)))
           for p, m in zip(wl.prompts, wl.max_new_tokens)]
    oracle.run()
    rec, done, _, _ = _chaos_run(side, sample)
    assert rec["restarts"] == 2 and rec["replay_mismatches"] == 0
    assert done == {r.req_id: _produced(r) for r in orc}
