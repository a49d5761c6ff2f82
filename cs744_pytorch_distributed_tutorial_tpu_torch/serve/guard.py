"""Deadlines, admission control, overload shedding and supervised engine
recovery for the serving engine (the JAX package's ``serve/guard.py``).

All of it runs on the host, between decode steps:

- **Deadlines** (``ServeGuard.expire``, at the top of every ``step()``):
  ``deadline_s`` bounds the time from arrival to retire, ``max_queue_s``
  the time queued before the first admission. An expired queued request
  resolves, an expired active slot retires and frees its pages at once
  (``PagePool.check_invariants`` audits it); both end ``timed_out``.
- **Admission control** (``ServeGuard.admit``, from ``submit()``): a
  bounded queue rejects at ``max_queue_depth`` (status ``rejected``);
  policy ``"degrade"`` first trims ``max_new_tokens`` to
  ``degrade_floor`` while the pool is under pressure, shedding work
  before requests. Each shed is a ``kind:"serve_shed"`` record with a
  ``reason`` (``queue_full`` or ``degrade_trim``). The sampling streams
  are keyed by (seed, request id, token index), so a trimmed request's
  output is a prefix of its untrimmed output at any temperature.
- **Supervised recovery** (``run_serve_with_recovery``): drives a Poisson
  workload; a ``ServeFailure`` (``DecodeNanError``, ``EngineCrashError``,
  or ``HungStepError`` once the ``StepWatchdog`` has climbed warn ->
  dump -> abort) snapshots the dead engine's host state, backs off,
  builds a fresh engine, re-installs the chaos monkey, resumes the
  snapshot and carries on. In-flight requests replay token for token.
  Every transition is a ``recovery_*`` event; no crash reaches a client.
"""

from __future__ import annotations

import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable

from cs744_pytorch_distributed_tutorial_tpu_torch.serve.engine import Request
from cs744_pytorch_distributed_tutorial_tpu_torch.serve.loadgen import (
    _emit_summary,
    _summarize,
    warm_up,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.utils.failure import (
    DecodeNanError,
    EngineCrashError,
    HungStepError,
    ServeFailure,
    StepWatchdog,
    emit_event,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.utils.logging import get_logger

__all__ = [
    "GuardConfig",
    "ServeGuard",
    "run_serve_with_recovery",
    "ServeFailure",
    "DecodeNanError",
    "EngineCrashError",
    "HungStepError",
]


@dataclass
class GuardConfig:
    """Admission-control and SLO policy of a ``ServeGuard``; every knob
    defaults to off, so a default guard changes nothing."""

    # Default budgets; a request's own deadline_s / max_queue_s win.
    deadline_s: float | None = None
    max_queue_s: float | None = None
    # Bounded queue: submissions beyond this depth are shed. None = unbounded.
    max_queue_depth: int | None = None
    # "reject": over-bound submissions are rejected. "degrade": also trim
    # max_new_tokens to ``degrade_floor`` while the pool is under pressure.
    shed_policy: str = "reject"
    degrade_floor: int = 8
    # Pool pressure: free pages below this share of the allocatable pool.
    pressure_free_frac: float = 0.25

    def __post_init__(self) -> None:
        if self.shed_policy not in ("reject", "degrade"):
            raise ValueError(
                f'shed_policy must be "reject" or "degrade", got {self.shed_policy!r}'
            )
        if self.degrade_floor < 1:
            raise ValueError(f"degrade_floor must be >= 1, got {self.degrade_floor}")
        if not (0.0 <= self.pressure_free_frac <= 1.0):
            raise ValueError(
                f"pressure_free_frac must be in [0, 1], got {self.pressure_free_frac}"
            )


@dataclass
class ServeGuard:
    """Admission control and deadline enforcement over a
    ``ServingEngine(..., guard=ServeGuard(cfg))``: the engine calls
    ``admit`` from ``submit()`` and ``expire`` at the top of every
    ``step()``, both on host state and the engine's ``clock``.
    ``shed_counts`` counts sheds by reason (rejections and trims)."""

    cfg: GuardConfig = field(default_factory=GuardConfig)
    shed_counts: dict[str, int] = field(default_factory=dict)
    timed_out: int = 0

    def _count(self, reason: str) -> None:
        self.shed_counts[reason] = self.shed_counts.get(reason, 0) + 1

    def admit(self, engine: Any, req: Request) -> bool:
        """Admission control for one submission: False when the request
        was shed (``engine._shed_reject`` already ran); on True ``req`` may
        carry the default budgets or a trimmed ``max_new_tokens``."""
        if req.recovered:
            # A resumed request was admitted once already; shedding it now
            # would lose an admitted request. Its budgets came with it.
            return True
        cfg = self.cfg
        if req.deadline_s is None:
            req.deadline_s = cfg.deadline_s
        if req.max_queue_s is None:
            req.max_queue_s = cfg.max_queue_s
        if cfg.max_queue_depth is not None and len(engine._queue) >= cfg.max_queue_depth:
            self._count("queue_full")
            engine._shed_reject(req, "queue_full", queue_depth=len(engine._queue))
            return False
        if cfg.shed_policy == "degrade":
            pool = engine.pool
            pressured = pool.free_pages < cfg.pressure_free_frac * (pool.num_pages - 1)
            if pressured and req.max_new_tokens > cfg.degrade_floor:
                trimmed = int(req.max_new_tokens) - cfg.degrade_floor
                req.max_new_tokens = cfg.degrade_floor
                self._count("degrade_trim")
                engine._emit({"kind": "serve_shed", "time": time.time(), "id": req.req_id,
                              "reason": "degrade_trim", "terminal": False,
                              "tokens_shed": trimmed, "free_pages": pool.free_pages})
        return True

    def expire(self, engine: Any) -> None:
        """Sweep the queue and the slots against their budgets; each expiry
        ends ``timed_out``."""
        now = engine.clock()
        expired = [(r, self._expiry_reason(r, now, queued=True)) for r in engine._queue]
        for req, reason in expired:
            if reason is None:
                continue
            engine._queue.remove(req)
            self.timed_out += 1
            engine._expire_request(req, slot=None, reason=reason)
        for i, slot in enumerate(engine._slots):
            if slot is None:
                continue
            reason = self._expiry_reason(slot.req, now, queued=False)
            if reason is not None:
                self.timed_out += 1
                engine._expire_request(slot.req, slot=i, reason=reason)

    @staticmethod
    def _expiry_reason(req: Request, now: float, *, queued: bool) -> str | None:
        if (req.deadline_s is not None and req.arrival_time is not None
                and now - req.arrival_time > req.deadline_s):
            return "deadline"
        if (queued and req.max_queue_s is not None and req.first_token_time is None
                and now - req.submit_time > req.max_queue_s):
            return "queue_wait"
        return None


# Keys of ``ServingEngine.stats()`` that are not summed over engine
# generations: the latest generation's view, or the maximum.
_LATEST = ("slot_occupancy", "pages_allocatable", "paged_attention_impl", "decode_ms_per_step")
_MAX = ("page_high_water",)


def _merge_stats(total: dict[str, Any], part: dict[str, Any]) -> None:
    """Fold one engine generation's ``stats()`` into the running totals."""
    for k, v in part.items():
        if k in _MAX:
            total[k] = max(total.get(k, 0), v)
        elif k in _LATEST:
            total[k] = v
        else:
            total[k] = total.get(k, 0) + v


def run_serve_with_recovery(
    make_engine: Callable[[], Any],
    workload: Any,
    *,
    monkey: Any = None,
    max_restarts: int = 2,
    backoff_s: float = 0.0,
    backoff_factor: float = 2.0,
    max_backoff_s: float = 60.0,
    sleep: Callable[[float], None] = time.sleep,
    step_timeout_s: float | None = None,
    telemetry: Any = None,
    sink: Any = None,
    warmup: bool = True,
    label: str = "continuous",
) -> dict[str, Any]:
    """Drive a Poisson ``Workload`` with supervised engine recovery.

    Arrivals are submitted on the wall clock and the engine stepped; a
    ``ServeFailure`` climbs the restart ladder instead of reaching the
    client:

    1. a ``recovery_restart`` event and exponential backoff
       (``backoff_s * backoff_factor**(n-1)``, at most ``max_backoff_s``,
       through ``sleep``);
    2. ``snapshot()`` of the dead engine (valid after the failure: the
       engine raises before any per-step bookkeeping), its completed
       requests banked; the tracer seals its open spans;
    3. ``make_engine()``, the monkey re-installed (its counter spans
       restarts, so a fault that fired never fires again);
    4. ``resume()`` of the snapshot, and on with the workload.

    Past ``max_restarts``: a ``recovery_giveup`` event with the failure's
    traceback, and the failure is raised.

    ``step_timeout_s`` arms a ``StepWatchdog`` an engine with the ladder
    ``("warn", "dump", "abort")`` and the engine's flight recorder; a
    step that outlives the whole ladder is raised as ``HungStepError``
    when it returns. The first engine is warmed up off the clock
    (``loadgen.warm_up``, its request ids reset to 0) and the monkey
    installed after, so fault indices count measured decode steps; a
    replacement engine starts on the clock: that is the recovery's
    downtime.

    Returns the ``serve_summary`` record, aggregated over the engine
    generations with ``restarts``, emitted on ``sink`` with the bench
    twins ``run_poisson`` emits.
    """
    log = get_logger()
    engine = make_engine()
    if warmup:
        warm_up(engine, workload)
        engine._next_id = 0
    if monkey is not None:
        monkey.install(engine)

    def make_watchdog(eng: Any) -> tuple[Any, dict[str, bool]]:
        hung = {"flag": False}
        if step_timeout_s is None:
            return None, hung

        def on_hang(elapsed_s: float) -> None:
            hung["flag"] = True

        wd = StepWatchdog(step_timeout_s, on_hang=on_hang, escalation=("warn", "dump", "abort"),
                          flight_recorder=eng.make_flight_recorder())
        return wd, hung

    wd, hung = make_watchdog(engine)
    totals: dict[str, Any] = {}
    finished: list[Request] = []
    restarts = 0
    arrivals = workload.arrivals
    n, i = len(arrivals), 0
    t0 = engine.clock()
    try:
        while i < n or engine.busy:
            now = engine.clock() - t0
            while i < n and arrivals[i] <= now:
                engine.submit(Request(prompt=workload.prompts[i],
                                      max_new_tokens=int(workload.max_new_tokens[i]),
                                      arrival_time=t0 + float(arrivals[i])))
                i += 1
            if not engine.busy:
                if i < n:
                    time.sleep(min(0.001, max(0.0, float(arrivals[i]) - now)))
                continue
            try:
                if wd is not None:
                    with wd.watch():
                        engine.step()
                else:
                    engine.step()
                if hung["flag"]:
                    hung["flag"] = False
                    raise HungStepError(elapsed_s=step_timeout_s or 0.0)
            except ServeFailure as e:
                restarts += 1
                if restarts > max_restarts:
                    emit_event(telemetry, "recovery_giveup", restarts=restarts - 1,
                               failure=repr(e), traceback="".join(traceback.format_exception(e)))
                    log.critical("serve recovery giving up after %d restarts (last failure: "
                                 "%s)", restarts - 1, e)
                    raise
                delay = 0.0
                if backoff_s > 0:
                    delay = min(backoff_s * backoff_factor ** (restarts - 1), max_backoff_s)
                emit_event(telemetry, "recovery_restart", restart=restarts,
                           max_restarts=max_restarts, failure=repr(e), tier="engine",
                           backoff_s=delay)
                log.error("serve failure (%s); engine restart %d/%d (backoff %.1fs)", e,
                          restarts, max_restarts, delay)
                snap = engine.snapshot()
                if engine.tracer is not None:
                    # The tracer outlives the engine: seal its open spans at
                    # the crash so the next engine's spans never overlap them.
                    engine.tracer.on_crash(engine.clock())
                finished.extend(engine._completed)
                _merge_stats(totals, engine.stats())
                if wd is not None:
                    wd.close()
                if delay > 0:
                    sleep(delay)
                engine = make_engine()
                if monkey is not None:
                    monkey.install(engine)
                engine.resume(snap)
                wd, hung = make_watchdog(engine)
    finally:
        if wd is not None:
            wd.close()
    if restarts:
        emit_event(telemetry, "recovery_complete", restarts=restarts)
    engine.finalize_trace()
    reqs = finished + list(engine._completed)
    _merge_stats(totals, engine.stats())
    totals["requests_done"] = len(reqs)
    totals["restarts"] = restarts
    # Every submitted request resolved exactly once.
    ids = sorted(r.req_id for r in reqs)
    if ids != sorted(set(ids)):
        raise RuntimeError(f"requests resolved more than once: "
                           f"{sorted({x for x in ids if ids.count(x) > 1})}")
    unresolved = [r.req_id for r in reqs if r.terminal_status is None]
    if unresolved:
        raise RuntimeError(f"requests ended unresolved: {unresolved}")
    if len(ids) != n:
        raise RuntimeError(f"submitted {n} requests but only {len(ids)} resolved")
    makespan = max((r.done_time for r in reqs if r.done_time is not None), default=t0) - t0
    record = _summarize(label, reqs, makespan, totals)
    _emit_summary(sink, record)
    return record
