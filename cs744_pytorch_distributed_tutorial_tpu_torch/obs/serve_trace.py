"""Request-level tracing and windowed SLO telemetry for ``serve/`` (the
JAX package's ``obs/serve_trace.py``).

The engine's end-of-request records say what a request's TTFT was; this
module records why. Three layers, all bookkeeping on the host over clock
stamps the engine already takes (no device work, no extra sync):

- **Span timeline** (``ServeTracer``): each request's lifecycle as closed
  spans: ``queue`` -> ``prefill`` (``recompute`` after a LIFO preemption,
  ``resume-replay`` after a kill and resume) -> coalesced ``decode_run``
  spans (one a residency in a slot, not one a token) -> ``retire``, with
  ``preempt`` instants between and ``shed`` for a request rejected at
  admission. Exported as Chrome/Perfetto trace-event JSON: a lane a
  decode slot, an async lane for queue waits, counter tracks for the
  pool. ``check_spans`` is the consistency gate (no orphan, unclosed or
  overlapping spans) and ``reconcile`` holds the span arithmetic against
  the engine's recorded TTFT and token streams.
- **Windowed SLO tracker**: ``kind:"serve_window"`` records at a set
  cadence: rolling TTFT/ITL p50/p99 over ring reservoirs, queue depth,
  preemption rate, slot occupancy, prefill counts a bucket and the pool's
  counters. The ITL reservoir is fed the surfaced-token gaps that
  ``loadgen._summarize`` diffs, so the windows and the summary agree.
- **Device attribution** (``profile_serve_programs``): device time
  (``obs/phases.py::capture_device_profile``), FLOPs and bytes
  (``segment_costs``, the hand-written kernels' own reports included) and
  the roofline class of the decode step and of every prefill bucket the
  run used, plus ``decode_host_exposed_ms``: the mean host wall of a live
  decode step less the profiled device time, what the host scheduler
  costs the decode loop.

The engine hands the tracer the same floats it stamps into
``first_token_time`` and ``token_times``, so queue + prefill spans sum to
the recorded TTFT exactly. The record kinds, their fields and the file
names are the JAX package's: ``benchmarks/metrics_summary.py`` reads them.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Any

import numpy as np
import torch

__all__ = [
    "PREFILL_KINDS",
    "ServeTracer",
    "check_spans",
    "reconcile",
    "load_trace_dir",
    "render_serve_report",
    "profile_serve_programs",
]

# Admission span kinds: how a request's KV got (re)built in its slot.
PREFILL_KINDS = frozenset({"prefill", "recompute", "resume-replay"})
_INTERVAL_KINDS = PREFILL_KINDS | {"queue", "decode_run"}
# "shed" is terminal like "retire", but for a request REJECTED at
# admission control (serve/guard.py) — it never queued, so its whole
# lifecycle is the one instant. "retire" instants carry a ``status``
# field when the disposition is not "completed" (e.g. "timed_out").
_INSTANT_KINDS = frozenset({"preempt", "retire", "shed"})

TRACE_NAME = "serve_trace.json"
SPANS_NAME = "serve_spans.jsonl"
WINDOWS_NAME = "serve_windows.jsonl"
REQUESTS_NAME = "serve_requests.jsonl"


def _pct(values: Any, q: float) -> float | None:
    vals = np.asarray(list(values), dtype=np.float64)
    return round(float(np.percentile(vals, q)), 3) if vals.size else None


class ServeTracer:
    """Span and SLO-window recorder on the host for one :class:`ServingEngine`.

    The engine calls the ``on_*`` hooks with its own clock stamps; the
    tracer never reads a clock of its own for span endpoints, so spans
    and the engine's latency bookkeeping share the exact same floats.
    ``reset()`` (called by ``run_poisson`` after warmup) drops warmup
    spans so the exported timeline covers only the measured run.

    ``window_every_s`` arms the SLO tracker: ``on_decode_step`` returns
    a flat ``kind:"serve_window"`` record once per cadence interval
    (the engine emits it through its sink); ``flush_window`` emits the
    final partial window at drain. TTFT/ITL percentiles are rolling
    over ``window_capacity``-deep ring reservoirs.
    """

    def __init__(
        self,
        num_slots: int,
        *,
        window_every_s: float | None = None,
        window_capacity: int = 4096,
    ) -> None:
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if window_every_s is not None and window_every_s <= 0:
            raise ValueError(
                f"window_every_s must be > 0, got {window_every_s}"
            )
        if window_capacity < 1:
            raise ValueError(
                f"window_capacity must be >= 1, got {window_capacity}"
            )
        self.num_slots = int(num_slots)
        self.window_every_s = window_every_s
        self.window_capacity = int(window_capacity)
        self.reset()

    def reset(self, now: float | None = None) -> None:
        """Drop all recorded state; ``now`` (engine clock) restarts the
        window origin so ``t_s`` counts from the measured run's start."""
        self.spans: list[dict[str, Any]] = []
        self.windows: list[dict[str, Any]] = []
        self.requests: list[dict[str, Any]] = []
        self._open_queue: dict[int, dict[str, Any]] = {}
        self._open_run: dict[int, dict[str, Any]] = {}
        self._t0: float | None = now
        self._last_flush: float | None = now
        self._ttft: deque[float] = deque(maxlen=self.window_capacity)
        self._itl: deque[float] = deque(maxlen=self.window_capacity)
        # (t, live_pages, free_pages, active_slots, queue_depth) at
        # decode-step cadence — the Perfetto counter tracks.
        self._pool_series: deque[tuple] = deque(maxlen=65536)
        self._last_pool: dict[str, Any] = {}
        self._churn_base: int | None = None
        self._trash_base: int | None = None
        self._reset_window_counters()

    def _reset_window_counters(self) -> None:
        self._tokens_w = 0
        self._done_w = 0
        self._preempt_w = 0
        self._steps_w = 0
        self._occ_w = 0
        self._queue_max_w = 0
        self._timeout_w = 0
        self._shed_w = 0
        self._prefill_w: dict[int, int] = {}

    def _seen(self, t: float) -> None:
        if self._t0 is None or t < self._t0:
            self._t0 = float(t)
        if self._last_flush is None:
            self._last_flush = float(t)

    # ------------------------------------------------------ engine hooks

    def on_submit(self, req: Any, now: float) -> None:
        """External submission: open the queue span at the request's
        arrival stamp. A resumed request's preserved ``arrival_time``
        belongs to the dead process's clock epoch, so its queue span
        restarts at the resubmission instant instead."""
        self._seen(float(now))
        if getattr(req, "recovered", False) or req.arrival_time is None:
            t0 = float(now)
        else:
            t0 = min(float(req.arrival_time), float(now))
        self._seen(t0)
        self._open_queue[req.req_id] = {
            "name": "queue", "req": int(req.req_id), "slot": None,
            "t0": t0, "t1": None,
        }

    def on_requeue(self, req: Any, now: float) -> None:
        """Preemption re-queue: a fresh queue span from the preempt
        instant until the recompute admission."""
        self._seen(float(now))
        self._open_queue[req.req_id] = {
            "name": "queue", "req": int(req.req_id), "slot": None,
            "t0": float(now), "t1": None,
        }

    def on_admit(
        self,
        req: Any,
        *,
        slot: int,
        bucket: int,
        t0: float,
        t1: float,
        kind: str,
        replayed: int = 0,
    ) -> None:
        """Admission prefill ran in ``[t0, t1]``; close the queue span
        at ``t0`` (the same float, so queue+prefill tile exactly)."""
        self._seen(float(t0))
        q = self._open_queue.pop(req.req_id, None)
        if q is not None:
            q["t1"] = float(t0)
            self.spans.append(q)
        span = {
            "name": kind, "req": int(req.req_id), "slot": int(slot),
            "bucket": int(bucket), "t0": float(t0), "t1": float(t1),
        }
        if replayed:
            span["replayed"] = int(replayed)
        self.spans.append(span)
        self._prefill_w[int(bucket)] = self._prefill_w.get(int(bucket), 0) + 1
        self._tokens_w += 1  # prefill surfaces the first token

    def _close_run(self, slot: int) -> None:
        run = self._open_run.pop(slot, None)
        if run is not None:
            self.spans.append(run)

    def on_decode_step(
        self,
        t0: float,
        t1: float,
        slot_reqs: dict[int, int],
        pool: dict[str, Any],
        queue_depth: int,
    ) -> dict[str, Any] | None:
        """One fixed-shape decode step over ``slot_reqs`` (slot ->
        req_id) ran in ``[t0, t1]``. Extends each slot's coalesced
        ``decode_run`` span, samples the pool counter series, and
        returns a ``serve_window`` record when the cadence elapsed."""
        self._seen(float(t0))
        for slot, rid in slot_reqs.items():
            run = self._open_run.get(slot)
            if run is None or run["req"] != rid:
                self._close_run(slot)  # missed retire — defensive close
                run = {
                    "name": "decode_run", "req": int(rid), "slot": int(slot),
                    "t0": float(t0), "t1": float(t1), "tokens": 0,
                }
                self._open_run[slot] = run
            run["t1"] = float(t1)
            run["tokens"] += 1
        self._steps_w += 1
        self._occ_w += len(slot_reqs)
        self._tokens_w += len(slot_reqs)
        self._queue_max_w = max(self._queue_max_w, int(queue_depth))
        if self._churn_base is None:
            self._churn_base = int(pool.get("churn", 0))
            self._trash_base = int(pool.get("trash", 0))
        self._last_pool = dict(pool)
        self._pool_series.append((
            float(t1), int(pool.get("live", 0)), int(pool.get("free", 0)),
            len(slot_reqs), int(queue_depth),
        ))
        if self.window_every_s is None or self._last_flush is None:
            return None
        if (float(t1) - self._last_flush) < self.window_every_s:
            return None
        return self.flush_window(float(t1), queue_depth=int(queue_depth))

    def on_preempt(self, req: Any, slot: int, now: float, replayed: int) -> None:
        self._seen(float(now))
        self._close_run(slot)
        self.spans.append({
            "name": "preempt", "req": int(req.req_id), "slot": int(slot),
            "t0": float(now), "t1": float(now), "replayed": int(replayed),
        })
        self._preempt_w += 1

    def on_crash(self, now: float) -> None:
        """Engine death under supervised recovery (serve/guard.py):
        seal every open span at the crash instant. The tracer outlives
        the engine generation, so without this the next generation's
        first decode step would extend the dead slots' open runs to
        post-resume timestamps, overlapping the resumed requests' new
        queue spans."""
        self._seen(float(now))
        for slot in sorted(self._open_run):
            self._close_run(slot)  # t1 already stamped at the last step
        for q in self._open_queue.values():
            q["t1"] = float(now)
            self.spans.append(q)
        self._open_queue.clear()

    def on_shed(self, req: Any, now: float, reason: str) -> None:
        """Terminal rejection at admission control (serve/guard.py):
        the request never queued, so its whole lifecycle is this one
        ``shed`` instant."""
        self._seen(float(now))
        self.spans.append({
            "name": "shed", "req": int(req.req_id), "slot": None,
            "t0": float(now), "t1": float(now), "reason": str(reason),
        })
        self._shed_w += 1
        self.requests.append({
            "req": int(req.req_id),
            "status": "rejected",
            "reason": str(reason),
            "tokens": 0,
            "preemptions": 0,
            "recovered": False,
        })

    def on_retire(self, req: Any, slot: int | None, now: float) -> None:
        self._seen(float(now))
        if slot is not None:
            self._close_run(slot)
        q = self._open_queue.pop(req.req_id, None)
        if q is not None:  # finished while queued (budget spent at preempt)
            q["t1"] = float(now)
            self.spans.append(q)
        retire_span: dict[str, Any] = {
            "name": "retire", "req": int(req.req_id),
            "slot": None if slot is None else int(slot),
            "t0": float(now), "t1": float(now),
        }
        status = getattr(req, "status", None)
        if status not in (None, "completed"):
            retire_span["status"] = status
        if status == "timed_out":
            self._timeout_w += 1
        self.spans.append(retire_span)
        self._done_w += 1
        rec: dict[str, Any] = {
            "req": int(req.req_id),
            "tokens": int(req.output_tokens),
            "preemptions": int(req.preemptions),
            "recovered": bool(getattr(req, "recovered", False)),
        }
        if status not in (None, "completed"):
            rec["status"] = status
        if req.first_token_time is not None and req.arrival_time is not None:
            rec["ttft_ms"] = (req.first_token_time - req.arrival_time) * 1e3
        if len(req.token_times) > 1:
            rec["stream_ms"] = (
                req.token_times[-1] - req.token_times[0]
            ) * 1e3
        self.requests.append(rec)

    def sample_ttft(self, ms: float, now: float) -> None:
        self._seen(float(now))
        self._ttft.append(float(ms))

    def sample_itl(self, ms: float, now: float) -> None:
        self._seen(float(now))
        self._itl.append(float(ms))

    # ------------------------------------------------------ SLO windows

    def flush_window(
        self, now: float, *, queue_depth: int = 0
    ) -> dict[str, Any] | None:
        """Emit one flat ``serve_window`` record covering everything
        since the previous flush (rolling percentiles over the full
        reservoirs; counters are per-window). Returns None before any
        recorded activity."""
        if self._t0 is None:
            return None
        if self._last_flush is None:
            self._last_flush = self._t0
        width = max(1e-9, float(now) - self._last_flush)
        pool = self._last_pool
        churn = int(pool.get("churn", self._churn_base or 0))
        trash = int(pool.get("trash", self._trash_base or 0))
        rec: dict[str, Any] = {
            "kind": "serve_window",
            "time": time.time(),
            "t_s": round(float(now) - self._t0, 4),
            "window_s": round(width, 4),
            "ttft_p50_ms": _pct(self._ttft, 50),
            "ttft_p99_ms": _pct(self._ttft, 99),
            "itl_p50_ms": _pct(self._itl, 50),
            "itl_p99_ms": _pct(self._itl, 99),
            "ttft_samples": len(self._ttft),
            "itl_samples": len(self._itl),
            "tokens": self._tokens_w,
            "requests_done": self._done_w,
            "decode_steps": self._steps_w,
            "preemptions": self._preempt_w,
            "preempt_rate_per_s": round(self._preempt_w / width, 3),
            "timed_out": self._timeout_w,
            "shed": self._shed_w,
            "queue_depth": int(queue_depth),
            "queue_depth_max": self._queue_max_w,
            "slot_occupancy": round(
                self._occ_w / (self._steps_w * self.num_slots), 4
            ) if self._steps_w else 0.0,
            "live_pages": int(pool.get("live", 0)),
            "free_pages": int(pool.get("free", 0)),
            "page_high_water": int(pool.get("high_water", 0)),
            "page_churn": churn - (self._churn_base or 0),
            "trash_rows": trash - (self._trash_base or 0),
        }
        for bucket, count in sorted(self._prefill_w.items()):
            rec[f"prefill_bucket_{bucket}"] = count
        self.windows.append(rec)
        self._last_flush = float(now)
        self._churn_base = churn
        self._trash_base = trash
        self._reset_window_counters()
        return rec

    # ---------------------------------------------------------- export

    def all_spans(self) -> list[dict[str, Any]]:
        """Closed spans plus a snapshot of still-open decode runs (their
        ``t1`` tracks the latest step end, so they export valid)."""
        return self.spans + [dict(r) for r in self._open_run.values()]

    def to_chrome_trace(self) -> dict[str, Any]:
        """Chrome trace-event JSON (Perfetto-loadable): pid 1 is the
        engine; tid 0 carries the queue's async spans plus the pool
        counter tracks, tids 1..num_slots are the decode-slot lanes."""
        spans = self.all_spans()
        times = [s["t0"] for s in spans] + [t for t, *_ in self._pool_series]
        origin = min(times) if times else 0.0

        def us(t: float) -> float:
            return round((t - origin) * 1e6, 3)

        events: list[dict[str, Any]] = [
            {"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
             "args": {"name": "graftserve"}},
            {"ph": "M", "pid": 1, "tid": 0, "name": "thread_name",
             "args": {"name": "queue"}},
        ]
        for s in range(self.num_slots):
            events.append({
                "ph": "M", "pid": 1, "tid": s + 1, "name": "thread_name",
                "args": {"name": f"slot {s}"},
            })
        for sp in spans:
            name = sp["name"]
            if name == "queue":
                # Async (b/e) events: queue waits overlap arbitrarily,
                # which a single lane of X events cannot render.
                events.append({
                    "ph": "b", "cat": "queue", "id": sp["req"], "pid": 1,
                    "tid": 0, "name": "queue", "ts": us(sp["t0"]),
                    "args": {"req": sp["req"]},
                })
                if sp["t1"] is not None:
                    events.append({
                        "ph": "e", "cat": "queue", "id": sp["req"],
                        "pid": 1, "tid": 0, "name": "queue",
                        "ts": us(sp["t1"]),
                    })
            elif name in _INSTANT_KINDS:
                tid = 0 if sp.get("slot") is None else sp["slot"] + 1
                events.append({
                    "ph": "i", "s": "t", "pid": 1, "tid": tid,
                    "name": f"{name} r{sp['req']}", "ts": us(sp["t0"]),
                    "args": {"req": sp["req"]},
                })
            else:
                label = (
                    "decode_run" if name == "decode_run"
                    else f"{name}[bucket={sp.get('bucket')}]"
                )
                args = {
                    k: sp[k]
                    for k in ("req", "bucket", "tokens", "replayed")
                    if sp.get(k) is not None
                }
                events.append({
                    "ph": "X", "pid": 1, "tid": sp["slot"] + 1,
                    "name": label, "ts": us(sp["t0"]),
                    "dur": max(0.001, round((sp["t1"] - sp["t0"]) * 1e6, 3)),
                    "args": args,
                })
        for t, live, free, active, depth in self._pool_series:
            events.append({
                "ph": "C", "pid": 1, "tid": 0, "name": "kv_pages",
                "ts": us(t), "args": {"live": live, "free": free},
            })
            events.append({
                "ph": "C", "pid": 1, "tid": 0, "name": "slots_active",
                "ts": us(t), "args": {"active": active},
            })
            events.append({
                "ph": "C", "pid": 1, "tid": 0, "name": "queue_depth",
                "ts": us(t), "args": {"depth": depth},
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write(self, trace_dir: str) -> dict[str, str]:
        """Write the trace artifacts; returns name -> path."""
        os.makedirs(trace_dir, exist_ok=True)
        paths = {
            "trace": os.path.join(trace_dir, TRACE_NAME),
            "spans": os.path.join(trace_dir, SPANS_NAME),
            "windows": os.path.join(trace_dir, WINDOWS_NAME),
            "requests": os.path.join(trace_dir, REQUESTS_NAME),
        }
        with open(paths["trace"], "w", encoding="utf-8") as f:
            json.dump(self.to_chrome_trace(), f)
        for key, rows in (
            ("spans", self.all_spans()),
            ("windows", self.windows),
            ("requests", self.requests),
        ):
            with open(paths[key], "w", encoding="utf-8") as f:
                for row in rows:
                    f.write(json.dumps(row) + "\n")
        return paths


# ---------------------------------------------------------------------------
# Consistency checks — the CI gate over a written trace
# ---------------------------------------------------------------------------


def check_spans(
    spans: list[dict[str, Any]], *, require_retired: bool = True
) -> list[str]:
    """Structural audit of a span list; returns human-readable problem
    strings (empty = consistent). Checks: every span closed and
    well-ordered, per-request interval spans never overlap, lifecycles
    start with a queue span, every admission span follows a queue span,
    exactly one retire per request (none extends past it), and — with
    ``require_retired`` — no orphans (requests that never retired)."""
    problems: list[str] = []
    by_req: dict[int, list[dict[str, Any]]] = {}
    for sp in spans:
        by_req.setdefault(sp.get("req"), []).append(sp)
    for rid in sorted(by_req, key=lambda r: (r is None, r)):
        sps = by_req[rid]
        for sp in sps:
            if sp.get("t1") is None:
                problems.append(f"req {rid}: unclosed {sp['name']} span")
            elif sp["t1"] < sp["t0"] - 1e-9:
                problems.append(
                    f"req {rid}: {sp['name']} span ends before it starts"
                )
        closed = sorted(
            (s for s in sps
             if s["name"] in _INTERVAL_KINDS and s.get("t1") is not None),
            key=lambda s: (s["t0"], s["t1"]),
        )
        for a, b in zip(closed, closed[1:]):
            if b["t0"] < a["t1"] - 1e-6:
                problems.append(
                    f"req {rid}: {a['name']} and {b['name']} spans overlap"
                )
        if closed and closed[0]["name"] != "queue":
            problems.append(
                f"req {rid}: lifecycle starts with {closed[0]['name']}, "
                "expected queue"
            )
        for i, sp in enumerate(closed):
            if sp["name"] in PREFILL_KINDS and (
                i == 0 or closed[i - 1]["name"] != "queue"
            ):
                problems.append(
                    f"req {rid}: {sp['name']} not preceded by a queue span"
                )
        retires = [s for s in sps if s["name"] == "retire"]
        sheds = [s for s in sps if s["name"] == "shed"]
        if len(retires) > 1:
            problems.append(f"req {rid}: {len(retires)} retire instants")
        if sheds and (retires or closed):
            # Shed happens at admission control, before the request ever
            # queues — a shed lifecycle is exactly one instant.
            problems.append(
                f"req {rid}: shed request has other lifecycle spans"
            )
        if not retires:
            if require_retired and not sheds:
                problems.append(f"req {rid}: never retired (orphan spans)")
        else:
            if closed:
                last_end = max(s["t1"] for s in closed)
                if retires[0]["t0"] < last_end - 1e-6:
                    problems.append(
                        f"req {rid}: spans extend past the retire instant"
                    )
            if (
                not any(s["name"] in PREFILL_KINDS for s in closed)
                and retires[0].get("status") != "timed_out"
            ):
                # A queued-expiry retire legitimately has only a closed
                # queue span: the request never reached a slot.
                problems.append(
                    f"req {rid}: retired without an admission span"
                )
    return problems


def reconcile(
    spans: list[dict[str, Any]],
    requests: list[dict[str, Any]],
    *,
    tol_ms: float = 1.0,
) -> list[str]:
    """Cross-check span arithmetic against the engine-recorded latency
    numbers: per request, (first admission end - first queue start) must
    equal the recorded TTFT, and the post-first-token spans must fit
    inside the recorded token stream. Recovered requests are skipped —
    their preserved stamps belong to the dead process's clock epoch."""
    problems: list[str] = []
    by_req: dict[int, list[dict[str, Any]]] = {}
    for sp in spans:
        if sp["name"] in _INTERVAL_KINDS and sp.get("t1") is not None:
            by_req.setdefault(sp["req"], []).append(sp)
    for rec in requests:
        if rec.get("recovered"):
            continue
        if rec.get("status") in ("rejected", "timed_out"):
            # Shed at admission (no spans at all) or expired before the
            # first token (no admission span / no TTFT) — nothing to
            # reconcile against.
            continue
        rid = rec["req"]
        sps = sorted(by_req.get(rid, []), key=lambda s: s["t0"])
        queues = [s for s in sps if s["name"] == "queue"]
        admits = [s for s in sps if s["name"] in PREFILL_KINDS]
        if not queues or not admits:
            problems.append(f"req {rid}: no queue/admission span to reconcile")
            continue
        ttft = rec.get("ttft_ms")
        if ttft is not None:
            span_ttft = (admits[0]["t1"] - queues[0]["t0"]) * 1e3
            if abs(span_ttft - ttft) > tol_ms:
                problems.append(
                    f"req {rid}: queue+prefill spans sum to "
                    f"{span_ttft:.3f} ms but recorded TTFT is "
                    f"{ttft:.3f} ms"
                )
        stream = rec.get("stream_ms")
        if stream is not None:
            first_end = admits[0]["t1"]
            covered = sum(
                (s["t1"] - max(s["t0"], first_end)) * 1e3
                for s in sps
                if s["t1"] > first_end
            )
            if covered > stream + tol_ms:
                problems.append(
                    f"req {rid}: {covered:.3f} ms of post-first-token "
                    f"spans exceed the {stream:.3f} ms token stream"
                )
    return problems


# ---------------------------------------------------------------------------
# Trace-dir loading + report rendering (obs __main__ serve-report)
# ---------------------------------------------------------------------------


def _load_jsonl(path: str) -> list[dict[str, Any]]:
    rows: list[dict[str, Any]] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(row, dict):
                rows.append(row)
    return rows


def load_trace_dir(path: str) -> dict[str, list[dict[str, Any]]]:
    """Load a serve trace dir (or a bare spans JSONL) into
    ``{"spans": [...], "windows": [...], "requests": [...]}``."""
    if os.path.isdir(path):
        out = {}
        for key, name in (
            ("spans", SPANS_NAME),
            ("windows", WINDOWS_NAME),
            ("requests", REQUESTS_NAME),
        ):
            p = os.path.join(path, name)
            out[key] = _load_jsonl(p) if os.path.exists(p) else []
        if not out["spans"]:
            raise FileNotFoundError(f"{path}: no {SPANS_NAME}")
        return out
    return {"spans": _load_jsonl(path), "windows": [], "requests": []}


def render_serve_report(data: dict[str, list[dict[str, Any]]]) -> str:
    """One-screen text summary of a loaded trace dir."""
    spans = data.get("spans", [])
    windows = data.get("windows", [])
    requests = data.get("requests", [])
    counts: dict[str, int] = {}
    for sp in spans:
        counts[sp.get("name", "?")] = counts.get(sp.get("name", "?"), 0) + 1
    rows = [
        ("spans", str(len(spans))),
        ("span kinds", ", ".join(
            f"{k}={v}" for k, v in sorted(counts.items())
        ) or "-"),
        ("requests", str(len({s.get("req") for s in spans}))),
        ("retired", str(counts.get("retire", 0))),
        ("shed", str(counts.get("shed", 0))),
        ("timed out", str(sum(
            1 for r in requests if r.get("status") == "timed_out"
        ))),
        ("recovered", str(sum(1 for r in requests if r.get("recovered")))),
        ("windows", str(len(windows))),
    ]
    if windows:
        last = windows[-1]
        rows.append(("ttft p99 (last window)",
                     f"{last.get('ttft_p99_ms')} ms"))
        rows.append(("itl p99 (last window)",
                     f"{last.get('itl_p99_ms')} ms"))
        rows.append(("live pages (peak)", str(max(
            (w.get("live_pages", 0) for w in windows), default=0
        ))))
        rows.append(("queue depth (max)", str(max(
            (w.get("queue_depth_max", 0) for w in windows), default=0
        ))))
    width = max(len(name) for name, _ in rows)
    return "\n".join(f"{name:<{width}}  {val}" for name, val in rows)


# ---------------------------------------------------------------------------
# Device attribution of the engine's programs
# ---------------------------------------------------------------------------


def _profile_table(b: int, p: int, num_pages: int) -> np.ndarray:
    """A page table whose rows each hold ``p`` allocatable pages (slots
    may share pages: the profile reads them, it does not care whose)."""
    return (1 + np.arange(b * p) % (num_pages - 1)).reshape(b, p).astype(np.int32)


def profile_serve_programs(engine: Any, *, iters: int = 3) -> list[dict[str, Any]]:
    """Device time, FLOPs and bytes, and roofline class of the engine's
    decode step and of every prompt bucket it prefilled.

    Run after the serving run. The programs write the page pools in
    place, so each runs on clones swapped into the engine and the live
    pools are put back after. The profiled calls go to the engine's
    ``_decode_step``/``_prefill_step`` directly: they never pass the chaos
    monkey's wrapper of ``_decode`` (no fault fires, its counter does not
    move) and do not count in ``decode_steps_all``/``prefills_all``; the
    engine counts them in ``profiled_decode_steps``/``profiled_prefills``.

    The decode step runs with every slot active at the run's mean live
    depth (1 before any step), each slot's table row full of pages; the
    prefills at the bucket's length (at most ``max_seq_len - 1``) onto
    trash page 0. Returns ``kind:"serve_phase"`` records (one a program)
    and one ``kind:"serve_phase_summary"`` with ``decode_step_ms``,
    ``decode_host_ms`` (the engine's mean host wall a live decode step),
    ``decode_host_exposed_ms`` (that less the profiled step) and the
    profiler's own calls so far (``profiled_decode_steps``,
    ``profiled_prefills``).
    """
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.transformer import KVCache

    from .phases import capture_device_profile, roofline_classify, segment_costs

    cfg = engine.cfg
    b, p, ps = cfg.num_slots, cfg.max_pages_per_slot, cfg.page_size
    dev = engine.device
    device_kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else None
    steps = engine._active_slot_steps
    depth = max(1, round(engine._active_depth_sum / steps)) if steps else 1
    depth = min(depth, p * ps - 1, engine.max_seq_len - 1)
    dec_args = (np.zeros((b,), np.int32), np.full((b,), depth, np.int32),
                np.ones((b,), np.int32), np.arange(b, dtype=np.int32),
                np.zeros((b,), np.int32), _profile_table(b, p, cfg.num_pages))

    def decode():
        engine.profiled_decode_steps += 1
        return engine._decode_step(*dec_args)

    def record(phase: str, fn, **extra) -> tuple[dict[str, Any], Any]:
        prof = capture_device_profile(fn, iters=iters)
        costs = segment_costs(fn)
        return {
            "kind": "serve_phase", "time": time.time(), "phase": phase,
            "impl": engine.paged_attention_impl, **extra, "clock": prof.clock,
            "device_ms": round(prof.device_ms, 4), "wall_ms": round(prof.wall_ms, 4),
            "flops": costs["flops"], "bytes_accessed": costs["bytes_accessed"],
            "roofline": roofline_classify(costs["flops"], costs["bytes_accessed"], device_kind),
            "iters": iters,
        }, prof

    live = engine._pages
    engine._pages = [KVCache(*(None if t is None else t.clone() for t in
                               (c.key, c.value, c.key_scale, c.value_scale))) for c in live]
    try:
        rec, prof = record("decode", decode, depth=depth)
        records = [rec]
        decode_ms = prof.best_ms()
        for bucket in sorted(engine._buckets):
            plen = min(bucket, engine.max_seq_len - 1)
            prompt = np.ones((1, bucket), np.int64)
            row = np.zeros((p,), np.int32)

            def prefill(prompt=prompt, plen=plen, row=row):
                engine.profiled_prefills += 1
                return engine._prefill_step(prompt, plen, 0, 0, row)

            records.append(record(f"prefill[bucket={bucket}]", prefill, bucket=bucket)[0])
    finally:
        engine._pages = live
    walls = [float(w) for w in engine._decode_walls]
    summary: dict[str, Any] = {
        "kind": "serve_phase_summary", "time": time.time(),
        "impl": engine.paged_attention_impl, "decode_step_ms": round(decode_ms, 4),
        "decode_clock": prof.clock, "decode_steps_observed": len(walls),
        "profiled_decode_steps": engine.profiled_decode_steps,
        "profiled_prefills": engine.profiled_prefills,
    }
    if walls:
        mean_wall_ms = sum(walls) / len(walls) * 1e3
        summary["decode_host_ms"] = round(mean_wall_ms, 4)
        summary["decode_host_exposed_ms"] = round(max(0.0, mean_wall_ms - decode_ms), 4)
    records.append(summary)
    return records
