"""Poisson load generation and the batch-at-a-time baseline.

Port of the JAX package's ``serve/loadgen.py``. ``make_poisson_workload``
draws a seeded open-loop trace with numpy's ``default_rng`` (the same
arrays as the JAX package's for the same arguments); ``run_poisson``
replays it against a ``ServingEngine`` on the wall clock after a warm-up
pass and reports:

- TTFT: first token's arrival on the host minus the request's scheduled
  arrival (queue time included);
- per-token decode latency: (done - first token) / (output - 1);
- ITL: the gaps between a request's consecutive surfaced tokens;
- tokens/s: total output tokens over the makespan (first arrival to
  last completion);
- terminal statuses: completed, rejected, timed out and recovered
  (``serve/guard.py``), each request in exactly one.

``run_batch_baseline`` replays the same trace through ``make_generator``
a batch at a time: arrival-order batches, prompts right-padded to the
batch's longest, the batch's longest budget decoded, nothing streamed
early (a request's TTFT is its batch's return). Both emit a
``kind:"serve_summary"`` record through the sink.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.serve.engine import Request, ServingEngine


@dataclass
class Workload:
    """A materialized open-loop trace (seeded, replayable)."""

    arrivals: np.ndarray  # [N] seconds from the trace's start, sorted
    prompts: list[np.ndarray]  # [N] int32 token vectors
    max_new_tokens: np.ndarray  # [N] int32

    def __len__(self) -> int:
        return len(self.prompts)


def make_poisson_workload(*, num_requests: int, rate_rps: float, prompt_len: tuple[int, int],
                          output_len: tuple[int, int], vocab_size: int,
                          seed: int = 0) -> Workload:
    """Poisson arrivals at ``rate_rps``, prompt and output lengths uniform
    in the given inclusive ranges, token ids in [1, vocab) (0 is the pad
    id)."""
    if num_requests < 1:
        raise ValueError(f"num_requests must be >= 1, got {num_requests}")
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_rps, size=num_requests)
    gaps[0] = 0.0  # the first request arrives at t = 0
    arrivals = np.cumsum(gaps)
    plens = rng.integers(prompt_len[0], prompt_len[1] + 1, num_requests)
    olens = rng.integers(output_len[0], output_len[1] + 1, num_requests)
    prompts = [rng.integers(1, vocab_size, size=int(n)).astype(np.int32) for n in plens]
    return Workload(arrivals=arrivals, prompts=prompts, max_new_tokens=olens.astype(np.int32))


def _percentile(values: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(values), q)) if values else 0.0


def _summarize(label: str, reqs: list[Request], makespan: float,
               extra: dict[str, Any]) -> dict[str, Any]:
    # Every request that left the system lands in one terminal bucket.
    # Latencies are over the requests that delivered (completed or
    # recovered): a rejected one has none, and a timed-out one's cut
    # stream would flatter the tail.
    statuses = {"completed": 0, "rejected": 0, "timed_out": 0, "recovered": 0}
    for r in reqs:
        if r.terminal_status in statuses:
            statuses[r.terminal_status] += 1
    delivered = [r for r in reqs if r.terminal_status in ("completed", "recovered")
                 and r.first_token_time is not None]
    ttfts = [(r.first_token_time - r.arrival_time) * 1e3 for r in delivered]
    per_tok = [(r.done_time - r.first_token_time) * 1e3 / max(1, r.output_tokens - 1)
               for r in delivered]
    itls: list[float] = []
    for r in delivered:
        if len(r.token_times) > 1:
            diffs = np.diff(np.asarray(r.token_times))
            # The gap across a resume boundary spans the kill (two clock
            # epochs), not an inter-token latency: left out. Every other
            # gap, preemption stalls included, counts.
            skip = {b - 1 for b in r.resume_boundaries if 1 <= b <= len(diffs)}
            itls.extend(float(d) * 1e3 for i, d in enumerate(diffs) if i not in skip)
    total_tokens = sum(r.output_tokens for r in reqs)
    return {
        "kind": "serve_summary",
        "time": time.time(),
        "engine": label,
        "requests": len(reqs),
        "total_output_tokens": int(total_tokens),
        "makespan_s": round(makespan, 4),
        "ttft_p50_ms": round(_percentile(ttfts, 50), 3),
        "ttft_p99_ms": round(_percentile(ttfts, 99), 3),
        "decode_ms_per_token_p50": round(_percentile(per_tok, 50), 4),
        "itl_p50_ms": round(_percentile(itls, 50), 4),
        "itl_p99_ms": round(_percentile(itls, 99), 4),
        "tokens_per_sec": round(total_tokens / makespan, 2) if makespan > 0 else 0.0,
        **statuses,
        **extra,
    }


def _emit_summary(sink: Any, record: dict[str, Any]) -> None:
    """The summary, then its metrics as ``kind:"bench"`` records (shared
    with ``serve/guard.py::run_serve_with_recovery``): throughput, the
    TTFT and ITL tails, and the recovered, rejected and timed-out
    counts (0 on a clean, unguarded run)."""
    if sink is None:
        return
    sink.emit(record)
    for metric, value, unit in (
            ("serve_tokens_per_sec", record["tokens_per_sec"], "tokens/sec"),
            ("serve_ttft_p99_ms", record["ttft_p99_ms"], "ms"),
            ("serve_itl_p99_ms", record["itl_p99_ms"], "ms"),
            ("serve_recovered", record.get("recovered_requests", 0), "requests"),
            ("serve_rejected", record.get("rejected", 0), "requests"),
            ("serve_timed_out", record.get("timed_out", 0), "requests")):
        sink.emit({"kind": "bench", "time": time.time(), "metric": metric, "value": value,
                   "unit": unit})


def reset_after_warmup(engine: ServingEngine) -> None:
    """Zero the counters a warm-up moved, so the measurement sees only
    measured traffic (``decode_steps_all``/``prefills_all`` keep
    counting: the kernels' launch counts are held against them)."""
    engine._completed.clear()
    engine._preemptions = 0
    engine._timed_out = 0
    engine._shed = 0
    engine._step_count = 0
    engine._active_slot_steps = 0
    engine._active_depth_sum = 0
    engine._trash_rows = 0
    engine._decode_walls.clear()
    engine._event_ring.clear()
    engine.pool.high_water = engine.pool.allocated_pages
    engine.pool.total_allocs = 0
    engine.pool.total_frees = 0


def warm_up(engine: ServingEngine, workload: Workload) -> None:
    """One throwaway request a prompt bucket of the workload (budget 2, so
    a decode step runs too) with the sink, tracer and guard detached, then
    ``reset_after_warmup``: first-call set-up stays out of the measured
    TTFTs, and no warm-up record, span or shed is counted."""
    buckets = sorted({engine._bucket_for(len(p)) for p in workload.prompts})
    saved = engine.sink, engine.tracer, engine.guard
    engine.sink = engine.tracer = engine.guard = None
    try:
        for b in buckets:
            engine.submit(Request(prompt=np.ones((min(b, engine.max_seq_len - 1),), np.int64),
                                  max_new_tokens=2))
        engine.run()
    finally:
        engine.sink, engine.tracer, engine.guard = saved
    reset_after_warmup(engine)
    if engine.tracer is not None:
        engine.tracer.reset(engine.clock())


def run_poisson(engine: ServingEngine, workload: Workload, *, sink: Any = None,
                warmup: bool = True, watchdog: Any = None) -> dict[str, Any]:
    """Replay ``workload`` open-loop against the engine on the wall clock;
    returns (and emits) the ``serve_summary`` record. ``warmup`` runs
    ``warm_up`` first. A ``StepWatchdog`` given as ``watchdog`` is armed
    around every measured step (give it ``engine.make_flight_recorder()``
    so a wedged step dumps the serve event ring). Every submitted request
    must end in exactly one terminal status."""
    clock = engine.clock
    if warmup:
        warm_up(engine, workload)
    t0 = clock()
    n, i = len(workload), 0
    submitted: list[Request] = []
    while i < n or engine.busy:
        now = clock() - t0
        while i < n and workload.arrivals[i] <= now:
            submitted.append(engine.submit(Request(
                prompt=workload.prompts[i], max_new_tokens=int(workload.max_new_tokens[i]),
                arrival_time=t0 + float(workload.arrivals[i]))))
            i += 1
        if engine.busy:
            if watchdog is not None:
                with watchdog.watch():
                    engine.step()
            else:
                engine.step()
        elif i < n:
            # Idle until the next arrival: the arrival process is the
            # experiment, so it is not pulled in early.
            time.sleep(min(0.002, max(0.0, float(workload.arrivals[i]) - now)))
    engine.finalize_trace()  # the last partial serve_window
    reqs = engine._completed[:]
    unresolved = [r.req_id for r in submitted if r.terminal_status is None]
    if unresolved:
        raise RuntimeError(f"requests ended unresolved: {unresolved}")
    ids = [r.req_id for r in reqs]
    if len(ids) != len(set(ids)):
        raise RuntimeError(f"requests resolved more than once: "
                           f"{sorted({x for x in ids if ids.count(x) > 1})}")
    makespan = max(r.done_time for r in reqs) - t0 if reqs else 0.0
    record = _summarize("continuous", reqs, makespan, {
        **engine.stats(),
        "num_slots": engine.cfg.num_slots,
        "page_size": engine.cfg.page_size,
        "num_pages": engine.cfg.num_pages,
        "kv_pool_tokens": engine.cfg.num_pages * engine.cfg.page_size,
    })
    _emit_summary(sink, record)
    return record


def run_batch_baseline(model: Any, workload: Workload, *, batch_size: int,
                       temperature: float = 0.0, eos_id: int | None = None, sink: Any = None,
                       warmup: bool = True, device: str = "cuda") -> dict[str, Any]:
    """Replay the workload through batch-at-a-time ``make_generator``
    (module docstring). Tokens past a request's own budget are computed
    and dropped: that is the waste being measured. Its dense cache holds
    ``batch_size * max_seq_len`` rows (``kv_cache_tokens``), to compare
    with the engine's ``kv_pool_tokens``."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.infer import make_generator

    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    gen = make_generator(model, max_new_tokens=int(np.max(workload.max_new_tokens)),
                         temperature=temperature, eos_id=eos_id, device=device)
    dev = next(model.parameters()).device
    plen_max = max(len(p) for p in workload.prompts)
    if warmup:
        gen(np.ones((batch_size, plen_max), np.int64))
    clock = time.monotonic
    t0 = clock()
    reqs: list[Request] = []
    n = len(workload)
    for start in range(0, n, batch_size):
        idx = list(range(start, min(start + batch_size, n)))
        batch_arrival = t0 + float(workload.arrivals[idx[-1]])
        now = clock()
        if now < batch_arrival:
            time.sleep(batch_arrival - now)
        prompt = np.zeros((batch_size, max(len(workload.prompts[j]) for j in idx)), np.int64)
        for row, j in enumerate(idx):
            prompt[row, : len(workload.prompts[j])] = workload.prompts[j]
        launch = clock()
        out = gen(prompt, torch.Generator(device=dev).manual_seed(start)).cpu().numpy()
        done = clock()
        for row, j in enumerate(idx):
            budget = int(workload.max_new_tokens[j])
            toks = out[row, :budget].tolist()
            if eos_id is not None and eos_id in toks:
                toks = toks[: toks.index(eos_id) + 1]
            r = Request(prompt=workload.prompts[j], max_new_tokens=budget, req_id=j,
                        arrival_time=t0 + float(workload.arrivals[j]))
            r.orig_prompt_len, r.orig_max_new_tokens = len(workload.prompts[j]), budget
            r.generated, r.submit_time = toks, launch
            r.first_token_time = r.done_time = done
            reqs.append(r)
    makespan = max(r.done_time for r in reqs) - t0 if reqs else 0.0
    record = _summarize("batch", reqs, makespan, {
        "batch_size": batch_size, "kv_cache_tokens": batch_size * model.max_seq_len,
    })
    if sink is not None:
        sink.emit(record)
    return record
