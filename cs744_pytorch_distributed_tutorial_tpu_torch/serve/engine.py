"""Continuous-batching serving engine over a paged KV pool.

Port of the JAX package's ``serve/engine.py``. Requests are served one
by one rather than a batch at a time:

- decode runs one fixed-shape step over ``num_slots`` slots, the
  model's ``paged_decode`` mode: one token a slot at per-slot depths,
  inactive slots parked on trash page 0, so slots retire, refill and are
  preempted without the step changing shape;
- K/V live in per-layer page pools (``TransformerLM.init_pages``,
  [num_pages, page_size, Hkv, D]) indexed by each slot's row of the page
  table; pool memory scales with the live tokens, and a retired slot's
  pages are reused at once (``pool.PagePool``);
- prefill is a dense causal pass over the prompt padded to a power of
  two from 8 (rows past the true prompt land on trash page 0), the first
  token sampled from the true last position, and the prompt's K/V rows
  scattered into the slot's pages;
- when the pool runs dry the most recently admitted slot is preempted
  (LIFO): its pages are freed and the request re-queues with
  prompt + generated as its prompt (recompute). Admission checks that
  every request fits the pool alone, so the oldest always completes.

Decode attention: ``gather`` (the JAX package's reference, kept as an
explicit option: each slot's pages gathered into the dense layout, the
same ``decode_attention`` as the dense cache, so greedy output equals
``make_generator``'s token for token) or ``kernel`` (the CUDA kernel of
``ops/paged_attention.py``, reading only live rows; tolerance-level
parity). ``auto`` is ``kernel``: the kernel's wrapper itself takes its
plain version (the gather path) for CPU tensors.

Sampling draws token t of request r from uniforms keyed by (seed, r, t)
(``infer/generate.py::stream_uniforms``), in prefill and decode alike,
so recompute-preemption replays a sampled victim's tokens exactly.
Tokens surface as they decode (``on_token``, ``iter_tokens``).

Each decode step sends the host's slot state (tokens, depths, activity,
request ids, token indices and the page table) to the device in one
pinned, non-blocking copy, and fetches the sampled tokens in one copy.
A sampled token outside the vocabulary (NaN logits, or the chaos
harness's poison) raises ``DecodeNanError`` before any bookkeeping of
the step, so ``snapshot()`` after it describes the world before it.

Host-side options, as in the JAX engine: ``tracer``
(``obs/serve_trace.py::ServeTracer``: spans and SLO windows from the
engine's own clock stamps), ``guard`` (``serve/guard.py::ServeGuard``:
admission control at ``submit``, deadline expiry at the top of
``step``), ``snapshot``/``resume`` (kill and replay through recompute)
and ``make_flight_recorder``.

Tensor-parallel serving (``mesh=``, ``param_specs=``, the JAX engine's
``shard_map`` path): the model is an ``LMTrainer.tp_decode_model()`` and
every rank of the mesh builds the engine with the same arguments and
drives it with the same calls (one process a rank). Each rank allocates
its own contiguous pools of its ``Hkv / T`` KV heads (``init_pages``),
runs every prefill and decode step on its heads (the paged kernel on
its pools) and takes part in the two sums a layer; the page table,
positions and tokens are the same on every rank. JAX runs one
controller; here each rank runs the host loop, so every host decision
must come out the same on every rank or a sum would wait for a step
another rank never takes. The engine's state and the tokens come out
the same on every rank by themselves: the logits are the same bits on
every tensor rank (each sum is reduced once and replicated) and
sampling is keyed by (seed, request, token index). What reads a clock
does not, so each rank keeps its own clock for its stamps, and every
decision taken on a clock reading is global rank 0's, taken over by the
others through ``agree`` (one broadcast over the mesh's host group)
where it is made: the guard's deadline expiries at the top of
``step()``, the Poisson replay's arrivals in each pass of its loop, and
the watchdog's verdict after a step under ``run_serve_with_recovery``.
Nothing else in the engine is a collective on the host. Only global
rank 0 writes the sink, so the records (serving records, the tracer's
windows, the flight recorder's dumps) are written once, on rank 0's
clock, and equal a mesh-free engine's on that clock.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from cs744_pytorch_distributed_tutorial_tpu_torch.infer.generate import (
    check_decode_mesh,
    check_decode_model,
    model_device,
    sample_tokens,
    stream_uniforms,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.models.transformer import PAGED_IMPLS
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import collectives as C
from cs744_pytorch_distributed_tutorial_tpu_torch.serve.pool import PagePool
from cs744_pytorch_distributed_tutorial_tpu_torch.utils.failure import DecodeNanError

SERVE_PAGED_IMPLS = ("auto", *PAGED_IMPLS)
RECOMPUTE_MODES = ("prefill", "decode")


@dataclass
class ServeConfig:
    """Engine geometry and sampling policy. ``max_pages_per_slot *
    page_size`` tokens bound one request's KV; ``num_pages`` bounds the
    live total over all slots (page 0 is the trash page, so ``num_pages -
    1`` are allocatable)."""

    num_slots: int = 4
    page_size: int = 16
    num_pages: int = 64
    max_pages_per_slot: int = 8
    temperature: float = 0.0
    top_k: int | None = None
    top_p: float | None = None
    eos_id: int | None = None
    pad_id: int = 0
    seed: int = 0
    paged_attention_impl: str = "auto"  # auto | gather | kernel
    # How a preempted or resumed request rebuilds its KV. "prefill" (the
    # JAX engine's): one dense pass over prompt + produced tokens, whose
    # rows differ from the decode steps' in the last bits, so a greedy
    # stream can fork after a rebuild at low precision. "decode": the
    # original prompt's dense pass at its own bucket, then the produced
    # tokens fed back through decode steps (their outputs discarded), the
    # arithmetic of the first pass bit for bit: streams do not depend on
    # preemptions or restarts, at one decode step a replayed token.
    recompute: str = "prefill"


@dataclass
class Request:
    """One generation request and its engine-side record."""

    prompt: np.ndarray  # [T] token ids
    max_new_tokens: int
    req_id: int = -1
    arrival_time: float | None = None  # loadgen wall clock; None = submit
    # SLO budgets (serve/guard.py): ``deadline_s`` bounds the time from
    # arrival to retire, ``max_queue_s`` the time queued before the first
    # admission. None takes the guard's default (unbounded without a
    # guard). Both survive snapshot/resume.
    deadline_s: float | None = None
    max_queue_s: float | None = None
    # Set once when the request leaves the system: "completed", "rejected"
    # (shed at admission) or "timed_out" (a budget expired).
    status: str | None = None
    generated: list[int] = field(default_factory=list)
    submit_time: float = 0.0
    first_token_time: float | None = None
    done_time: float | None = None
    preemptions: int = 0
    # Clock time each output token surfaced, monotone across preemptions.
    token_times: list[float] = field(default_factory=list)
    # Recompute-preemption moves produced tokens into the prompt; these
    # keep the original accounting.
    orig_prompt_len: int = -1
    orig_max_new_tokens: int = -1
    # Kill/resume: ``recovered`` marks a request replayed from a
    # ServeSnapshot; each ``resume_boundaries`` entry is the
    # ``token_times`` index of the first token after a resume, whose gap
    # to the one before spans the kill (two clock epochs) and is left out
    # of ITL. ``replay_pending``: the next admission is a resume-replay.
    recovered: bool = False
    resume_boundaries: list[int] = field(default_factory=list)
    replay_pending: bool = False

    @property
    def output_tokens(self) -> int:
        return self.orig_max_new_tokens - self.max_new_tokens + len(self.generated)

    @property
    def terminal_status(self) -> str | None:
        """``completed``, ``rejected``, ``timed_out`` or ``recovered`` (a
        completed request replayed through a resume) once the request has
        left the system, else None."""
        status = self.status
        if status is None and self.done_time is not None:
            status = "completed"  # the batch baseline's requests
        if status == "completed" and self.recovered:
            return "recovered"
        return status


@dataclass
class _Slot:
    req: Request
    length: int  # committed KV rows (prompt + fed tokens)
    pages: list[int]
    last_tok: int
    admit_seq: int  # admission order, for LIFO preemption
    # recompute="decode": produced tokens still to feed back before the
    # slot's outputs are new again.
    forced: list[int] = field(default_factory=list)


@dataclass
class ServeSnapshot:
    """The request state of an engine, not its KV: recompute rebuilds any
    slot's KV from prompt + generated, and the sampling streams keyed by
    (seed, request id, absolute token index) make that rebuild give the
    same tokens. In-flight requests are recorded with the preemption
    transform applied (produced tokens folded into the prompt); with the
    seed and the id counter, ``resume`` on a fresh engine replays them
    token for token, greedy or sampled."""

    seed: int
    next_id: int
    requests: list[dict[str, Any]] = field(default_factory=list)


class ServingEngine:
    """In-flight batching over ``cfg.num_slots`` decode slots.

    ``model`` is a decode ``TransformerLM`` on ``device`` (``cuda``, or
    ``cpu`` when asked), e.g. ``LMTrainer.decode_model()`` or
    ``quantized_decode_model(kv_cache=True)``; its pools are built here.
    Drive it with ``submit()`` and ``step()`` (one admission and decode
    iteration; returns the requests completed in it) or ``run()`` (until
    drained); ``serve/loadgen.py`` adds Poisson replay on the wall clock.
    A ``tp_decode_model()`` serves with ``mesh`` and ``param_specs``
    (the module docstring).
    """

    def __init__(self, model: Any, cfg: ServeConfig, *, device: str = "cuda", sink: Any = None,
                 clock: Callable[[], float] = time.monotonic,
                 on_token: Callable[[Request, int], None] | None = None,
                 tracer: Any = None, guard: Any = None, mesh: Any = None,
                 param_specs: Any = None) -> None:
        check_decode_model(model, "serving", allow_tensor=mesh is not None)
        if mesh is not None:
            check_decode_mesh(model, mesh, param_specs)
        if cfg.num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {cfg.num_slots}")
        if cfg.max_pages_per_slot < 1:
            raise ValueError(f"max_pages_per_slot must be >= 1, got {cfg.max_pages_per_slot}")
        if cfg.paged_attention_impl not in SERVE_PAGED_IMPLS:
            raise ValueError(f"paged_attention_impl must be one of {SERVE_PAGED_IMPLS}, "
                             f"got {cfg.paged_attention_impl!r}")
        if cfg.recompute not in RECOMPUTE_MODES:
            raise ValueError(f"recompute must be one of {RECOMPUTE_MODES}, got "
                             f"{cfg.recompute!r}")
        if tracer is not None and getattr(tracer, "num_slots", cfg.num_slots) != cfg.num_slots:
            raise ValueError(f"tracer was built for {tracer.num_slots} slots, engine has "
                             f"{cfg.num_slots}")
        self.device = model_device(model, device)
        impl = cfg.paged_attention_impl
        self.paged_attention_impl = "kernel" if impl == "auto" else impl
        self.model, self.cfg, self.mesh = model, cfg, mesh
        # Under a mesh of more than one rank: rank 0's decisions on every
        # rank (agree), rank 0 alone writing records.
        self._shared = mesh is not None and mesh.world_size > 1
        if self._shared:
            self._check_same_on_every_rank(tracer, guard)
            if mesh.rank != 0:
                sink = None
        self.sink, self.clock, self.on_token = sink, clock, on_token
        self.tracer, self.guard = tracer, guard
        self.max_seq_len = model.max_seq_len
        self.pool = PagePool(cfg.num_pages, cfg.page_size)
        self._pages = model.init_pages(cfg.num_pages, cfg.page_size, device=self.device)
        self._prefill_cache = model.init_cache(1, device=self.device)

        b, p = cfg.num_slots, cfg.max_pages_per_slot
        self._queue: deque[Request] = deque()
        self._slots: list[_Slot | None] = [None] * b
        self._page_table = np.zeros((b, p), np.int32)  # 0 = trash page
        # The decode step's inputs, host side (pinned on CUDA) and device
        # side: tokens, depths, active, request ids, token indices [B]
        # each, then the page table [B, P].
        pin = self.device.type == "cuda"
        self._host_in = torch.zeros(5 * b + b * p, dtype=torch.int32, pin_memory=pin)
        self._dev_in = torch.zeros_like(self._host_in, device=self.device)
        self._next_id = 0
        self._admit_seq = 0
        self._step_count = 0
        self._active_slot_steps = 0
        self._active_depth_sum = 0  # KV rows of the active slots, summed over steps
        self._preemptions = 0
        self._recovered = 0  # requests resumed from a ServeSnapshot
        self._timed_out = 0  # requests retired at a budget's expiry
        self._shed = 0  # requests rejected at admission
        self._trash_rows = 0
        # recompute="decode": fed-back tokens the decode step did not
        # reproduce (0 while the arithmetic is deterministic).
        self._replay_mismatches = 0
        # The tail of every emitted record (a flight dump's payload), the
        # host wall of each decode step (decode_host_exposed_ms) and an
        # optional straggler window (make_flight_recorder).
        self._event_ring: deque[dict[str, Any]] = deque(maxlen=256)
        self._decode_walls: deque[float] = deque(maxlen=4096)
        self._straggler: Any = None
        self._completed: list[Request] = []
        self._buckets: set[int] = set()  # prompt buckets prefilled so far
        # Since construction, warm-up included: what the launch counts of
        # the kernels are held against. The profiler's own steps
        # (obs/serve_trace.py::profile_serve_programs) count apart.
        self.decode_steps_all = 0
        self.prefills_all = 0
        self.profiled_decode_steps = 0
        self.profiled_prefills = 0

    # ------------------------------------------------------- the ranks
    def _check_same_on_every_rank(self, tracer: Any, guard: Any) -> None:
        """Every rank must take the same host path (the module docstring):
        the geometry, the policy and whether a tracer and a guard ride
        along (a guard agrees on its expiries each step) must agree over
        the mesh."""
        mine = (dataclasses.asdict(self.cfg), tracer is not None,
                None if guard is None else dataclasses.asdict(guard.cfg))
        every = [None] * self.mesh.world_size
        dist.all_gather_object(every, mine, group=self.mesh.host_group())
        if any(other != every[0] for other in every):
            raise ValueError("the ranks of a tensor-parallel engine must build it alike (config, "
                             f"tracer, guard); got {every}")

    def agree(self, value):
        """Global rank 0's ``value`` of a decision taken on a clock
        reading (a number, or an array of the same shape on every rank),
        ``value`` itself without a mesh: the module docstring lists the
        callers. Every rank calls it at the same point of the loop."""
        if not self._shared:
            return value
        out = C.broadcast_host(np.asarray(value), self.mesh)
        return out.item() if out.ndim == 0 else out

    # ------------------------------------------------------------ model
    @staticmethod
    def _bucket_for(n: int) -> int:
        b = 8
        while b < n:
            b *= 2
        return b

    def _prompt_bucket(self, n: int) -> int:
        return min(self._bucket_for(n), self.max_seq_len)

    def _uniforms(self, req_ids: torch.Tensor, tok_idx: torch.Tensor) -> torch.Tensor | None:
        if self.cfg.temperature == 0.0:
            return None
        return stream_uniforms(self.cfg.seed, req_ids, tok_idx, self.model.vocab_size)

    def _sample(self, logits: torch.Tensor, req_ids: torch.Tensor,
                tok_idx: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        return sample_tokens(logits, self._uniforms(req_ids, tok_idx),
                             temperature=cfg.temperature, top_k=cfg.top_k, top_p=cfg.top_p)

    @torch.no_grad()
    def _prefill_step(self, prompt: np.ndarray, plen: int, req_id: int, tok_index: int,
                      row: np.ndarray) -> torch.Tensor:
        """Dense causal pass over ``prompt`` [1, bucket] (padded past
        ``plen``), the first token sampled from its true last position,
        and the prompt's K/V rows committed to the pages of ``row`` (the
        rows past it to trash page 0). Returns the token on the device."""
        dev, ps = self.device, self.cfg.page_size
        bucket = prompt.shape[1]
        logits = self.model(torch.from_numpy(prompt).to(dev), "prefill",
                            cache=self._prefill_cache)
        ids = torch.tensor([[req_id, tok_index]], device=dev)
        tok = self._sample(logits[:, plen - 1], ids[:, 0], ids[:, 1])
        idx = torch.arange(bucket, device=dev)
        row_dev = torch.from_numpy(row).to(dev).long()
        page = row_dev[torch.clamp(idx // ps, max=len(row) - 1)]
        pidx = torch.where(idx < plen, page, 0)
        off = idx % ps
        for pool, cache in zip(self._pages, self._prefill_cache):
            pool.key[pidx, off] = cache.key[0, :bucket]
            pool.value[pidx, off] = cache.value[0, :bucket]
            if pool.key_scale is not None:
                pool.key_scale[pidx, off] = cache.key_scale[0, :bucket]
                pool.value_scale[pidx, off] = cache.value_scale[0, :bucket]
        return tok

    def _prefill(self, req: Request, row: np.ndarray, bucket: int, plen: int,
                 tok_index: int) -> int:
        prompt = np.zeros((1, bucket), np.int64)
        prompt[0, :plen] = req.prompt[:plen]
        tok = self._prefill_step(prompt, plen, req.req_id, tok_index, row)
        self.prefills_all += 1
        self._buckets.add(bucket)
        self._trash_rows += bucket - plen
        return int(tok[0])  # blocks: the request's first token

    @torch.no_grad()
    def _decode_step(self, tokens, lengths, active, req_ids, tok_idx,
                     page_table: np.ndarray) -> torch.Tensor:
        """One fixed-shape decode step over every slot; returns the sampled
        tokens on the device (``pad_id`` for inactive slots)."""
        b, p = self.cfg.num_slots, self.cfg.max_pages_per_slot
        host = self._host_in.numpy()
        for i, col in enumerate((tokens, lengths, active, req_ids, tok_idx)):
            host[i * b:(i + 1) * b] = col
        host[5 * b:] = page_table.reshape(-1)
        dev = self._dev_in
        dev.copy_(self._host_in, non_blocking=True)
        d_tokens, d_lengths, d_active, d_req, d_idx = (dev[i * b:(i + 1) * b] for i in range(5))
        table = dev[5 * b:].view(b, p)
        logits = self.model(d_tokens[:, None], "paged_decode", decode_pos=d_lengths,
                            page_table=table, cache=self._pages,
                            paged_attention_impl=self.paged_attention_impl)
        tok = self._sample(logits[:, 0], d_req, d_idx)
        return torch.where(d_active.bool(), tok, self.cfg.pad_id)

    def _decode(self, tokens, lengths, active, req_ids, tok_idx) -> np.ndarray:
        """The serving decode step over the live page table; the chaos
        harness (``utils/chaos.py``) wraps this method."""
        tok = self._decode_step(tokens, lengths, active, req_ids, tok_idx, self._page_table)
        self.decode_steps_all += 1
        return tok.cpu().numpy()  # the scheduler needs the tokens: one fetch a step

    # -------------------------------------------------------- admission
    def submit(self, req: Request) -> Request:
        """Queue a request. Raises if it can never fit: a request that
        fits the pool alone is what makes preemption deadlock-free."""
        req.prompt = np.asarray(req.prompt, np.int64).reshape(-1)
        if req.prompt.size < 1:
            raise ValueError("empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {req.max_new_tokens}")
        # Ids are assigned before admission control, so a guarded run's
        # ids line up with an unguarded run of the same workload and a
        # shed record carries a real id.
        if req.req_id < 0:
            req.req_id = self._next_id
            self._next_id += 1
        # The guard may reject the request (returned unqueued, status
        # "rejected") or trim its budget, before the budget is recorded:
        # the trimmed budget is the request's budget.
        if self.guard is not None and not self.guard.admit(self, req):
            return req
        if req.orig_prompt_len < 0:
            req.orig_prompt_len = int(req.prompt.size)
            req.orig_max_new_tokens = int(req.max_new_tokens)
        total = int(req.prompt.size) + int(req.max_new_tokens)
        if total > self.max_seq_len:
            raise ValueError(f"prompt ({req.prompt.size}) + max_new_tokens "
                             f"({req.max_new_tokens}) exceeds max_seq_len ({self.max_seq_len})")
        # KV rows a request can hold: prompt + budget - 1 (the last
        # sampled token is never fed back).
        need = self.pool.pages_for(total - 1)
        cap = min(self.cfg.max_pages_per_slot, self.cfg.num_pages - 1)
        if need > cap:
            raise ValueError(
                f"request needs {need} pages ({total - 1} KV rows at page_size "
                f"{self.cfg.page_size}); the engine caps a slot at {cap} pages: raise "
                "max_pages_per_slot/num_pages or shrink the request"
            )
        req.submit_time = self.clock()
        if req.arrival_time is None:
            req.arrival_time = req.submit_time
        self._queue.append(req)
        if self.tracer is not None:
            self.tracer.on_submit(req, req.submit_time)
        return req

    @property
    def busy(self) -> bool:
        return bool(self._queue) or any(s is not None for s in self._slots)

    # -------------------------------------------------------- telemetry
    def _emit(self, record: dict[str, Any]) -> None:
        """A record to the sink and to the event ring (what a flight dump
        replays, kept even while the sink is detached)."""
        self._event_ring.append(record)
        if self.sink is not None:
            self.sink.emit(record)

    def _pool_stats(self) -> dict[str, int]:
        """The pool's counters at decode-step cadence, for the tracer."""
        pool = self.pool
        return {"live": pool.allocated_pages, "free": pool.free_pages,
                "high_water": pool.high_water, "churn": pool.total_allocs + pool.total_frees,
                "trash": self._trash_rows}

    def finalize_trace(self) -> None:
        """Flush the tracer's last partial SLO window through the sink."""
        if self.tracer is None:
            return
        rec = self.tracer.flush_window(self.clock(), queue_depth=len(self._queue))
        if rec is not None:
            self._emit(rec)

    def make_flight_recorder(self, telemetry: Any = None, *,
                             emit: Callable[..., None] | None = None, ring_tail: int = 32,
                             hbm: bool = True) -> Any:
        """A FlightRecorder over the serving loop: a crash, watchdog or
        SIGTERM dump carries the pool and queue header, the decode-step
        straggler window and the tail of the event ring. Without
        ``telemetry`` or ``emit`` the dump goes through the engine's sink."""
        from cs744_pytorch_distributed_tutorial_tpu_torch.obs.flight import (
            FlightRecorder,
            HbmHighWater,
            StragglerMonitor,
        )

        if self._straggler is None:
            self._straggler = StragglerMonitor()
        if telemetry is None and emit is None:
            def emit(event, **fields):
                self._emit({"kind": "event", "event": event, "time": time.time(), **fields})

        def serve_tail():
            # Re-keyed so the records nest under flight_serve events
            # without colliding with their kind/event/time.
            out = []
            for rec in list(self._event_ring)[-ring_tail:]:
                out.append({("serve_event" if k == "event" else "t" if k == "time" else k): v
                            for k, v in rec.items() if k != "kind"})
            return out

        def header():
            pool = self.pool
            return {
                "queue_depth": len(self._queue),
                "active_slots": sum(s is not None for s in self._slots),
                "decode_steps": self._step_count,
                "preemptions": self._preemptions,
                "pages_live": pool.allocated_pages,
                "page_high_water": pool.high_water,
                "page_churn": pool.total_allocs + pool.total_frees,
                "trash_rows_written": self._trash_rows,
            }

        return FlightRecorder(telemetry=telemetry, straggler=self._straggler,
                              hbm=HbmHighWater() if hbm else None, ring_tail=ring_tail,
                              emit=emit, tails={"serve": serve_tail}, header_fn=header)

    # ------------------------------------------------------- scheduling
    def _preempt_lifo(self) -> bool:
        """Free the most recently admitted slot and re-queue its request
        (front) with prompt + generated as its prompt. False when no slot
        is active."""
        victim = -1
        for i, s in enumerate(self._slots):
            if s is not None and (victim < 0 or s.admit_seq > self._slots[victim].admit_seq):
                victim = i
        if victim < 0:
            return False
        req = self._slots[victim].req
        req.preemptions += 1
        self._preemptions += 1
        replayed = len(req.generated)
        now = self.clock()
        if self.tracer is not None:
            self.tracer.on_preempt(req, victim, now, replayed)
        self._emit({"kind": "serve", "event": "preempt", "time": time.time(),
                    "id": req.req_id, "replayed_tokens": replayed})
        req.prompt = np.concatenate([req.prompt, np.asarray(req.generated, np.int64)])
        req.max_new_tokens -= len(req.generated)
        req.generated = []
        self._free_slot(victim)
        if req.max_new_tokens >= 1:
            self._queue.appendleft(req)
            if self.tracer is not None:
                self.tracer.on_requeue(req, now)
        else:  # its budget was spent exactly at preemption
            self._finish(req)
        return True

    def _free_slot(self, i: int) -> None:
        self.pool.free(self._slots[i].pages)
        self._page_table[i, :] = 0
        self._slots[i] = None
        if __debug__:
            # Every path that frees pages (retire, preempt, expiry) ends
            # here: audit the accounting where a leak would begin.
            self.pool.check_invariants()

    def _ensure_pages(self, n: int) -> bool:
        """Make n pages allocatable, preempting LIFO as needed."""
        while not self.pool.can_alloc(n):
            if not self._preempt_lifo():
                return False
        return True

    def _admit(self, slot_idx: int, req: Request) -> None:
        t_admit = self.clock()
        # The admission's span kind: a first admission is a prefill, a
        # preempted request's re-admission a recompute, a resumed
        # in-flight request's first re-admission a resume-replay.
        if req.replay_pending:
            admit_kind = "resume-replay"
        elif req.preemptions > 0:
            admit_kind = "recompute"
        else:
            admit_kind = "prefill"
        req.replay_pending = False
        plen = int(req.prompt.size)
        replayed = max(0, plen - req.orig_prompt_len)
        pages = self.pool.alloc(max(1, self.pool.pages_for(plen)))
        row = np.zeros((self.cfg.max_pages_per_slot,), np.int32)
        row[: len(pages)] = pages
        # recompute="decode": the original prompt's pass, then the produced
        # tokens fed back (the first of them is what this pass samples).
        forced = ([int(t) for t in req.prompt[req.orig_prompt_len:]]
                  if replayed and self.cfg.recompute == "decode" else [])
        fill = req.orig_prompt_len if forced else plen
        bucket = self._prompt_bucket(fill)
        tok = self._prefill(req, row, bucket, fill, req.output_tokens - len(forced))
        now = self.clock()
        first = req.first_token_time is None
        if first:
            req.first_token_time = now
        if self.tracer is not None:
            self.tracer.on_admit(req, slot=slot_idx, bucket=bucket, t0=t_admit, t1=now,
                                 kind=admit_kind, replayed=replayed)
            if first:
                self.tracer.sample_ttft((now - req.arrival_time) * 1e3, now)
        if forced:
            self._replay_mismatches += tok != forced[0]
            tok, forced, plen = forced[0], forced[1:], fill
        else:
            req.generated.append(tok)
            self._surface(req, tok, now)
        self._admit_seq += 1
        self._slots[slot_idx] = _Slot(req=req, length=plen, pages=pages, last_tok=tok,
                                      admit_seq=self._admit_seq, forced=forced)
        self._page_table[slot_idx, :] = row
        if self._slot_done(self._slots[slot_idx]):
            self._retire(slot_idx)

    def _slot_done(self, slot: _Slot) -> bool:
        if len(slot.req.generated) >= slot.req.max_new_tokens:
            return True
        return self.cfg.eos_id is not None and slot.last_tok == self.cfg.eos_id

    def _retire(self, i: int, status: str = "completed") -> None:
        req = self._slots[i].req
        self._free_slot(i)
        self._finish(req, slot=i, status=status)

    def _finish(self, req: Request, slot: int | None = None, status: str = "completed") -> None:
        req.status = status
        req.done_time = self.clock()
        if status == "timed_out":
            self._timed_out += 1
        self._completed.append(req)
        if self.tracer is not None:
            self.tracer.on_retire(req, slot, req.done_time)
        # A request that timed out while queued produced no token: its
        # latency fields are absent, not zero.
        ttft_ms = decode_ms = None
        out = req.output_tokens
        if req.first_token_time is not None:
            ttft_ms = round((req.first_token_time - req.arrival_time) * 1e3, 3)
            decode_ms = round((req.done_time - req.first_token_time) * 1e3 / max(1, out - 1), 4)
        self._emit({
            "kind": "serve", "event": "request", "time": time.time(), "id": req.req_id,
            "status": req.terminal_status, "prompt_tokens": req.orig_prompt_len,
            "output_tokens": out, "queue_ms": round((req.submit_time - req.arrival_time) * 1e3, 3),
            "ttft_ms": ttft_ms, "decode_ms_per_token": decode_ms,
            "preemptions": req.preemptions, "recovered": req.recovered,
        })

    def _shed_reject(self, req: Request, reason: str, **fields: Any) -> None:
        """Reject ``req`` at admission for good (the guard calls this from
        ``submit``): it never queues or touches the pool, and resolves at
        once with status ``rejected``."""
        now = self.clock()
        req.submit_time = now
        if req.arrival_time is None:
            req.arrival_time = now
        if req.orig_prompt_len < 0:
            req.orig_prompt_len = int(req.prompt.size)
            req.orig_max_new_tokens = int(req.max_new_tokens)
        req.status = "rejected"
        req.done_time = now
        self._shed += 1
        self._completed.append(req)
        if self.tracer is not None:
            self.tracer.on_shed(req, now, reason)
        self._emit({"kind": "serve_shed", "time": time.time(), "id": req.req_id,
                    "reason": reason, "terminal": True, **fields})

    def _expire_request(self, req: Request, slot: int | None, reason: str) -> None:
        """Retire ``req`` as ``timed_out``: an active slot's pages are
        freed at once, a queued request just resolves. ``reason`` is the
        budget that expired (``deadline`` or ``queue_wait``)."""
        self._emit({"kind": "serve", "event": "timed_out", "time": time.time(),
                    "id": req.req_id, "reason": reason, "queued": slot is None})
        if slot is not None:
            self._retire(slot, status="timed_out")
        else:
            self._finish(req, slot=None, status="timed_out")

    # ------------------------------------------------------------- loop
    def step(self) -> list[Request]:
        """Expire requests past their budgets (with a guard), refill free
        slots from the queue (a prefill each), grow the page tables of
        slots crossing a page boundary (preempting LIFO if the pool is
        dry), then one decode step over all slots; returns the requests
        completed in it."""
        done_before = len(self._completed)
        cfg = self.cfg
        # Before the refill: an expired queue head must not be admitted,
        # and an expired slot's pages are free for this step.
        if self.guard is not None:
            self.guard.expire(self)
        # Refill, first come first served: the queue head is admitted only
        # when its prompt's pages are free; never preempt to admit.
        for i in range(cfg.num_slots):
            if not self._queue:
                break
            if self._slots[i] is not None:
                continue
            if not self.pool.can_alloc(max(1, self.pool.pages_for(int(self._queue[0].prompt.size)))):
                break
            self._admit(i, self._queue.popleft())
        # Grow: each active slot needs a page for the row its next fed
        # token writes (position slot.length).
        for i in range(cfg.num_slots):
            slot = self._slots[i]
            if slot is None or self._slot_done(slot):
                continue
            if slot.length // cfg.page_size < len(slot.pages):
                continue
            if not self._ensure_pages(1):
                raise RuntimeError("page pool dry with no active slots")
            slot = self._slots[i]  # _ensure_pages may have preempted it
            if slot is None or slot.length // cfg.page_size < len(slot.pages):
                continue
            page = self.pool.alloc(1)[0]
            self._page_table[i, len(slot.pages)] = page
            slot.pages.append(page)
        if not any(s is not None for s in self._slots):
            return self._completed[done_before:]

        b = cfg.num_slots
        t0 = self.clock()
        tokens = np.full((b,), cfg.pad_id, np.int32)
        lengths, active, req_ids, tok_idx = (np.zeros((b,), np.int32) for _ in range(4))
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            tokens[i], lengths[i], active[i] = slot.last_tok, slot.length, 1
            # The draw's index is that of the token the step produces (a
            # fed-back one's own while the slot replays).
            req_ids[i] = slot.req.req_id
            tok_idx[i] = slot.req.output_tokens - len(slot.forced)
        toks = self._decode(tokens, lengths, active, req_ids, tok_idx)
        # Poisoned logits sample outside the vocabulary: raised before any
        # bookkeeping of the step, so snapshot() gives the world before it
        # (run_serve_with_recovery replays the step on a fresh engine).
        bad = active.astype(bool) & ((toks < 0) | (toks >= self.model.vocab_size))
        if bad.any():
            raise DecodeNanError(step=self._step_count, slots=np.nonzero(bad)[0])
        self._step_count += 1
        n_active = int(active.sum())
        self._active_slot_steps += n_active
        self._active_depth_sum += int(lengths.sum())
        self._trash_rows += b - n_active  # parked slots write trash page 0
        now = self.clock()
        self._decode_walls.append(now - t0)
        if self._straggler is not None:
            self._straggler.record(self._step_count, now - t0)
        window = None
        if self.tracer is not None:
            # Slot residency before retiring: each live slot's decode_run
            # span extends to ``now``, the stamp its token surfaces with.
            slot_reqs = {i: s.req.req_id for i, s in enumerate(self._slots) if s is not None}
            window = self.tracer.on_decode_step(t0, now, slot_reqs, self._pool_stats(),
                                                len(self._queue))
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            slot.length += 1
            if slot.forced:  # a fed-back token, delivered before: not surfaced
                self._replay_mismatches += int(toks[i]) != slot.forced[0]
                slot.last_tok = slot.forced.pop(0)
                continue
            slot.last_tok = int(toks[i])
            slot.req.generated.append(slot.last_tok)
            self._surface(slot.req, slot.last_tok, now)
            if self._slot_done(slot):
                self._retire(i)
        if window is not None:
            self._emit(window)
        return self._completed[done_before:]

    def run(self) -> list[Request]:
        """Step until the queue and every slot are empty."""
        while self.busy:
            self.step()
        return self._completed

    # -------------------------------------------------------- streaming
    def _surface(self, req: Request, tok: int, now: float) -> None:
        if self.tracer is not None and req.token_times:
            # The gap loadgen's summary diffs, except across a resume
            # boundary (it spans the kill), which loadgen leaves out too.
            if len(req.token_times) not in req.resume_boundaries:
                self.tracer.sample_itl((now - req.token_times[-1]) * 1e3, now)
        req.token_times.append(now)
        if self.on_token is not None:
            self.on_token(req, tok)

    def iter_tokens(self, req: Request):
        """Yield a submitted request's tokens as they surface, driving the
        engine as needed, until the request completes."""
        yielded = 0
        while True:
            produced = req.output_tokens
            if produced > yielded:
                ids = list(req.prompt[req.orig_prompt_len:]) + list(req.generated)
                for tok in ids[yielded:produced]:
                    yield int(tok)
                yielded = produced
            if req.done_time is not None or not self.busy:
                return
            self.step()

    # --------------------------------------------------------- recovery
    def snapshot(self) -> ServeSnapshot:
        """Every unfinished request, the live engine untouched: in-flight
        slots with the recompute transform applied to copies, oldest
        admission first (a resume re-admits in that order), then the
        queue as it stands."""

        def record(req: Request, *, in_flight: bool, replayed: int) -> dict:
            prompt = np.asarray(req.prompt, np.int32).copy()
            max_new = int(req.max_new_tokens)
            if replayed:
                prompt = np.concatenate([prompt, np.asarray(req.generated, np.int32)])
                max_new -= replayed
            return {
                "req_id": int(req.req_id), "prompt": prompt, "max_new_tokens": max_new,
                "deadline_s": req.deadline_s, "max_queue_s": req.max_queue_s,
                "orig_prompt_len": int(req.orig_prompt_len),
                "orig_max_new_tokens": int(req.orig_max_new_tokens),
                "preemptions": int(req.preemptions), "arrival_time": req.arrival_time,
                "first_token_time": req.first_token_time,
                "token_times": list(req.token_times),
                "resume_boundaries": list(req.resume_boundaries),
                "replayed_tokens": replayed, "in_flight": in_flight,
            }

        active = sorted((s for s in self._slots if s is not None), key=lambda s: s.admit_seq)
        requests = [record(s.req, in_flight=True, replayed=len(s.req.generated))
                    for s in active]
        requests += [record(r, in_flight=False, replayed=0) for r in self._queue]
        return ServeSnapshot(seed=self.cfg.seed, next_id=self._next_id, requests=requests)

    def resume(self, snap: ServeSnapshot) -> list[Request]:
        """Re-submit a snapshot's requests into this idle engine, which
        must share its seed (the sampling streams are keyed off it). Each
        in-flight request replays through recompute: its re-prefill draws
        token ``output_tokens`` from the key the dead engine's decode
        would have used. Returns the requests in submission order."""
        if self.busy:
            raise RuntimeError("resume requires an idle engine: live requests would "
                               "interleave with the snapshot's admission order")
        if snap.seed != self.cfg.seed:
            raise ValueError(f"snapshot was taken under seed {snap.seed}, engine has "
                             f"{self.cfg.seed}: per-request PRNG streams differ, replay "
                             "would not be token-identical")
        out = []
        for rec in snap.requests:
            req = Request(prompt=np.asarray(rec["prompt"], np.int32),
                          max_new_tokens=int(rec["max_new_tokens"]), req_id=int(rec["req_id"]),
                          arrival_time=rec["arrival_time"])
            req.deadline_s = rec.get("deadline_s")
            req.max_queue_s = rec.get("max_queue_s")
            req.orig_prompt_len = int(rec["orig_prompt_len"])
            req.orig_max_new_tokens = int(rec["orig_max_new_tokens"])
            req.preemptions = int(rec["preemptions"])
            req.first_token_time = rec["first_token_time"]
            req.token_times = list(rec["token_times"])
            req.resume_boundaries = list(rec.get("resume_boundaries", []))
            if req.token_times:
                # The next token lands at this index; its gap spans the kill.
                req.resume_boundaries.append(len(req.token_times))
            req.recovered = True
            req.replay_pending = bool(rec["in_flight"])
            self.submit(req)
            if rec["in_flight"]:
                self._recovered += 1
                self._emit({"kind": "serve", "event": "recovered", "time": time.time(),
                            "id": req.req_id, "replayed_tokens": int(rec["replayed_tokens"])})
            out.append(req)
        self._next_id = max(self._next_id, int(snap.next_id))
        return out

    # -------------------------------------------------------- reporting
    def stats(self) -> dict[str, Any]:
        steps = max(1, self._step_count)
        walls = self._decode_walls
        return {
            "requests_done": len(self._completed),
            "decode_steps": self._step_count,
            "slot_occupancy": self._active_slot_steps / (steps * self.cfg.num_slots),
            "page_high_water": self.pool.high_water,
            "pages_allocatable": self.cfg.num_pages - 1,
            "preemptions": self._preemptions,
            "recovered_requests": self._recovered,
            "timed_out_requests": self._timed_out,
            "shed_requests": self._shed,
            "page_churn": self.pool.total_allocs + self.pool.total_frees,
            "trash_rows_written": self._trash_rows,
            "replay_mismatches": self._replay_mismatches,
            "decode_ms_per_step": 1e3 * sum(walls) / len(walls) if walls else None,
            "decode_steps_all": self.decode_steps_all,
            "prefills_all": self.prefills_all,
            "paged_attention_impl": self.paged_attention_impl,
        }
