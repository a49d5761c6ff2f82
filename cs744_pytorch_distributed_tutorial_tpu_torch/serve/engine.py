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
``guard``, ``tracer``, ``mesh``, ``snapshot``/``resume`` and
``make_flight_recorder`` are not ported yet.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.infer.generate import (
    check_decode_model,
    model_device,
    sample_tokens,
    stream_uniforms,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.models.transformer import PAGED_IMPLS
from cs744_pytorch_distributed_tutorial_tpu_torch.serve.pool import PagePool

SERVE_PAGED_IMPLS = ("auto", *PAGED_IMPLS)


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


@dataclass
class Request:
    """One generation request and its engine-side record."""

    prompt: np.ndarray  # [T] token ids
    max_new_tokens: int
    req_id: int = -1
    arrival_time: float | None = None  # loadgen wall clock; None = submit
    status: str | None = None  # "completed" once it leaves the system
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

    @property
    def output_tokens(self) -> int:
        return self.orig_max_new_tokens - self.max_new_tokens + len(self.generated)

    @property
    def terminal_status(self) -> str | None:
        if self.status is None and self.done_time is not None:
            return "completed"  # the batch baseline's requests
        return self.status


@dataclass
class _Slot:
    req: Request
    length: int  # committed KV rows (prompt + fed tokens)
    pages: list[int]
    last_tok: int
    admit_seq: int  # admission order, for LIFO preemption


class ServingEngine:
    """In-flight batching over ``cfg.num_slots`` decode slots.

    ``model`` is a decode ``TransformerLM`` on ``device`` (``cuda``, or
    ``cpu`` when asked), e.g. ``LMTrainer.decode_model()`` or
    ``quantized_decode_model(kv_cache=True)``; its pools are built here.
    Drive it with ``submit()`` and ``step()`` (one admission and decode
    iteration; returns the requests completed in it) or ``run()`` (until
    drained); ``serve/loadgen.py`` adds Poisson replay on the wall clock.
    """

    def __init__(self, model: Any, cfg: ServeConfig, *, device: str = "cuda", sink: Any = None,
                 clock: Callable[[], float] = time.monotonic,
                 on_token: Callable[[Request, int], None] | None = None,
                 tracer: Any = None, guard: Any = None, mesh: Any = None) -> None:
        for name, value in (("tracer", tracer), ("guard", guard), ("mesh", mesh)):
            if value is not None:
                raise NotImplementedError(f"ServingEngine {name}= is not yet ported")
        check_decode_model(model, "serving")
        if cfg.num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {cfg.num_slots}")
        if cfg.max_pages_per_slot < 1:
            raise ValueError(f"max_pages_per_slot must be >= 1, got {cfg.max_pages_per_slot}")
        if cfg.paged_attention_impl not in SERVE_PAGED_IMPLS:
            raise ValueError(f"paged_attention_impl must be one of {SERVE_PAGED_IMPLS}, "
                             f"got {cfg.paged_attention_impl!r}")
        self.device = model_device(model, device)
        impl = cfg.paged_attention_impl
        self.paged_attention_impl = "kernel" if impl == "auto" else impl
        self.model, self.cfg = model, cfg
        self.sink, self.clock, self.on_token = sink, clock, on_token
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
        self._preemptions = 0
        self._trash_rows = 0
        self._decode_walls: list[float] = []
        self._completed: list[Request] = []
        # Since construction, warm-up included: what the launch counts of
        # the kernels are held against.
        self.decode_steps_all = 0
        self.prefills_all = 0

    # ------------------------------------------------------------ model
    @staticmethod
    def _bucket_for(n: int) -> int:
        b = 8
        while b < n:
            b *= 2
        return b

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
    def _prefill(self, req: Request, row: np.ndarray) -> int:
        """Dense causal pass over the padded prompt, the first token from
        its true last position, and the prompt's K/V rows committed to the
        slot's pages (the rows past it to trash page 0)."""
        dev, ps = self.device, self.cfg.page_size
        plen = int(req.prompt.size)
        bucket = min(self._bucket_for(plen), self.max_seq_len)
        prompt = np.zeros((1, bucket), np.int64)
        prompt[0, :plen] = req.prompt
        logits = self.model(torch.from_numpy(prompt).to(dev), "prefill",
                            cache=self._prefill_cache)
        self.prefills_all += 1
        ids = torch.tensor([[req.req_id, req.output_tokens]], device=dev)
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
        self._trash_rows += bucket - plen
        return int(tok[0])  # blocks: the request's first token

    @torch.no_grad()
    def _decode(self, tokens, lengths, active, req_ids, tok_idx) -> np.ndarray:
        """One fixed-shape decode step over every slot; returns the sampled
        tokens (``pad_id`` for inactive slots)."""
        b, p = self.cfg.num_slots, self.cfg.max_pages_per_slot
        host = self._host_in.numpy()
        for i, col in enumerate((tokens, lengths, active, req_ids, tok_idx)):
            host[i * b:(i + 1) * b] = col
        host[5 * b:] = self._page_table.reshape(-1)
        dev = self._dev_in
        dev.copy_(self._host_in, non_blocking=True)
        d_tokens, d_lengths, d_active, d_req, d_idx = (dev[i * b:(i + 1) * b] for i in range(5))
        table = dev[5 * b:].view(b, p)
        logits = self.model(d_tokens[:, None], "paged_decode", decode_pos=d_lengths,
                            page_table=table, cache=self._pages,
                            paged_attention_impl=self.paged_attention_impl)
        tok = self._sample(logits[:, 0], d_req, d_idx)
        tok = torch.where(d_active.bool(), tok, self.cfg.pad_id)
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
        if req.req_id < 0:
            req.req_id = self._next_id
            self._next_id += 1
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
        return req

    @property
    def busy(self) -> bool:
        return bool(self._queue) or any(s is not None for s in self._slots)

    def _emit(self, record: dict[str, Any]) -> None:
        if self.sink is not None:
            self.sink.emit(record)

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
        self._emit({"kind": "serve", "event": "preempt", "time": time.time(),
                    "id": req.req_id, "replayed_tokens": len(req.generated)})
        req.prompt = np.concatenate([req.prompt, np.asarray(req.generated, np.int64)])
        req.max_new_tokens -= len(req.generated)
        req.generated = []
        self._free_slot(victim)
        if req.max_new_tokens >= 1:
            self._queue.appendleft(req)
        else:  # its budget was spent exactly at preemption
            self._finish(req)
        return True

    def _free_slot(self, i: int) -> None:
        self.pool.free(self._slots[i].pages)
        self._page_table[i, :] = 0
        self._slots[i] = None
        if __debug__:
            self.pool.check_invariants()

    def _ensure_pages(self, n: int) -> bool:
        """Make n pages allocatable, preempting LIFO as needed."""
        while not self.pool.can_alloc(n):
            if not self._preempt_lifo():
                return False
        return True

    def _admit(self, slot_idx: int, req: Request) -> None:
        plen = int(req.prompt.size)
        pages = self.pool.alloc(max(1, self.pool.pages_for(plen)))
        row = np.zeros((self.cfg.max_pages_per_slot,), np.int32)
        row[: len(pages)] = pages
        tok = self._prefill(req, row)
        now = self.clock()
        if req.first_token_time is None:
            req.first_token_time = now
        req.generated.append(tok)
        self._surface(req, tok, now)
        self._admit_seq += 1
        self._slots[slot_idx] = _Slot(req=req, length=plen, pages=pages, last_tok=tok,
                                      admit_seq=self._admit_seq)
        self._page_table[slot_idx, :] = row
        if self._slot_done(self._slots[slot_idx]):
            self._retire(slot_idx)

    def _slot_done(self, slot: _Slot) -> bool:
        if len(slot.req.generated) >= slot.req.max_new_tokens:
            return True
        return self.cfg.eos_id is not None and slot.last_tok == self.cfg.eos_id

    def _retire(self, i: int) -> None:
        req = self._slots[i].req
        self._free_slot(i)
        self._finish(req)

    def _finish(self, req: Request) -> None:
        req.status = "completed"
        req.done_time = self.clock()
        self._completed.append(req)
        out = req.output_tokens
        self._emit({
            "kind": "serve", "event": "request", "time": time.time(), "id": req.req_id,
            "status": req.terminal_status, "prompt_tokens": req.orig_prompt_len,
            "output_tokens": out, "queue_ms": round((req.submit_time - req.arrival_time) * 1e3, 3),
            "ttft_ms": round((req.first_token_time - req.arrival_time) * 1e3, 3),
            "decode_ms_per_token": round(
                (req.done_time - req.first_token_time) * 1e3 / max(1, out - 1), 4),
            "preemptions": req.preemptions,
        })

    # ------------------------------------------------------------- loop
    def step(self) -> list[Request]:
        """Refill free slots from the queue (a prefill each), grow the
        page tables of slots crossing a page boundary (preempting LIFO if
        the pool is dry), then one decode step over all slots; returns the
        requests completed in it."""
        done_before = len(self._completed)
        cfg = self.cfg
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
            req_ids[i], tok_idx[i] = slot.req.req_id, slot.req.output_tokens
        toks = self._decode(tokens, lengths, active, req_ids, tok_idx)
        self._step_count += 1
        n_active = int(active.sum())
        self._active_slot_steps += n_active
        self._trash_rows += b - n_active  # parked slots write trash page 0
        now = self.clock()
        self._decode_walls.append(now - t0)
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            slot.length += 1
            slot.last_tok = int(toks[i])
            slot.req.generated.append(slot.last_tok)
            self._surface(slot.req, slot.last_tok, now)
            if self._slot_done(slot):
                self._retire(i)
        return self._completed[done_before:]

    def run(self) -> list[Request]:
        """Step until the queue and every slot are empty."""
        while self.busy:
            self.step()
        return self._completed

    # -------------------------------------------------------- streaming
    def _surface(self, req: Request, tok: int, now: float) -> None:
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

    def snapshot(self):
        raise NotImplementedError("ServingEngine.snapshot is not yet ported")

    def resume(self, snap):
        raise NotImplementedError("ServingEngine.resume is not yet ported")

    def make_flight_recorder(self, *args, **kwargs):
        raise NotImplementedError("ServingEngine.make_flight_recorder is not yet ported")

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
            "page_churn": self.pool.total_allocs + self.pool.total_frees,
            "trash_rows_written": self._trash_rows,
            "decode_ms_per_step": 1e3 * sum(walls) / len(walls) if walls else None,
            "decode_steps_all": self.decode_steps_all,
            "prefills_all": self.prefills_all,
            "paged_attention_impl": self.paged_attention_impl,
        }
