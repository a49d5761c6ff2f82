"""Tensor-parallel decode and serving of GPT-2-small on the card(s).

    python scripts/tp_serve_ranks.py --mode smoke|cards --rank R --world N --port P --out DIR

Each rank builds ``LMTrainer`` at ``tensor_parallel = world`` (GPT-2-small's
decode shape: 12 layers, d 768, 12 heads over 4 KV heads, d_ff 3072, vocab
50304, RoPE, bf16; weights drawn from seed 0 at their global shapes, so a
world of one holds the same model whole), takes ``tp_decode_model()`` and
drives the port's decoders on the mesh; rank r writes ``DIR/rank{r}.pt``.

- ``smoke`` (``chip_smoke.py``'s phase 29, one card): a process a rank,
  every rank on card 0, joined by ``HostMemoryGroup`` (shared memory;
  NCCL refuses two ranks on one card, and Gloo's TCP costs 6.6-13.7 ms a
  sum on that host), each with its own slices and pools: the first
  16 requests of the serving trace submitted at once and served to the
  end with bf16 pools, then with int8 pools; greedy ``make_generator``
  (batch 4, prompt 64, 32 new tokens) and beam search (batch 2 x 4 beams,
  prompt 64, 16 new). Per run: the streams, each rank's paged kernel
  launches and plain-path calls, the first decode step's logits, the
  pools' shapes, wall seconds. ``reference()`` gives the same on one rank
  without a mesh (``decode_model``), what ``chip_smoke.py`` holds the
  ranks against.
- ``cards`` (``scripts/tp_serve_cards.sh``; rank r a process on card r,
  NCCL): the 64-request Poisson trace (64 rps, prompts and outputs
  64-256) through ``run_poisson`` with its warm-up, at the world's tensor
  size (a world of one: ``decode_model``, no process group). Records the
  ``serve_summary``, the streams by request, the paged launches, one
  decode step's host wall and device ms (kernels from one
  ``torch.profiler`` trace of 10 steps on cloned pools, NCCL's apart),
  and the host collectives apart: the replay's agreements (broadcasts
  over the host group, counted) and one NCCL sum of a step's
  activations, each timed alone.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from multiprocessing import resource_tracker, shared_memory

import numpy as np
import torch
import torch.distributed as dist

try:  # private; HostMemoryGroup was written against torch 2.11.0 (the card host's)
    from torch._C._distributed_c10d import _create_work_from_future
except ImportError as e:
    raise ImportError("HostMemoryGroup needs torch._C._distributed_c10d._create_work_from_future "
                      f"(written against torch 2.11.0; this is torch {torch.__version__})") from e

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DECODE_WIDTH = dict(num_layers=12, d_model=768, num_heads=12, num_kv_heads=4, d_ff=3072,
                    vocab_size=50304, max_seq_len=1024)
SERVE_GEOMETRY = dict(num_slots=16, page_size=16, num_pages=513, max_pages_per_slot=32)
SERVE_TRACE = dict(num_requests=64, rate_rps=64.0, prompt_len=(64, 256), output_len=(64, 256),
                   seed=0)
SMOKE_REQUESTS = 16
GEN = dict(batch=4, prompt=64, new=32)
BEAM = dict(batch=2, beams=4, prompt=64, new=16)
PROFILE_STEPS = 10


def trainer(tensor: int, device: str):
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMConfig, LMTrainer

    cfg = LMConfig(**DECODE_WIDTH, use_rope=True, compute_dtype="bfloat16", seq_len=128,
                   attention_impl="dense", tensor_parallel=tensor, device=device)
    tr = LMTrainer(cfg)
    tr.init()
    return tr


def decode_models(tensor: int, device: str) -> tuple[dict, dict]:
    """The bf16 and int8-pool decode models of this rank (``tp_decode_model``
    at tensor > 1, else ``decode_model``) and the mesh keywords."""
    tr = trainer(tensor, device)
    if tensor > 1:
        models = {"bfloat16": tr.tp_decode_model(), "int8": tr.tp_decode_model(kv_cache=True)}
        mesh_kw = dict(mesh=tr.mesh, param_specs=tr.param_specs)
    else:
        models = {"bfloat16": tr.decode_model(), "int8": tr.decode_model(kv_cache=True)}
        mesh_kw = {}
    del tr
    torch.cuda.empty_cache()
    return models, mesh_kw


def workload(n: int | None = None):
    from cs744_pytorch_distributed_tutorial_tpu_torch.serve import make_poisson_workload

    wl = make_poisson_workload(vocab_size=DECODE_WIDTH["vocab_size"], **SERVE_TRACE)
    if n is not None:
        wl = type(wl)(arrivals=wl.arrivals[:n], prompts=wl.prompts[:n],
                      max_new_tokens=wl.max_new_tokens[:n])
    return wl


def prompts(batch: int, length: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(1, DECODE_WIDTH["vocab_size"], size=(batch, length))


def streams(reqs) -> list[list[int]]:
    return [[int(t) for t in r.prompt[r.orig_prompt_len:]] + [int(t) for t in r.generated]
            for r in sorted(reqs, key=lambda r: r.req_id)]


SLOT_BYTES = 8 << 20  # a collective's largest tensor: a prefill's [1, 512, 768] bf16 is 0.8 MB
SPIN_TIMEOUT_S = 300.0
_SEGMENTS: list = []  # (shared memory, created here) of every group of this process


class HostMemoryGroup(dist.ProcessGroup):
    """A process group of the ranks of one host through shared memory, for
    ranks that share one card (``--mode smoke``): NCCL refuses two ranks on
    one card, and Gloo's TCP costs 6.6-13.7 ms a sum on the card's host.
    A collective copies each rank's tensor into its slot of one segment,
    meets the others at a barrier (a counter a rank, each written by its
    rank only, spun on), and reads the slots: a sum adds them in rank
    order, so every rank holds the same bits. Two slot banks, used in turn,
    let a rank write the next collective's slot while no rank still reads
    this one. Sums (all-reduce), broadcasts, all-gathers and barriers.
    Written against torch 2.11.0: it hands back its results through the
    private ``_create_work_from_future``, and this module's import fails,
    naming it, on a torch without it."""

    def __init__(self, store, rank: int, size: int):
        super().__init__(rank, size)
        self._rank, self._size, self._count = rank, size, 0
        if size == 1:
            return
        nbytes = 64 * size + 2 * size * SLOT_BYTES
        if rank == 0:
            shm = shared_memory.SharedMemory(create=True, size=nbytes)
            store.set("shm", shm.name)
        else:
            shm = shared_memory.SharedMemory(name=store.get("shm").decode())
            resource_tracker.unregister(shm._name, "shared_memory")  # rank 0's to unlink
        _SEGMENTS.append((shm, rank == 0))
        self._counters = np.ndarray((size, 8), np.int64, shm.buf)[:, 0]  # a cache line each
        self._slots = np.ndarray((2, size, SLOT_BYTES), np.uint8, shm.buf, offset=64 * size)

    def getBackendName(self) -> str:
        return "host_memory"

    def size(self) -> int:
        return self._size

    def _meet(self) -> np.ndarray:
        """Arrive at the next collective's barrier, wait for every rank;
        returns the collective's slot bank."""
        self._count += 1
        self._counters[self._rank] = self._count
        deadline = time.monotonic() + SPIN_TIMEOUT_S
        spins = 0
        while (self._counters < self._count).any():
            spins += 1
            if spins > 64:  # past a short spin, give the core to the other ranks
                time.sleep(0)
                if time.monotonic() > deadline:
                    raise RuntimeError(f"rank {self._rank}: a collective waited "
                                       f"{SPIN_TIMEOUT_S} s for {self._counters}")
        return self._slots[self._count % 2]

    def _put(self, bank_index: int, tensor: torch.Tensor) -> int:
        data = tensor.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy()
        if data.size > SLOT_BYTES:
            raise ValueError(f"a collective of {data.size} bytes exceeds the {SLOT_BYTES}-byte slot")
        self._slots[bank_index, self._rank, :data.size] = data
        return data.size

    def _get(self, bank: np.ndarray, rank: int, like: torch.Tensor) -> torch.Tensor:
        n = like.numel() * like.element_size()
        return torch.from_numpy(bank[rank, :n].copy()).view(like.dtype).view(like.shape)

    def _done(self, result):
        fut = torch.futures.Future()
        fut.set_result(result)
        return _create_work_from_future(fut)

    def allreduce(self, tensors, opts=None):
        if opts is not None and opts.reduceOp != dist.ReduceOp.SUM:
            raise NotImplementedError(f"host_memory sums only, got {opts.reduceOp}")
        for t in tensors:
            if self._size > 1:
                self._put((self._count + 1) % 2, t)
                bank = self._meet()
                total = self._get(bank, 0, t)
                for r in range(1, self._size):
                    total += self._get(bank, r, t)
                t.copy_(total)
        return self._done(tensors)

    def broadcast(self, tensors, opts):
        for t in tensors:
            if self._size > 1:
                if self._rank == opts.rootRank:
                    self._put((self._count + 1) % 2, t)
                bank = self._meet()
                if self._rank != opts.rootRank:
                    t.copy_(self._get(bank, opts.rootRank, t))
        return self._done(tensors)

    def allgather(self, outputs, tensors, opts=None):
        for out, t in zip(outputs, tensors):
            if self._size > 1:
                self._put((self._count + 1) % 2, t)
                bank = self._meet()
            for r, o in enumerate(out):
                o.copy_(t if self._size == 1 else self._get(bank, r, o))
        return self._done(outputs)

    def barrier(self, opts=None):
        if self._size > 1:
            self._meet()
        return self._done([])


def _make_host_memory_group(store, rank, size, timeout):
    return HostMemoryGroup(store, rank, size)


def close_segments() -> None:
    """Detach this process's segments; their creators unlink them."""
    for shm, created in _SEGMENTS:
        shm.close()
        if created:
            shm.unlink()
    _SEGMENTS.clear()


class PlainCalls:
    """Counts the model's calls of the paged attention's plain version (the
    gather path) while it is entered: on the card the engine must take the
    kernel every call."""

    def __enter__(self):
        from cs744_pytorch_distributed_tutorial_tpu_torch.models import transformer as TM

        self.module, self.real, self.calls = TM, TM.paged_attention_plain, 0

        def counted(*args, **kwargs):
            self.calls += 1
            return self.real(*args, **kwargs)

        TM.paged_attention_plain = counted
        return self

    def __exit__(self, *exc):
        self.module.paged_attention_plain = self.real


def first_decode_logits(model) -> tuple[dict, object]:
    """A hook keeping the logits [slots, vocab] (fp32, on the host) of the
    model's first ``paged_decode`` call; (the box, the hook's handle)."""
    box: dict = {}

    def hook(module, args, kwargs, output):
        mode = args[1] if len(args) > 1 else kwargs.get("mode")
        if mode == "paged_decode" and "logits" not in box:
            box["logits"] = output[:, 0].float().cpu()

    return box, model.register_forward_hook(hook, with_kwargs=True)


def serve_at_once(model, mesh_kw: dict, wl) -> dict:
    """Every request of ``wl`` submitted at once, served to the end."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import paged_attention as PA
    from cs744_pytorch_distributed_tutorial_tpu_torch.serve import (
        Request,
        ServeConfig,
        ServingEngine,
    )

    t0 = time.perf_counter()
    eng = ServingEngine(model, ServeConfig(**SERVE_GEOMETRY), device="cuda", **mesh_kw)
    box, handle = first_decode_logits(model)
    PA.reset_launch_count()
    torch.cuda.synchronize()
    with PlainCalls() as plain:
        reqs = [eng.submit(Request(prompt=p, max_new_tokens=int(n)))
                for p, n in zip(wl.prompts, wl.max_new_tokens)]
        eng.run()
        torch.cuda.synchronize()
    handle.remove()
    pool = eng._pages[0]
    return {
        "streams": streams(reqs), "stats": eng.stats(), "launches": PA.launch_count(),
        "plain_calls": plain.calls, "first_logits": box["logits"],
        "pool_shape": list(pool.key.shape), "pool_dtype": str(pool.key.dtype),
        "scale_shape": None if pool.key_scale is None else list(pool.key_scale.shape),
        "pools_contiguous": all(t.is_contiguous() for c in eng._pages for t in
                                (c.key, c.value, c.key_scale, c.value_scale) if t is not None),
        "seconds": time.perf_counter() - t0,
    }


def decoders(model, mesh_kw: dict) -> dict:
    """Greedy generation and beam search on fixed prompts."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.infer import (
        make_beam_searcher,
        make_generator,
    )

    out = {}
    t0 = time.perf_counter()
    gen = make_generator(model, max_new_tokens=GEN["new"], temperature=0.0, device="cuda",
                         **mesh_kw)
    out["generate"] = gen(prompts(GEN["batch"], GEN["prompt"], 1)).cpu()
    out["generate_timing"] = gen.timing
    t1 = time.perf_counter()
    search = make_beam_searcher(model, beam_size=BEAM["beams"], max_new_tokens=BEAM["new"],
                                device="cuda", **mesh_kw)
    tokens, scores = search(prompts(BEAM["batch"], BEAM["prompt"], 2))
    out["beam"], out["beam_scores"] = tokens.cpu(), scores.cpu()
    out["beam_timing"] = search.timing
    out["seconds"] = {"generate": t1 - t0, "beam": time.perf_counter() - t1}
    return out


def reference() -> dict:
    """The smoke's runs on one rank without a mesh (the weights whole)."""
    t0 = time.perf_counter()
    models, _ = decode_models(1, "cuda")
    res = {"build_seconds": time.perf_counter() - t0}
    wl = workload(SMOKE_REQUESTS)
    res.update({name: serve_at_once(model, {}, wl) for name, model in models.items()})
    res.update(decoders(models["bfloat16"], {}))
    return res


def sum_ms(mesh) -> float:
    """Host ms of one sum over the tensor axis of a decode step's
    activations ([16, 1, 768] bf16), the mean of 50 after a warm-up."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import collectives as C

    x = torch.ones(SERVE_GEOMETRY["num_slots"], 1, DECODE_WIDTH["d_model"],
                   dtype=torch.bfloat16, device="cuda")
    C.axis_sum(x, mesh, "tensor")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        C.axis_sum(x, mesh, "tensor")
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / 50


def agree_ms(eng) -> float:
    """Host ms of one ``engine.agree`` (a broadcast of an int64 from rank 0
    over the host group; nothing at a world of one), the mean of 50."""
    eng.agree(0)
    t0 = time.perf_counter()
    for _ in range(50):
        eng.agree(0)
    return (time.perf_counter() - t0) * 1e3 / 50


def smoke(world: int) -> dict:
    t0 = time.perf_counter()
    models, mesh_kw = decode_models(world, "cuda")
    res = {"build_seconds": time.perf_counter() - t0,
           "sum_ms": sum_ms(mesh_kw["mesh"]) if mesh_kw else None}
    wl = workload(SMOKE_REQUESTS)
    res.update({name: serve_at_once(model, mesh_kw, wl) for name, model in models.items()})
    res.update(decoders(models["bfloat16"], mesh_kw))
    return res


def device_ms_a_step(eng) -> dict:
    """One decode step's kernel ms on this rank's card: ``PROFILE_STEPS``
    steps with every slot live at depth 256, on cloned pools, in one
    ``torch.profiler`` trace (taken once, so every rank runs the same
    steps; an empty trace gives None), NCCL's kernels apart."""
    from torch.profiler import ProfilerActivity, profile

    from cs744_pytorch_distributed_tutorial_tpu_torch.models.transformer import KVCache

    cfg = eng.cfg
    b, p = cfg.num_slots, cfg.max_pages_per_slot
    table = (1 + np.arange(b * p) % (cfg.num_pages - 1)).reshape(b, p).astype(np.int32)
    args = (np.ones((b,), np.int32), np.full((b,), 256, np.int32), np.ones((b,), np.int32),
            np.arange(b, dtype=np.int32), np.zeros((b,), np.int32), table)
    live = eng._pages
    eng._pages = [KVCache(*(None if t is None else t.clone() for t in
                            (c.key, c.value, c.key_scale, c.value_scale))) for c in live]
    try:
        eng._decode_step(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_STEPS):
                eng._decode_step(*args)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    finally:
        eng._pages = live
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        return {"wall_ms": wall, "device_ms": None, "nccl_ms": None}
    nccl = sum(e.time_range.elapsed_us() for e in kernels if "nccl" in e.name.lower())
    total = sum(e.time_range.elapsed_us() for e in kernels)
    return {"wall_ms": wall, "device_ms": (total - nccl) / PROFILE_STEPS / 1e3,
            "nccl_ms": nccl / PROFILE_STEPS / 1e3}


def cards(world: int) -> dict:
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import paged_attention as PA
    from cs744_pytorch_distributed_tutorial_tpu_torch.serve import (
        ServeConfig,
        ServingEngine,
        run_poisson,
    )

    models, mesh_kw = decode_models(world, "cuda")
    eng = ServingEngine(models["bfloat16"], ServeConfig(**SERVE_GEOMETRY), device="cuda",
                        **mesh_kw)
    agree, agreements = eng.agree, [0]

    def counted(value):
        agreements[0] += 1
        return agree(value)

    eng.agree = counted
    PA.reset_launch_count()
    summary = run_poisson(eng, workload())
    torch.cuda.synchronize()
    launches = PA.launch_count()
    steps, agreed = eng.decode_steps_all, agreements[0]
    step = device_ms_a_step(eng)
    host = {"agreements": agreed, "agreements_a_step": agreed / summary["decode_steps"],
            "agree_ms": agree_ms(eng), "sum_ms": sum_ms(mesh_kw["mesh"]) if mesh_kw else None}
    return {"summary": summary, "streams": streams(eng._completed), "launches": launches,
            "decode_steps_all": steps, "step": step, "host_collectives": host}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("smoke", "cards"), required=True)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tp_serve_ranks: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    if args.mode == "smoke":  # every rank on card 0, joined through shared memory
        dist.Backend.register_backend("host_memory", _make_host_memory_group,
                                      devices=["cpu", "cuda"])
        torch.cuda.set_device(0)
        torch.set_num_threads(2)  # four ranks and the reference share the host's cores
        backend = "host_memory"
    else:
        torch.cuda.set_device(args.rank)
        backend = "nccl"
    if args.world > 1:
        dist.init_process_group(backend, init_method=f"tcp://localhost:{args.port}",
                                world_size=args.world, rank=args.rank)
    try:
        res = smoke(args.world) if args.mode == "smoke" else cards(args.world)
        if dist.is_initialized():
            dist.barrier()  # no rank still reads a segment its creator unlinks
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        close_segments()
    res["card"] = torch.cuda.get_device_name()
    torch.save(res, os.path.join(args.out, f"rank{args.rank}.pt"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
