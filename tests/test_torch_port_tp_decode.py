"""Tensor-parallel decode and serving in the port (``make_generator``,
``make_beam_searcher`` and ``ServingEngine`` with ``mesh=`` and
``param_specs=`` on ``LMTrainer.tp_decode_model()``) on 4 Gloo ranks,
against the JAX package's ``shard_map`` path on 4 host devices with the
same meshes, ``{data 2, tensor 2}`` and ``{tensor 4}``.

The LM is the JAX tests' (``tests/test_tp_decode.py``): vocab 64, 2
layers, 4 heads, d 32, d_ff 64, max_seq 64, dense, fp32, seed 11,
trained 2 steps by the JAX ``LMTrainer`` on ``{data 2, tensor 2}``; a
second one with 2 KV heads and RoPE. Each rank loads its slices of the
JAX weights (``models/convert.py``). One launch of 4 processes (this
file, run as a script) runs every case while JAX runs its own:

- greedy ``make_generator`` tokens equal to JAX's tensor-parallel
  generator's and to the port's gathered decode (``decode_model``),
  exactly, on every rank; prefill logits against the JAX model's within
  rtol 1e-5, atol 1e-6, the same bits on every rank;
- beam search: tokens equal to JAX's, scores within rtol 1e-5 (JAX's own
  bound against its gathered path);
- sampling: ``jax.random`` cannot be reproduced in PyTorch, so sampled
  tokens are not held to JAX's; they are held deterministic for a
  generator seed, the same on the tensor ranks of a data shard and
  different across data shards (JAX's
  ``test_sampling_decorrelated_across_data_shards``);
- the engine: ``tests/test_serve.py``'s tensor-parallel case (2 slots,
  page 4, 33 pages, 8 a slot, requests (4, 6), (7, 5), (5, 8) from
  ``default_rng(23)``) equal to the JAX engine's on the same mesh and to
  the port's mesh-free engine on gathered weights; each rank's pools
  ``[33, 4, Hkv / T, 8]``, allocated whole; then int8 pools, a pool that
  preempts, a mid-run ``snapshot``/``resume`` and ``scan_layers`` pools
  (one contiguous stack a pool), each equal to the JAX engine's run of
  the same on the same mesh and to the mesh-free engine's; and, where
  JAX has no counterpart (one controller reads one clock), a rank whose
  clock runs 1,000 times as fast as rank 0's (under a guard whose
  deadlines that clock would expire) and ``run_serve_with_recovery``
  through a NaN decode step and an engine crash with that rank's clock
  ahead of the arrivals: equal to the mesh-free engine's streams on rank
  0's clock, every rank's streams the same, and rank 0's records (through
  a tracer's windows) equal to the mesh-free engine's on the same clock,
  field for field but the wall time, with nothing written on the other
  ranks.

The JAX refusals (a tensor-parallel model without ``mesh=``, ``mesh=``
without ``param_specs``, a mesh without the model's tensor axis,
``tp_decode_model`` under fsdp or expert parallelism) keep their types
and messages.
"""

import itertools
import os
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

WORLD, V = 4, 64
SMALL = dict(vocab_size=V, num_layers=2, num_heads=4, d_model=32, d_ff=64, max_seq_len=64,
             attention_impl="dense", global_batch_size=4, seq_len=16, seed=11)
GQA = dict(use_rope=True, num_kv_heads=2)
MODELS = {"base": {}, "gqa": GQA}
LAYOUTS = {"data2_tensor2": (2, 2), "tensor4": (1, 4)}  # (data, tensor)
# name: (layout, model); the GQA model's 2 KV heads do not split 4 ways.
GREEDY = {"data2_tensor2": ("data2_tensor2", "base"), "tensor4": ("tensor4", "base"),
          "data2_tensor2_gqa_rope": ("data2_tensor2", "gqa")}
PROMPT = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12], [13, 14, 15, 16]], np.int64)
BEAM_PROMPT = np.asarray([[1, 2, 3, 4], [9, 10, 11, 12]] * 2, np.int64)
NEW, BEAM, BEAM_NEW = 8, 3, 5
SERVE = dict(num_slots=2, page_size=4, num_pages=33, max_pages_per_slot=8)
SERVE_CASES = [(4, 6), (7, 5), (5, 8)]
# Engine variants: (layout, model options, ServeConfig overrides).
VARIANTS = {
    "int8_pools": ("tensor4", {}, {}),
    "preempting_pool": ("data2_tensor2", {}, dict(num_pages=5)),
    "snapshot_resume": ("data2_tensor2", {}, {}),
    "scan_layers_pools": ("tensor4", dict(scan_layers=True), {}),
    "skewed_clock": ("data2_tensor2", {}, {}),
    "chaos_recovery": ("data2_tensor2", {}, {}),
}
# The variants JAX's tensor-parallel engine runs too.
JAX_VARIANTS = ("int8_pools", "preempting_pool", "snapshot_resume", "scan_layers_pools")
FAULTS = {2: "decode_nan", 5: "engine_crash"}  # decode calls of run_serve_with_recovery
ARRIVALS_S = (0.0, 0.004, 0.008)  # the recovery run's, on rank 0's clock of 1 ms a reading
DEADLINE_S = 0.5  # rank 0's clock ticks 1 ms a reading; the skewed rank's 1 s
TOL = {"logits": dict(rtol=1e-5, atol=1e-6), "scores": dict(rtol=1e-5)}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _prompts():
    rng = np.random.default_rng(23)
    return [rng.integers(1, V, size=plen).astype(np.int64) for plen, _ in SERVE_CASES]


class _ListSink:
    def __init__(self):
        self.records = []

    def emit(self, record):
        self.records.append(dict(record))


def _ticks(step: float):
    """A clock that advances ``step`` seconds at each reading."""
    counter = itertools.count()
    return lambda: next(counter) * step


# ------------------------------------------------------------------ ranks
def _trainer(layout: str, **kw):
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMConfig, LMTrainer

    d, t = LAYOUTS[layout]
    return LMTrainer(LMConfig(**{**SMALL, **kw}, data_parallel=d, tensor_parallel=t,
                              device="cpu"))


def _serve(engine, steps: int | None = None):
    """The serving case's requests submitted at once, run to the end (or
    ``steps`` steps); their requests."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.serve import Request

    reqs = [engine.submit(Request(prompt=p.copy(), max_new_tokens=n))
            for p, (_, n) in zip(_prompts(), SERVE_CASES)]
    if steps is None:
        engine.run()
    else:
        for _ in range(steps):
            engine.step()
    return reqs


def _streams(reqs) -> list:
    return [[int(t) for t in r.prompt[r.orig_prompt_len:]] + [int(t) for t in r.generated]
            for r in reqs]


def _pools(engine) -> dict:
    pool = engine._pages[0]
    return {"shape": tuple(pool.key.shape), "dtype": str(pool.key.dtype),
            "scale_shape": None if pool.key_scale is None else tuple(pool.key_scale.shape),
            "contiguous": all(t.is_contiguous() for c in engine._pages
                              for t in (c.key, c.value) if t is not None),
            "stacked": tuple(pool.key._base.shape) if pool.key._base is not None else None}


def _engine_case(res: dict, name: str, tr, serve_kw: dict, variant: str | None) -> None:
    from cs744_pytorch_distributed_tutorial_tpu_torch.obs.serve_trace import ServeTracer
    from cs744_pytorch_distributed_tutorial_tpu_torch.serve import (
        GuardConfig,
        ServeConfig,
        ServeGuard,
        ServingEngine,
    )

    kv_cache = variant == "int8_pools"
    cfg = ServeConfig(**{**SERVE, **serve_kw})
    model = tr.tp_decode_model(kv_cache=kv_cache)
    full = tr.decode_model(kv_cache=kv_cache)  # the gathered weights, a world of one
    rank = tr.mesh.rank
    kw = {}
    if variant == "skewed_clock":
        kw = dict(clock=_ticks(1.0 if rank == 1 else 1e-3), sink=_ListSink(),
                  tracer=ServeTracer(cfg.num_slots, window_every_s=0.01),
                  guard=ServeGuard(GuardConfig(deadline_s=DEADLINE_S)))
    if variant == "chaos_recovery":
        res[f"{name}/streams"], res[f"{name}/stats"] = _recovered(
            model, cfg, dict(mesh=tr.mesh, param_specs=tr.param_specs,
                             clock=_ticks(1.0 if rank == 1 else 1e-3)))
        res[f"{name}/gathered"], res[f"{name}/gathered_stats"] = _recovered(
            full, cfg, dict(clock=_ticks(1e-3)))
        return
    eng = ServingEngine(model, cfg, device="cpu", mesh=tr.mesh, param_specs=tr.param_specs, **kw)
    if variant == "snapshot_resume":
        first = _serve(eng, steps=4)
        snap = eng.snapshot()
        assert snap.requests and eng.busy
        done = {r.req_id: r for r in eng._completed}
        eng = ServingEngine(model, cfg, device="cpu", mesh=tr.mesh, param_specs=tr.param_specs)
        resumed = {r.req_id: r for r in eng.resume(snap)}
        eng.run()
        res[f"{name}/resumed"] = len(resumed)
        reqs = [done.get(r.req_id) or resumed[r.req_id] for r in first]
    else:
        reqs = _serve(eng)
    res[f"{name}/streams"] = _streams(reqs)
    res[f"{name}/stats"] = eng.stats()
    res[f"{name}/pools"] = _pools(eng)
    if variant == "skewed_clock":
        res[f"{name}/records"] = eng.sink.records if eng.sink is not None else None
        res[f"{name}/sink_records"] = kw["sink"].records
        res[f"{name}/statuses"] = [r.terminal_status for r in reqs]
        if rank == 0:  # the mesh-free engine on rank 0's clock
            sink = _ListSink()
            ref = ServingEngine(full, cfg, device="cpu", clock=_ticks(1e-3), sink=sink,
                                tracer=ServeTracer(cfg.num_slots, window_every_s=0.01),
                                guard=ServeGuard(GuardConfig(deadline_s=DEADLINE_S)))
            res[f"{name}/gathered"] = _streams(_serve(ref))
            res[f"{name}/gathered_records"] = sink.records
        return
    res[f"{name}/gathered"] = _streams(_serve(ServingEngine(full, cfg, device="cpu")))


def _recovered(model, cfg, engine_kw: dict) -> tuple[list, dict]:
    """The serving case through ``run_serve_with_recovery``, arriving at
    ``ARRIVALS_S`` on the engines' clock (one clock over the engines), with
    a NaN decode step and an engine crash (two restarts, each resuming the
    dead engine's snapshot); the streams as they surfaced, and the
    summary."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.serve import (
        ServingEngine,
        Workload,
        run_serve_with_recovery,
    )
    from cs744_pytorch_distributed_tutorial_tpu_torch.utils.chaos import (
        FaultSchedule,
        ServeChaosMonkey,
    )

    surfaced: dict[int, list] = {}

    def on_token(req, tok):
        surfaced.setdefault(req.req_id, []).append(int(tok))

    wl = Workload(arrivals=np.asarray(ARRIVALS_S), prompts=_prompts(),
                  max_new_tokens=np.asarray([n for _, n in SERVE_CASES], np.int32))
    rec = run_serve_with_recovery(
        lambda: ServingEngine(model, cfg, device="cpu", on_token=on_token, **engine_kw), wl,
        monkey=ServeChaosMonkey(FaultSchedule(dict(FAULTS))), max_restarts=2, warmup=False)
    return [surfaced[i] for i in sorted(surfaced)], rec


def _errors(res: dict) -> None:
    """``tp_decode_model``'s refusals, on trainers of 4 ranks."""
    for name, kw, layout in (("fsdp", dict(fsdp=True), "data2_tensor2"),
                             ("expert_parallel", dict(moe_experts=4, moe_expert_parallel=True),
                              "data2_tensor2")):
        tr = _trainer(layout, **kw)
        try:
            tr.tp_decode_model()
        except ValueError as e:
            res[f"error/{name}"] = str(e)


def _run(res: dict, inits: dict) -> None:
    from cs744_pytorch_distributed_tutorial_tpu_torch.infer import (
        make_beam_searcher,
        make_generator,
    )
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.transformer import (
        stack_block_params,
    )

    for name, (layout, model_key) in GREEDY.items():
        tr = _trainer(layout, **MODELS[model_key])
        tr.init(state_dict=inits[model_key])
        model = tr.tp_decode_model()
        mesh_kw = dict(mesh=tr.mesh, param_specs=tr.param_specs, device="cpu")
        res[f"{name}/greedy"] = make_generator(model, max_new_tokens=NEW, temperature=0.0,
                                               **mesh_kw)(PROMPT).numpy()
        with torch.no_grad():
            res[f"{name}/logits"] = model(torch.from_numpy(PROMPT), "prefill",
                                          cache=model.init_cache(len(PROMPT))).numpy()
        res[f"{name}/cache_shape"] = tuple(model.init_cache(1)[0].key.shape)
        full = tr.decode_model()
        res[f"{name}/gathered"] = make_generator(full, max_new_tokens=NEW, temperature=0.0,
                                                 device="cpu")(PROMPT).numpy()
        if model_key == "base":
            tok, score = make_beam_searcher(model, beam_size=BEAM, max_new_tokens=BEAM_NEW,
                                            **mesh_kw)(BEAM_PROMPT)
            res[f"{name}/beam"] = (tok.numpy(), score.numpy())
            tok, score = make_beam_searcher(full, beam_size=BEAM, max_new_tokens=BEAM_NEW,
                                            device="cpu")(BEAM_PROMPT)
            res[f"{name}/beam_gathered"] = (tok.numpy(), score.numpy())
            _engine_case(res, f"engine/{layout}", tr, {}, None)
        if name == "data2_tensor2":
            sample = make_generator(model, max_new_tokens=16, temperature=1.0, top_k=8,
                                    **mesh_kw)
            same = np.repeat(PROMPT[:1], 4, axis=0)
            res["sample/a"] = sample(same, torch.Generator().manual_seed(3)).numpy()
            res["sample/b"] = sample(same, torch.Generator().manual_seed(3)).numpy()
            res["sample/other_seed"] = sample(same, torch.Generator().manual_seed(4)).numpy()
    for name, (layout, model_kw, serve_kw) in VARIANTS.items():
        tr = _trainer(layout, **model_kw)
        init = inits["base"]
        tr.init(state_dict=stack_block_params(init) if model_kw.get("scan_layers") else init)
        _engine_case(res, f"variant/{name}", tr, serve_kw, name)
    _errors(res)


def _worker(rank: int, port: int, tmp: str, out_path: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=WORLD,
                            rank=rank)
    try:
        with open(os.path.join(tmp, "inits.pkl"), "rb") as f:
            inits = pickle.load(f)
        res: dict = {}
        _run(res, inits)
        with open(out_path, "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# -------------------------------------------------------------------- JAX
def _jax_trainer(layout: str, **kw):
    import jax

    from cs744_pytorch_distributed_tutorial_tpu.parallel import make_mesh
    from cs744_pytorch_distributed_tutorial_tpu.train.lm import LMConfig, LMTrainer

    d, t = LAYOUTS[layout]
    mesh = make_mesh({"data": d, "seq": 1, "tensor": t}, devices=jax.devices()[:WORLD])
    return LMTrainer(LMConfig(**{**SMALL, **kw}, data_parallel=d, tensor_parallel=t), mesh=mesh)


def _jax_trained(model_key: str):
    """JAX's trainer on {data 2, tensor 2}, 2 steps (``tests/test_tp_decode.py``);
    (trainer, sharded params, gathered host params)."""
    from cs744_pytorch_distributed_tutorial_tpu.data.text import synthetic_tokens

    tr = _jax_trainer("data2_tensor2", **MODELS[model_key])
    params, opt_state = tr.init()
    toks = synthetic_tokens(8, 16, V, seed=0)
    for s in range(2):
        x, y = tr.shard_batch(toks[s * 4:s * 4 + 4])
        params, opt_state, _ = tr.train_step(params, opt_state, x, y)
    return tr, params, tr.gather_for_decode(params)


def _jax_tp_prefill(tr):
    """The JAX tensor-parallel model's prefill logits under ``shard_map``
    (the prompt's rows over data, the logits replicated over tensor)."""
    import jax
    from jax.sharding import PartitionSpec as P

    model = tr.tp_decode_model()
    rows = P("data")

    def prefill(params, prompt):
        return model.apply({"params": params}, prompt, mode="prefill", mutable=["cache"])[0]

    return jax.jit(jax.shard_map(prefill, mesh=tr.mesh, in_specs=(tr.param_specs, rows),
                                 out_specs=rows, check_vma=False))


def _jax_runs(trained: dict) -> dict:
    """JAX's tensor-parallel generator, beam search and engine."""
    import jax

    from cs744_pytorch_distributed_tutorial_tpu.infer import make_beam_searcher, make_generator
    from cs744_pytorch_distributed_tutorial_tpu.models.transformer import stack_block_params

    want = {}
    for name, (layout, model_key) in GREEDY.items():
        tr22, sharded, host = trained[model_key]
        tr = tr22 if layout == "data2_tensor2" else _jax_trainer(layout, **MODELS[model_key])
        params = sharded if tr is tr22 else host
        mesh_kw = dict(mesh=tr.mesh, param_specs=tr.param_specs)
        gen = make_generator(tr.tp_decode_model(), max_new_tokens=NEW, temperature=0.0,
                             **mesh_kw)
        want[f"{name}/greedy"] = np.asarray(gen(params, PROMPT.astype(np.int32),
                                                jax.random.key(0)))
        want[f"{name}/logits"] = np.asarray(_jax_tp_prefill(tr)(params, PROMPT.astype(np.int32)))
        if model_key != "base":
            continue
        search = make_beam_searcher(tr.tp_decode_model(), beam_size=BEAM,
                                    max_new_tokens=BEAM_NEW, **mesh_kw)
        tok, score = search(params, BEAM_PROMPT.astype(np.int32))
        want[f"{name}/beam"] = (np.asarray(tok), np.asarray(score))
        want[f"engine/{layout}/streams"] = _jax_engine(tr, params, {}, None)
    tr22, sharded, host = trained["base"]
    for name in JAX_VARIANTS:
        layout, model_kw, serve_kw = VARIANTS[name]
        if model_kw:
            tr, params = _jax_trainer(layout, **model_kw), stack_block_params(host)
        elif layout == "data2_tensor2":
            tr, params = tr22, sharded
        else:
            tr, params = _jax_trainer(layout), host
        want[f"variant/{name}/streams"] = _jax_engine(tr, params, serve_kw, name)
    return want


def _jax_engine(tr, params, serve_kw: dict, variant: str | None) -> list:
    """The JAX tensor-parallel engine's streams on the serving case."""
    from cs744_pytorch_distributed_tutorial_tpu.serve import Request, ServeConfig, ServingEngine

    model = tr.tp_decode_model()
    if variant == "int8_pools":
        model = model.clone(quant_kv_cache=True)
    cfg = ServeConfig(**{**SERVE, **serve_kw})

    def engine():
        return ServingEngine(model, params, cfg, mesh=tr.mesh, param_specs=tr.param_specs)

    eng = engine()
    reqs = [eng.submit(Request(prompt=p.astype(np.int32), max_new_tokens=n))
            for p, (_, n) in zip(_prompts(), SERVE_CASES)]
    if variant == "snapshot_resume":  # as the ranks do: 4 steps, then a new engine
        for _ in range(4):
            eng.step()
        snap = eng.snapshot()
        done = {r.req_id: r for r in eng._completed}
        eng = engine()
        resumed = {r.req_id: r for r in eng.resume(snap)}
        eng.run()
        reqs = [done.get(r.req_id) or resumed[r.req_id] for r in reqs]
    else:
        eng.run()
    return _streams(reqs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each rank's results, JAX's)."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import lm_params_from_jax

    tmp = tmp_path_factory.mktemp("tp_decode")
    trained = {key: _jax_trained(key) for key in MODELS}
    with open(tmp / "inits.pkl", "wb") as f:
        pickle.dump({key: lm_params_from_jax(host) for key, (_, _, host) in trained.items()}, f)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(port),
                               str(tmp), str(tmp / f"r{r}.pkl")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    try:  # the ranks decode while JAX compiles and runs
        want = _jax_runs(trained)
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    results = []
    for r in range(WORLD):
        with open(tmp / f"r{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results, want


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("name", list(GREEDY))
def test_greedy_tokens_are_jax_s_and_the_gathered_decode_s(runs, name):
    results, want = runs
    for r, res in enumerate(results):
        np.testing.assert_array_equal(res[f"{name}/greedy"], want[f"{name}/greedy"],
                                      err_msg=f"{name}, rank {r}")
        np.testing.assert_array_equal(res[f"{name}/greedy"], res[f"{name}/gathered"],
                                      err_msg=f"{name}, rank {r}")


@pytest.mark.parametrize("name", list(GREEDY))
def test_prefill_logits_match_jax_on_this_rank_s_heads(runs, name):
    """Every rank's logits within the bound of the JAX model's, the same
    bits on every rank; each rank's cache holds its Hkv / T heads."""
    results, want = runs
    layout, model_key = GREEDY[name]
    kv = MODELS[model_key].get("num_kv_heads", SMALL["num_heads"]) // LAYOUTS[layout][1]
    for r, res in enumerate(results):
        np.testing.assert_allclose(res[f"{name}/logits"], want[f"{name}/logits"],
                                   **TOL["logits"], err_msg=f"{name}, rank {r}")
        np.testing.assert_array_equal(res[f"{name}/logits"], results[0][f"{name}/logits"])
        assert res[f"{name}/cache_shape"] == (1, SMALL["max_seq_len"], kv, 8)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_beam_search_is_jax_s(runs, layout):
    results, want = runs
    jtok, jscore = want[f"{layout}/beam"]
    for r, res in enumerate(results):
        tok, score = res[f"{layout}/beam"]
        np.testing.assert_array_equal(tok, jtok, err_msg=f"{layout}, rank {r}")
        np.testing.assert_allclose(score, jscore, **TOL["scores"], err_msg=f"{layout}, rank {r}")
        gtok, gscore = res[f"{layout}/beam_gathered"]
        np.testing.assert_array_equal(tok, gtok)
        np.testing.assert_allclose(score, gscore, **TOL["scores"])


def test_sampling_is_deterministic_and_the_same_on_the_tensor_ranks(runs):
    """A sampled row cannot equal JAX's (``jax.random`` is not reproduced);
    it is a function of the generator's seed, the same on every rank (the
    global rows gathered), and another seed draws another stream."""
    results, _ = runs
    a = results[0]["sample/a"]
    assert a.shape == (4, 16) and ((0 <= a) & (a < V)).all()
    for res in results:
        np.testing.assert_array_equal(res["sample/a"], a)
        np.testing.assert_array_equal(res["sample/b"], a)
    assert not np.array_equal(results[0]["sample/other_seed"], a)


def test_sampling_decorrelated_across_data_shards(runs):
    """Four identical rows, rows 0-1 on data shard 0 and 2-3 on shard 1:
    the shards draw different streams (JAX's ``fold_in`` of the data
    coordinate)."""
    results, _ = runs
    out = results[0]["sample/a"]
    assert not np.array_equal(out[0], out[2]) or not np.array_equal(out[1], out[3])


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_engine_streams_are_jax_s_on_this_rank_s_pools(runs, layout):
    """``tests/test_serve.py::test_tp_engine_greedy_matches_gathered`` in the
    port: the JAX engine's tokens on the same mesh, the mesh-free engine's
    on gathered weights, every rank's pools its own KV heads."""
    results, want = runs
    key = f"engine/{layout}"
    kv = SMALL["num_heads"] // LAYOUTS[layout][1]
    for r, res in enumerate(results):
        assert res[f"{key}/streams"] == want[f"{key}/streams"], (layout, r)
        assert res[f"{key}/streams"] == res[f"{key}/gathered"], (layout, r)
        pools = res[f"{key}/pools"]
        assert pools["shape"] == (SERVE["num_pages"], SERVE["page_size"], kv, 8)
        assert pools["contiguous"] and pools["stacked"] is None


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_engine_variants_match_the_mesh_free_engine(runs, variant):
    """Each variant's streams on every rank: the mesh-free engine's on
    gathered weights, and the JAX tensor-parallel engine's where JAX runs
    the variant (``JAX_VARIANTS``)."""
    results, want = runs
    key = f"variant/{variant}"
    layout = VARIANTS[variant][0]
    kv = SMALL["num_heads"] // LAYOUTS[layout][1]
    pages, ps = SERVE["num_pages"], SERVE["page_size"]
    gathered = results[0][f"{key}/gathered"]
    for r, res in enumerate(results):
        assert res[f"{key}/streams"] == gathered, (variant, r)
        if variant in JAX_VARIANTS:
            assert res[f"{key}/streams"] == want[f"{key}/streams"], (variant, r)
        pools = res.get(f"{key}/pools", {"contiguous": True})  # the recovery run's engines die
        assert pools["contiguous"], (variant, r)
        if variant == "int8_pools":
            assert pools["dtype"] == "torch.int8"
            assert pools["shape"] == (pages, ps, kv, 8) and pools["scale_shape"] == (pages, ps, kv)
        elif variant == "scan_layers_pools":  # a layer's pool is a slice of one stack
            assert pools["stacked"] == (SMALL["num_layers"], pages, ps, kv, 8)
        elif variant == "preempting_pool":
            assert res[f"{key}/stats"]["preemptions"] > 0
        elif variant == "snapshot_resume":  # after 4 steps: one done, one in flight, one queued
            assert res[f"{key}/resumed"] == 2
        elif variant == "chaos_recovery":  # both faults restart, on the mesh as without it
            assert res[f"{key}/stats"]["restarts"] == len(FAULTS)
            assert res[f"{key}/gathered_stats"]["restarts"] == len(FAULTS)
    if variant == "skewed_clock":
        _check_records(results, key)


def _check_records(results, key):
    """Rank 0's records equal the mesh-free engine's on the same clock
    (bar the wall time); the other ranks write none; no deadline expired,
    though the skewed rank's own clock would have expired every one."""
    def strip(records):
        return [{k: v for k, v in rec.items() if k != "time"} for rec in records]

    rank0 = results[0]
    assert rank0[f"{key}/sink_records"], "rank 0 wrote no record"
    assert any(rec.get("kind") == "serve_window" for rec in rank0[f"{key}/sink_records"])
    assert strip(rank0[f"{key}/sink_records"]) == strip(rank0[f"{key}/gathered_records"])
    for res in results[1:]:
        assert res[f"{key}/sink_records"] == [] and res[f"{key}/records"] is None
    for res in results:
        assert res[f"{key}/statuses"] == ["completed"] * len(SERVE_CASES)


# ------------------------------------------------- refusals, in one process
def _stub_mesh(data: int, tensor: int):
    """A mesh's layout for building a model's slices in one process (the
    checks below refuse before any collective)."""
    return types.SimpleNamespace(sizes={"data": data, "seq": 1, "tensor": tensor},
                                 coords={"data": 0, "seq": 0, "tensor": 0})


def _port_tp_model(tensor: int = 2, **kw):
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.transformer import TransformerLM

    model_kw = {**{k: SMALL[k] for k in ("vocab_size", "num_layers", "num_heads", "d_model",
                                         "d_ff", "max_seq_len")}, **kw}
    return TransformerLM(**model_kw, attention_impl="dense", tensor_axis_size=tensor,
                         mesh=_stub_mesh(4 // tensor, tensor))


REFUSALS = [  # (entry point, how, the JAX message)
    ("generator", "no_mesh", "generation with a tensor-parallel model needs the shard_map path"),
    ("beam", "no_mesh", "beam search with a tensor-parallel model needs the shard_map path"),
    ("engine", "no_mesh", "serving with a tensor-parallel model needs the shard_map path"),
    ("generator", "no_param_specs", "the shard_map decode path needs param_specs"),
    ("beam", "no_param_specs", "the shard_map decode path needs param_specs"),
    ("generator", "mesh_without_tensor", "does not carry the model's tensor axis"),
    ("beam", "mesh_without_tensor", "does not carry the model's tensor axis"),
]


def _jax_refusal(entry: str, how: str):
    import jax

    from cs744_pytorch_distributed_tutorial_tpu.infer import make_beam_searcher, make_generator
    from cs744_pytorch_distributed_tutorial_tpu.parallel import make_mesh
    from cs744_pytorch_distributed_tutorial_tpu.serve import ServeConfig, ServingEngine

    tr = _jax_trainer("data2_tensor2")
    model = tr.tp_decode_model()
    kw = {"no_mesh": {}, "no_param_specs": dict(mesh=tr.mesh),
          "mesh_without_tensor": dict(mesh=make_mesh({"data": 4}, devices=jax.devices()[:4]),
                                      param_specs=tr.param_specs)}[how]
    if entry == "engine":
        return ServingEngine(model, None, ServeConfig(**SERVE), **kw)
    if entry == "beam":
        return make_beam_searcher(model, beam_size=2, max_new_tokens=4, **kw)
    return make_generator(model, max_new_tokens=4, **kw)


def _port_refusal(entry: str, how: str):
    from cs744_pytorch_distributed_tutorial_tpu_torch.infer import (
        make_beam_searcher,
        make_generator,
    )
    from cs744_pytorch_distributed_tutorial_tpu_torch.serve import ServeConfig, ServingEngine

    model = _port_tp_model()
    kw = {"no_mesh": {}, "no_param_specs": dict(mesh=model.mesh),
          "mesh_without_tensor": dict(mesh=_stub_mesh(4, 1),
                                      param_specs=model.param_specs)}[how]
    if entry == "engine":
        return ServingEngine(model, ServeConfig(**SERVE), device="cpu", **kw)
    if entry == "beam":
        return make_beam_searcher(model, beam_size=2, max_new_tokens=4, device="cpu", **kw)
    return make_generator(model, max_new_tokens=4, device="cpu", **kw)


@pytest.mark.parametrize("entry,how,match", REFUSALS)
def test_refusals_are_jax_s(entry, how, match):
    with pytest.raises(ValueError, match=match) as jax_error:
        _jax_refusal(entry, how)
    with pytest.raises(ValueError, match=match) as port_error:
        _port_refusal(entry, how)
    if how != "mesh_without_tensor":  # the mesh's repr differs
        assert str(port_error.value) == str(jax_error.value)


def test_param_specs_must_be_the_model_s():
    from cs744_pytorch_distributed_tutorial_tpu_torch.infer import make_generator

    model = _port_tp_model()
    specs = {name: (None,) * len(spec) for name, spec in model.param_specs.items()}
    with pytest.raises(ValueError, match="param_specs are not the model's"):
        make_generator(model, max_new_tokens=4, device="cpu", mesh=model.mesh, param_specs=specs)


@pytest.mark.parametrize("kw,match", [
    (dict(num_kv_heads=2, tensor=4), "num_kv_heads 2 not divisible by tensor axis 4"),
    (dict(num_heads=6, d_model=36, tensor=4), "num_heads 6 not divisible by tensor axis 4"),
    (dict(d_ff=66, tensor=4), "d_ff 66 not divisible by tensor axis 4")])
def test_divisibility_errors_keep_their_type(kw, match):
    """The JAX model's divisibility errors, ``ValueError`` on both sides."""
    import jax
    import jax.numpy as jnp

    from cs744_pytorch_distributed_tutorial_tpu.models.transformer import TransformerLM as JaxLM

    kw = dict(kw)
    tensor = kw.pop("tensor")
    model_kw = {**{k: SMALL[k] for k in ("vocab_size", "num_layers", "num_heads", "d_model",
                                         "d_ff", "max_seq_len")}, **kw}
    jmodel = JaxLM(**model_kw, attention_impl="dense", tensor_axis="tensor",
                   tensor_axis_size=tensor)
    with pytest.raises(ValueError, match=match):
        jax.eval_shape(lambda: jmodel.init(jax.random.key(0), jnp.zeros((1, 4), jnp.int32)))
    with pytest.raises(ValueError, match=match):
        _port_tp_model(tensor, **kw)


def test_tp_decode_model_refusals_are_jax_s(runs):
    """``tp_decode_model`` under fsdp and under expert parallelism: JAX's
    ``ValueError``s, their messages, on every rank."""
    results, _ = runs
    jtr = _jax_trainer("data2_tensor2", fsdp=True)
    with pytest.raises(ValueError) as fsdp:
        jtr.tp_decode_model()
    jtr = _jax_trainer("data2_tensor2", moe_experts=4, moe_expert_parallel=True)
    with pytest.raises(ValueError) as ep:
        jtr.tp_decode_model()
    for res in results:
        assert res["error/fsdp"] == str(fsdp.value)
        assert res["error/expert_parallel"] == str(ep.value)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
