"""The LM's sharded optimizers (``parallel/zero.py``: ``Zero1Adam``,
``Zero1Lion``, ``Zero1SgdLM``, ``FsdpAdam``, ``FsdpLion``, ``FsdpSgdLM``)
in the port's ``LMTrainer`` on 4 Gloo ranks against the JAX
``LMTrainer`` on 4 host devices.

One launch of 4 processes (this file, run as a script) trains every
configuration while JAX runs its own. The LM is tiny: 2 layers, d 32, 4
heads, vocab 64, T 16, global batch 8 (2 a rank), RoPE, fp32, dense
attention on both sides, from the JAX init carried over by
``models/convert.py``, for 4 steps on the same batches.

- zero1 and fsdp under adamw, lion and sgd, each per leaf
  (``sync_bucket_mb=0``), bucketed (a 2 KiB bucket: several) and
  overlapped, against the JAX trainer of that rule (its fused and
  overlapped paths share the elementwise numerics); zero1 with the clip
  and ``warmup_cosine``; zero1 on the int8 wire (``bucket+int8``); fsdp
  with ``accum_steps=2`` and ``scan_layers``. Losses (the world mean)
  rtol 1e-5; the final parameters, and each rank's rows (moments, fsdp's
  parameter rows) against row r of JAX's ``[4, chunk]`` leaves, rtol
  1e-5, atol 1e-6: the reduce-scatter sums in gloo's order, the products
  in another order. Under AdamW one parameter element of 20,992 (in
  ``blocks.0.mlp_out.weight``) ends 2.48e-6 from JAX's, past its 1.08e-6:
  Adam divides each gradient by its own magnitude, and an element whose
  ranks' gradients nearly cancel carries the two frameworks' rounding
  into its step (``ROADMAP.md`` C). AdamW's parameters and fsdp rows are
  therefore held as ``test_torch_port_lm.py`` holds the one-device AdamW
  against JAX: every element within rtol 1e-5, atol 1e-6 but at most one
  in 10,000, those within lr a step, and 1e-6 on average. The int8 wire quantizes each framework's own flat
  order (flax ``[in, out]`` kernels against ``Linear``'s ``[out, in]``),
  so its chunks hold other elements: held to ``INT8_TOL``, the wire's
  own error (``test_torch_port_zero.py``).
- The collectives a step, counted at the ``torch.distributed`` calls,
  equal the JAX ``*_collective_schedule`` of the port's own bucket
  count (fsdp: every microbatch gathers).
- fsdp holds rows only between steps: the module's parameters are empty
  and each rank keeps ``[chunk]`` rows of parameters and moments.
- A same-world resume from a checkpoint (zero1 and fsdp) is bitwise the
  uninterrupted run.
- After fsdp, ``gather_for_decode``'s weights generate the greedy tokens
  of the JAX ``lm_cli``'s route (``gather_for_decode`` + the JAX
  generator) on the JAX trainer's own weights.
- Every JAX rejection of these options raises with JAX's type, on both
  sides, before a process group is needed.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

WORLD, STEPS, BATCH, T, V = 4, 4, 8, 16, 64
SMALL = dict(vocab_size=V, num_layers=2, num_heads=4, d_model=32, d_ff=64, max_seq_len=T,
             seq_len=T, global_batch_size=BATCH, use_rope=True, learning_rate=1e-3,
             attention_impl="dense", data_parallel=WORLD)
SMALL_BUCKET_MB = 2048 / 2**20
LAYOUTS = {"leaf": dict(sync_bucket_mb=0), "bucket": dict(sync_bucket_mb=SMALL_BUCKET_MB),
           "overlap": dict(sync_bucket_mb=SMALL_BUCKET_MB, sync_overlap="bucket")}
# JAX reference: the configuration the port's runs are held against.
REFS = {f"{shard}_{rule}": {shard: True, "optimizer": rule}
        for shard in ("zero1", "fsdp") for rule in ("adamw", "lion", "sgd")}
REFS.update({
    "zero1_adamw_clip_cosine": dict(zero1=True, grad_clip_norm=0.05,
                                    lr_schedule="warmup_cosine", warmup_steps=2,
                                    total_steps=STEPS),
    "zero1_adamw_int8": dict(zero1=True, grad_compress="int8", sync_overlap="bucket+int8"),
    "fsdp_adamw_accum2_scan": dict(fsdp=True, accum_steps=2, scan_layers=True,
                                   sync_bucket_mb=SMALL_BUCKET_MB),
})
RUNS = {f"{ref}_{layout}": (ref, {**REFS[ref], **lkw})
        for ref in list(REFS)[:6] for layout, lkw in LAYOUTS.items()}
RUNS.update({ref: (ref, REFS[ref]) for ref in list(REFS)[6:]})
RESUME = ("zero1_adamw", "fsdp_adamw")
INT8_TOL = {"losses": dict(rtol=0.02), "params": dict(rtol=0, atol=5e-3),
            "rows": dict(rtol=0, atol=5e-2)}
FLOAT_TOL = {"losses": dict(rtol=1e-5), "params": dict(rtol=1e-5, atol=1e-6),
             "rows": dict(rtol=1e-5, atol=1e-6)}
# AdamW's elements past FLOAT_TOL: at most this share of a tree, each
# within lr a step (test_torch_port_lm.py's bound for the one-device path).
ADAM_OUTLIERS = 1e-4
GEN_NEW, GEN_PROMPT = 8, 6
COUNTED = ("reduce_scatter_tensor", "all_gather_into_tensor", "all_to_all_single", "all_gather")
KIND = {"reduce_scatter_tensor": "reduce_scatter", "all_gather_into_tensor": "all_gather",
        "all_to_all_single": "all_to_all", "all_gather": "all_gather"}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tokens():
    from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_tokens

    return synthetic_tokens(STEPS * BATCH, T, V, seed=1)


# ------------------------------------------------------------------ ranks
def _count_collectives():
    import torch.distributed as dist

    counts = dict.fromkeys(COUNTED, 0)
    for name in COUNTED:
        fn = getattr(dist, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*a, **kw)

        setattr(dist, name, counted)
    return counts


def _trainer(kw: dict, init: dict, **extra):
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.transformer import (
        stack_block_params,
    )
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMConfig, LMTrainer

    tr = LMTrainer(LMConfig(**SMALL, **kw, **extra, device="cpu"))
    tr.init(state_dict=stack_block_params(init) if kw.get("scan_layers") else init)
    return tr


def _run(name: str, kw: dict, init: dict, toks, counts: dict, res: dict) -> None:
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.transformer import (
        unstack_block_params,
    )

    tr = _trainer(kw, init)
    losses = []
    for s in range(STEPS):
        for c in COUNTED:
            counts[c] = 0
        m = tr.train_step(*tr.split_batch(toks[s * BATCH : (s + 1) * BATCH]))
        if s == 1:
            res.update({f"{name}/count/{k}": np.array(v) for k, v in counts.items()})
        losses.append(float(m["loss"]))
        res[f"{name}/metrics"] = np.array(sorted(m))
    res[f"{name}/losses"] = np.array(losses)
    opt = tr.optimizer
    names = [n for n, _ in tr.model.named_parameters()] if not kw.get("fsdp") else tr._param_names
    res.update({f"{name}/{mom}/{n}": r.numpy() for mom, rows in opt.moments.items()
                for n, r in zip(names, rows)})
    res[f"{name}/count"] = np.array(opt.count)
    if kw.get("fsdp"):
        res.update({f"{name}/rows/{n}": r.detach().numpy() for n, r in zip(names, opt.params)})
        res[f"{name}/module_numel"] = np.array(sum(p.numel() for p in tr.model.parameters()))
    sd = tr.state_dict()  # fsdp: gathered from the rows
    sd = unstack_block_params(sd) if kw.get("scan_layers") else sd
    res.update({f"{name}/params/{k}": v.numpy() for k, v in sd.items()})
    layout = opt.layout(tr._param_shapes if kw.get("fsdp") else opt.params)
    res[f"{name}/units"] = np.array(len(layout.bucket_cols) if opt.bucketed else len(names))
    if name == "fsdp_adamw_leaf":
        from cs744_pytorch_distributed_tutorial_tpu_torch.infer import make_generator

        model = tr.decode_model()  # the gather every rank joins
        prompt = toks[:1, :GEN_PROMPT].astype(np.int64)
        out = make_generator(model, max_new_tokens=GEN_NEW, temperature=0.0,
                             device="cpu")(prompt)
        res["generate/tokens"] = np.asarray(out)


def _resume(name: str, kw: dict, toks, ckdir: str, res: dict) -> None:
    """``fit`` to step 2 (a checkpoint at 2), a new trainer resumed to
    step 4, and an uninterrupted run to 4: their losses and final states."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMConfig, LMTrainer

    def make(**extra):
        return LMTrainer(LMConfig(**SMALL, **kw, **extra, device="cpu"))

    make(checkpoint_dir=ckdir, checkpoint_every=2).fit(toks, 2)
    resumed = make(checkpoint_dir=ckdir, checkpoint_every=2)
    _, _, tail = resumed.fit(toks, STEPS)
    whole = make()
    _, _, full = whole.fit(toks, STEPS)
    res[f"resume/{name}/tail"] = np.array(tail)
    res[f"resume/{name}/full"] = np.array(full)
    a, b = resumed.capture_state(), whole.capture_state()
    same = all(torch.equal(u, v) for key in ("params", "momentum", "opt_nu")
               for u, v in zip(a[key], b[key], strict=True))
    res[f"resume/{name}/same"] = np.array(same and a["opt_count"] == b["opt_count"]
                                          and a["step"] == b["step"] == STEPS)


def _worker(rank: int, port: int, tmp: str, out_path: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=WORLD,
                            rank=rank)
    counts = _count_collectives()
    try:
        inits = {key: torch.load(os.path.join(tmp, f"init_{key}.pt")) for key in ("flat", "scan")}
        toks = _tokens()
        res: dict = {}
        for name, (_, kw) in RUNS.items():
            _run(name, kw, inits["scan" if kw.get("scan_layers") else "flat"], toks, counts, res)
        for name in RESUME:
            _resume(name, REFS[name], toks, os.path.join(tmp, f"ck_{name}"), res)
        np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# -------------------------------------------------------------------- JAX
def _jax_mesh():
    import jax

    from cs744_pytorch_distributed_tutorial_tpu.parallel import make_mesh

    return make_mesh({"data": WORLD, "seq": 1}, devices=jax.devices()[:WORLD])


def _jax_run(ref: str, mesh, toks) -> dict:
    import jax

    from cs744_pytorch_distributed_tutorial_tpu.train import LMConfig as JaxConfig
    from cs744_pytorch_distributed_tutorial_tpu.train import LMTrainer as JaxTrainer

    jt = JaxTrainer(JaxConfig(**SMALL, **REFS[ref]), mesh=mesh)
    params, opt = jt.init()
    # fsdp's init is [4, chunk] rows already: the whole tensors, unsharded.
    init = jt.gather_for_decode(params) if REFS[ref].get("fsdp") else jax.device_get(params)
    losses = []
    for s in range(STEPS):
        params, opt, m = jt.train_step(params, opt, *jt.shard_batch(toks[s * BATCH:(s + 1) * BATCH]),
                                       s)
        losses.append(float(m["loss"]))
    out = {"init": init, "losses": np.array(losses), "metrics": sorted(m),
           "opt": jax.device_get(opt[0] if REFS[ref].get("grad_compress") else opt),
           "params": jax.device_get(params)}
    if REFS[ref].get("fsdp"):
        out["rows"] = out["params"]
        out["params"] = jt.gather_for_decode(params)
    if ref == "fsdp_adamw":
        from cs744_pytorch_distributed_tutorial_tpu.infer import make_generator

        gen = make_generator(jt.decode_model(), max_new_tokens=GEN_NEW, temperature=0.0)
        out["tokens"] = np.asarray(gen(out["params"], np.asarray(toks[:1, :GEN_PROMPT]),
                                       jax.random.key(0)))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each rank's results, JAX's runs by reference name)."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import lm_params_from_jax

    tmp = tmp_path_factory.mktemp("zero_lm")
    mesh, toks = _jax_mesh(), _tokens()
    want = {"zero1_adamw": _jax_run("zero1_adamw", mesh, toks),
            "fsdp_adamw_accum2_scan": _jax_run("fsdp_adamw_accum2_scan", mesh, toks)}
    torch.save(lm_params_from_jax(want["zero1_adamw"]["init"]), tmp / "init_flat.pt")
    torch.save(lm_params_from_jax(want["fsdp_adamw_accum2_scan"]["init"]), tmp / "init_scan.pt")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(port),
                               str(tmp), str(tmp / f"r{r}.npz")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    try:  # the ranks train while JAX compiles and runs
        for ref in REFS:
            if ref not in want:
                want[ref] = _jax_run(ref, mesh, toks)
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [dict(np.load(tmp / f"r{r}.npz")) for r in range(WORLD)], want


def _assert_tree_close(got: dict, want: dict, tol: dict, adam: bool, what: str,
                       total: int = 0) -> None:
    """``got`` (numpy arrays by name) against ``want`` (tensors by name)
    at ``tol``; under ``adam``, all but ``ADAM_OUTLIERS`` of the model's
    ``total`` elements (a rank's rows hold a share of them), the rest
    within lr a step and the mean gap within 1e-6."""
    if not adam:
        for name, value in want.items():
            np.testing.assert_allclose(got[name], value.numpy(), **tol, err_msg=f"{what} {name}")
        return
    gaps = np.concatenate([np.abs(got[n] - v.numpy()).ravel() for n, v in want.items()])
    limit = np.concatenate([tol["atol"] + tol["rtol"] * np.abs(v.numpy()).ravel()
                            for v in want.values()])
    past = gaps > limit
    assert past.sum() <= ADAM_OUTLIERS * max(total, gaps.size), (what, int(past.sum()))
    assert gaps.max() <= SMALL["learning_rate"] * STEPS and gaps.mean() <= 1e-6, what


def _flat_sd(tree) -> dict:
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import lm_params_from_jax
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.transformer import (
        is_stacked,
        unstack_block_params,
    )

    sd = lm_params_from_jax(tree)
    return unstack_block_params(sd) if is_stacked(sd) else sd


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("run", list(RUNS))
def test_trainer_matches_jax_on_four_ranks(runs, run):
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import lm_zero_state_from_jax

    results, want = runs
    ref, kw = RUNS[run]
    jr = want[ref]
    for a, b in zip(_flat_sd(jr["init"]).values(), _flat_sd(want["zero1_adamw"]["init"]).values()):
        if not kw.get("scan_layers"):
            np.testing.assert_array_equal(a.numpy(), b.numpy())  # every run, one init
    tol = INT8_TOL if kw.get("grad_compress") else FLOAT_TOL
    adam = tol is FLOAT_TOL and kw.get("optimizer", "adamw") == "adamw"
    params = _flat_sd(jr["params"])
    like = jr["init"]
    for r, res in enumerate(results):
        np.testing.assert_allclose(res[f"{run}/losses"], jr["losses"], **tol["losses"],
                                   err_msg=f"{run} losses, rank {r}")
        # zero1/fsdp leave the gradient and parameter norms out, as JAX.
        assert list(res[f"{run}/metrics"]) == jr["metrics"] == ["loss"]
        _assert_tree_close({n: res[f"{run}/params/{n}"] for n in params}, params, tol["params"],
                           adam, f"{run} parameters, rank {r}")
        rows = lm_zero_state_from_jax(jr["opt"], like, r, fsdp_params=jr.get("rows"))
        assert int(res[f"{run}/count"]) == rows.pop("count") == STEPS
        moments = {"mu", "nu"} if kw.get("optimizer") == "adamw" or "adamw" in ref else {"mu"}
        assert set(rows) == moments | ({"params"} if kw.get("fsdp") else set())
        for kind, by_name in rows.items():
            key = "rows" if kind == "params" else kind
            _assert_tree_close({n: res[f"{run}/{key}/{n}"] for n in by_name}, by_name,
                               tol["rows"], adam and kind == "params", f"{run} {kind}, rank {r}",
                               total=sum(v.numel() for v in params.values()))


@pytest.mark.parametrize("run", list(RUNS))
def test_collectives_a_step_follow_the_jax_schedule(runs, run):
    from cs744_pytorch_distributed_tutorial_tpu.parallel import zero as JZ

    results, _ = runs
    _, kw = RUNS[run]
    units = int(results[0][f"{run}/units"])
    if kw.get("grad_compress"):
        want = JZ.zero1_int8_collective_schedule(units, WORLD)
    elif kw.get("fsdp"):
        want = JZ.fsdp_collective_schedule(units * kw.get("accum_steps", 1), WORLD)
    else:
        want = JZ.zero1_collective_schedule(units, WORLD)
    for r, res in enumerate(results):
        got: dict[str, int] = {}
        for name, kind in KIND.items():
            n = int(res[f"{run}/count/{name}"])
            if n:
                got[kind] = got.get(kind, 0) + n
        assert got == want, (run, r, units)
    if kw.get("sync_bucket_mb"):
        assert units > 1


def test_fsdp_holds_its_rows_only(runs):
    """Between steps each rank keeps its [chunk] rows of every parameter
    and moment; the module's own parameters are empty."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.transformer import TransformerLM

    results, _ = runs
    model = TransformerLM(**{k: SMALL[k] for k in ("vocab_size", "num_layers", "num_heads",
                                                   "d_model", "d_ff", "max_seq_len",
                                                   "use_rope")})
    chunks = {n: -(-p.numel() // WORLD) for n, p in model.named_parameters()}
    total = sum(p.numel() for p in model.parameters())
    for run in (r for r in RUNS if r.startswith("fsdp") and "scan" not in r):
        moments = ("mu", "nu") if "adamw" in run else ("mu",)
        for res in results:
            assert int(res[f"{run}/module_numel"]) == 0
            for kind in ("rows", *moments):
                got = {n: res[f"{run}/{kind}/{n}"].shape for n in chunks}
                assert got == {n: (c,) for n, c in chunks.items()}, (run, kind)
            held = sum(res[f"{run}/{k}/{n}"].nbytes for k in ("rows", *moments) for n in chunks)
            assert held == (1 + len(moments)) * 4 * sum(chunks.values())
            assert held < (1 + len(moments)) * 4 * total / 3


@pytest.mark.parametrize("name", RESUME)
def test_same_world_resume_is_bitwise(runs, name):
    results, _ = runs
    for res in results:
        assert bool(res[f"resume/{name}/same"])
        np.testing.assert_array_equal(res[f"resume/{name}/tail"],
                                      res[f"resume/{name}/full"][2:])


def test_gather_for_decode_after_fsdp_generates_jax_tokens(runs):
    results, want = runs
    for res in results:
        np.testing.assert_array_equal(res["generate/tokens"], want["fsdp_adamw"]["tokens"])


def test_rows_round_trip_through_the_jax_layout():
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import (
        jax_lm_params_from_state_dict,
        jax_lm_zero_state,
        lm_zero_state_from_jax,
        shard_row,
    )
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.transformer import TransformerLM

    gen = torch.Generator().manual_seed(5)
    model = TransformerLM(**{k: SMALL[k] for k in ("vocab_size", "num_layers", "num_heads",
                                                   "d_model", "d_ff", "max_seq_len", "use_rope")},
                          generator=gen)
    sd = model.state_dict()
    states = [{"mu": {n: shard_row(v, r, WORLD) for n, v in sd.items()},
               "nu": {n: shard_row(v * 2, r, WORLD) for n, v in sd.items()}, "count": 3,
               "params": {n: shard_row(v * 3, r, WORLD) for n, v in sd.items()}}
              for r in range(WORLD)]
    tree = jax_lm_zero_state(states, {n: tuple(v.shape) for n, v in sd.items()})
    like = jax_lm_params_from_state_dict(sd)
    # The JAX leaves are flax's [in, out] kernels' rows: transposed first.
    kernel = like["block_0"]["attn"]["q"]["kernel"]
    np.testing.assert_array_equal(tree["mu"]["block_0"]["attn"]["q"]["kernel"].reshape(-1)[
        : kernel.size], kernel.reshape(-1))
    for r in range(WORLD):
        back = lm_zero_state_from_jax(tree, like, r, fsdp_params=tree["params"])
        assert back["count"] == 3
        for kind in ("mu", "nu", "params"):
            for n in sd:
                assert torch.equal(back[kind][n], states[r][kind][n]), (kind, n, r)


REJECTIONS = [
    (dict(zero1=True, optimizer="adam"), "unknown optimizer"),
    (dict(zero1=True, fsdp=True), "mutually exclusive"),
    (dict(grad_compress="fp8"), "unknown grad_compress"),
    (dict(fsdp=True, grad_compress="int8"), "cannot ride fsdp"),
    (dict(zero1=True, grad_compress="int8"), "bucket\\+int8"),
    (dict(zero1=True, grad_compress="int8", sync_overlap="bucket"), "bucket\\+int8"),
    (dict(sync_bucket_mb=-1.0), "sync_bucket_mb"),
    (dict(sync_overlap="ring"), "unknown sync_overlap"),
    (dict(sync_overlap="bucket"), "fixed-LR SGD"),
    (dict(optimizer="sgd", lr_schedule="cosine", total_steps=8, sync_overlap="bucket"),
     "fixed-LR SGD"),
    (dict(optimizer="sgd", warmup_steps=2, sync_overlap="bucket"), "fixed-LR SGD"),
    (dict(optimizer="sgd", grad_clip_norm=1.0, sync_overlap="bucket"), "fixed-LR SGD"),
    (dict(optimizer="sgd", grad_compress="int8", sync_overlap="bucket"), "bucket\\+int8"),
    (dict(optimizer="sgd", sync_overlap="bucket+int8"), "set grad_compress"),
    (dict(zero1=True, grad_clip_norm=1.0, sync_overlap="bucket"), "pure data parallelism"),
    (dict(fsdp=True, grad_clip_norm=1.0, sync_overlap="bucket"), "pure data parallelism"),
    (dict(global_batch_size=6), "not divisible"),
    (dict(accum_steps=4), "accum_steps"),
]


@pytest.mark.parametrize("kw,match", REJECTIONS)
def test_rejections_are_jax_s(kw, match):
    """The JAX ``LMTrainer``'s refusals (``test_zero1_lm.py``, its
    ``train/lm.py:415-506,567-571``): the same type and message on both
    sides, the port's before any process group (its ranks never start)."""
    from cs744_pytorch_distributed_tutorial_tpu.train import LMConfig as JaxConfig
    from cs744_pytorch_distributed_tutorial_tpu.train import LMTrainer as JaxTrainer
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMConfig, LMTrainer

    cfg = {**SMALL, **kw}
    with pytest.raises(ValueError, match=match):
        JaxTrainer(JaxConfig(**cfg), mesh=_jax_mesh())
    with pytest.raises(ValueError, match=match):
        LMTrainer(LMConfig(**cfg, device="cpu"))


@pytest.mark.parametrize("kw", [dict(data_parallel=2), dict(data_parallel=1, zero1=True),
                                dict(data_parallel=1, grad_compress="int8")])
def test_the_world_must_match_and_the_wire_needs_a_group(kw):
    """``data_parallel`` must be the process group's world (one without a
    group), and the sharded rules and the int8 wire need a group."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMConfig, LMTrainer

    match = "world size" if kw["data_parallel"] > 1 else "process group"
    with pytest.raises(ValueError, match=match):
        LMTrainer(LMConfig(**{**SMALL, **kw}, device="cpu"))


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
