"""The port's ``PipelineLMTrainer`` on 4 Gloo ranks against the JAX
``PipelineLMTrainer`` on 4 host devices with the same mesh.

One launch of 4 processes (this file, run as a script) trains every
layout in turn while JAX runs its own. The LM is tiny: 4 layers, d 32, 4
heads, d_ff 64, vocab 64, T 16, global batch 8, fp32, from each layout's
JAX init carried over by ``models/convert.py`` (every rank loads its
slices of the global tree), 3 steps on the same batches:

1. pipe 4, GPipe, dense, AdamW;
2. pipe 4, 1F1B (the distributed tail: vocab 64 divides over 4 stages),
   flash (the plain versions on the CPU; JAX's Pallas kernels in
   interpret mode), remat ``dots``, RoPE, 2 KV heads;
3. data 2 x pipe 2, interleaved V 2, dropout 0.1: both sides fed the
   same numpy masks (flax's ``nn.Dropout`` and the port's
   ``dropout_mask`` patched; JAX draws a mask a site when it traces the
   stage, so one a site);
4. data 2 x pipe 2, GPipe, zero1 and the clip;
5. data 2 x pipe 2, GPipe, fsdp and Lion;
6. pipe 2 x tensor 2, 1F1B with the distributed tail over (pipe,
   tensor);
7. pipe 2 x seq 2, GPipe, ``ring_flash``;
8. data 2 x pipe 2, 4 experts split over the data axis, ``scatter``,
   SGD: its parameters are held element by element (under AdamW 13 of
   its 89,152 elements, in the expert kernels, fell outside the
   tolerance by up to lr / 10: Adam's step on a near-zero gradient
   carries the summation order; SGD holds the gradients themselves).

Losses and the held-out ``evaluate`` after the steps rtol 1e-5 on every
rank. The final parameters, gathered to the
global tree in storage order on every rank (``host_params``), rtol 1e-5,
atol 1e-6, every element under SGD; AdamW's and Lion's as
``test_torch_port_lm_dp4.py`` holds AdamW's (all but one element in
10,000, those within lr a step). Every
rank's (data, pipe, seq, tensor) coordinates are its device's in the JAX
mesh; the zero1 layout's first moments, converted from the JAX
``[dp, S, chunk]`` leaves (``pipeline_zero_rows_from_jax``), are each
rank's rows (rtol 1e-4, atol 1e-7: 3 steps of moments). ``fit`` with
checkpoints (the zero1 layout): 2 steps then a resume to 4 equal bit for
bit to 4 steps without a break; the same directory refused by an
interleaved trainer (another storage layout); then resumed on data 1 x
pipe 2 (a second launch, 2 ranks) to step 6, its losses the
uninterrupted run's at rtol 1e-5. That launch then runs ``lm_cli
--pipeline-parallel 2`` on each schedule: rank 0's ``--json`` summary has
the JAX route's keys.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

WORLD, STEPS, BATCH, T, V = 4, 3, 8, 16, 64
SMALL = dict(vocab_size=V, num_layers=4, num_heads=4, d_model=32, d_ff=64, max_seq_len=T,
             seq_len=T, global_batch_size=BATCH, learning_rate=1e-3)
DROPOUT = 0.1
CLIP = 0.05
# name: ((data, pipe, seq, tensor), options)
LAYOUTS = {
    "pipe4_gpipe": ((1, 4, 1, 1), dict(schedule="gpipe", num_microbatches=4)),
    "pipe4_1f1b_flash_remat_rope_gqa": ((1, 4, 1, 1), dict(
        schedule="1f1b", num_microbatches=4, attention_impl="flash", remat=True,
        remat_policy="dots", use_rope=True, num_kv_heads=2)),
    "data2_pipe2_interleaved_v2_dropout": ((2, 2, 1, 1), dict(
        schedule="interleaved", num_virtual_stages=2, num_microbatches=2,
        dropout_rate=DROPOUT)),
    "data2_pipe2_zero1_clip": ((2, 2, 1, 1), dict(num_microbatches=2, zero1=True,
                                                  grad_clip_norm=CLIP)),
    "data2_pipe2_fsdp_lion": ((2, 2, 1, 1), dict(num_microbatches=2, fsdp=True,
                                                 optimizer="lion")),
    "pipe2_tensor2_1f1b_dist_tail": ((1, 2, 1, 2), dict(schedule="1f1b", num_microbatches=2)),
    "pipe2_seq2_ring_flash": ((1, 2, 2, 1), dict(num_microbatches=2,
                                                 attention_impl="ring_flash")),
    "data2_pipe2_ep_scatter_sgd": ((2, 2, 1, 1), dict(num_microbatches=2, moe_experts=4,
                                                      moe_expert_parallel=True,
                                                      moe_dispatch="scatter", optimizer="sgd")),
}
TOL = {"loss": dict(rtol=1e-5), "params": dict(rtol=1e-5, atol=1e-6)}
OUTLIERS = 1e-4
RESUME = "data2_pipe2_zero1_clip"
RESUMED_TO = 6  # steps: 4 on 4 ranks, then 2 more on data 1 x pipe 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(name: str) -> dict:
    (d, p, s, t), kw = LAYOUTS[name]
    return dict(SMALL, **kw, data_parallel=d, pipeline_parallel=p, seq_parallel=s,
                tensor_parallel=t)


def _tokens():
    from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_tokens

    return synthetic_tokens(STEPS * BATCH, T, V, seed=1)


def _masks():
    """One fixed keep-mask a site (attention, MLP) at a microbatch's
    shape on one data shard."""
    rng = np.random.default_rng(4)
    b = BATCH // 2 // LAYOUTS["data2_pipe2_interleaved_v2_dropout"][1]["num_microbatches"]
    return [rng.random((b, T, SMALL["d_model"])) >= DROPOUT for _ in range(2)]


# ------------------------------------------------------------------ ranks
def _run(name: str, init: dict, toks, res: dict) -> None:
    from cs744_pytorch_distributed_tutorial_tpu_torch.models import transformer as TM
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import pipeline as PP

    cfg = PP.PipelineLMConfig(**_config(name), device="cpu")
    real_mask = TM.dropout_mask
    if cfg.dropout_rate:
        masks = _masks()

        def fixed(key, shape, rate, device):  # key: (..., layer, microbatch, site)
            return torch.from_numpy(masks[key[-1]])

        TM.dropout_mask = fixed
    try:
        tr = PP.PipelineLMTrainer(cfg)
        tr.init(params=init)
        losses = [float(tr.train_step(*tr.split_batch(toks[s * BATCH:(s + 1) * BATCH]))["loss"])
                  for s in range(STEPS)]
    finally:
        TM.dropout_mask = real_mask
    res[f"{name}/loss"] = np.array(losses)
    res[f"{name}/eval"] = np.array(tr.evaluate(toks)["loss"])
    if name == "pipe4_gpipe":
        x, y = tr.split_batch(toks[:BATCH])
        logits = tr.forward_fn(x)
        res[f"{name}/forward_ce"] = np.array(float(torch.nn.functional.cross_entropy(
            logits.reshape(-1, V), y.reshape(-1))))
        res[f"{name}/eval_step"] = np.array(float(tr.eval_step(x, y)["loss"]))
    res.update({f"{name}/params/{k}": v.numpy() for k, v in tr.host_params().items()})
    res[f"{name}/coords"] = np.array([tr.coords[a] for a in ("data", "pipe", "seq", "tensor")])
    if cfg.zero1:
        res.update({f"{name}/mu/{k}": m.numpy()
                    for k, m in zip(tr.names, tr.optimizer.moments["mu"])})


def _resume(tmp: str, toks, res: dict) -> None:
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import pipeline as PP

    cfg = PP.PipelineLMConfig(**_config(RESUME), device="cpu")
    whole = PP.PipelineLMTrainer(cfg)
    _, _, losses = whole.fit(toks, RESUMED_TO)
    ck = os.path.join(tmp, "ckpt")
    first = PP.PipelineLMTrainer(cfg.replace(checkpoint_dir=ck, checkpoint_every=1))
    _, _, l1 = first.fit(toks, 2)
    again = PP.PipelineLMTrainer(cfg.replace(checkpoint_dir=ck, checkpoint_every=1))
    _, _, l2 = again.fit(toks, 4)
    full = PP.PipelineLMTrainer(cfg)
    _, _, l4 = full.fit(toks, 4)
    res["resume/losses"] = np.array(losses)
    res["resume/split"] = np.array(l1 + l2)
    res["resume/equal"] = np.array(all(torch.equal(a, b) for a, b in zip(
        full.capture_state()["params"], again.capture_state()["params"])) and all(
        torch.equal(a, b) for a, b in zip(full.optimizer.moments["nu"],
                                          again.optimizer.moments["nu"])) and l4 == l1 + l2)
    other = PP.PipelineLMTrainer(cfg.replace(checkpoint_dir=ck, schedule="interleaved",
                                             num_virtual_stages=2))
    try:
        other.fit(toks, 5)
        res["resume/refused"] = np.array("")
    except ValueError as e:
        res["resume/refused"] = np.array(str(e))


CLI = ["--num-layers", "4", "--d-model", "32", "--num-heads", "4", "--d-ff", "64",
       "--vocab-size", "64", "--max-seq-len", "16", "--seq-len", "16", "--global-batch-size",
       "8", "--steps", "2", "--num-seqs", "24", "--eval-frac", "0.34", "--json",
       "--pipeline-parallel", "2", "--num-microbatches", "2"]
CLI_SCHEDULES = ("gpipe", "1f1b", "interleaved")


def _resume_on_two(rank: int, port: int, tmp: str, out_path: str, cli_ports) -> None:
    """data 1 x pipe 2 resumes the data 2 x pipe 2 zero1 checkpoint (its
    rows re-chunked by ``elastic_state``) to step ``RESUMED_TO``; then
    ``lm_cli --pipeline-parallel 2`` on each schedule, a process group
    each."""
    import contextlib
    import io

    import torch.distributed as dist

    from cs744_pytorch_distributed_tutorial_tpu_torch import lm_cli
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import pipeline as PP

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    try:
        cfg = PP.PipelineLMConfig(**dict(_config(RESUME), data_parallel=1), device="cpu",
                                  checkpoint_dir=os.path.join(tmp, "ckpt"))
        _, _, losses = PP.PipelineLMTrainer(cfg).fit(_tokens(), RESUMED_TO)
    finally:
        dist.destroy_process_group()
    out = {"losses": np.array(losses)}
    for schedule, cli_port in zip(CLI_SCHEDULES, cli_ports):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = lm_cli.main(CLI + ["--device", "cpu", "--pipeline-schedule", schedule,
                                    "--coordinator", f"localhost:{cli_port}",
                                    "--num-processes", "2", "--process-id", str(rank)])
        out[f"cli/{schedule}"] = np.array(buf.getvalue() if rc == 0 else f"rc={rc}")
    np.savez(out_path, **out)


def _worker(rank: int, port: int, tmp: str, out_path: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=WORLD,
                            rank=rank)
    try:
        toks, res = _tokens(), {}
        for name in LAYOUTS:
            _run(name, torch.load(os.path.join(tmp, f"init_{name}.pt")), toks, res)
        _resume(tmp, toks, res)
        np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# -------------------------------------------------------------------- JAX
def _jax_mesh(name: str):
    import jax

    from cs744_pytorch_distributed_tutorial_tpu.parallel import make_mesh

    d, p, s, t = LAYOUTS[name][0]
    axes = {"data": d, "pipe": p}
    if s > 1:
        axes["seq"] = s
    if t > 1:
        axes["tensor"] = t
    return make_mesh(axes, devices=jax.devices()[:WORLD])


def _flax_dropout(masks, calls):
    """flax ``nn.Dropout.__call__`` fed ``masks`` in call order."""
    import jax.numpy as jnp

    def call(self, inputs, deterministic=None, rng=None):
        det = self.deterministic if deterministic is None else deterministic
        if det or self.rate == 0.0:
            return inputs
        mask = masks[calls["n"] % len(masks)]
        calls["n"] += 1
        return jnp.where(mask, inputs / (1.0 - self.rate), jnp.zeros_like(inputs))

    return call


def _jax_init(name: str):
    """The JAX trainer and its init as the port's global tree (logical
    order)."""
    from cs744_pytorch_distributed_tutorial_tpu.parallel import pipeline as JP
    from cs744_pytorch_distributed_tutorial_tpu_torch.models import convert

    jt = JP.PipelineLMTrainer(JP.PipelineLMConfig(**_config(name)), mesh=_jax_mesh(name))
    params, opt = jt.init()
    host = jt.host_params(params)
    host = dict(host, blocks=jt.blocks_to_logical(host["blocks"]))
    return jt, params, opt, convert.pipeline_params_from_jax(host)


def _jax_run(name: str, jt, params, opt, toks) -> dict:
    import flax.linen as fnn
    import jax

    saved, calls = fnn.Dropout.__call__, {"n": 0}
    if _config(name).get("dropout_rate"):
        fnn.Dropout.__call__ = _flax_dropout(_masks(), calls)
    try:
        losses = []
        for s in range(STEPS):
            params, opt, m = jt.train_step(params, opt,
                                           *jt.shard_batch(toks[s * BATCH:(s + 1) * BATCH]), s)
            losses.append(float(m["loss"]))
    finally:
        fnn.Dropout.__call__ = saved
    devices = list(np.asarray(jax.devices()[:WORLD]))
    axes = list(jt.mesh.axis_names)
    coords = []
    for dev in devices:
        at = dict(zip(axes, (int(c) for c in np.argwhere(jt.mesh.devices == dev)[0])))
        coords.append(tuple(at.get(a, 0) for a in ("data", "pipe", "seq", "tensor")))
    out = {"loss": losses, "params": jt.host_params(params), "coords": coords,
           "dropout_calls": calls["n"], "eval": jt.evaluate(params, toks)["loss"]}
    if _config(name).get("zero1"):
        out["mu"] = jax.device_get(opt["mu"])
        out["local_shapes"] = _local_shapes(jt)
    return out


def _local_shapes(jt):
    """Each leaf's local shape at a (pipe, tensor) coordinate (JAX's
    ``local_chunk_shapes`` of the trainer's specs)."""
    import jax

    from cs744_pytorch_distributed_tutorial_tpu.parallel.zero import local_chunk_shapes

    shapes = jax.eval_shape(jt._init_host, 0)
    local = local_chunk_shapes(shapes, jt._orig_param_specs, {"pipe": jt.pipe_size})
    return jax.tree.map(lambda s: np.zeros(s.shape, np.float32), local)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each rank's results, JAX's runs by layout)."""
    tmp = tmp_path_factory.mktemp("pipeline_ranks4")
    toks = _tokens()
    jax_state = {}
    for name in LAYOUTS:
        jt, params, opt, init = _jax_init(name)
        torch.save(init, tmp / f"init_{name}.pt")
        jax_state[name] = (jt, params, opt)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(port),
                               str(tmp), str(tmp / f"r{r}.npz")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    try:  # the ranks train while JAX compiles and runs
        want = {name: _jax_run(name, *jax_state[name], toks) for name in LAYOUTS}
        logs = [p.communicate(timeout=400)[0] for p in procs]
        assert all(p.returncode == 0 for p in procs), "\n".join(logs)
        ports = [str(_free_port()) for _ in range(1 + len(CLI_SCHEDULES))]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "two", str(r),
                                   str(tmp), str(tmp / f"two{r}.npz"), *ports], env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        logs = [p.communicate(timeout=200)[0] for p in procs]
        assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = [dict(np.load(tmp / f"r{r}.npz")) for r in range(WORLD)]
    for r in range(2):
        two = dict(np.load(tmp / f"two{r}.npz"))
        results[r]["resume/on_two"] = two.pop("losses")
        results[r].update(two)
    return results, want


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_trainer_matches_jax_on_four_ranks(runs, name):
    from cs744_pytorch_distributed_tutorial_tpu_torch.models import convert

    results, want = runs
    jr = want[name]
    exact = LAYOUTS[name][1].get("optimizer", "adamw") == "sgd"
    params = convert.pipeline_params_from_jax(jr["params"])
    for r, res in enumerate(results):
        np.testing.assert_allclose(res[f"{name}/loss"], jr["loss"], **TOL["loss"],
                                   err_msg=f"{name}, rank {r}")
        if exact:
            for k, v in params.items():
                np.testing.assert_allclose(res[f"{name}/params/{k}"], v.numpy(),
                                           **TOL["params"], err_msg=f"{name} {k}, rank {r}")
            continue
        gaps = np.concatenate([np.abs(res[f"{name}/params/{k}"] - v.numpy()).ravel()
                               for k, v in params.items()])
        limit = np.concatenate([TOL["params"]["atol"] + TOL["params"]["rtol"]
                                * np.abs(v.numpy()).ravel() for v in params.values()])
        over = {k: int((np.abs(res[f"{name}/params/{k}"] - v.numpy())
                        > TOL["params"]["atol"] + TOL["params"]["rtol"] * np.abs(v.numpy())).sum())
                for k, v in params.items()}
        assert (gaps > limit).sum() <= OUTLIERS * gaps.size, (name, r, gaps.max(),
                                                              {k: n for k, n in over.items() if n})
        assert gaps.max() <= SMALL["learning_rate"] * STEPS and gaps.mean() <= 1e-6, (name, r)


def test_evaluate_and_forward_match_jax(runs):
    """``evaluate`` (the held-out contract) after the steps equals JAX's
    on every layout and rank (rtol 1e-5); ``forward_fn``'s logits give
    ``eval_step``'s loss."""
    results, want = runs
    for name in LAYOUTS:
        for r, res in enumerate(results):
            np.testing.assert_allclose(res[f"{name}/eval"], want[name]["eval"], rtol=1e-5,
                                       err_msg=f"{name}, rank {r}")
    for res in results:
        np.testing.assert_allclose(res["pipe4_gpipe/forward_ce"], res["pipe4_gpipe/eval_step"],
                                   rtol=1e-6)


def test_ranks_sit_where_the_jax_mesh_puts_their_devices(runs):
    results, want = runs
    for name in LAYOUTS:
        for r, res in enumerate(results):
            assert tuple(res[f"{name}/coords"]) == want[name]["coords"][r], (name, r)


def test_dropout_masks_drawn_once_a_site_by_jax(runs):
    """JAX draws the patched masks when it traces the stage: one a site,
    which the port's patch hands out by site."""
    _, want = runs
    assert want["data2_pipe2_interleaved_v2_dropout"]["dropout_calls"] == 2


def test_zero1_rows_are_jax_s(runs):
    from cs744_pytorch_distributed_tutorial_tpu_torch.models import convert

    results, want = runs
    name = "data2_pipe2_zero1_clip"
    jr = want[name]
    like = jr["local_shapes"]
    for r, res in enumerate(results):
        d, p, _, t = (int(c) for c in res[f"{name}/coords"])
        rows = convert.pipeline_zero_rows_from_jax(jr["mu"], like,
                                                   {"data": d, "pipe": p, "tensor": t})
        for k, v in rows.items():
            np.testing.assert_allclose(res[f"{name}/mu/{k}"], v.numpy(), rtol=1e-4, atol=1e-7,
                                       err_msg=f"{k}, rank {r}")


def test_resume_is_bitwise_and_another_layout_is_refused(runs):
    results, _ = runs
    for res in results:
        np.testing.assert_array_equal(res["resume/split"], res["resume/losses"][:4])
        assert bool(res["resume/equal"])
        assert "layer-storage layout 0, this trainer uses 200002" in str(res["resume/refused"])


def test_lm_cli_runs_each_schedule_with_jax_s_summary(runs, capsys):
    """``lm_cli --pipeline-parallel 2`` on 2 Gloo ranks, each schedule: 2
    finite steps and an eval on rank 0, whose ``--json`` summary has the
    JAX pipeline route's keys and values (rank 1 prints none)."""
    import json

    from cs744_pytorch_distributed_tutorial_tpu import lm_cli as jax_cli

    results, _ = runs
    jax_cli.main(CLI + ["--pipeline-schedule", "1f1b"])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for schedule in CLI_SCHEDULES:
        text = str(results[0][f"cli/{schedule}"])
        got = json.loads(text.strip().splitlines()[-1])
        assert sorted(got) == sorted(want), schedule
        assert got["engine"] == "pipeline" and got["schedule"] == schedule
        assert got["steps_run"] == 2 and got["finite"] and got["pipeline_parallel"] == 2
        assert np.isfinite(got["eval"]["loss"])
        assert not str(results[1][f"cli/{schedule}"]).strip().startswith("{")
        if schedule == "1f1b":  # the same run as JAX's, from another init
            assert got["final_loss"] == pytest.approx(want["final_loss"], rel=0.05)


def test_resume_over_data_parallel(runs):
    """The data 2 x pipe 2 zero1 checkpoint at step 4 resumed on data 1 x
    pipe 2: the moments' rows re-chunked, the next two losses the
    uninterrupted 4-rank run's (rtol 1e-5: the data axis's mean is
    another sum order)."""
    results, _ = runs
    for r in range(2):
        np.testing.assert_allclose(results[r]["resume/on_two"],
                                   results[r]["resume/losses"][4:], rtol=1e-5)


if __name__ == "__main__":
    if sys.argv[1] == "two":
        _resume_on_two(int(sys.argv[2]), int(sys.argv[5]), sys.argv[3], sys.argv[4],
                       [int(p) for p in sys.argv[6:]])
    else:
        _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
