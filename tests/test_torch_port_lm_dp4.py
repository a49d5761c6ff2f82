"""The port's ``LMTrainer`` on 4 Gloo ranks, pure data parallelism,
against the JAX ``LMTrainer`` on 4 host devices.

One launch of 4 processes (this file, run as a script) trains every
configuration while JAX runs its own. The LM is tiny: 2 layers, d 32, 4
heads, vocab 64, T 16, global batch 8 (2 a rank), RoPE, fp32, dense
attention on both sides, from the JAX init carried over by
``models/convert.py``, for 4 steps on the same batches.

- The all-reduce path (AdamW), alone and with ``accum_steps=2``; the
  int8 wire (AdamW) and its overlapped form (``bucket+int8``, sgd at a
  constant lr); sgd fused and overlapped (``sync_overlap="bucket"``);
  a dense and a dropless MoE run. Losses, ``grad_norm``,
  ``param_norm`` and the MoE statistics (world means) rtol 1e-5; the
  final parameters rtol 1e-5, atol 1e-6, AdamW's as
  ``test_torch_port_zero_lm.py`` holds them (all but one element in
  10,000, those within lr a step, 1e-6 on average: Adam carries an
  element's near-cancelling gradient rounding into its step). The int8
  paths as ``INT8_TOL``: each framework quantizes its own flat order
  (flax ``[in, out]`` kernels against ``Linear``'s ``[out, in]``); fed
  the same flat order, the wire's codes and scales are JAX's bit for
  bit.
- The overlapped sgd path against the port's fused one: losses and
  parameters within rtol 1e-6, atol 1e-7 (gloo sums a bucket's elements
  in an order that depends on the buffer, and the two paths' buckets
  differ), and bitwise at a world of one.
- Dropout 0.1: ranks draw different masks (the same rows give each rank
  another loss), a rerun of a step draws the same masks again, and rank
  0's key is the one-device key (its loss is the forward's under
  (seed, step, microbatch), bit for bit).
- ``LMSegments``' sync segment (all-reduce, int8, overlapped) on 4
  ranks: present, its segmented step equal to the fused one, the
  trainer restored, the wire's bytes priced.
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
RUNS = {
    "allreduce": {},
    "allreduce_accum2": dict(accum_steps=2),
    "int8": dict(grad_compress="int8"),
    "sgd_int8_overlap": dict(optimizer="sgd", grad_compress="int8", sync_overlap="bucket+int8",
                             sync_bucket_mb=SMALL_BUCKET_MB),
    "sgd": dict(optimizer="sgd", sync_bucket_mb=SMALL_BUCKET_MB),
    "sgd_overlap": dict(optimizer="sgd", sync_overlap="bucket", sync_bucket_mb=SMALL_BUCKET_MB),
    "moe_dropless": dict(moe_experts=4, moe_dispatch="dropless"),
}
SEGMENTS = {"allreduce": {}, "int8": dict(grad_compress="int8"),
            "sgd_overlap": dict(optimizer="sgd", sync_overlap="bucket",
                                sync_bucket_mb=SMALL_BUCKET_MB)}
INT8_TOL = {"losses": dict(rtol=0.02), "params": dict(rtol=0, atol=5e-3)}
FLOAT_TOL = {"losses": dict(rtol=1e-5), "params": dict(rtol=1e-5, atol=1e-6)}
ADAM_OUTLIERS = 1e-4
OVERLAP_TOL = dict(rtol=1e-6, atol=1e-7)
DROPOUT = 0.1
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tokens():
    from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_tokens

    return synthetic_tokens(STEPS * BATCH, T, V, seed=1)


def _trainer(kw: dict, init: dict | None):
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMConfig, LMTrainer

    tr = LMTrainer(LMConfig(**{**SMALL, **kw}, device="cpu"))
    tr.init(state_dict=init)
    return tr


# ------------------------------------------------------------------ ranks
def _run(name: str, kw: dict, init: dict, toks, res: dict) -> None:
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import fused_sgd as K

    tr = _trainer(kw, init)
    history: dict[str, list] = {}
    calls = []
    real = K.fused_sgd_multi_

    def spy(params, *a, **k):  # the overlapped lane's update, a bucket a call
        calls.append(len(params))
        return real(params, *a, **k)

    K.fused_sgd_multi_ = spy
    import cs744_pytorch_distributed_tutorial_tpu_torch.parallel.overlap as OV

    OV.fused_sgd_multi_ = spy
    try:
        for s in range(STEPS):
            m = tr.train_step(*tr.split_batch(toks[s * BATCH : (s + 1) * BATCH]))
            for k, v in m.items():
                history.setdefault(k, []).append(float(v))
    finally:
        K.fused_sgd_multi_ = OV.fused_sgd_multi_ = real
    res.update({f"{name}/{k}": np.array(v) for k, v in history.items()})
    res.update({f"{name}/params/{k}": v.numpy() for k, v in tr.state_dict().items()})
    res[f"{name}/sgd_calls"] = np.array(len(calls))
    if tr.overlap is not None:
        res[f"{name}/buckets"] = np.array(tr.overlap.num_buckets)


def _dropout(rank: int, init: dict, toks, res: dict) -> None:
    """Every rank's loss on the same rows under dropout (step 0), drawn
    twice, and rank 0's against the forward under the one-device key."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.engine import _smoothed_xent

    tr = _trainer(dict(dropout_rate=DROPOUT), init)
    x, y = (torch.as_tensor(toks[:2], dtype=torch.int64)[:, :-1],
            torch.as_tensor(toks[:2], dtype=torch.int64)[:, 1:])
    with torch.no_grad():
        first = tr.objective(x, y, step=0)[0]
        again = tr.objective(x, y, step=0)[0]
        plain = tr.objective(x, y, step=1)[0]
        one_device = _smoothed_xent(tr.model(x, dropout=(tr.cfg.seed, 0, 0)).reshape(-1, V),
                                    y.reshape(-1), 0.0)
    res["dropout/loss"] = first.numpy()
    res["dropout/again"] = again.numpy()
    res["dropout/next_step"] = plain.numpy()
    res["dropout/one_device_key"] = np.array(bool(torch.equal(first, one_device)))
    losses = [float(tr.train_step(*tr.split_batch(toks[s * BATCH:(s + 1) * BATCH]))["loss"])
              for s in range(2)]
    res["dropout/train_losses"] = np.array(losses)


def _segments(name: str, kw: dict, init: dict, toks, res: dict) -> None:
    from cs744_pytorch_distributed_tutorial_tpu_torch.obs import phases as P

    tr = _trainer(kw, init)
    x, y = tr.split_batch(toks[:BATCH])
    before = tr.capture_state(clone=True)
    segs = P.build_lm_segments(tr)
    res[f"seg/{name}/has_sync"] = np.array(segs.sync is not None)
    report = P.profile_lm_phases(tr, x, y, iters=1)
    after = tr.capture_state()
    res[f"seg/{name}/restored"] = np.array(all(
        torch.equal(a, b) for key in ("params", "momentum", "opt_nu", "ef")
        for a, b in zip(before[key], after[key], strict=True)) and before["step"] == after["step"])
    res[f"seg/{name}/parity_ok"] = np.array(report.parity_ok)
    res[f"seg/{name}/n_chips"] = np.array(report.n_chips)
    sync = report.phase("grad_sync")
    res[f"seg/{name}/comm_bytes"] = np.array(sync.comm_bytes)
    res[f"seg/{name}/roofline"] = np.array(sync.roofline)
    res[f"seg/{name}/sync_wall_ms"] = np.array(sync.wall_ms)


def _worker(rank: int, port: int, init_path: str, out_path: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=WORLD,
                            rank=rank)
    try:
        init, toks, res = torch.load(init_path), _tokens(), {}
        for name, kw in RUNS.items():
            _run(name, kw, init if not kw.get("moe_experts") else torch.load(
                init_path.replace(".pt", "_moe.pt")), toks, res)
        _dropout(rank, init, toks, res)
        for name, kw in SEGMENTS.items():
            _segments(name, kw, init, toks, res)
        np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# -------------------------------------------------------------------- JAX
def _jax_run(name: str, mesh, toks) -> dict:
    import jax

    from cs744_pytorch_distributed_tutorial_tpu.train import LMConfig as JaxConfig
    from cs744_pytorch_distributed_tutorial_tpu.train import LMTrainer as JaxTrainer

    jt = JaxTrainer(JaxConfig(**SMALL, **RUNS[name]), mesh=mesh)
    params, opt = jt.init()
    init = jax.device_get(params)
    history: dict[str, list] = {}
    for s in range(STEPS):
        params, opt, m = jt.train_step(params, opt, *jt.shard_batch(toks[s * BATCH:(s + 1) * BATCH]),
                                       s)
        for k, v in m.items():
            history.setdefault(k, []).append(float(v))
    return {"init": init, "history": history, "params": jax.device_get(params)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each rank's results, JAX's runs by name)."""
    import jax

    from cs744_pytorch_distributed_tutorial_tpu.parallel import make_mesh
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import lm_params_from_jax

    tmp = tmp_path_factory.mktemp("lm_dp4")
    mesh = make_mesh({"data": WORLD, "seq": 1}, devices=jax.devices()[:WORLD])
    toks = _tokens()
    want = {name: _jax_run(name, mesh, toks) for name in ("allreduce", "moe_dropless")}
    torch.save(lm_params_from_jax(want["allreduce"]["init"]), tmp / "init.pt")
    torch.save(lm_params_from_jax(want["moe_dropless"]["init"]), tmp / "init_moe.pt")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(port),
                               str(tmp / "init.pt"), str(tmp / f"r{r}.npz")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    try:  # the ranks train while JAX compiles and runs
        for name in RUNS:
            if name not in want:
                want[name] = _jax_run(name, mesh, toks)
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    init = torch.load(tmp / "init.pt")
    return [dict(np.load(tmp / f"r{r}.npz")) for r in range(WORLD)], want, init


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("run", list(RUNS))
def test_trainer_matches_jax_on_four_ranks(runs, run):
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import lm_params_from_jax

    results, want, _ = runs
    kw = RUNS[run]
    jr = want[run]
    int8 = kw.get("grad_compress") == "int8"
    tol = INT8_TOL if int8 else FLOAT_TOL
    adam = not int8 and kw.get("optimizer", "adamw") == "adamw"
    params = lm_params_from_jax(jr["params"])
    for r, res in enumerate(results):
        assert sorted(k for k in jr["history"]) == sorted(
            k.split("/")[1] for k in res if k.startswith(f"{run}/") and k.count("/") == 1
            and k.split("/")[1] not in ("sgd_calls", "buckets"))
        for key, values in jr["history"].items():
            np.testing.assert_allclose(res[f"{run}/{key}"], values, **tol["losses"],
                                       err_msg=f"{run} {key}, rank {r}")
        if not adam:
            for name, value in params.items():
                np.testing.assert_allclose(res[f"{run}/params/{name}"], value.numpy(),
                                           **tol["params"], err_msg=f"{run} {name}, rank {r}")
            continue
        gaps = np.concatenate([np.abs(res[f"{run}/params/{n}"] - v.numpy()).ravel()
                               for n, v in params.items()])
        limit = np.concatenate([1e-6 + 1e-5 * np.abs(v.numpy()).ravel()
                                for v in params.values()])
        assert (gaps > limit).sum() <= ADAM_OUTLIERS * gaps.size, (run, r)
        assert gaps.max() <= SMALL["learning_rate"] * STEPS and gaps.mean() <= 1e-6, (run, r)


def test_metrics_are_the_world_means(runs):
    """Every rank reports the same loss, norms and MoE statistics."""
    results, _, _ = runs
    keys = [k for k in results[0] if k.startswith(RUNS_KEYS) and k.count("/") == 1]
    assert any(k.endswith("moe_load_entropy") for k in keys)
    for key in keys:
        for res in results[1:]:
            np.testing.assert_array_equal(res[key], results[0][key], err_msg=key)


RUNS_KEYS = tuple(f"{name}/" for name in RUNS)


def test_overlap_matches_the_fused_path_and_launches_a_bucket(runs):
    """sgd overlapped against fused: the same update a bucket at a time,
    one fused-SGD call a bucket a step (``OverlappedSGD``)."""
    results, _, _ = runs
    for res in results:
        buckets = int(res["sgd_overlap/buckets"])
        assert buckets > 1 and int(res["sgd_overlap/sgd_calls"]) == buckets * STEPS
        assert int(res["sgd/sgd_calls"]) == 0
        np.testing.assert_allclose(res["sgd_overlap/loss"], res["sgd/loss"], **OVERLAP_TOL)
        for key in (k for k in res if k.startswith("sgd/params/")):
            np.testing.assert_allclose(res[key.replace("sgd/", "sgd_overlap/", 1)], res[key],
                                       **OVERLAP_TOL, err_msg=key)
        assert int(res["sgd_int8_overlap/sgd_calls"]) > 0


def test_overlap_is_bitwise_the_fused_path_at_a_world_of_one():
    """At a world of one (a Gloo group of one: the all-reduces are copies)
    the overlapped sgd schedule is the fused path bit for bit."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        toks = _tokens()
        out = {}
        for name in ("sgd", "sgd_overlap"):
            tr = _trainer({**RUNS[name], "data_parallel": 1}, None)
            losses = [tr.train_step(*tr.split_batch(toks[s * BATCH:(s + 1) * BATCH]))["loss"]
                      for s in range(STEPS)]
            out[name] = (torch.stack(losses), tr.state_dict())
        assert torch.equal(out["sgd"][0], out["sgd_overlap"][0])
        for k, v in out["sgd"][1].items():
            assert torch.equal(out["sgd_overlap"][1][k], v), k
    finally:
        dist.destroy_process_group()


def test_dropout_masks_differ_by_rank_and_repeat(runs):
    results, _, _ = runs
    losses = [float(res["dropout/loss"]) for res in results]
    assert len(set(losses)) == WORLD  # the same rows, four masks
    for res in results:
        assert float(res["dropout/again"]) == float(res["dropout/loss"])  # redrawn exactly
        assert float(res["dropout/next_step"]) != float(res["dropout/loss"])
        assert np.isfinite(res["dropout/train_losses"]).all()
    assert bool(results[0]["dropout/one_device_key"])


def test_dropout_at_a_world_of_one_keeps_the_one_device_key(runs):
    """Without a process group the trainer's key is (seed, step,
    microbatch), the one-device trainer's key."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.engine import _smoothed_xent

    _, _, init = runs
    tr = _trainer(dict(dropout_rate=DROPOUT, data_parallel=1), init)
    toks = torch.as_tensor(_tokens()[:2], dtype=torch.int64)
    x, y = toks[:, :-1], toks[:, 1:]
    with torch.no_grad():
        got = tr.objective(x, y, step=3, microbatch=1)[0]
        want = _smoothed_xent(tr.model(x, dropout=(tr.cfg.seed, 3, 1)).reshape(-1, V),
                              y.reshape(-1), 0.0)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", list(SEGMENTS))
def test_lm_sync_segment_on_four_ranks(runs, name):
    results, _, _ = runs
    for res in results:
        assert bool(res[f"seg/{name}/has_sync"])
        assert bool(res[f"seg/{name}/parity_ok"]) and bool(res[f"seg/{name}/restored"])
        assert int(res[f"seg/{name}/n_chips"]) == WORLD
        assert float(res[f"seg/{name}/comm_bytes"]) > 0
        assert str(res[f"seg/{name}/roofline"]) == "comms"
        assert float(res[f"seg/{name}/sync_wall_ms"]) > 0


def test_int8_codes_are_jax_bitwise_in_one_flat_order():
    """Fed the same flat order (the LM's parameter shapes, the port's
    order, on both sides), the pure-DP int8 wire's buckets and their
    codes and scales equal JAX's bit for bit."""
    import jax.numpy as jnp

    from cs744_pytorch_distributed_tutorial_tpu.ops.quant import quantize_chunked as jax_quant
    from cs744_pytorch_distributed_tutorial_tpu.parallel import buckets as JB
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.transformer import TransformerLM
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops.quant import quantize_chunked
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import buckets as B
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.sync import QUANT_CHUNK

    shapes = [tuple(p.shape) for p in TransformerLM(
        **{k: SMALL[k] for k in ("vocab_size", "num_layers", "num_heads", "d_model", "d_ff",
                                 "max_seq_len", "use_rope")}).parameters()]
    rng = np.random.default_rng(11)
    grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    ef = [rng.standard_normal(s).astype(np.float32) * np.float32(1e-2) for s in shapes]
    bucket = int(SMALL_BUCKET_MB * 2**20)
    jl = JB.bucket_layout([jnp.asarray(g) for g in grads], bucket, rows=0)
    tl = B.bucket_layout([torch.from_numpy(g) for g in grads], bucket, rows=0)
    assert tl.bucket_cols == jl.bucket_cols and len(tl.bucket_cols) > 1
    jg = JB.flatten_for_sync([jnp.asarray(g) for g in grads], jl)
    je = JB.flatten_for_sync([jnp.asarray(e) for e in ef], jl)
    tg = B.flatten_for_sync([torch.from_numpy(g) for g in grads], tl)
    te = B.flatten_for_sync([torch.from_numpy(e) for e in ef], tl)
    for a, b, c, d in zip(jg, je, tg, te, strict=True):
        jb = np.asarray(a) + np.asarray(b)
        tb = c + d
        np.testing.assert_array_equal(tb.numpy(), jb)
        pad = WORLD * (-(-jb.size // (WORLD * QUANT_CHUNK))) * QUANT_CHUNK - jb.size
        jq, js = jax_quant(jnp.pad(jnp.asarray(jb), (0, pad)), QUANT_CHUNK)
        tq, ts = quantize_chunked(torch.nn.functional.pad(tb, (0, pad)), QUANT_CHUNK)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
