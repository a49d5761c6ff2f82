"""The port's sharded optimizers (``parallel/zero.py``) against the JAX
package's: ZeRO-1 and FSDP in the Trainer on 4 Gloo ranks, and
``Zero1SGD`` on lists of tensors.

One launch of 4 processes (this file, run as a script) does both.

- The Trainer: tiny_cnn, global batch 16 (4 a rank), augmentation off,
  lr 0.02, 5 steps from the JAX Trainer's initialization carried over
  (``models/convert.py``), against the JAX Trainer on 4 host devices:
  zero1 per tensor, bucketed (2 KiB buckets: several), overlapped, with
  accumulation and on the int8 wire; fsdp per tensor, bucketed,
  overlapped and with accumulation. Losses (the world mean) agree at
  rtol 1e-5; the final parameters, each rank's momentum rows (and fsdp's
  parameter rows) against row r of JAX's ``[4, chunk]`` leaves, and the
  BatchNorm running means at rtol 1e-5, atol 1e-6: the reduce-scatter
  sums in gloo's order, the convolutions in another order. Running
  variances differ by the Bessel convention (``BESSEL_RTOL``, as in
  ``test_torch_port_trainer_dp4.py``). The int8 wire quantizes each
  framework's own flat order of the tensors (OIHW against HWIO), so
  its chunks hold other elements: held to ``INT8_RTOL``, the wire's own
  error.
- The collectives a step, counted at the ``torch.distributed`` calls,
  equal the JAX ``*_collective_schedule`` of the port's bucket count.
- FSDP holds its rows only: the module's own parameters are empty and
  each rank persists ``[chunk]`` parameters and momentum.
- ``Zero1SGD.apply`` on a list of odd-sized tensors (the same order on
  both sides, so the same buckets): per tensor and bucketed within rtol
  1e-6, atol 1e-7 of JAX's (gloo's summation order); the int8 wire's
  codes bit for bit, its parameters, momentum and residuals within 2^-20
  of the largest input (``test_torch_port_int8_wire.py``: XLA fuses a
  dequantize into the following add).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

WORLD, STEPS, BATCH, LR = 4, 5, 16, 0.02
SMALL_BUCKET_MB = 2048 / 2**20  # 128 columns of 4 rows: tiny_cnn in 5 buckets
RUNS = {
    "zero1_leaf": dict(sync="zero1", sync_bucket_mb=0),
    "zero1_bucket": dict(sync="zero1", sync_bucket_mb=SMALL_BUCKET_MB),
    "zero1_overlap": dict(sync="zero1", sync_bucket_mb=SMALL_BUCKET_MB, sync_overlap="bucket"),
    "zero1_overlap_accum2": dict(sync="zero1", sync_bucket_mb=SMALL_BUCKET_MB,
                                 sync_overlap="bucket", accum_steps=2),
    "zero1_int8": dict(sync="zero1", grad_compress="int8", sync_overlap="bucket+int8"),
    "fsdp_leaf": dict(sync="fsdp", sync_bucket_mb=0),
    "fsdp_bucket": dict(sync="fsdp", sync_bucket_mb=SMALL_BUCKET_MB),
    "fsdp_overlap": dict(sync="fsdp", sync_bucket_mb=SMALL_BUCKET_MB, sync_overlap="bucket"),
    "fsdp_accum2": dict(sync="fsdp", sync_bucket_mb=SMALL_BUCKET_MB, accum_steps=2),
}
COMMON = dict(model="tiny_cnn", num_devices=WORLD, global_batch_size=BATCH,
              synthetic_data=True, augment=False, learning_rate=LR)
BESSEL_RTOL = 1 / 511 + 1e-5  # see test_torch_port_trainer_dp4.py
# The int8 wire rounds each element by up to half a step of its 127-level
# chunk scale a step; under another chunking the two trajectories part by
# that much, compounded by the momentum. Losses: the short-run bar of the
# int8 wire in test_torch_port_overlap.py (rtol 0.02; measured 1.04e-2 at
# step 4). The rest: about
# 3x the gap measured over 5 steps (parameters 1.6e-3, momentum rows
# 2.0e-2, running statistics 8.7e-4 of their largest value).
INT8_TOL = {"losses": dict(rtol=0.02), "params": dict(rtol=0, atol=5e-3),
            "mom": dict(rtol=0, atol=5e-2), "stats": dict(rtol=3e-3, atol=3e-3)}
COUNTED = ("reduce_scatter_tensor", "all_gather_into_tensor", "all_to_all_single", "all_gather")
KIND = {"reduce_scatter_tensor": "reduce_scatter", "all_gather_into_tensor": "all_gather",
        "all_to_all_single": "all_to_all", "all_gather": "all_gather"}

LEAVES = [(3, 5, 7), (10,), (1,), (16, 3, 3, 3), (300,), (40, 25)]
LEAF_BUCKET = 2048
LEAF_LR, LEAF_MU, LEAF_WD = 0.1, 0.9, 1e-2
TOL = 2.0**-20
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------- the inputs
def _dataset():
    from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_cifar10

    return synthetic_cifar10(STEPS * BATCH, 8, seed=0)


def _leaf_inputs(rank: int) -> dict[str, list[np.ndarray]]:
    """Parameters (the same on every rank), this rank's gradients and
    residuals, and every rank's momentum rows ``[4, chunk]``."""
    rng = np.random.default_rng(7)
    params = [rng.standard_normal(s).astype(np.float32) for s in LEAVES]
    moms = [rng.standard_normal((WORLD, -(-int(np.prod(s)) // WORLD))).astype(np.float32)
            for s in LEAVES]
    own = np.random.default_rng(100 + rank)
    grads = [own.standard_normal(s).astype(np.float32) for s in LEAVES]
    ef = [own.standard_normal(s).astype(np.float32) * np.float32(1e-2) for s in LEAVES]
    return {"params": params, "moms": moms, "grads": grads, "ef": ef}


LEAF_CASES = {  # name: (bucket_bytes, overlap layout, int8 wire)
    "leaf": (0, False, False),
    "bucket": (LEAF_BUCKET, False, False),
    "reverse": (LEAF_BUCKET, True, False),
    "int8": (LEAF_BUCKET, True, True),
}


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


def _worker(rank: int, port: int, init_path: str, out_path: str) -> None:
    import torch.distributed as dist

    from cs744_pytorch_distributed_tutorial_tpu_torch.config import TrainConfig
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import jax_from_state_dict
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.zero import Zero1SGD
    from cs744_pytorch_distributed_tutorial_tpu_torch.train import Trainer

    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", world_size=WORLD, rank=rank
    )
    counts = _count_collectives()
    try:
        res = {}
        init = torch.load(init_path)
        ds = _dataset()
        per = BATCH // WORLD
        for run, kw in RUNS.items():
            tr = Trainer(TrainConfig(**COMMON, **kw, device="cpu"))
            tr.load_state_dict(init)
            losses = []
            for s in range(STEPS):
                lo = s * BATCH + rank * per
                x = torch.from_numpy(ds.train_images[lo : lo + per])
                y = torch.from_numpy(ds.train_labels[lo : lo + per].astype(np.int64))
                for name in COUNTED:
                    counts[name] = 0
                loss = tr.train_step(x, y)
                if s == 1:
                    res.update({f"{run}/count/{k}": np.array(v) for k, v in counts.items()})
                losses.append(tr.global_mean(loss))
            res[f"{run}/losses"] = np.array(losses)
            for name, v in _flat(jax_from_state_dict(tr.state_dict(), "tiny_cnn")).items():
                res[f"{run}/{name}"] = v
            names = tr._param_names if tr._fsdp else [n for n, _ in tr.model.named_parameters()]
            res.update({f"{run}/mom/{n}": m.numpy() for n, m in zip(names, tr.state.momentum)})
            if tr._fsdp:
                res.update({f"{run}/shard/{n}": p.detach().numpy()
                            for n, p in zip(names, tr.state.params)})
                res[f"{run}/module_numel"] = np.array(
                    sum(p.numel() for p in tr.model.parameters()))
            res[f"{run}/units"] = np.array(len(tr.tx.layout(
                tr._param_shapes if tr._fsdp else tr.params).bucket_cols))

        for case, (bucket_bytes, overlap, int8) in LEAF_CASES.items():
            inp = _leaf_inputs(rank)
            params = [torch.from_numpy(p.copy()) for p in inp["params"]]
            moms = [torch.from_numpy(m[rank].copy()) for m in inp["moms"]]
            ef = [torch.from_numpy(e.copy()) for e in inp["ef"]] if int8 else None
            zero = Zero1SGD(LEAF_LR, LEAF_MU, LEAF_WD, WORLD, bucket_bytes=bucket_bytes,
                            overlap=overlap)
            zero.apply(params, moms, [torch.from_numpy(g) for g in inp["grads"]], ef=ef)
            res.update({f"leaf/{case}/p/{i}": p.numpy() for i, p in enumerate(params)})
            res.update({f"leaf/{case}/m/{i}": m.numpy() for i, m in enumerate(moms)})
            if int8:
                res.update({f"leaf/{case}/ef/{i}": e.numpy() for i, e in enumerate(ef)})
        np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(tree[k])
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# -------------------------------------------------------------------- JAX
def _jax_run(run: str, mesh, ds):
    import jax

    from cs744_pytorch_distributed_tutorial_tpu.config import TrainConfig as JaxConfig
    from cs744_pytorch_distributed_tutorial_tpu.parallel.mesh import shard_global_batch
    from cs744_pytorch_distributed_tutorial_tpu.train import Trainer as JaxTrainer

    jtr = JaxTrainer(JaxConfig(**COMMON, **RUNS[run]), mesh=mesh)
    state = jtr.init()
    init = {"params": jax.tree.map(np.asarray, state.params),
            "batch_stats": jax.tree.map(lambda a: np.asarray(a)[0], state.batch_stats)}
    key = jax.random.key(0)
    losses = []
    for s in range(STEPS):
        xb, yb = shard_global_batch(mesh, ds.train_images[s * BATCH : (s + 1) * BATCH],
                                    ds.train_labels[s * BATCH : (s + 1) * BATCH])
        state, metrics = jtr.train_step(state, xb, yb, key)
        losses.append(float(metrics["loss"]))
    final = jax.tree.map(np.asarray, {"params": state.params, "opt": state.opt_state,
                                      "batch_stats": state.batch_stats})
    return init, np.array(losses), final


def _jax_leaf_case(case: str, mesh):
    import jax
    from jax.sharding import PartitionSpec as P

    from cs744_pytorch_distributed_tutorial_tpu.parallel.zero import Zero1SGD as JaxZero1

    bucket_bytes, overlap, int8 = LEAF_CASES[case]
    inp = [_leaf_inputs(r) for r in range(WORLD)]
    params = inp[0]["params"]
    moms = inp[0]["moms"]
    grads = [np.stack([inp[r]["grads"][i] for r in range(WORLD)]) for i in range(len(LEAVES))]
    ef = [np.stack([inp[r]["ef"][i] for r in range(WORLD)]) for i in range(len(LEAVES))]
    tx = JaxZero1(LEAF_LR, LEAF_MU, LEAF_WD, "data", WORLD, bucket_bytes=bucket_bytes,
                  overlap=overlap)

    def local(ps, ms, gs, es):
        gs = [g[0] for g in gs]
        if not int8:
            new_p, new_m = tx.apply(ps, ms, gs)
            return new_p, new_m, es
        new_p, new_m, new_e = tx.apply(ps, ms, gs, ef=[e[0] for e in es])
        return new_p, new_m, [e[None] for e in new_e]

    fn = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(P(), P("data"), P("data"), P("data")),
                               out_specs=(P(), P("data"), P("data")), check_vma=False))
    new_p, new_m, new_e = jax.tree.map(np.asarray, fn(params, moms, grads, ef))
    return new_p, new_m, new_e


# ------------------------------------------------------------------ tests
@pytest.fixture(scope="module")
def runs(tmp_path_factory, mesh4):
    """(each rank's results, JAX's runs, JAX's list cases)."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import state_dict_from_jax

    tmp = tmp_path_factory.mktemp("zero")
    ds = _dataset()
    first = list(RUNS)[0]
    init, *run = _jax_run(first, mesh4, ds)
    torch.save(state_dict_from_jax(init, "tiny_cnn"), tmp / "init.pt")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(port), str(tmp / "init.pt"),
             str(tmp / f"r{r}.npz")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(WORLD)
    ]
    try:  # the ranks train while JAX compiles and runs
        want = {first: (init, *run)}
        for name in list(RUNS)[1:]:
            want[name] = _jax_run(name, mesh4, ds)
        leaf = {case: _jax_leaf_case(case, mesh4) for case in LEAF_CASES}
        logs = [p.communicate(timeout=200)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [dict(np.load(tmp / f"r{r}.npz")) for r in range(WORLD)], want, leaf


def _unshard(rows: dict, like: dict) -> dict:
    """A flax tree of ``[4, chunk]`` rows -> the full tensors of ``like``."""
    return {k: {n: v.reshape(-1)[: like[k][n].size].reshape(like[k][n].shape)
                for n, v in leaf.items()} for k, leaf in rows.items()}


@pytest.mark.parametrize("run", list(RUNS))
def test_trainer_matches_jax_on_four_ranks(runs, run):
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import zero_rows_from_jax

    results, want, _ = runs
    init, losses, final = want[run]
    like = want["zero1_leaf"][0]["params"]
    fsdp = run.startswith("fsdp")
    if fsdp:  # its init is JAX's [4, chunk] rows of zero1's
        init = {**init, "params": _unshard(init["params"], like)}
    for a, b in zip(_flat(init).values(), _flat(want["zero1_leaf"][0]).values(), strict=True):
        np.testing.assert_array_equal(a, b)  # every run starts from one init
    float_tol = dict(rtol=1e-5, atol=1e-6)
    tol = INT8_TOL if run.endswith("int8") else dict(
        losses=dict(rtol=1e-5), params=float_tol, mom=float_tol, stats=float_tol)
    params = _unshard(final["params"], like) if fsdp else final["params"]
    for r in range(WORLD):
        res = results[r]
        np.testing.assert_allclose(res[f"{run}/losses"], losses, **tol["losses"],
                                   err_msg=f"{run} losses, rank {r}")
        for name, value in _flat(params).items():
            np.testing.assert_allclose(res[f"{run}/params/{name}"], value, **tol["params"],
                                       err_msg=f"{run} {name}, rank {r}")
        for name, value in _flat(final["batch_stats"]).items():
            got = res[f"{run}/batch_stats/{name}"]
            stat_tol = dict(tol["stats"], rtol=BESSEL_RTOL) if name.endswith("/var") else tol["stats"]
            np.testing.assert_allclose(got, value[r], **stat_tol, err_msg=f"{run} {name}, rank {r}")
        rows = {"mom": final["opt"]} | ({"shard": final["params"]} if fsdp else {})
        for kind, tree in rows.items():
            kind_tol = tol["mom" if kind == "mom" else "params"]
            for name, row in zero_rows_from_jax(tree, like, "tiny_cnn", r).items():
                np.testing.assert_allclose(res[f"{run}/{kind}/{name}"], row.numpy(), **kind_tol,
                                           err_msg=f"{run} {kind} {name}, rank {r}")


@pytest.mark.parametrize("run", list(RUNS))
def test_collectives_a_step_follow_the_jax_schedule(runs, run):
    from cs744_pytorch_distributed_tutorial_tpu.parallel import zero as JZ

    results, _, _ = runs
    kw = RUNS[run]
    bucketed = kw.get("sync_bucket_mb", 4.0) > 0
    units = int(results[0][f"{run}/units"]) if bucketed else 10
    if run.endswith("int8"):
        want = JZ.zero1_int8_collective_schedule(units, WORLD)
    elif run.startswith("fsdp"):
        # Every microbatch differentiates through the gather.
        want = JZ.fsdp_collective_schedule(units * kw.get("accum_steps", 1), WORLD)
    else:
        want = JZ.zero1_collective_schedule(units, WORLD)
    for r in range(WORLD):
        got: dict[str, int] = {}
        for name, kind in KIND.items():
            n = int(results[r][f"{run}/count/{name}"])
            if n:
                got[kind] = got.get(kind, 0) + n
        assert got == want, (run, r)
    if kw.get("sync_bucket_mb"):
        assert units > 1


def test_fsdp_holds_its_rows_only(runs):
    """Between steps each rank keeps its [chunk] rows of every parameter
    and momentum buffer; the module's own parameters are empty."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.models import get_model

    results, _, _ = runs
    shapes = dict(get_model("tiny_cnn").named_parameters())
    chunks = {n: -(-p.numel() // WORLD) for n, p in shapes.items()}
    for run in (r for r in RUNS if r.startswith("fsdp")):
        for res in results:
            assert int(res[f"{run}/module_numel"]) == 0
            for kind in ("shard", "mom"):
                got = {n: res[f"{run}/{kind}/{n}"].shape for n in chunks}
                assert got == {n: (c,) for n, c in chunks.items()}, (run, kind)
            held = sum(res[f"{run}/{k}/{n}"].nbytes for k in ("shard", "mom") for n in chunks)
            assert held == 2 * 4 * sum(chunks.values()) < 2 * 4 * sum(
                p.numel() for p in shapes.values()) / 3


@pytest.mark.parametrize("case", list(LEAF_CASES))
def test_zero1_apply_matches_jax_on_lists(runs, case):
    results, _, leaf = runs
    new_p, new_m, new_e = leaf[case]
    int8 = LEAF_CASES[case][2]
    if int8:
        inputs = [_leaf_inputs(r) for r in range(WORLD)]
        atol = TOL * max(float(np.abs(g + e).max()) for inp in inputs
                         for g, e in zip(inp["grads"], inp["ef"]))
        rtol = 0.0
    else:
        rtol, atol = 1e-6, 1e-7
    for r, res in enumerate(results):
        for i in range(len(LEAVES)):
            np.testing.assert_allclose(res[f"leaf/{case}/p/{i}"], new_p[i], rtol=rtol,
                                       atol=atol, err_msg=f"{case} p {i}, rank {r}")
            np.testing.assert_allclose(res[f"leaf/{case}/m/{i}"], new_m[i][r], rtol=rtol,
                                       atol=atol, err_msg=f"{case} m {i}, rank {r}")
            if int8:
                np.testing.assert_allclose(res[f"leaf/{case}/ef/{i}"], new_e[i][r], rtol=rtol,
                                           atol=atol, err_msg=f"{case} ef {i}, rank {r}")
                assert np.abs(res[f"leaf/{case}/ef/{i}"]).max() > 0


def test_zero1_int8_codes_are_jax_bitwise():
    """The int8 wire's payload is a bucket's ``[n, cols]`` rows of g + ef,
    flattened: its codes and scales equal JAX's bit for bit."""
    import jax.numpy as jnp

    from cs744_pytorch_distributed_tutorial_tpu.ops.quant import quantize_chunked as jax_quant
    from cs744_pytorch_distributed_tutorial_tpu.parallel import buckets as JB
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops.quant import quantize_chunked
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import buckets as B
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.sync import QUANT_CHUNK

    for r in range(WORLD):
        inp = _leaf_inputs(r)
        jl = JB.bucket_layout([jnp.asarray(g) for g in inp["grads"]], LEAF_BUCKET, rows=WORLD,
                              reverse=True)
        tl = B.bucket_layout([torch.from_numpy(g) for g in inp["grads"]], LEAF_BUCKET,
                             rows=WORLD, reverse=True)
        assert len(tl.bucket_cols) == len(jl.bucket_cols) > 1
        jg = JB.flatten_for_sync([jnp.asarray(g) for g in inp["grads"]], jl)
        je = JB.flatten_for_sync([jnp.asarray(e) for e in inp["ef"]], jl)
        tg = B.flatten_for_sync([torch.from_numpy(g) for g in inp["grads"]], tl)
        te = B.flatten_for_sync([torch.from_numpy(e) for e in inp["ef"]], tl)
        for a, b, c, d in zip(jg, je, tg, te, strict=True):
            jb = np.asarray(a).reshape(-1) + np.asarray(b).reshape(-1)
            tb = c.reshape(-1) + d.reshape(-1)
            np.testing.assert_array_equal(tb.numpy(), jb)
            size = jb.size
            m = -(-size // (WORLD * QUANT_CHUNK))
            pad = WORLD * m * QUANT_CHUNK - size
            jq, js = jax_quant(jnp.pad(jnp.asarray(jb), (0, pad)), QUANT_CHUNK)
            tq, ts = quantize_chunked(torch.nn.functional.pad(tb, (0, pad)), QUANT_CHUNK)
            np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("units", [1, 5, 62])
@pytest.mark.parametrize("world", [1, 4])
def test_schedule_functions_are_jax_s(units, world):
    from cs744_pytorch_distributed_tutorial_tpu.parallel import zero as JZ
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import zero as Z

    for name in ("zero1_collective_schedule", "fsdp_collective_schedule",
                 "zero1_int8_collective_schedule"):
        assert getattr(Z, name)(units, world) == getattr(JZ, name)(units, world)


def test_rows_round_trip_through_the_jax_layout():
    from cs744_pytorch_distributed_tutorial_tpu_torch.models import get_model
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import (
        jax_from_state_dict,
        jax_rows_from_zero,
        shard_row,
        zero_rows_from_jax,
    )

    torch.manual_seed(0)
    sd = {k: torch.randn_like(v) if v.is_floating_point() else v
          for k, v in get_model("tiny_cnn").state_dict().items()}
    names = [n for n, _ in get_model("tiny_cnn").named_parameters()]
    ranks = [{n: shard_row(sd[n], r, WORLD) for n in names} for r in range(WORLD)]
    rows = jax_rows_from_zero(ranks, {n: tuple(sd[n].shape) for n in names}, "tiny_cnn")
    like = jax_from_state_dict(sd, "tiny_cnn")["params"]
    for leaf, ref in zip(_flat(rows).values(), _flat(like).values(), strict=True):
        assert leaf.shape == (WORLD, -(-ref.size // WORLD))
        np.testing.assert_array_equal(leaf.reshape(-1)[: ref.size], ref.reshape(-1))
    for r in range(WORLD):
        back = zero_rows_from_jax(rows, like, "tiny_cnn", r)
        assert list(back) == names
        for n in names:
            np.testing.assert_array_equal(back[n].numpy(), ranks[r][n].numpy())


@pytest.mark.parametrize(
    "kw,match",
    [
        (dict(sync="zero1", fused_optimizer=True), "zero1"),
        (dict(sync="fsdp", fused_optimizer=True), "fsdp"),
        (dict(sync="fsdp", debug_sync_check=True), "debug_sync_check"),
        (dict(sync="fsdp", grad_compress="int8"), "fsdp"),
        (dict(sync="zero1", grad_compress="int8"), "bucket\\+int8"),
        (dict(sync="fsdp", grad_compress="int8", sync_overlap="bucket+int8"), "fsdp"),
        (dict(sync="zero1", sync_overlap="bucket+int8"), "int8"),
    ],
)
def test_rejections(kw, match):
    """The JAX Trainer's rejections (``tests/test_zero1.py``,
    ``tests/test_fsdp.py``), raised before any process group is needed."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.config import TrainConfig
    from cs744_pytorch_distributed_tutorial_tpu_torch.train import Trainer

    with pytest.raises(ValueError, match=match):
        Trainer(TrainConfig(model="tiny_cnn", global_batch_size=16, device="cpu", **kw))


def test_zero1_int8_needs_the_bucketed_path():
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.zero import Zero1SGD

    p = [torch.zeros(10)]
    zero = Zero1SGD(0.1, 0.9, 0.0, 4, bucket_bytes=0)
    with pytest.raises(ValueError, match="bucketed path"):
        zero.apply(p, [torch.zeros(3)], [torch.ones(10)], ef=[torch.zeros(10)])


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
