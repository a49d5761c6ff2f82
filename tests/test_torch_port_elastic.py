"""The elastic restore and the re-mesh (``parallel/zero.py``'s re-chunk,
``utils/checkpoint.py``, ``utils/memstore.py``, the trainers'
``elastic_state``, ``parallel/elastic.py``) against the JAX package.

- ``rechunk_elastic``, ``chunk_local_sizes``, ``local_chunk_shapes`` and
  ``make_elastic_adapt`` bit for bit against JAX's on the same
  numpy-seeded arrays, the padding and both errors included.
- One launch of 4 Gloo processes (this file, run as a script) saves the
  LM (1 layer, d 16, vocab 32, T 16, global batch 12, AdamW) under zero1
  and fsdp at 4, 2 and 3 ranks and restores each checkpoint at 2, 4 and
  1 ranks. Each restored rank's rows (both moments; fsdp's parameters)
  equal, bit for bit, JAX's ``adapt_and_place`` with the JAX trainer's
  own ``make_elastic_adapt`` hook on the same saved tree, converted
  through ``models/convert.py``. The CIFAR trainer's per-replica
  BatchNorm buffers are sliced (4 -> 2) and tiled (2 -> 4) as JAX's
  ``adapt_host_leaf`` does, and a CIFAR zero1 checkpoint across worlds
  raises JAX's ``ValueError``.
- The same launch: a ``device_loss`` of ranks 2 and 3 at step 2 of a
  4-rank zero1 run with ``snapshot_every=1`` under ``run_chaos(...,
  remesh=default_remesh)`` goes on at 2 ranks with no checkpoint read;
  its losses equal JAX's uninterrupted dp4 trajectory (from the port's
  initial parameters) at rtol 1e-6 (JAX ``tests/test_chaos.py``'s bar).
"""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
TINY = dict(vocab_size=32, num_layers=1, num_heads=2, d_model=16, d_ff=32, max_seq_len=64,
            seq_len=16, attention_impl="dense")
LM_SCENARIOS = [("zero1", 4, 2), ("zero1", 2, 4), ("zero1", 3, 1),
                ("fsdp", 4, 2), ("fsdp", 2, 4), ("fsdp", 3, 1)]
CIFAR_SCENARIOS = [("cifar", 4, 2), ("cifar", 2, 4), ("cifar_zero1", 2, 4)]
# The MoE LM with its experts split over the data axis (zero1): whole
# experts re-shard across the new data axis, in the state and in the rows.
MOE = dict(moe_experts=4, moe_expert_parallel=True, moe_dispatch="scatter")
MOE_SCENARIOS = [("zero1_moe", 4, 2), ("zero1_moe", 2, 4)]
CIFAR = dict(model="tiny_cnn", sync="allreduce", augment=False, global_batch_size=8,
             synthetic_data=True, synthetic_train_size=8, synthetic_test_size=8, seed=0,
             device="cpu", learning_rate=0.05)
LOSS_STEPS, LOST = 6, [2, 3]


def _scenario_dir(root, kind, a, b):
    return os.path.join(root, f"{kind}_{a}_{b}")


# ------------------------------------------------------------------ ranks
def _group(world: int, rank: int, store: str) -> None:
    """Join a Gloo group of ``world`` ranks that meet at the file ``store``
    (no port to collide with the sockets earlier groups left open)."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank)


def _lm_cfg(mode: str, dp: int, **kw):
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMConfig

    if mode == "zero1_moe":
        mode, kw = "zero1", dict(kw, **MOE)
    return LMConfig(**TINY, global_batch_size=12, data_parallel=dp, device="cpu",
                    **{mode: True}, **kw)


def _lm_scenario(rank, root, mode, a, b, res):
    import torch.distributed as dist

    from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_tokens
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMTrainer
    from cs744_pytorch_distributed_tutorial_tpu_torch.utils.checkpoint import Checkpointer

    d = _scenario_dir(root, mode, a, b)
    toks = synthetic_tokens(24, 16, 32, seed=0)
    if rank < a:
        _group(a, rank, d + ".save")
        tr = LMTrainer(_lm_cfg(mode, a))
        tr.init()
        for s in range(2):
            tr.train_step(*tr.split_batch(toks[s * 12:(s + 1) * 12]))
        ck = Checkpointer(d)
        ck.save(tr.capture_state(), wait=True)
        ck.close()
        full = {k: v.clone() for k, v in tr.state_dict().items()}  # every rank joins
        if rank == 0:
            res[f"{mode}_{a}_{b}/saved_state_dict"] = full
        dist.destroy_process_group()
    if rank < b:
        _group(b, rank, d + ".restore")
        tr = LMTrainer(_lm_cfg(mode, b))
        tr.init()
        ck = Checkpointer(d)
        st = ck.restore_latest(adapt=tr.elastic_state)
        key = f"{mode}_{a}_{b}"
        res[f"{key}/read"] = ck.last_read
        res[f"{key}/state"] = st
        tr.restore_state(st)
        res[f"{key}/state_dict"] = {k: v.clone() for k, v in tr.state_dict().items()}
        m = tr.train_step(*tr.split_batch(toks[:12]))
        res[f"{key}/next_loss"] = float(m["loss"])
        ck.close()
        dist.destroy_process_group()


def _cifar_scenario(rank, root, kind, a, b, res):
    import torch.distributed as dist

    from cs744_pytorch_distributed_tutorial_tpu_torch.config import TrainConfig
    from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_cifar10
    from cs744_pytorch_distributed_tutorial_tpu_torch.train import Trainer
    from cs744_pytorch_distributed_tutorial_tpu_torch.utils.checkpoint import Checkpointer

    d = _scenario_dir(root, kind, a, b)
    kw = dict(CIFAR, sync="zero1") if kind == "cifar_zero1" else CIFAR
    ds = synthetic_cifar10(8, 8, seed=3)
    if rank < a:
        _group(a, rank, d + ".save")
        tr = Trainer(TrainConfig(**kw, num_devices=a))
        per = 8 // a
        x = torch.as_tensor(ds.train_images[rank * per:(rank + 1) * per])
        y = torch.as_tensor(ds.train_labels[rank * per:(rank + 1) * per]).long()
        tr.train_step(x, y)
        ck = Checkpointer(d)
        ck.save(tr.capture_state(), wait=True)
        ck.close()
        dist.destroy_process_group()
    if rank < b:
        _group(b, rank, d + ".restore")
        tr = Trainer(TrainConfig(**kw, num_devices=b))
        ck = Checkpointer(d)
        try:
            st = ck.restore_latest(adapt=tr.elastic_state)
            tr.restore_state(st)
            res[f"{kind}_{a}_{b}/state"] = st
        except ValueError as e:
            res[f"{kind}_{a}_{b}/error"] = str(e)
        ck.close()
        dist.destroy_process_group()


def _device_loss(rank, root, res):
    from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_tokens
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.elastic import (
        RankRetired,
        default_remesh,
    )
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.mesh import shutdown
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMConfig, LMTrainer
    from cs744_pytorch_distributed_tutorial_tpu_torch.utils.chaos import FaultSchedule, run_chaos
    from cs744_pytorch_distributed_tutorial_tpu_torch.utils.checkpoint import Checkpointer

    _group(WORLD, rank, os.path.join(root, "device_loss.store"))
    tokens = synthetic_tokens(8, 16, 32, seed=0)
    tr = LMTrainer(LMConfig(**TINY, global_batch_size=8, data_parallel=WORLD, zero1=True,
                            snapshot_every=1, device="cpu"))
    memstore = tr.memstore
    restores = Checkpointer.total_restores
    try:
        _, _, losses, restarts, monkey = run_chaos(
            tr, FaultSchedule({2: {"kind": "device_loss", "lost": LOST}}),
            remesh=default_remesh, fit_args=(tokens, LOSS_STEPS), max_restarts=2)
    except RankRetired as e:
        res["dl/retired"] = e.rank
        return
    import torch.distributed as dist

    res["dl/world_after"] = dist.get_world_size()
    res["dl/losses"] = np.array(losses)
    res["dl/restarts"] = restarts
    res["dl/injected"] = monkey.injected
    res["dl/disk_restores"] = Checkpointer.total_restores - restores
    res["dl/mem_restores"] = memstore.restores
    res["dl/gathered_bytes"] = memstore.gathered_bytes
    shutdown()


def _worker(rank: int, root: str) -> None:
    torch.set_num_threads(1)
    res: dict = {}
    for kind, a, b in LM_SCENARIOS + MOE_SCENARIOS:
        _lm_scenario(rank, root, kind, a, b, res)
    for kind, a, b in CIFAR_SCENARIOS:
        _cifar_scenario(rank, root, kind, a, b, res)
    _device_loss(rank, root, res)
    torch.save(res, os.path.join(root, f"rank{rank}.res"))


# -------------------------------------------------------------------- JAX
def _port_init_state_dict() -> dict:
    """The port's initial LM parameters (the seed's draw at global shapes,
    the same at every layout)."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMConfig, LMTrainer

    tr = LMTrainer(LMConfig(**TINY, global_batch_size=8, device="cpu"))
    tr.init()
    return {k: v.detach().clone() for k, v in tr.state_dict().items()}


def _jax_dp4_losses(init_sd: dict, tokens) -> list[float]:
    """JAX's uninterrupted dp4 zero1 trajectory from the port's initial
    parameters, on the LM fit's batch plan."""
    import jax

    from cs744_pytorch_distributed_tutorial_tpu.parallel import make_mesh
    from cs744_pytorch_distributed_tutorial_tpu.train import LMConfig, LMTrainer
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import (
        jax_lm_params_from_state_dict,
    )

    mesh = make_mesh({"data": WORLD, "seq": 1}, devices=jax.devices()[:WORLD])
    jt = LMTrainer(LMConfig(**TINY, global_batch_size=8, data_parallel=WORLD, zero1=True),
                   mesh=mesh)
    params, opt = jt.init()
    converted = jax_lm_params_from_state_dict({k: v.numpy() for k, v in init_sd.items()})
    params = jax.tree.map(lambda p, c: jax.device_put(np.asarray(c, np.float32), p.sharding),
                          params, converted)
    losses, n, b = [], len(tokens), 8
    for step in range(LOSS_STEPS):
        lo = (step * b) % max(n - b + 1, 1)
        params, opt, m = jt.train_step(params, opt, *jt.shard_batch(tokens[lo:lo + b]), step)
        losses.append(float(m["loss"]))
    return losses


def _jax_restore(mode: str, a: int, b: int, rank_states: list[dict], names: list[str],
                 shapes: dict) -> list[dict]:
    """JAX's elastic restore of the saved tree (the ranks' rows as JAX's
    ``[a, chunk]`` leaves) at ``b`` devices: ``adapt_and_place`` with the
    JAX trainer's own adapt hook; back as each new rank's rows by name."""
    import jax

    from cs744_pytorch_distributed_tutorial_tpu.parallel import make_mesh
    from cs744_pytorch_distributed_tutorial_tpu.train import LMConfig, LMTrainer
    from cs744_pytorch_distributed_tutorial_tpu.utils.checkpoint import adapt_and_place
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import (
        jax_lm_params_from_state_dict,
        jax_lm_zero_state,
        lm_zero_state_from_jax,
    )

    jt = LMTrainer(LMConfig(**TINY, global_batch_size=12, data_parallel=b, **{mode: True}),
                   mesh=make_mesh({"data": b, "seq": 1}, devices=jax.devices()[:b]))
    fsdp = mode == "fsdp"

    def zero_state(st):
        out = {"mu": dict(zip(names, st["momentum"])), "nu": dict(zip(names, st["opt_nu"])),
               "count": st["opt_count"]}
        if fsdp:
            out["params"] = dict(zip(names, st["params"]))
        return out

    def tree(z):
        t = {"opt_state": {k: z[k] for k in ("mu", "nu", "count")}}
        if fsdp:
            t["params"] = z["params"]
        return t

    saved = tree(jax_lm_zero_state([zero_state(st) for st in rank_states], shapes))
    zeros = {"momentum": [torch.zeros(-(-math.prod(shapes[n]) // b)) for n in names],
             "opt_nu": [torch.zeros(-(-math.prod(shapes[n]) // b)) for n in names],
             "params": [torch.zeros(-(-math.prod(shapes[n]) // b)) for n in names],
             "opt_count": 0}
    template = tree(jax_lm_zero_state([zero_state(zeros)] * b, shapes))
    out = adapt_and_place(saved, template, jt._zero_elastic_adapt)
    like = jax_lm_params_from_state_dict({n: np.zeros(shapes[n], np.float32) for n in names})
    return [lm_zero_state_from_jax(jax.device_get(out["opt_state"]), like, r,
                                   fsdp_params=jax.device_get(out["params"]) if fsdp else None)
            for r in range(b)]


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    """(each rank's results, the checkpoint root, JAX's dp4 losses)."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_tokens

    root = str(tmp_path_factory.mktemp("elastic"))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), root],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(WORLD)]
    try:  # JAX runs its trajectory while the ranks train
        init_sd = _port_init_state_dict()
        jax_losses = _jax_dp4_losses(init_sd, synthetic_tokens(8, 16, 32, seed=0))
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    results = [torch.load(os.path.join(root, f"rank{r}.res"), weights_only=False)
               for r in range(WORLD)]
    return results, root, jax_losses


# ------------------------------------------------------------------ tests
def _rng_rows(rng, dp, mid, chunk):
    return rng.standard_normal((dp, *mid, chunk)).astype(np.float32)


@pytest.mark.parametrize("dp_old,dp_new,mid,size", [
    (4, 2, (), 37), (2, 4, (), 37), (3, 1, (), 10), (1, 3, (), 10), (4, 2, (2,), 9),
    (3, 5, (3,), 16)])
def test_rechunk_is_jax_bitwise(dp_old, dp_new, mid, size):
    from cs744_pytorch_distributed_tutorial_tpu.parallel import zero as JZ
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import zero as Z

    rng = np.random.default_rng(dp_old * 10 + dp_new)
    saved = _rng_rows(rng, dp_old, mid, -(-size // dp_old))
    like = np.zeros((dp_new, *mid, -(-size // dp_new)), np.float32)
    want = JZ.rechunk_elastic(saved, like, size)
    got_np = Z.rechunk_elastic(saved, like, size)
    got_t = Z.rechunk_elastic(torch.from_numpy(saved), torch.from_numpy(like), size)
    np.testing.assert_array_equal(got_np, want)
    np.testing.assert_array_equal(got_t.numpy(), want)
    assert got_np.dtype == want.dtype and isinstance(got_t, torch.Tensor)
    # the padding past ``size`` is zero, as JAX's
    assert not want.reshape(dp_new, -1, like.shape[-1]).transpose(1, 0, 2).reshape(
        -1, dp_new * like.shape[-1])[:, size:].any()


def test_rechunk_errors_are_jax():
    from cs744_pytorch_distributed_tutorial_tpu.parallel import zero as JZ
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import zero as Z

    saved = np.ones((4, 2, 3), np.float32)
    for like, size in ((np.zeros((2, 3, 6)), 12), (np.zeros((2, 2, 6)), 13)):
        with pytest.raises(ValueError) as want:
            JZ.rechunk_elastic(saved, like, size)
        with pytest.raises(ValueError) as got:
            Z.rechunk_elastic(torch.from_numpy(saved), like, size)
        assert str(got.value) == str(want.value)


def test_chunk_sizes_and_adapt_are_jax():
    import jax
    from jax.sharding import PartitionSpec as P

    from cs744_pytorch_distributed_tutorial_tpu.parallel import zero as JZ
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import zero as Z

    shapes = {"a": (8, 6), "b": (5,), "e": (4, 3, 2), "t": (6, 4)}
    jspecs = {"a": P(None, "tensor"), "b": P(), "e": P("data", None, "tensor"), "t": P("tensor")}
    specs = {"a": (None, "tensor"), "b": (None,), "e": ("data", None, "tensor"),
             "t": ("tensor", None)}
    sds = {k: jax.ShapeDtypeStruct(v, np.float32) for k, v in shapes.items()}
    axes = {"tensor": 2}
    want = JZ.local_chunk_shapes(sds, jspecs, axes)
    assert Z.local_chunk_shapes(shapes, specs, axes) == {k: v.shape for k, v in want.items()}
    want_sizes = JZ.chunk_local_sizes(sds, jspecs, axes, exclude_axis="data")
    got_sizes = Z.chunk_local_sizes(shapes, specs, axes, exclude_axis="data")
    assert got_sizes == want_sizes and "e" not in got_sizes
    assert Z.chunk_local_sizes(shapes, specs, axes) == JZ.chunk_local_sizes(sds, jspecs, axes)
    j_adapt = JZ.make_elastic_adapt(want_sizes)
    adapt = Z.make_elastic_adapt(got_sizes)
    rng = np.random.default_rng(5)
    for name in ("a", "b", "t"):
        size = got_sizes[name]
        mid = (2,) if "tensor" in specs[name] else ()
        saved = _rng_rows(rng, 4, mid, -(-size // 4))
        like = np.zeros((3, *mid, -(-size // 3)), np.float32)
        want = j_adapt(f"opt_state/nu/{name}", saved, like)
        np.testing.assert_array_equal(adapt(f"opt_nu/{name}", torch.from_numpy(saved),
                                            like).numpy(), want)
        assert adapt(f"params/{name}", saved, like) is None  # not a chunked prefix here
        assert j_adapt(f"params/{name}", saved, like) is None
    saved = np.zeros((4, 2), np.float32)
    assert adapt("momentum/e", saved, np.zeros((2, 2))) is None  # expert: re-shard
    assert j_adapt("opt_state/mu/e", saved, np.zeros((2, 2))) is None


def test_default_leaf_rule_is_jax():
    """The per-replica rule: slice when shrinking, tile cyclically when
    growing; any other mismatch raises JAX's message."""
    from cs744_pytorch_distributed_tutorial_tpu.utils.checkpoint import adapt_host_leaf as jleaf
    from cs744_pytorch_distributed_tutorial_tpu_torch.utils.checkpoint import adapt_host_leaf

    saved = np.random.default_rng(2).standard_normal((3, 5)).astype(np.float32)
    for n in (1, 2, 3, 5, 7):
        like = np.zeros((n, 5), np.float32)
        np.testing.assert_array_equal(
            adapt_host_leaf("x", torch.from_numpy(saved), like.shape).numpy(),
            jleaf((), saved, like))
    with pytest.raises(ValueError) as want:
        jleaf((), np.zeros((4, 7)), np.zeros((2, 13)))
    with pytest.raises(ValueError) as got:
        adapt_host_leaf("x", torch.zeros(4, 7), (2, 13))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("mode,a,b", LM_SCENARIOS)
def test_lm_restore_across_worlds_is_jax_bitwise(launch, mode, a, b):
    from cs744_pytorch_distributed_tutorial_tpu_torch.utils.checkpoint import RankStates

    results, root, _ = launch
    sd = _port_init_state_dict()
    names, shapes = list(sd), {k: tuple(v.shape) for k, v in sd.items()}
    step_dir = os.path.join(_scenario_dir(root, mode, a, b), "step_2")
    saved = RankStates([os.path.join(step_dir, f"rank{r}.pt") for r in range(a)])
    want = _jax_restore(mode, a, b, list(saved), names, shapes)
    key = f"{mode}_{a}_{b}"
    for r in range(b):
        got = results[r][f"{key}/state"]
        assert results[r][f"{key}/read"] == list(range(a))  # every old rank's file
        assert got["step"] == 2 and got["opt_count"] == want[r]["count"] == 2
        assert got["world_size"] == b and got["layout"] == [b, 1, 1]
        for coll, jcoll in (("momentum", "mu"), ("opt_nu", "nu")) + (
                (("params", "params"),) if mode == "fsdp" else ()):
            for name, row in zip(names, got[coll]):
                assert torch.equal(row, want[r][jcoll][name]), (key, r, coll, name)
        if mode == "zero1":  # replicated parameters: any file's
            for name, p in zip(names, got["params"]):
                assert torch.equal(p, saved[0]["params"][names.index(name)])
        assert np.isfinite(results[r][f"{key}/next_loss"])
    # the new world's rows hold the old rows' values, the padding dropped
    for i, name in enumerate(names):
        size = math.prod(shapes[name])
        old = torch.cat([saved[r]["momentum"][i] for r in range(a)])[:size]
        new = torch.cat([results[r][f"{key}/state"]["momentum"][i] for r in range(b)])
        assert torch.equal(new[:size], old) and not new[size:].any()


@pytest.mark.parametrize("mode,a,b", LM_SCENARIOS + MOE_SCENARIOS)
def test_lm_restore_keeps_the_global_parameters(launch, mode, a, b):
    """Every layout's restored parameters gather to the saved world's."""
    results, _, _ = launch
    key = f"{mode}_{a}_{b}"
    want = results[0][f"{key}/saved_state_dict"]
    for r in range(b):
        got = results[r][f"{key}/state_dict"]
        assert list(got) == list(want)
        for name, value in want.items():
            assert torch.equal(got[name], value), (key, r, name)


@pytest.mark.parametrize("a,b", [(4, 2), (2, 4)])
def test_moe_experts_reshard_whole_across_the_data_axis(launch, a, b):
    """Expert-split tensors (and their zero1 moments, whole local tensors)
    are the saved world's experts cut anew: new rank r holds experts
    [r E/b, (r+1) E/b) of the old ranks' concatenation."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.utils.checkpoint import RankStates

    results, root, _ = launch
    step_dir = os.path.join(_scenario_dir(root, "zero1_moe", a, b), "step_2")
    saved = RankStates([os.path.join(step_dir, f"rank{r}.pt") for r in range(a)])
    full_sd = results[0][f"zero1_moe_{a}_{b}/saved_state_dict"]
    names = list(full_sd)
    split = [i for i, n in enumerate(names)
             if saved[0]["params"][i].shape[0] * a == full_sd[n].shape[0] != saved[0][
                 "params"][i].shape[0]]
    assert split, names
    for i in split:
        shape = saved[0]["params"][i].shape
        for key in ("params", "momentum", "opt_nu"):
            full = torch.cat([saved[r][key][i].reshape(shape) for r in range(a)])
            for r in range(b):
                got = results[r][f"zero1_moe_{a}_{b}/state"][key][i]
                want = full.chunk(b)[r]
                assert torch.equal(got.reshape(want.shape), want), (names[i], key, r)
    for r in range(b):
        assert np.isfinite(results[r][f"zero1_moe_{a}_{b}/next_loss"])


@pytest.mark.parametrize("a,b", [(4, 2), (2, 4)])
def test_cifar_bn_buffers_slice_and_tile_as_jax(launch, a, b):
    from cs744_pytorch_distributed_tutorial_tpu.utils.checkpoint import adapt_host_leaf as jleaf
    from cs744_pytorch_distributed_tutorial_tpu_torch.utils.checkpoint import RankStates

    results, root, _ = launch
    step_dir = os.path.join(_scenario_dir(root, "cifar", a, b), "step_1")
    saved = RankStates([os.path.join(step_dir, f"rank{r}.pt") for r in range(a)])
    names = list(saved[0]["buffers"])
    assert not torch.equal(saved[0]["buffers"][names[0]], saved[1]["buffers"][names[0]])
    for name in names:
        stacked = np.stack([saved[r]["buffers"][name].numpy() for r in range(a)])
        want = jleaf((), stacked, np.zeros((b, *stacked.shape[1:]), stacked.dtype))
        for r in range(b):
            got = results[r][f"cifar_{a}_{b}/state"]
            np.testing.assert_array_equal(got["buffers"][name].numpy(), want[r])
            assert torch.equal(got["buffers"][name], saved[r % a]["buffers"][name])
    for r in range(b):
        got = results[r][f"cifar_{a}_{b}/state"]
        assert got["world_size"] == b and got["step"] == 1
        for p, q in zip(got["params"], saved[0]["params"]):
            assert torch.equal(p, q)
        for m, q in zip(got["momentum"], saved[a - 1]["momentum"]):
            assert torch.equal(m, q)


def test_cifar_zero1_across_worlds_raises_jax_error(launch):
    """The JAX CIFAR engine passes no adapt hook, so its default rule
    meets ``[2, c2]`` against ``[4, c4]`` and raises; so does the port."""
    from cs744_pytorch_distributed_tutorial_tpu.utils.checkpoint import adapt_host_leaf as jleaf
    from cs744_pytorch_distributed_tutorial_tpu_torch.utils.checkpoint import RankStates

    from cs744_pytorch_distributed_tutorial_tpu_torch.models import get_model

    results, root, _ = launch
    step_dir = os.path.join(_scenario_dir(root, "cifar_zero1", 2, 4), "step_1")
    saved = RankStates([os.path.join(step_dir, f"rank{r}.pt") for r in range(2)])
    rows = np.stack([saved[r]["momentum"][0].numpy() for r in range(2)])
    size = next(get_model("tiny_cnn", num_classes=10).parameters()).numel()
    assert rows.shape == (2, -(-size // 2))
    with pytest.raises(ValueError) as want:
        jleaf((), rows, np.zeros((4, -(-size // 4)), np.float32))
    for r in range(4):
        assert results[r]["cifar_zero1_2_4/error"] == str(want.value)


def test_device_loss_remeshes_to_two_ranks_from_memory(launch):
    """Ranks 2 and 3 leave; ranks 0 and 1 re-form a world of 2, restore the
    gathered snapshot re-chunked (zero reads of a checkpoint) and follow
    JAX's uninterrupted dp4 trajectory."""
    results, _, jax_losses = launch
    assert [results[r].get("dl/retired") for r in (2, 3)] == [2, 3]
    for r in (0, 1):
        res = results[r]
        assert res["dl/world_after"] == 2 and res["dl/restarts"] == 1
        assert res["dl/injected"] == [(2, "device_loss")]
        assert res["dl/disk_restores"] == 0 and res["dl/mem_restores"] >= 1
        assert res["dl/gathered_bytes"] > 0
        losses = res["dl/losses"]
        assert len(losses) >= LOSS_STEPS - 2
        np.testing.assert_allclose(losses, jax_losses[-len(losses):], rtol=1e-6)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), sys.argv[2])
