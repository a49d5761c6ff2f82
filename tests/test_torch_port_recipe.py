"""The rest of the CIFAR Trainer's recipe against the JAX package's: the
schedules, AdamW and Lion, the global-norm clip, SyncBN and the
divergence check.

- Functions on numpy inputs, one process: every schedule at every count
  from 0 to ``total_steps + 2`` within one float32 ulp of the peak lr
  of optax's value (optax takes XLA's float32 cosine, the port the
  correctly rounded one: up to 2 ulps of the value apart); one Lion and one AdamW update bit for bit (the same operations
  in the same order); the clip bit for bit below ``max_norm`` and within
  rtol 1e-6 above it (the norm's sum runs in another order).
- One launch of 4 Gloo processes (this file, run as a script) against
  JAX on 4 host devices: ``SyncBatchNorm2d``'s output and gradients
  against flax ``BatchNorm(axis_name="data")`` under ``shard_map``
  (rtol 1e-5, atol 1e-6), and the Trainer (tiny_cnn, global batch 16,
  augmentation off, 5 steps from JAX's initialization) with SyncBN
  under ``allreduce`` and under ``auto`` (DDP), AdamW + warmup_cosine +
  clip, Lion + cosine, and ``debug_sync_check`` under allreduce and
  zero1. Losses agree at rtol 1e-5, parameters and running means at
  rtol 1e-5, atol 1e-6; running variances by the Bessel convention
  (``BESSEL_RTOL``). The convolutions' biases, whose gradient a
  BatchNorm makes zero up to rounding, are held under AdamW and Lion to
  twice the optimizer's largest step (``LARGEST_STEP``), and so are the
  running means they shift: both optimizers step by about lr whatever
  the gradient's size, so rounding noise of either sign moves them.
- The JAX rejections (``tests/test_optimizers.py``,
  ``tests/test_sync_bn.py``, ``tests/test_debug.py``) as cases against
  the port; its CLIs with the new flags.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.config import TrainConfig
from cs744_pytorch_distributed_tutorial_tpu_torch.train import state as S

WORLD, STEPS, BATCH, LR = 4, 5, 16, 0.02
LION_LR = 1e-4
RUNS = {
    "allreduce_sync_bn": dict(sync="allreduce", sync_bn=True),
    "auto_sync_bn": dict(sync="auto", sync_bn=True),
    "adamw": dict(sync="allreduce", optimizer="adamw", learning_rate=1e-3,
                  lr_schedule="warmup_cosine", warmup_steps=2, total_steps=STEPS,
                  grad_clip_norm=1.0),
    "lion": dict(sync="allreduce", optimizer="lion", learning_rate=LION_LR,
                 lr_schedule="cosine", total_steps=STEPS),
    "debug_allreduce": dict(sync="allreduce", debug_sync_check=True),
    "debug_zero1": dict(sync="zero1", debug_sync_check=True),
}
COMMON = dict(model="tiny_cnn", num_devices=WORLD, global_batch_size=BATCH,
              synthetic_data=True, augment=False, learning_rate=LR)
BESSEL_RTOL = 1 / 511 + 1e-5  # see test_torch_port_trainer_dp4.py
# The convolutions' biases feed a BatchNorm, which removes them: their
# gradient is zero up to rounding, noise of either sign in either
# framework. AdamW and Lion step by about lr whatever a gradient's size,
# so there the two trajectories part by up to twice the largest step a
# step: lr for Lion, lr (1 - b1) / sqrt(1 - b2) for Adam (Kingma & Ba,
# section 2.1). In units of lr:
LARGEST_STEP = {"lion": 1.0, "adamw": 0.1 / math.sqrt(1 - 0.999)}
BN_SHAPE = (4, 6, 5, 7)  # a rank's [N, C, H, W]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(**kw):
    from types import SimpleNamespace

    base = dict(learning_rate=0.1, momentum=0.9, weight_decay=1e-4, optimizer="sgd",
                lr_schedule="constant", warmup_steps=0, total_steps=None, grad_clip_norm=None)
    return SimpleNamespace(**{**base, **kw})


# ------------------------------------------------------------- functions
SCHEDULES = [
    dict(lr_schedule="cosine", total_steps=12),
    dict(lr_schedule="warmup_cosine", warmup_steps=4, total_steps=12),
    dict(lr_schedule="cosine", warmup_steps=3, total_steps=100),
    dict(lr_schedule="warmup_cosine", total_steps=20),
    dict(lr_schedule="constant", warmup_steps=7, total_steps=20),
    dict(lr_schedule="constant", total_steps=5),
    dict(lr_schedule="cosine", total_steps=1000, learning_rate=0.3),
    dict(lr_schedule="warmup_cosine", warmup_steps=10, total_steps=137, learning_rate=1e-3),
]


@pytest.mark.parametrize("kw", SCHEDULES)
def test_schedule_is_optax_s_at_every_count(kw):
    from cs744_pytorch_distributed_tutorial_tpu.config import TrainConfig as JaxConfig
    from cs744_pytorch_distributed_tutorial_tpu.train.state import make_schedule as jax_schedule

    want = jax_schedule(JaxConfig(**kw))
    got = S.make_schedule(TrainConfig(**kw))
    ulp = np.spacing(np.float32(kw.get("learning_rate", TrainConfig.learning_rate)))
    for count in range(kw["total_steps"] + 3):
        w = np.float32(want if isinstance(want, float) else want(count))
        g = np.float32(got(count))
        assert abs(g - w) <= ulp, (count, g, w)


def _updates(name: str, steps: int, lm: bool = False, **kw):
    """(port parameters, optax parameters) after ``steps`` updates of the
    same gradients, zeros among them (sign(0) = 0); ``lm`` takes the
    port's ``make_lm_optimizer``."""
    import jax.numpy as jnp
    import optax

    from cs744_pytorch_distributed_tutorial_tpu.config import TrainConfig as JaxConfig
    from cs744_pytorch_distributed_tutorial_tpu.train.state import make_optimizer as jax_opt

    rng = np.random.default_rng(5)
    shapes = [(5, 3), (7,), (64,)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    cfg = dict(optimizer=name, learning_rate=0.05, momentum=0.9, weight_decay=0.1, **kw)
    tx = jax_opt(JaxConfig(**cfg))
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in p0]
    if lm:
        bound = S.make_lm_optimizer(_cfg(**cfg), tp)
    else:
        port = S.make_optimizer(TrainConfig(**cfg))
        mom = port.init(tp)
    for _ in range(steps):
        g = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        g[0][0] = 0.0
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        if lm:
            for p, x in zip(tp, g):
                p.grad = torch.from_numpy(x)
            bound.step()
        else:
            port.apply(tp, mom, [torch.from_numpy(x) for x in g])
    return [p.numpy() for p in tp], [np.asarray(p) for p in jp]


@pytest.mark.parametrize("name", ["lion", "adamw"])
def test_one_update_is_optax_s_bitwise(name):
    for got, want in zip(*_updates(name, 1), strict=True):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["lion", "adamw", "sgd"])
def test_scheduled_clipped_updates_follow_optax(name):
    """Four updates at a warmup-cosine lr behind a clip that binds: the
    norm sums in another order, so rtol 1e-6."""
    got, want = _updates(name, 4, lr_schedule="warmup_cosine", warmup_steps=2,
                         total_steps=4, grad_clip_norm=0.5)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("scale", [1e-3, 1e3])
def test_clip_by_global_norm_is_optax_s(scale):
    import jax.numpy as jnp
    import optax

    rng = np.random.default_rng(1)
    grads = [rng.standard_normal(s).astype(np.float32) * np.float32(scale)
             for s in [(4, 3), (10,)]]
    want, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in grads], None)
    got = S.clip_by_global_norm([torch.from_numpy(g) for g in grads], 1.0)
    for a, b, g in zip(got, want, grads):
        if scale < 1:  # below max_norm: the gradients as they are
            np.testing.assert_array_equal(a.numpy(), g)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)
    if scale > 1:
        assert math.sqrt(sum(float((a.double() ** 2).sum()) for a in got)) == pytest.approx(
            1.0, rel=1e-6)


@pytest.mark.parametrize(
    "kw,match",
    [
        (dict(optimizer="adagrad"), "optimizer"),
        (dict(lr_schedule="step"), "lr_schedule"),
        (dict(lr_schedule="cosine"), "total_steps"),
        (dict(grad_clip_norm=-1.0), "grad_clip_norm"),
        (dict(sync="zero1", optimizer="adamw"), "registry"),
        (dict(sync="fsdp", optimizer="lion"), "registry"),
        (dict(sync="allreduce", fused_optimizer=True, lr_schedule="cosine", total_steps=10),
         "registry"),
        (dict(sync="zero1", grad_clip_norm=1.0), "registry"),
        (dict(sync="allreduce", sync_overlap="bucket", optimizer="adamw"), "fixed-lr"),
        (dict(model="vit_tiny", sync_bn=True), "no BN"),
    ],
)
def test_rejections(kw, match):
    """The JAX Trainer's rejections, raised before any process group is
    needed."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.train import Trainer

    with pytest.raises(ValueError, match=match):
        Trainer(TrainConfig(**{**dict(model="tiny_cnn", global_batch_size=16, device="cpu"),
                               **kw}))


def test_monitor_flags_divergence():
    from cs744_pytorch_distributed_tutorial_tpu_torch.utils.debug import DivergenceMonitor

    m = DivergenceMonitor(rtol=1e-6)
    m.record(0, 0, 1.0)
    m.record(0, 1, 1.0)
    m.record(1, 0, 1.0)
    m.record(1, 1, 1.5)  # drifted replica
    m.record_world(2, torch.tensor([float("nan"), 1.0]))
    assert m.divergent_steps() == [1, 2]
    with pytest.raises(AssertionError, match="divergence"):
        m.assert_in_sync()


def test_monitor_tolerates_equal_replicas():
    from cs744_pytorch_distributed_tutorial_tpu_torch.utils.debug import DivergenceMonitor

    m = DivergenceMonitor()
    for step in range(5):
        m.record_world(step, torch.full((4,), 3.14 * (step + 1)))
    assert m.divergent_steps() == [] and m.steps_recorded == 5 and m.replicas_seen(4) == 4
    m.assert_in_sync()


def test_tree_checksum():
    from cs744_pytorch_distributed_tutorial_tpu_torch.utils.debug import tree_checksum

    assert float(tree_checksum([torch.ones(2, 2), -torch.ones(3)])) == pytest.approx(7.0)
    assert float(tree_checksum([])) == 0.0


@pytest.fixture
def world_of_one():
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import mesh

    mesh.initialize(None, 1, 0, device=torch.device("cpu"))
    yield
    mesh.shutdown()


def test_sync_bn_at_world_one_is_batchnorm_up_to_rounding(world_of_one):
    """At a world of one the statistics are the local ones, in flax's
    arithmetic (E[x^2] - E[x]^2) rather than torch's: a step's loss
    within rtol 1e-6 of the per-replica path, not bit for bit."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_cifar10
    from cs744_pytorch_distributed_tutorial_tpu_torch.train import Trainer

    ds = synthetic_cifar10(32, 4, seed=0)
    x = torch.from_numpy(ds.train_images[:16])
    y = torch.from_numpy(ds.train_labels[:16].astype(np.int64))
    losses = {}
    for sync_bn in (False, True):
        tr = Trainer(TrainConfig(model="tiny_cnn", sync="auto", num_devices=1,
                                 global_batch_size=16, device="cpu", sync_bn=sync_bn))
        losses[sync_bn] = [float(tr.train_step(x, y)) for _ in range(2)]
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-6)


def test_cli_runs_the_recipes(world_of_one, capsys):
    from cs744_pytorch_distributed_tutorial_tpu_torch import cli
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import mesh

    mesh.shutdown()  # the CLI makes its own process group
    small = ["--model", "tiny_cnn", "--synthetic-data", "--synthetic-train-size", "96",
             "--synthetic-test-size", "40", "--global-batch-size", "16", "--device", "cpu",
             "--json", "--num-devices", "1"]
    for flags in (["--part", "1", "--optimizer", "lion", "--lr-schedule", "cosine",
                   "--total-steps", "6", "--lr", "1e-4"],
                  ["--part", "1", "--optimizer", "adamw", "--lr-schedule", "warmup_cosine",
                   "--warmup-steps", "2", "--total-steps", "6", "--grad-clip-norm", "1.0",
                   "--lr", "1e-3"],
                  ["--part", "2b", "--sync-bn", "--debug-sync-check"],
                  ["--part", "2b", "--sync", "zero1", "--sync-overlap", "bucket"],
                  ["--part", "2b", "--sync", "fsdp"]):
        assert cli.main([*flags, *small]) == 0
        summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert summary["steps"] == 6 and math.isfinite(summary["final_train_loss"]), flags
        assert 0.0 <= summary["final_eval_accuracy"] <= 1.0
    mesh.initialize(None, 1, 0, device=torch.device("cpu"))


def test_lm_cli_runs_lion_with_a_schedule_and_clip(capsys):
    from cs744_pytorch_distributed_tutorial_tpu_torch import lm_cli

    argv = ["--num-layers", "2", "--d-model", "32", "--num-heads", "4", "--d-ff", "64",
            "--vocab-size", "64", "--max-seq-len", "32", "--seq-len", "16",
            "--global-batch-size", "4", "--steps", "4", "--num-seqs", "16",
            "--attention-impl", "dense", "--optimizer", "lion", "--lr-schedule",
            "warmup_cosine", "--warmup-steps", "1", "--grad-clip-norm", "1.0", "--json",
            "--device", "cpu"]
    assert lm_cli.main(argv) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["steps_run"] == 4 and summary["finite"]


@pytest.mark.parametrize("name", ["lion", "adamw", "sgd"])
def test_lm_optimizer_follows_optax(name):
    """``make_lm_optimizer`` goes through the same registry: four updates
    of a warmup-cosine, clipped recipe against the JAX ``make_optimizer``
    the JAX LM builds (rtol 1e-6: the clip's norm)."""
    got, want = _updates(name, 4, lm=True, lr_schedule="warmup_cosine", warmup_steps=2,
                         total_steps=4, grad_clip_norm=0.5)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------------ ranks
def _bn_inputs(rank: int):
    rng = np.random.default_rng(30 + rank)
    x = (rng.standard_normal(BN_SHAPE) * (1 + rank) + rank).astype(np.float32)
    ct = rng.standard_normal(BN_SHAPE).astype(np.float32)
    return x, ct


def _bn_params():
    rng = np.random.default_rng(3)
    c = BN_SHAPE[1]
    return (1 + 0.1 * rng.standard_normal(c)).astype(np.float32), \
        (0.1 * rng.standard_normal(c)).astype(np.float32)


def _dataset():
    from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_cifar10

    return synthetic_cifar10(STEPS * BATCH, 8, seed=0)


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(tree[k])
    return out


def _worker(rank: int, port: int, init_path: str, out_path: str) -> None:
    import torch.distributed as dist

    from cs744_pytorch_distributed_tutorial_tpu_torch.models.batchnorm import SyncBatchNorm2d
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import jax_from_state_dict
    from cs744_pytorch_distributed_tutorial_tpu_torch.train import Trainer

    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", world_size=WORLD, rank=rank
    )
    try:
        res = {}
        x, ct = _bn_inputs(rank)
        bn = SyncBatchNorm2d(BN_SHAPE[1], eps=1e-5, momentum=0.1)
        scale, bias = _bn_params()
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(scale))
            bn.bias.copy_(torch.from_numpy(bias))
        xt = torch.from_numpy(x).requires_grad_()
        y = bn(xt)
        (y * torch.from_numpy(ct)).sum().backward()
        res.update({"bn/y": y.detach().numpy(), "bn/dx": xt.grad.numpy(),
                    "bn/dscale": bn.weight.grad.numpy(), "bn/dbias": bn.bias.grad.numpy(),
                    "bn/mean": bn.running_mean.numpy(), "bn/var": bn.running_var.numpy()})

        init = torch.load(init_path)
        ds = _dataset()
        per = BATCH // WORLD
        for run, kw in RUNS.items():
            tr = Trainer(TrainConfig(**{**COMMON, **kw}, device="cpu"))
            tr.load_state_dict(init)
            losses = []
            for s in range(STEPS):
                lo = s * BATCH + rank * per
                xb = torch.from_numpy(ds.train_images[lo : lo + per])
                yb = torch.from_numpy(ds.train_labels[lo : lo + per].astype(np.int64))
                losses.append(tr.global_mean(tr.train_step(xb, yb)))
            res[f"{run}/losses"] = np.array(losses)
            for name, v in _flat(jax_from_state_dict(tr.state_dict(), "tiny_cnn")).items():
                res[f"{run}/{name}"] = v
            if tr.sync_monitor is not None:
                res[f"{run}/monitor"] = np.array(
                    [tr.sync_monitor.steps_recorded, len(tr.sync_monitor.divergent_steps())]
                    + [tr.sync_monitor.replicas_seen(s) for s in range(STEPS)])
        np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_run(run: str, mesh, ds):
    import jax

    from cs744_pytorch_distributed_tutorial_tpu.config import TrainConfig as JaxConfig
    from cs744_pytorch_distributed_tutorial_tpu.parallel.mesh import shard_global_batch
    from cs744_pytorch_distributed_tutorial_tpu.train import Trainer as JaxTrainer

    jtr = JaxTrainer(JaxConfig(**{**COMMON, **RUNS[run]}), mesh=mesh)
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
    if jtr.sync_monitor is not None:
        jtr.sync_monitor.assert_in_sync()
    final = {"params": jax.tree.map(np.asarray, state.params),
             "batch_stats": jax.tree.map(np.asarray, state.batch_stats)}
    return init, np.array(losses), final


def _jax_bn(mesh):
    """flax BatchNorm(axis_name="data") on each device's NHWC input: its
    output, its input gradient and each device's own scale/bias
    gradient for the cotangent ``ct``, and the running statistics."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    scale, bias = _bn_params()
    xs, cts = zip(*(_bn_inputs(r) for r in range(WORLD)))
    x = np.stack([a.transpose(0, 2, 3, 1) for a in xs])  # [4, N, H, W, C]
    ct = np.stack([a.transpose(0, 2, 3, 1) for a in cts])
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                       axis_name="data")
    stats0 = {"mean": jnp.zeros(BN_SHAPE[1]), "var": jnp.ones(BN_SHAPE[1])}

    def local(x, ct):
        x, ct = x[0], ct[0]

        def f(x, p):
            y, upd = bn.apply({"params": p, "batch_stats": stats0}, x, mutable=["batch_stats"])
            return y, upd["batch_stats"]

        y, pull, st = jax.vjp(f, x, {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                              has_aux=True)
        dx, dp = pull(ct)
        return (y[None], dx[None], dp["scale"][None], dp["bias"][None], st["mean"][None],
                st["var"][None])

    fn = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(P("data"), P("data")),
                               out_specs=(P("data"),) * 6, check_vma=False))
    y, dx, ds, db, mean, var = jax.tree.map(np.asarray, fn(x, ct))
    return {"bn/y": y.transpose(0, 1, 4, 2, 3), "bn/dx": dx.transpose(0, 1, 4, 2, 3),
            "bn/dscale": ds, "bn/dbias": db, "bn/mean": mean, "bn/var": var}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, mesh4):
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import state_dict_from_jax

    tmp = tmp_path_factory.mktemp("recipe")
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
        bn = _jax_bn(mesh4)
        logs = [p.communicate(timeout=200)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [dict(np.load(tmp / f"r{r}.npz")) for r in range(WORLD)], want, bn


def test_sync_bn_is_flax_s_over_four_ranks(runs):
    """Output, input gradient (through the all-reduce of the statistics)
    and the rank's own scale and bias gradients; the running mean, and
    the running variance up to the Bessel factor of the global count."""
    results, _, want = runs
    count = WORLD * BN_SHAPE[0] * BN_SHAPE[2] * BN_SHAPE[3]
    for r, res in enumerate(results):
        for key in ("bn/y", "bn/dx", "bn/dscale", "bn/dbias", "bn/mean"):
            np.testing.assert_allclose(res[key], want[key][r], rtol=1e-5, atol=1e-6,
                                       err_msg=f"{key}, rank {r}")
        # flax keeps the biased variance; torch's convention takes n / (n - 1).
        flax_var = 0.9 + (want["bn/var"][r] - 0.9) * count / (count - 1)
        np.testing.assert_allclose(res["bn/var"], flax_var, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(res["bn/mean"], results[0]["bn/mean"])


def _bias_bound(run: str) -> float:
    """How far two trajectories of a conv bias that feeds a BatchNorm may
    part: twice the largest step, every step (and the running mean, which
    the bias shifts, as far)."""
    lr = S.make_schedule(TrainConfig(**{**COMMON, **RUNS[run]}))
    return 2 * LARGEST_STEP[run] * sum(lr(t) for t in range(STEPS)) + 1e-6


@pytest.mark.parametrize("run", list(RUNS))
def test_trainer_matches_jax_on_four_ranks(runs, run):
    results, want, _ = runs
    init, losses, final = want[run]
    for a, b in zip(_flat(init).values(), _flat(want[list(RUNS)[0]][0]).values(), strict=True):
        np.testing.assert_array_equal(a, b)  # every run starts from one init
    for r, res in enumerate(results):
        np.testing.assert_allclose(res[f"{run}/losses"], losses, rtol=1e-5,
                                   err_msg=f"{run} losses, rank {r}")
        for name, value in _flat(final["params"]).items():
            got = res[f"{run}/params/{name}"]
            if run in LARGEST_STEP and name.startswith("Conv_") and name.endswith("/bias"):
                assert np.abs(got - value).max() <= _bias_bound(run), (run, name)
            else:
                np.testing.assert_allclose(got, value, rtol=1e-5, atol=1e-6,
                                           err_msg=f"{run} {name}, rank {r}")
            np.testing.assert_array_equal(got, results[0][f"{run}/params/{name}"])
        for name, value in _flat(final["batch_stats"]).items():
            got = res[f"{run}/batch_stats/{name}"]
            if run in LARGEST_STEP and name.endswith("/mean"):  # the biases shift the mean
                assert np.abs(got - value[r]).max() <= _bias_bound(run), (run, name)
                continue
            rtol = BESSEL_RTOL if name.endswith("/var") else 1e-5
            np.testing.assert_allclose(got, value[r], rtol=rtol, atol=1e-6,
                                       err_msg=f"{run} {name}, rank {r}")
            if "sync_bn" in run:  # the world's statistics: every rank's the same
                np.testing.assert_array_equal(got, results[0][f"{run}/batch_stats/{name}"])
        if run.startswith("debug"):
            steps, divergent, *seen = res[f"{run}/monitor"].tolist()
            assert (steps, divergent, seen) == (STEPS, 0, [WORLD] * STEPS)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
