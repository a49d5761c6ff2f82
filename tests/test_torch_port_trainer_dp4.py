"""The port's Trainer on 4 Gloo ranks against the JAX Trainer on 4 host
devices: the reference's parts 2a, 2a_extra, 2b and 3, and 2b and 3
with ``accum_steps=2``.

tiny_cnn, global batch 16 (4 a rank), augmentation off, lr 0.02, 5
steps from the JAX Trainer's initialization carried over
(``models/convert.py``). One launch of 4 processes (this file, run as a
script) trains every configuration in turn, rank r on rows [4r, 4r+4)
of each global batch, as ``shard_global_batch`` hands them to device r.
Per-step losses (the world mean) agree at rtol 1e-5, the final
parameters and each rank's BatchNorm running means at rtol 1e-5, atol
1e-6: the float strategies sum in another order (gloo's all-reduce,
DDP's pre-divided buckets), and the convolutions accumulate in another
order. Running variances differ by the Bessel convention
(``BESSEL_RTOL``).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

WORLD, STEPS, BATCH, LR = 4, 5, 16, 0.02
PARTS = {
    "2a": dict(sync="gather_scatter"),
    "2a_extra": dict(sync="p2p_star"),
    "2b": dict(sync="allreduce"),
    "3": dict(sync="auto"),
    "2b_accum2": dict(sync="allreduce", accum_steps=2),
    "3_accum2": dict(sync="auto", accum_steps=2),
}
COMMON = dict(model="tiny_cnn", num_devices=WORLD, global_batch_size=BATCH,
              synthetic_data=True, augment=False, learning_rate=LR)
# torch's running variance takes the batch variance with Bessel's
# factor n / (n - 1), flax's without (a convention, not a fault). The
# smallest n is 512, at tiny_cnn's second BatchNorm under accum_steps=2
# (2 images of 16 x 16): the running values differ by at most that factor
# (10 updates at momentum 0.1 carry 1 - 0.9^10 = 65 % of it).
BESSEL_RTOL = 1 / 511 + 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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

    from cs744_pytorch_distributed_tutorial_tpu_torch.config import TrainConfig
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import jax_from_state_dict
    from cs744_pytorch_distributed_tutorial_tpu_torch.train import Trainer

    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", world_size=WORLD, rank=rank
    )
    try:
        init = torch.load(init_path)
        ds = _dataset()
        per = BATCH // WORLD
        res = {}
        for part, kw in PARTS.items():
            tr = Trainer(TrainConfig(**COMMON, **kw, device="cpu"))
            tr.model.load_state_dict(init)
            losses = []
            for s in range(STEPS):
                lo = s * BATCH + rank * per
                x = torch.from_numpy(ds.train_images[lo : lo + per])
                y = torch.from_numpy(ds.train_labels[lo : lo + per].astype(np.int64))
                losses.append(tr.global_mean(tr.train_step(x, y)))
            assert tr.state.step == STEPS
            res[f"{part}/losses"] = np.array(losses)
            got = jax_from_state_dict(tr.model.state_dict(), "tiny_cnn")
            res.update({f"{part}/{k}": v for k, v in _flat(got).items()})
        np.savez(out_path, **res)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_run(part: str, mesh, ds):
    import jax

    from cs744_pytorch_distributed_tutorial_tpu.config import TrainConfig as JaxConfig
    from cs744_pytorch_distributed_tutorial_tpu.parallel.mesh import shard_global_batch
    from cs744_pytorch_distributed_tutorial_tpu.train import Trainer as JaxTrainer

    jtr = JaxTrainer(JaxConfig(**COMMON, **PARTS[part]), mesh=mesh)
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
    final = {"params": jax.tree.map(np.asarray, state.params),
             "batch_stats": jax.tree.map(np.asarray, state.batch_stats)}  # [WORLD, ...]
    return init, np.array(losses), final


def test_trainer_matches_jax_on_four_ranks(tmp_path, mesh4):
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import state_dict_from_jax

    ds = _dataset()
    first = list(PARTS)[0]
    init, *run = _jax_run(first, mesh4, ds)
    torch.save(state_dict_from_jax(init, "tiny_cnn"), tmp_path / "init.pt")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(port),
             str(tmp_path / "init.pt"), str(tmp_path / f"r{r}.npz")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(WORLD)
    ]
    try:  # the ranks train while JAX compiles and runs the other parts
        want = {first: run}
        for part in list(PARTS)[1:]:
            part_init, *want[part] = _jax_run(part, mesh4, ds)
            for a, b in zip(_flat(part_init).values(), _flat(init).values(), strict=True):
                np.testing.assert_array_equal(a, b)  # every part starts from one init
        logs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    results = [np.load(tmp_path / f"r{r}.npz") for r in range(WORLD)]

    for part, (losses, final) in want.items():
        for r in range(WORLD):
            np.testing.assert_allclose(results[r][f"{part}/losses"], losses, rtol=1e-5,
                                       err_msg=f"{part} losses, rank {r}")
            for name, value in _flat(final).items():
                kind = name.split("/")[0]
                value = value[r] if kind == "batch_stats" else value
                got = results[r][f"{part}/{name}"]
                rtol = BESSEL_RTOL if name.endswith("/var") else 1e-5
                np.testing.assert_allclose(got, value, rtol=rtol, atol=1e-6,
                                           err_msg=f"{part} {name}, rank {r}")
                if kind == "params" and r:  # replicated: every rank holds rank 0's
                    np.testing.assert_array_equal(got, results[0][f"{part}/{name}"])


@pytest.mark.parametrize("accum", [0, 3])
def test_accum_steps_must_divide_the_rank_batch(accum):
    from cs744_pytorch_distributed_tutorial_tpu_torch.config import TrainConfig
    from cs744_pytorch_distributed_tutorial_tpu_torch.train import Trainer

    with pytest.raises(ValueError, match="accum_steps"):
        Trainer(TrainConfig(model="tiny_cnn", sync="none", num_devices=1,
                            global_batch_size=16, accum_steps=accum, device="cpu"))


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
