"""Checkpoints, snapshots and resume: the port's run loop against itself
and against the JAX package's contracts (``tests/test_checkpoint.py``).

A resume from a mid-epoch state, from either tier, must be bitwise equal
to the uninterrupted run: the same parameters, momentum, error feedback,
BatchNorm buffers, optimizer state and augmentation generator state.
Each case trains tiny_cnn for one epoch of 8 steps (64 examples, batch
8) three ways: uninterrupted; stopped by a NaN injected at the fifth
step and resumed by a fresh Trainer from the disk checkpoint of step 3;
and recovered in place by ``run_with_recovery`` from the in-memory
snapshot of step 3. Cases: SGD with augmentation, AdamW with
warmup_cosine and the clip, the fused optimizer, the int8 wire's error
feedback (a Gloo group of one), and zero1 and fsdp on 2 Gloo ranks.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from cs744_pytorch_distributed_tutorial_tpu_torch.config import TrainConfig
from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_cifar10
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.mesh import free_port
from cs744_pytorch_distributed_tutorial_tpu_torch.train import Trainer
from cs744_pytorch_distributed_tutorial_tpu_torch.utils.checkpoint import Checkpointer
from cs744_pytorch_distributed_tutorial_tpu_torch.utils.failure import (
    NonFiniteLossError,
    run_with_recovery,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(model="tiny_cnn", sync="none", num_devices=1, global_batch_size=8,
            learning_rate=0.02, device="cpu")
CASES = {
    "sgd_augment": dict(augment=True),
    "adamw_warmup_cosine_clip": dict(optimizer="adamw", lr_schedule="warmup_cosine",
                                     warmup_steps=2, total_steps=16, grad_clip_norm=0.5,
                                     learning_rate=1e-3),
    "fused_optimizer": dict(fused_optimizer=True, augment=False),
}
NAN_AT_CALL, EVERY = 5, 3


def nan_once_at(trainer, call: int) -> dict:
    """Make ``trainer.train_step`` return a NaN loss once, at its
    ``call``-th call (a transient fault: clean on replay)."""
    orig = trainer.train_step
    calls = {"n": 0}

    def step(x, y):
        loss = orig(x, y)
        calls["n"] += 1
        if calls["n"] == call:
            loss = torch.full_like(loss, float("nan"))
        return loss

    trainer.train_step = step
    return calls


def assert_states_bitwise(got: dict, want: dict) -> None:
    assert got["step"] == want["step"]
    assert got["opt_count"] == want["opt_count"]
    assert torch.equal(got["augment_gen"], want["augment_gen"])
    for key in ("params", "momentum", "ef", "opt_nu"):
        assert len(got[key]) == len(want[key]), key
        for i, (a, b) in enumerate(zip(got[key], want[key])):
            assert torch.equal(a, b), f"{key}[{i}] differs by {(a - b).abs().max()}"
    assert got["buffers"].keys() == want["buffers"].keys()
    for name, t in want["buffers"].items():
        assert torch.equal(got["buffers"][name], t), name


def three_runs(cfg: TrainConfig, ds, tmp_path) -> dict[str, dict]:
    """The uninterrupted run, the disk resume and the memory recovery."""
    clean = Trainer(cfg)
    clean.fit(dataset=ds)
    out = {"clean": clean.capture_state()}

    disk_cfg = cfg.replace(checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_every=EVERY)
    first = Trainer(disk_cfg)
    nan_once_at(first, NAN_AT_CALL)
    with pytest.raises(NonFiniteLossError):
        first.fit(dataset=ds)
    resumed = Trainer(disk_cfg)
    restores = Checkpointer.total_restores
    resumed.fit(dataset=ds)
    assert Checkpointer.total_restores == restores + 1
    out["disk"] = resumed.capture_state()

    mem = Trainer(cfg.replace(snapshot_every=EVERY))
    calls = nan_once_at(mem, NAN_AT_CALL)
    restores = Checkpointer.total_restores
    _, history, restarts = run_with_recovery(mem, max_restarts=1, fit_kwargs={"dataset": ds})
    assert restarts == 1 and calls["n"] == NAN_AT_CALL + 5  # replays steps 3..7
    assert Checkpointer.total_restores == restores  # the memory tier read no file
    assert mem.memstore.restores == 1
    assert np.isfinite(history["eval"][-1]["avg_loss"])
    out["memory"] = mem.capture_state()
    return out


@pytest.fixture(scope="module")
def ds():
    return synthetic_cifar10(64, 16, seed=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_mid_epoch_resume_is_bitwise(case, ds, tmp_path):
    runs = three_runs(TrainConfig(**{**BASE, **CASES[case]}), ds, tmp_path)
    assert runs["clean"]["step"] == 8
    assert_states_bitwise(runs["disk"], runs["clean"])
    assert_states_bitwise(runs["memory"], runs["clean"])
    if case.startswith("adamw"):
        assert runs["clean"]["opt_count"] == 8 and runs["clean"]["opt_nu"]


@pytest.fixture
def gloo_world_of_one():
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_mid_epoch_resume_is_bitwise_int8_wire(ds, tmp_path, gloo_world_of_one):
    cfg = TrainConfig(**{**BASE, "sync": "allreduce"}, grad_compress="int8", augment=False)
    runs = three_runs(cfg, ds, tmp_path)
    assert any(bool(e.abs().max() > 0) for e in runs["clean"]["ef"])  # the wire's residuals
    assert_states_bitwise(runs["disk"], runs["clean"])
    assert_states_bitwise(runs["memory"], runs["clean"])


# ----------------------------------------------------------- 2 Gloo ranks
WORLD = 2
SHARDED = {"zero1": dict(sync="zero1"), "fsdp": dict(sync="fsdp")}


def _worker(rank: int, port: int, out_dir: str) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank)
    try:
        import pathlib

        data = synthetic_cifar10(128, 16, seed=0)  # 8 steps of 16 (8 a rank)
        res = {}
        for name, kw in SHARDED.items():
            cfg = TrainConfig(**{**BASE, "num_devices": WORLD, "global_batch_size": 16,
                                 "augment": True, **kw})
            tmp = pathlib.Path(out_dir) / name
            runs = three_runs(cfg, data, tmp)
            for tier in ("disk", "memory"):
                try:
                    assert_states_bitwise(runs[tier], runs["clean"])
                    res[f"{name}/{tier}"] = "ok"
                except AssertionError as e:
                    res[f"{name}/{tier}"] = str(e)
            res[f"{name}/step"] = runs["clean"]["step"]
        torch.save(res, os.path.join(out_dir, f"rank{rank}.res"))
    finally:
        dist.destroy_process_group()


def test_sharded_resume_is_bitwise_on_two_ranks(tmp_path):
    """zero1 and fsdp on 2 Gloo ranks: each rank's shards resume bitwise
    from either tier; then a world of one refuses their checkpoint."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(port), str(tmp_path)],
                              env=env, cwd=REPO) for r in range(WORLD)]
    for p in procs:
        assert p.wait(timeout=300) == 0
    for r in range(WORLD):
        res = torch.load(tmp_path / f"rank{r}.res")
        for name in SHARDED:
            assert res[f"{name}/step"] == 8
            assert res[f"{name}/disk"] == "ok", (r, name, res[f"{name}/disk"])
            assert res[f"{name}/memory"] == "ok", (r, name, res[f"{name}/memory"])
    ckpt = Checkpointer(str(tmp_path / "zero1" / "ckpt"))
    try:
        with pytest.raises(ValueError, match="world of 2 ranks.*elastic restore"):
            ckpt.restore_latest()
    finally:
        ckpt.close()


# ------------------------------------------------------- the JAX contracts
def test_checkpoint_roundtrip(tmp_path, ds):
    tr = Trainer(TrainConfig(**BASE))
    tr.state.step = 7
    state = tr.capture_state()
    ckpt = Checkpointer(str(tmp_path / "ckpt"))
    saves = Checkpointer.total_saves
    ckpt.save(state)
    assert Checkpointer.total_saves == saves + 1
    assert ckpt.latest_step() == 7
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_7"]
    assert os.listdir(tmp_path / "ckpt" / "step_7") == ["rank0.pt"]
    restored = ckpt.restore_latest()
    ckpt.close()
    assert_states_bitwise(restored, state)
    assert all(t.device.type == "cpu" for t in restored["params"])


def test_checkpointer_keeps_the_newest(tmp_path):
    tr = Trainer(TrainConfig(**BASE))
    ckpt = Checkpointer(str(tmp_path / "ckpt"), max_to_keep=2)
    for step in (1, 2, 3):
        tr.state.step = step
        ckpt.save(tr.capture_state(), wait=True)
    ckpt.save(tr.capture_state(), force=True)  # step 3 again: skipped
    assert ckpt.latest_step() == 3
    ckpt.close()
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_2", "step_3"]


def test_fit_saves_and_resumes(tmp_path):
    """4 steps; a fresh trainer on the finished run restores and trains
    nothing; 2 epochs resume from the finished first (as JAX's 4 -> 4 -> 8)."""
    data = synthetic_cifar10(64, 16, seed=0)
    cfg = TrainConfig(**{**BASE, "global_batch_size": 16}, epochs=1,
                      checkpoint_dir=str(tmp_path / "run"))
    state, _ = Trainer(cfg).fit(dataset=data)
    assert state.step == 4
    state2, hist2 = Trainer(cfg).fit(dataset=data)
    assert state2.step == 4 and hist2["eval"] == []
    state3, _ = Trainer(cfg.replace(epochs=2)).fit(dataset=data)
    assert state3.step == 8


def test_evaluate_only_restores_and_matches(tmp_path):
    data = synthetic_cifar10(64, 16, seed=4)
    cfg = TrainConfig(**{**BASE, "global_batch_size": 16},
                      checkpoint_dir=str(tmp_path / "run"))
    _, hist = Trainer(cfg).fit(dataset=data)
    got = Trainer(cfg).evaluate_only(dataset=data)
    want = hist["eval"][-1]
    assert got["count"] == want["count"] == 16
    assert got["correct"] == want["correct"]
    np.testing.assert_allclose(got["avg_loss"], want["avg_loss"], rtol=1e-6)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        Trainer(cfg.replace(checkpoint_dir=str(tmp_path / "empty"))).evaluate_only(dataset=data)


def test_state_from_another_world_size_raises():
    tr = Trainer(TrainConfig(**BASE))
    state = dict(tr.capture_state(), world_size=4)
    with pytest.raises(ValueError, match="world of 4 ranks.*elastic restore"):
        tr.restore_state(state)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
