"""The port's boundaries: it imports no JAX, its entry points need a GPU
unless asked for the CPU, and its CLI runs parts 1 and 2b on the CPU."""

import ast
import json
import math
import os
import pathlib

import pytest
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch import cli
from cs744_pytorch_distributed_tutorial_tpu_torch.config import TrainConfig
from cs744_pytorch_distributed_tutorial_tpu_torch.train import Trainer

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "cs744_pytorch_distributed_tutorial_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "cs744_pytorch_distributed_tutorial_tpu")


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_and_chip_smoke_import_no_jax():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = [
        (str(f.relative_to(REPO)), mod)
        for f in files
        for mod in _imported_modules(f)
        if mod.split(".")[0] in FORBIDDEN
    ]
    assert not bad, bad


def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid here")


def test_trainer_without_gpu_raises():
    _no_gpu()
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(TrainConfig(model="tiny_cnn", sync="none", num_devices=1))


def test_cli_without_gpu_raises():
    _no_gpu()
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--part", "1", "--model", "tiny_cnn", "--synthetic-data"])


SMALL = ["--model", "tiny_cnn", "--synthetic-data", "--synthetic-train-size", "96",
         "--synthetic-test-size", "40", "--global-batch-size", "16",
         "--fused-optimizer", "--device", "cpu", "--json"]


@pytest.mark.parametrize("part,backend", [("1", None), ("2b", "gloo")])
def test_cli_runs_on_cpu(part, backend, capsys):
    assert cli.main(["--part", part, "--num-devices", "1", *SMALL]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["steps"] == 6 and summary["backend"] == backend
    assert summary["num_devices"] == 1 and summary["device"] == "cpu"
    assert 0.0 <= summary["final_eval_accuracy"] <= 1.0
    assert not torch.distributed.is_initialized()


def test_multi_rank_part_needs_a_coordinator():
    with pytest.raises(ValueError, match="coordinator"):
        cli.main(["--part", "2b", *SMALL])


@pytest.mark.parametrize(
    "override,exc",
    [
        (dict(optimizer="adamw"), NotImplementedError),
        (dict(lr_schedule="cosine"), NotImplementedError),
        (dict(grad_clip_norm=1.0), NotImplementedError),
        (dict(accum_steps=2), NotImplementedError),
        (dict(model="vit_tiny"), NotImplementedError),
        (dict(model="vgg11", fast_conv=True), ValueError),  # no ResNet 3x3 convs
        (dict(sync="zero1"), NotImplementedError),
        (dict(sync="allreduce"), ValueError),  # no process group
        (dict(num_devices=2), ValueError),
    ],
)
def test_unported_options_raise(override, exc):
    kw = {**dict(model="tiny_cnn", sync="none", device="cpu"), **override}
    with pytest.raises(exc):
        Trainer(TrainConfig(**kw))


def test_build_directory_is_ignored_by_git():
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import _build

    assert _build.BUILD_DIR.relative_to(REPO).parts[0] == "build"
    assert "build/" in (REPO / ".gitignore").read_text().split()
    for source in ("fused_sgd.cu", "fused_conv.cu", "flash_attention.cu"):
        assert os.path.exists(_build.CSRC_DIR / source)


def test_bfloat16_autocast_trains_on_cpu():
    cfg = TrainConfig(model="tiny_cnn", sync="none", num_devices=1, global_batch_size=16,
                      synthetic_data=True, synthetic_train_size=64, synthetic_test_size=16,
                      compute_dtype="bfloat16", learning_rate=0.02, device="cpu")
    state, hist = Trainer(cfg).fit()
    assert state.step == 4
    assert all(p.dtype == torch.float32 for p in state.params)
    assert all(math.isfinite(loss) for (_, _, loss) in hist["train_loss"])
    assert math.isfinite(hist["eval"][-1]["avg_loss"])
