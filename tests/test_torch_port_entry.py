"""The port's boundaries: it imports no JAX, its entry points need a GPU
unless asked for the CPU, its options of later slices raise, its CLI runs
parts 1 and 2b on the CPU, and ``lm_cli --generate`` and ``serve_cli``
run on the CPU at tiny sizes."""

import ast
import json
import math
import os
import pathlib

import pytest
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch import cli, lm_cli, serve_cli
from cs744_pytorch_distributed_tutorial_tpu_torch.config import TrainConfig
from cs744_pytorch_distributed_tutorial_tpu_torch.infer import make_generator
from cs744_pytorch_distributed_tutorial_tpu_torch.models.transformer import TransformerLM
from cs744_pytorch_distributed_tutorial_tpu_torch.serve import ServeConfig, ServingEngine
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


RUN_LOOP_MODULES = [
    "native/__init__.py", "native/build.py", "data/native_decode.py",
    "data/native_batcher.py", "data/prefetch.py", "obs/sinks.py", "obs/run_manifest.py",
    "obs/system.py", "obs/metrics.py", "obs/flight.py", "utils/checkpoint.py",
    "utils/memstore.py", "utils/failure.py", "utils/profiling.py", "utils/logging.py",
    # the phase profiler and its report CLI
    "obs/phases.py", "obs/__main__.py", "ops/_cost.py",
]


@pytest.mark.parametrize("module", RUN_LOOP_MODULES)
def test_run_loop_modules_import_no_jax(module):
    """The run loop's modules, the native build included, import neither
    JAX nor the JAX package, and build the port's own C++ copies."""
    path = PORT / module
    assert path.exists()
    bad = [mod for mod in _imported_modules(path) if mod.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    if module == "native/build.py":
        assert (PORT / "native" / "batcher.cpp").exists() and (PORT / "native" / "decode.cpp").exists()
        assert "cs744_pytorch_distributed_tutorial_tpu/" not in path.read_text()


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


TINY_LM = dict(vocab_size=64, num_layers=1, num_heads=2, d_model=16, d_ff=32, max_seq_len=32)
LM_FLAGS = ["--num-layers", "2", "--d-model", "32", "--num-heads", "4", "--num-kv-heads", "2",
            "--d-ff", "64", "--vocab-size", "128", "--max-seq-len", "64", "--use-rope"]
SERVE_FLAGS = [*LM_FLAGS, "--requests", "6", "--rate", "50", "--prompt-len", "3", "12",
               "--output-len", "2", "9", "--num-slots", "3", "--page-size", "4",
               "--num-pages", "20", "--max-pages-per-slot", "6"]


@pytest.mark.parametrize("entry", ["make_generator", "ServingEngine", "serve_cli",
                                   "lm_cli --generate", "lm_cli --generate (MoE)",
                                   "lm_cli --fused-xent"])
def test_inference_entry_points_without_gpu_raise(entry):
    _no_gpu()
    model = TransformerLM(**TINY_LM)
    calls = {
        "make_generator": lambda: make_generator(model, max_new_tokens=2),
        "ServingEngine": lambda: ServingEngine(model, ServeConfig()),
        "serve_cli": lambda: serve_cli.main(SERVE_FLAGS),
        "lm_cli --generate": lambda: lm_cli.main([*LM_FLAGS, "--steps", "0", "--generate", "4",
                                                  "--seq-len", "16", "--num-seqs", "8"]),
        "lm_cli --generate (MoE)": lambda: lm_cli.main(
            [*LM_FLAGS, "--moe-experts", "4", "--moe-dispatch", "dropless", "--steps", "0",
             "--generate", "4", "--seq-len", "16", "--num-seqs", "8"]),
        "lm_cli --fused-xent": lambda: lm_cli.main([*LM_FLAGS, "--fused-xent", "--steps", "1",
                                                    "--seq-len", "16", "--num-seqs", "8"]),
    }
    with pytest.raises(RuntimeError, match="cuda"):
        calls[entry]()


@pytest.mark.parametrize(
    "argv",
    [["--trace-dir", "t"], ["--window-every", "0.5"], ["--deadline-s", "3"],
     ["--max-queue-s", "1"], ["--max-queue-depth", "4"], ["--shed-policy", "degrade"],
     ["--chaos", "4:decode_nan"], ["--step-timeout-s", "2"], ["--max-restarts", "3"]],
)
def test_serve_cli_unported_flags_exit(argv):
    with pytest.raises(SystemExit, match="not yet ported"):
        serve_cli.main([*SERVE_FLAGS, "--device", "cpu", *argv])


@pytest.mark.parametrize("flag", ["--beam", "--speculative-k"])
def test_lm_cli_unported_decoders_exit(flag):
    with pytest.raises(SystemExit, match="not yet ported"):
        lm_cli.main([*LM_FLAGS, "--generate", "4", flag, "2", "--device", "cpu"])


@pytest.mark.parametrize("option", ["guard", "tracer", "mesh", "snapshot", "resume",
                                    "make_flight_recorder", "generator_mesh"])
def test_unported_serving_options_raise(option):
    model = TransformerLM(**TINY_LM)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        if option in ("guard", "tracer", "mesh"):
            ServingEngine(model, ServeConfig(), device="cpu", **{option: object()})
        elif option == "generator_mesh":
            make_generator(model, max_new_tokens=2, device="cpu", mesh=object())
        else:
            engine = ServingEngine(model, ServeConfig(), device="cpu")
            getattr(engine, option)(*([None] if option == "resume" else []))


def test_lm_cli_generates_on_cpu(capsys):
    """Train 2 steps, then 6 greedy tokens for 3 prompts with the int8
    head and an int8 KV cache (the kernels' plain versions)."""
    argv = [*LM_FLAGS, "--seq-len", "16", "--global-batch-size", "4", "--steps", "2",
            "--num-seqs", "12", "--generate", "6", "--prompt-len", "5", "--generate-batch", "3",
            "--temperature", "0", "--int8-decode", "--int8-kv-cache", "--json", "--device", "cpu"]
    assert lm_cli.main(argv) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    gen = summary["generation"]
    assert gen["batch"] == 3 and gen["int8_decode"] == "head" and gen["int8_kv_cache"]
    assert len(gen["tokens"]) == 3 and summary["sample"] == gen["tokens"][0]
    assert all(len(row) == 6 and all(0 <= t < 128 for t in row) for row in gen["tokens"])


def test_serve_cli_runs_on_cpu(capsys):
    """Parity (engine vs make_generator), the Poisson replay and the
    baseline comparison on the CPU."""
    assert serve_cli.main([*SERVE_FLAGS, "--device", "cpu", "--parity-check",
                           "--compare-baseline"]) == 0
    records = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    parity = [r for r in records if r.get("event") == "parity"]
    summary = [r for r in records if r.get("kind") == "serve_summary"]
    assert parity[0]["parity_ok"] and parity[0]["requests"] == 6
    assert [r["engine"] for r in summary] == ["continuous", "batch"]
    assert summary[0]["completed"] == 6 and summary[0]["paged_attention_impl"] == "kernel"
    assert any(r.get("event") == "comparison" for r in records)


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
        # The recipes and the sharded optimizers run now: each case is the
        # JAX Trainer's rejection of a combination.
        (dict(optimizer="adamw", fused_optimizer=True), ValueError),  # fused: SGD only
        (dict(lr_schedule="cosine"), ValueError),  # no total_steps
        (dict(grad_clip_norm=-1.0), ValueError),  # must be > 0
        (dict(sync="fsdp", debug_sync_check=True), ValueError),  # no replicated state
        (dict(model="vit_tiny"), NotImplementedError),
        (dict(model="vgg11", fast_conv=True), ValueError),  # no ResNet 3x3 convs
        (dict(sync="zero1", fused_optimizer=True), ValueError),  # its own update
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
    for source in ("fused_sgd.cu", "fused_conv.cu", "flash_attention.cu", "paged_attention.cu",
                   "int8_matmul.cu"):
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
