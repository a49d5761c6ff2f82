"""The port's boundaries: it imports no JAX, its entry points need a GPU
unless asked for the CPU, its options of later slices raise, its CLI runs
parts 1 and 2b on the CPU, and ``lm_cli --generate`` and ``serve_cli``
(its trace, guard, chaos and recovery flags included) run on the CPU at
tiny sizes."""

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
    # the serving tracer, guard and chaos monkey
    "obs/serve_trace.py", "serve/guard.py", "utils/chaos.py",
    # the sequence, tensor and expert axes
    "parallel/tensor.py",
    # the pipe axis and the HuggingFace checkpoint import
    "parallel/pipeline.py", "models/hf_interop.py",
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
                                   "lm_cli --fused-xent", "lm_cli --remat --accum-steps",
                                   "lm_cli --beam", "lm_cli --speculative-k"])
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
        "lm_cli --remat --accum-steps": lambda: lm_cli.main(
            [*LM_FLAGS, "--remat", "--accum-steps", "2", "--dropout-rate", "0.1",
             "--scan-layers", "--steps", "1", "--seq-len", "16", "--num-seqs", "8"]),
        "lm_cli --beam": lambda: lm_cli.main([*LM_FLAGS, "--steps", "0", "--generate", "4",
                                              "--beam", "2", "--seq-len", "16",
                                              "--num-seqs", "8"]),
        "lm_cli --speculative-k": lambda: lm_cli.main(
            [*LM_FLAGS, "--steps", "0", "--generate", "4", "--speculative-k", "2",
             "--temperature", "0", "--seq-len", "16", "--num-seqs", "8"]),
    }
    with pytest.raises(RuntimeError, match="cuda"):
        calls[entry]()


def _records(out: str) -> list[dict]:
    rows = []
    for line in out.splitlines():
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(rec, dict):
            rows.append(rec)
    return rows


@pytest.mark.parametrize(
    "argv",
    [["--trace-dir", "t"], ["--window-every", "0.5"], ["--deadline-s", "0"],
     ["--max-queue-s", "0"], ["--max-queue-depth", "1", "--rate", "1e6"],
     ["--shed-policy", "degrade", "--degrade-floor", "2"],
     ["--chaos", "4:decode_nan"], ["--step-timeout-s", "2"],
     ["--max-restarts", "3", "--chaos", "1:engine_crash,2:engine_crash,3:engine_crash"]],
)
def test_serve_cli_unported_flags_exit(argv, tmp_path, monkeypatch, capsys):
    """The serving CLI's trace, guard, chaos and recovery flags (each once
    exited "not yet ported") run on the CPU, each case checking what its
    flag does: the trace dir, the SLO windows, deadline and queue-wait
    expiry (budget 0: every request expires), the bounded queue's sheds,
    the degrade policy's trims (exactly the admissions made under pool
    pressure with a budget above the floor), one restart after a
    ``decode_nan``, the watchdog armed around every step, and three
    restarts allowed and taken."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.obs.serve_trace import (
        check_spans,
        load_trace_dir,
    )
    from cs744_pytorch_distributed_tutorial_tpu_torch.serve import ServeGuard
    from cs744_pytorch_distributed_tutorial_tpu_torch.utils.failure import StepWatchdog

    monkeypatch.chdir(tmp_path)
    admits, arms = [], []
    real_admit, real_arm = ServeGuard.admit, StepWatchdog.arm

    def admit(self, engine, req):
        pool, budget = engine.pool, req.max_new_tokens
        pressured = pool.free_pages < self.cfg.pressure_free_frac * (pool.num_pages - 1)
        ok = real_admit(self, engine, req)
        admits.append((self.cfg.shed_policy, pressured and budget > self.cfg.degrade_floor,
                       req.max_new_tokens < budget))
        return ok

    def arm(self, timeout_s=None):
        arms.append(self.timeout_s)
        real_arm(self, timeout_s)

    monkeypatch.setattr(ServeGuard, "admit", admit)
    monkeypatch.setattr(StepWatchdog, "arm", arm)
    assert serve_cli.main([*SERVE_FLAGS, "--device", "cpu", *argv]) == 0
    records = _records(capsys.readouterr().out)
    (summary,) = [r for r in records if r.get("kind") == "serve_summary"]
    events = [r.get("event") for r in records if r.get("kind") == "event"]
    flag = argv[0]
    assert summary["requests"] == 6
    assert sum(summary[k] for k in ("completed", "rejected", "timed_out", "recovered")) == 6
    if flag == "--trace-dir":
        data = load_trace_dir("t")
        assert check_spans(data["spans"]) == [] and len(data["requests"]) == 6
        assert data["windows"] and os.path.exists("t/serve_trace.json")
        phases = json.load(open("t/serve_phases.json"))
        assert phases[0]["phase"] == "decode" and "decode_host_exposed_ms" in phases[-1]
        assert any(r.get("kind") == "serve_phase" for r in records)
    elif flag == "--window-every":
        assert [r for r in records if r.get("kind") == "serve_window"]
    elif flag in ("--deadline-s", "--max-queue-s"):
        reason = "deadline" if flag == "--deadline-s" else "queue_wait"
        expired = [r for r in records if r.get("event") == "timed_out"]
        assert summary["timed_out"] == len(expired) >= 1
        assert all(r["reason"] == reason for r in expired)
    elif flag == "--max-queue-depth":
        sheds = [r for r in records if r.get("kind") == "serve_shed"]
        assert summary["rejected"] == len(sheds) >= 1
        assert all(r["reason"] == "queue_full" and r["terminal"] for r in sheds)
    elif flag == "--shed-policy":
        assert len(admits) == 6 and all(policy == "degrade" for policy, _, _ in admits)
        assert all(trimmed == should for _, should, trimmed in admits)
        trims = [r for r in records if r.get("reason") == "degrade_trim"]
        assert len(trims) == sum(t for _, _, t in admits)
    elif flag == "--chaos":
        assert summary["restarts"] == 1 and events.count("recovery_restart") == 1
        assert events.count("chaos_inject") == 1 and "recovery_complete" in events
    elif flag == "--step-timeout-s":
        assert summary["restarts"] == 0 and len(arms) >= summary["decode_steps"] > 0
        assert set(arms) == {2.0}
    else:
        assert summary["restarts"] == 3 and events.count("recovery_restart") == 3
        assert "recovery_giveup" not in events


@pytest.mark.parametrize("flag", ["--beam", "--speculative-k"])
def test_lm_cli_unported_decoders_exit(flag):
    """Both decoders run now (``test_torch_port_lm_options.py``); each
    still exits where the JAX CLI does: ``--beam`` with a sampling
    temperature, ``--speculative-k`` with the int8 decode paths."""
    extra, match = {"--beam": (["--temperature", "0.5"], "--beam is deterministic"),
                    "--speculative-k": (["--int8-decode", "head"], "int8 decode")}[flag]
    with pytest.raises(SystemExit, match=match):
        lm_cli.main([*LM_FLAGS, "--generate", "4", flag, "2", *extra, "--device", "cpu"])


@pytest.mark.parametrize("option", ["guard", "tracer", "mesh", "snapshot", "resume",
                                    "make_flight_recorder", "generator_mesh"])
def test_unported_serving_options_raise(option):
    """Every option once refused now serves on the CPU. ``mesh`` (the
    engine's and the generator's) is the tensor-parallel path
    (``tests/test_torch_port_tp_decode.py``); on a model without a tensor
    axis it raises JAX's refusals: ``param_specs`` missing, then a mesh
    that does not carry the model's tensor axis."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.obs.serve_trace import ServeTracer
    from cs744_pytorch_distributed_tutorial_tpu_torch.serve import Request, ServeGuard

    model = TransformerLM(**TINY_LM)
    cfg = ServeConfig(num_slots=2, page_size=4, num_pages=9, max_pages_per_slot=4)
    if option in ("mesh", "generator_mesh"):
        def build(**kw):
            if option == "mesh":
                return ServingEngine(model, cfg, device="cpu", **kw)
            return make_generator(model, max_new_tokens=2, device="cpu", **kw)

        with pytest.raises(ValueError, match="the shard_map decode path needs param_specs"):
            build(mesh=object())
        with pytest.raises(ValueError, match="does not carry the model's tensor axis None"):
            build(mesh=object(), param_specs=model.param_specs)
        return
    kw = {"guard": ServeGuard(), "tracer": ServeTracer(2)}.get(option)
    engine = ServingEngine(model, cfg, device="cpu", **({option: kw} if kw else {}))
    reqs = [engine.submit(Request(prompt=[1, 2, 3], max_new_tokens=5)) for _ in range(3)]
    engine.step()
    if option == "guard":
        assert engine.guard is kw and all(r.deadline_s is None for r in reqs)
    elif option == "tracer":
        assert {s["name"] for s in kw.spans} == {"queue", "prefill"}
    elif option in ("snapshot", "resume"):
        snap = engine.snapshot()
        assert [r["in_flight"] for r in snap.requests] == [True, True, False]
        if option == "resume":
            fresh = ServingEngine(model, cfg, device="cpu")
            resumed = fresh.resume(snap)
            fresh.run()
            engine.run()
            assert [list(r.prompt[r.orig_prompt_len:]) + r.generated for r in resumed] == [
                r.generated for r in reqs]
            assert all(r.terminal_status == "recovered" for r in resumed)
    else:
        sink = []
        engine.make_flight_recorder(emit=lambda event, **f: sink.append(event),
                                    hbm=False).dump("test")
        assert sink[0] == "flight_dump" and "flight_serve" not in sink
    engine.run()
    assert all(r.terminal_status in ("completed", "recovered") for r in reqs)


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
        (dict(model="vit_tiny", dropout_rate=1.0), ValueError),  # rate in [0, 1)
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
