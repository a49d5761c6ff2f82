"""The port's telemetry against the JAX package's (``tests/test_obs.py``,
``tests/test_profiling.py``): sinks, the manifest, the straggler
monitor, the flight recorder, the profiler window, the metric stream of
``fit`` (the same record keys as JAX's for the same configuration, and
the same ``grad_sync_bytes`` on 2 ranks, the int8 wire's smaller count
included) and the CLI's run-loop flags."""

import io
import json
import math
import os
import signal
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from cs744_pytorch_distributed_tutorial_tpu.config import TrainConfig as JaxConfig
from cs744_pytorch_distributed_tutorial_tpu.data import synthetic_cifar10 as jax_synthetic
from cs744_pytorch_distributed_tutorial_tpu.obs.flight import (
    StragglerMonitor as JaxStragglerMonitor,
)
from cs744_pytorch_distributed_tutorial_tpu.parallel import make_mesh
from cs744_pytorch_distributed_tutorial_tpu.train import Trainer as JaxTrainer
from cs744_pytorch_distributed_tutorial_tpu_torch import cli
from cs744_pytorch_distributed_tutorial_tpu_torch.config import TrainConfig
from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_cifar10
from cs744_pytorch_distributed_tutorial_tpu_torch.obs import system
from cs744_pytorch_distributed_tutorial_tpu_torch.obs.flight import (
    FlightRecorder,
    StragglerMonitor,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.obs.metrics import (
    Telemetry,
    tree_l2_norm,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.obs.run_manifest import (
    read_manifest,
    write_manifest,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.obs.sinks import (
    CsvSink,
    JsonlSink,
    NullSink,
    RingSink,
    rank_zero,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.mesh import free_port
from cs744_pytorch_distributed_tutorial_tpu_torch.train import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(model="tiny_cnn", global_batch_size=16, synthetic_data=True,
            synthetic_train_size=80, synthetic_test_size=16, augment=False,
            learning_rate=0.02, metrics_every=1)
WIRES = {"allreduce": dict(sync="allreduce"),
         "int8": dict(sync="allreduce", grad_compress="int8")}


def _records(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


# ---------------------------------------------------------------- sinks
def test_jsonl_csv_ring_and_null_sinks(tmp_path):
    jsonl = JsonlSink(str(tmp_path / "m.jsonl"))
    jsonl.emit({"a": 1.0, "b": float("nan"), "c": np.float32(2.5)})
    jsonl.close()
    assert json.loads((tmp_path / "m.jsonl").read_text()) == {"a": 1.0, "b": None, "c": 2.5}

    csv_sink = CsvSink(str(tmp_path / "m.csv"))
    csv_sink.emit({"step": 0, "loss": 1.5})
    csv_sink.emit({"step": 1, "extra": 9})  # header frozen: 'extra' dropped, 'loss' blank
    csv_sink.close()
    assert (tmp_path / "m.csv").read_text().splitlines() == ["step,loss", "0,1.5", "1,"]

    ring = RingSink(capacity=3)
    for i in range(5):
        ring.emit({"i": i})
    assert [r["i"] for r in ring.records()] == [2, 3, 4] and len(ring) == 3
    assert [r["i"] for r in ring.tail(2)] == [3, 4]
    with pytest.raises(ValueError, match="capacity"):
        RingSink(0)
    NullSink().emit({"x": 1})
    gated = RingSink()
    rank_zero(gated).emit({"x": 1})  # no process group: rank 0
    assert len(gated) == 1


def test_manifest_round_trip(tmp_path):
    path = write_manifest(str(tmp_path / "run"), config=TrainConfig(model="tiny_cnn"),
                          device=torch.device("cpu"), run="cifar", grad_sync_bytes_per_step=7)
    man = read_manifest(str(tmp_path / "run"))
    assert path.endswith("manifest.json") and read_manifest(path) == man
    assert man["kind"] == "manifest" and man["run"] == "cifar"
    assert man["config"]["model"] == "tiny_cnn" and man["config"]["device"] == "cuda"
    assert man["torch_version"] == torch.__version__
    assert man["device"] == "cpu" and man["world_size"] == 1 and man["backend"] is None
    assert man["grad_sync_bytes_per_step"] == 7
    assert {"cuda_version", "cudnn_version", "device_name", "git_sha"} <= man.keys()


def test_telemetry_amortizes_step_time_and_counts_builds(tmp_path, monkeypatch):
    tel = Telemetry(str(tmp_path), every=2, system_every=2, flops_per_step=1e9,
                    device_kind="cpu")
    assert tel.due(0) and not tel.due(1) and tel.due(4)
    from cs744_pytorch_distributed_tutorial_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "build_seconds", dict(_build.build_seconds))
    counter = system.CompileCounter()
    _build.build_seconds["x.cu"] = 2.5
    _build.build_seconds["cached.cu"] = 0.0
    assert counter.count == 1 and counter.seconds == 2.5
    tel.emit_step(0, loss=1.0)
    tel.emit_step(4, loss=0.5)
    tel.emit_event("eval", avg_loss=0.4)
    tel.close()
    recs = _records(str(tmp_path))
    steps = [r for r in recs if r["kind"] == "step"]
    assert steps[0]["step_time_s"] is None and steps[1]["step_time_s"] > 0
    assert steps[1]["mfu"] is None  # no peak for the CPU
    sysrec = [r for r in recs if r["kind"] == "system"]
    assert len(sysrec) == 1 and sysrec[0]["hbm_bytes_in_use"] is None
    assert sysrec[0]["compile_count"] >= 1
    assert recs[-1]["event"] == "eval" and recs[-1]["process_id"] == 0
    assert system.hbm_stats(torch.device("cpu")) is None


def test_tree_l2_norm_matches_numpy():
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in [(3, 4), (5,), (2, 2, 2)]]
    want = math.sqrt(sum(float((a.astype(np.float64) ** 2).sum()) for a in arrays))
    got = float(tree_l2_norm([torch.from_numpy(a) for a in arrays]))
    assert got == pytest.approx(want, rel=1e-6)


def test_logger_prefix_computed_per_record(monkeypatch):
    from cs744_pytorch_distributed_tutorial_tpu_torch.utils import logging as L

    logger = L.get_logger("cs744_torch_prefix_test")
    stream = io.StringIO()
    handler = logger.handlers[0]
    old, handler.stream = handler.stream, stream
    try:
        logger.info("single")
        monkeypatch.setattr(L, "_rank_and_world", lambda: (2, 4))
        logger.info("multi")
        assert L.rank_zero_only(lambda: "ran")() is None
    finally:
        handler.stream = old
    assert stream.getvalue().splitlines() == ["single", "[proc 2/4] multi"]


# -------------------------------------------------- straggler and flight
def _series():
    for step in range(64):
        wall = 0.102 if step % 2 else 0.098
        yield step, 1.5 if step == 50 else wall


def test_straggler_monitor_flags_the_seeded_outlier_as_jax():
    port, jaxm = StragglerMonitor(min_samples=16), JaxStragglerMonitor(min_samples=16)
    got = [o for s, w in _series() if (o := port.record(s, w)) is not None]
    want = [o for s, w in _series() if (o := jaxm.record(s, w)) is not None]
    assert [o["step"] for o in got] == [o["step"] for o in want] == [50]
    for key in ("wall_s", "median_s", "mad_s", "excess_sigma"):
        assert got[0][key] == want[0][key]
    assert port.stats()["outlier_count"] == 1 and port.tail(4)[-1]["step"] == 63


def test_flight_recorder_chains_hooks_and_sets_sigterm_from_main_thread_only():
    ring = RingSink()
    rec = FlightRecorder(emit=lambda event, **f: ring.emit({"event": event, **f}),
                         straggler=StragglerMonitor())
    seen = []
    prev_hook = sys.excepthook
    sys.excepthook = lambda *a: seen.append(a[0])
    try:
        prev_term = signal.getsignal(signal.SIGTERM)
        box = {}
        t = threading.Thread(target=lambda: box.update(ok=rec.install() is None))
        t.start()
        t.join(timeout=10)
        assert box["ok"] and signal.getsignal(signal.SIGTERM) is prev_term
        sys.excepthook(RuntimeError, RuntimeError("x"), None)
        rec.uninstall()
        assert seen == [RuntimeError] and ring.records()[0]["reason"] == "exception"
        if threading.current_thread() is threading.main_thread():
            rec.install()
            assert signal.getsignal(signal.SIGTERM) == rec._on_sigterm
            rec.uninstall()
            assert signal.getsignal(signal.SIGTERM) is prev_term
    finally:
        sys.excepthook = prev_hook
    with pytest.raises(ValueError, match="telemetry or an emit"):
        FlightRecorder()


# ------------------------------------------------------------- profiler
def test_profile_window_writes_a_trace_of_its_steps(tmp_path):
    cfg = TrainConfig(**TINY, sync="none", num_devices=1, device="cpu",
                      profile_dir=str(tmp_path / "trace"), profile_start_step=1,
                      profile_num_steps=2)
    _, hist = Trainer(cfg).fit()
    assert hist["eval"]
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].startswith("trace_rank0_")
    with open(tmp_path / "trace" / files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"train#1", "train#2"} <= names and "train#0" not in names
    assert "train#3" not in names and "input_fetch" in names


def test_trace_context_writes_a_chrome_trace(tmp_path):
    from cs744_pytorch_distributed_tutorial_tpu_torch.utils import profiling

    with profiling.trace(str(tmp_path)) as capture:
        with profiling.annotate("region"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    with open(capture.path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert os.path.dirname(capture.path) == str(tmp_path) and "region" in names


def test_profile_window_past_the_end_is_a_noop(tmp_path, caplog):
    cfg = TrainConfig(**TINY, sync="none", num_devices=1, device="cpu",
                      profile_dir=str(tmp_path / "trace"), profile_start_step=10_000)
    with caplog.at_level("WARNING"):
        _, hist = Trainer(cfg).fit()
    assert hist["eval"]
    assert not os.path.isdir(tmp_path / "trace") or not os.listdir(tmp_path / "trace")
    assert any("never opened" in r.getMessage() for r in caplog.records)


# ------------------------------------------------ the stream against JAX
def _jax_records(tmp_path, world: int, **kw) -> list[dict]:
    mesh = make_mesh({"data": world}, devices=jax.devices()[:world])
    out = str(tmp_path / f"jax_{world}_{kw.get('grad_compress', 'none')}_{kw['sync']}")
    cfg = JaxConfig(**TINY, num_devices=world, metrics_dir=out, **kw)
    JaxTrainer(cfg, mesh=mesh).fit(dataset=jax_synthetic(80, 16, seed=0))
    return _records(out)


def _kinds(recs):
    steps = [r for r in recs if r["kind"] == "step"]
    events = sorted({r["event"] for r in recs if r["kind"] == "event"})
    system_keys = [set(r) for r in recs if r["kind"] == "system"]
    return steps, events, system_keys


def test_step_stream_matches_jax_at_world_one(tmp_path):
    out = str(tmp_path / "port")
    Trainer(TrainConfig(**TINY, sync="none", num_devices=1, device="cpu",
                        metrics_dir=out)).fit(dataset=synthetic_cifar10(80, 16, seed=0))
    steps, events, system_keys = _kinds(_records(out))
    jsteps, jevents, jsystem_keys = _kinds(_jax_records(tmp_path, 1, sync="none"))
    assert [r["step"] for r in steps] == [r["step"] for r in jsteps] == [0, 1, 2, 3, 4]
    assert [set(r) for r in steps] == [set(r) for r in jsteps]
    assert events == jevents and system_keys == jsystem_keys
    for r, j in zip(steps, jsteps):
        assert r["grad_sync_bytes"] == j["grad_sync_bytes"] == 0
        assert r["lr"] == pytest.approx(j["lr"])
    man = read_manifest(out)
    assert man["run"] == "cifar" and man["grad_sync_bytes_per_step"] == 0


def _worker(rank: int, port: int, out_dir: str) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    try:
        ds = synthetic_cifar10(80, 16, seed=0)
        for name, kw in WIRES.items():
            cfg = TrainConfig(**TINY, num_devices=2, device="cpu",
                              metrics_dir=os.path.join(out_dir, name), **kw)
            Trainer(cfg).fit(dataset=ds)
        tr = Trainer(TrainConfig(**TINY, num_devices=2, device="cpu", sync="fsdp"))
        sharded = float(tree_l2_norm(tr.params, [("data",)] * len(tr.params)))
        full = float(tree_l2_norm(list(tr.state_dict()[n] for n in tr._param_names)))
        torch.save({"sharded": sharded, "full": full}, os.path.join(out_dir, f"norm{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_step_stream_and_wire_bytes_match_jax_on_two_ranks(tmp_path):
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(port), str(tmp_path)],
                              env=env, cwd=REPO) for r in range(2)]
    for p in procs:
        assert p.wait(timeout=300) == 0
    wire = {}
    for name, kw in WIRES.items():
        steps, events, _ = _kinds(_records(str(tmp_path / name)))
        jsteps, jevents, _ = _kinds(_jax_records(tmp_path, 2, **kw))
        assert [set(r) for r in steps] == [set(r) for r in jsteps]
        assert events == jevents
        wire[name] = {r["grad_sync_bytes"] for r in steps}
        assert wire[name] == {r["grad_sync_bytes"] for r in jsteps}
        assert all(r["grad_norm"] > 0 and r["param_norm"] > 0 for r in steps)
        assert read_manifest(str(tmp_path / name))["world_size"] == 2
    (f32,), (int8,) = wire["allreduce"], wire["int8"]
    assert 0 < int8 < f32 and f32 / int8 > 3.0
    for r in range(2):
        norms = torch.load(tmp_path / f"norm{r}.pt")
        assert norms["sharded"] == pytest.approx(norms["full"], rel=1e-6)


# ------------------------------------------------------------------ CLI
NEW_FLAGS = {
    "--prefetch-depth": ("3", "prefetch_depth", 3),
    "--checkpoint-dir": ("ck", "checkpoint_dir", "ck"),
    "--checkpoint-every": ("5", "checkpoint_every", 5),
    "--snapshot-every": ("4", "snapshot_every", 4),
    "--snapshot-keep": ("3", "snapshot_keep", 3),
    "--step-timeout-s": ("2.5", "step_timeout_s", 2.5),
    "--hang-action": ("escalate", "hang_action", "escalate"),
    "--no-halt-on-nonfinite": (None, "halt_on_nonfinite", False),
    "--metrics-dir": ("m", "metrics_dir", "m"),
    "--metrics-every": ("7", "metrics_every", 7),
    "--profile-dir": ("p", "profile_dir", "p"),
    "--profile-start-step": ("11", "profile_start_step", 11),
    "--profile-num-steps": ("6", "profile_num_steps", 6),
}


@pytest.mark.parametrize("flag", sorted(NEW_FLAGS))
def test_cli_flag_parses_into_its_field(flag):
    value, field, want = NEW_FLAGS[flag]
    argv = [flag] + ([] if value is None else [value])
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    assert getattr(cfg, field) == want
    assert getattr(TrainConfig(), field) == getattr(JaxConfig(), field)  # JAX's default


def test_cli_recovery_flags_and_invalid_values():
    args = cli.build_parser().parse_args(
        ["--max-restarts", "2", "--restart-backoff-s", "0.5", "--restart-jitter",
         "decorrelated", "--eval-only"])
    assert (args.max_restarts, args.restart_backoff_s, args.restart_jitter, args.eval_only) == (
        2, 0.5, "decorrelated", True)
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--hang-action", "explode"])
    with pytest.raises(ValueError, match="prefetch_depth"):
        Trainer(TrainConfig(model="tiny_cnn", sync="none", device="cpu", prefetch_depth=-1))


def _cli(argv, capsys):
    base = ["--part", "1", "--model", "tiny_cnn", "--synthetic-data",
            "--synthetic-train-size", "96", "--synthetic-test-size", "32",
            "--global-batch-size", "16", "--no-augment", "--log-every", "1",
            "--device", "cpu", "--json"]
    rc = cli.main(base + argv)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, out


def test_cli_eval_only_prints_jaxs_keys(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    rc, out = _cli(["--checkpoint-dir", ck, "--metrics-dir", str(tmp_path / "m")], capsys)
    trained = json.loads(out[-1])
    rc2, out2 = _cli(["--checkpoint-dir", ck, "--eval-only"], capsys)
    got = json.loads(out2[-1])
    # JAX cli.py's --eval-only summary
    assert set(got) == {"sync", "model", "num_devices", "final_eval_loss", "final_eval_accuracy"}
    assert rc == rc2 == 0
    assert got["final_eval_loss"] == pytest.approx(trained["final_eval_loss"], rel=1e-6)
    assert trained["native_batches"] == 6 + 2 and trained["restarts"] == 0
    with pytest.raises(FileNotFoundError):
        _cli(["--checkpoint-dir", str(tmp_path / "empty"), "--eval-only"], capsys)


def _nan_from(call: int, transient: bool, monkeypatch):
    orig = Trainer.train_step
    calls = {"n": 0}

    def step(self, x, y):
        loss = orig(self, x, y)
        calls["n"] += 1
        if calls["n"] == call or (not transient and calls["n"] > call):
            loss = torch.full_like(loss, float("nan"))
        return loss

    monkeypatch.setattr(Trainer, "train_step", step)


def test_cli_max_restarts_recovers_gives_up_and_halt_off(tmp_path, capsys, monkeypatch):
    _nan_from(3, True, monkeypatch)
    rc, out = _cli(["--checkpoint-dir", str(tmp_path / "a"), "--checkpoint-every", "2",
                    "--max-restarts", "1"], capsys)
    assert rc == 0 and "recovered after 1 restart(s)" in out
    assert json.loads(out[-1])["restarts"] == 1 and json.loads(out[-1])["steps"] == 6
    _nan_from(3, False, monkeypatch)
    from cs744_pytorch_distributed_tutorial_tpu_torch.utils.failure import NonFiniteLossError

    with pytest.raises(NonFiniteLossError):
        _cli(["--snapshot-every", "1", "--max-restarts", "1"], capsys)
    rc, out = _cli(["--no-halt-on-nonfinite"], capsys)
    assert rc == 0 and json.loads(out[-1])["steps"] == 6


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
