"""Failure detection and recovery in the port (``utils/failure.py``)
against the JAX package's (``tests/test_failure.py``).

The watchdog's timing cases use short timeouts with wide margins. The
recovery case against JAX: tiny_cnn, one replica, augmentation off, lr
0.02, 4 steps, a checkpoint every step and a NaN injected once at the
third step, from the JAX Trainer's initialization carried over
(``models/convert.py``): both recover with one restart and end on the
same step, and the final parameters agree at rtol 1e-4, atol 1e-5 (as
``test_torch_port_trainer.py``: convolution sums in another order).
"""

import os
import subprocess
import sys
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cs744_pytorch_distributed_tutorial_tpu.config import TrainConfig as JaxConfig
from cs744_pytorch_distributed_tutorial_tpu.parallel import make_mesh
from cs744_pytorch_distributed_tutorial_tpu.train import Trainer as JaxTrainer
from cs744_pytorch_distributed_tutorial_tpu.utils import failure as jax_failure
from cs744_pytorch_distributed_tutorial_tpu_torch.config import TrainConfig
from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import (
    jax_from_state_dict,
    state_dict_from_jax,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.obs.metrics import Telemetry
from cs744_pytorch_distributed_tutorial_tpu_torch.obs.sinks import RingSink
from cs744_pytorch_distributed_tutorial_tpu_torch.train import Trainer
from cs744_pytorch_distributed_tutorial_tpu_torch.utils.checkpoint import Checkpointer
from cs744_pytorch_distributed_tutorial_tpu_torch.utils.failure import (
    DeviceLossError,
    NonFiniteLossError,
    ProcessLossError,
    StepWatchdog,
    TrainingFailure,
    run_with_recovery,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(model="tiny_cnn", sync="none", num_devices=1, global_batch_size=32,
            synthetic_data=True, synthetic_train_size=128, synthetic_test_size=64,
            augment=False, learning_rate=0.02, log_every=1)


def nan_at(trainer, call: int, transient: bool) -> dict:
    """NaN loss at the ``call``-th train_step call: once (transient), or
    from then on (persistent: the failure replays after each restart)."""
    orig = trainer.train_step
    calls = {"n": 0, "injected": False}

    def step(x, y):
        loss = orig(x, y)
        calls["n"] += 1
        fire = (calls["n"] == call and not calls["injected"]) if transient else calls["n"] >= call
        if fire:
            calls["injected"] = True
            loss = torch.full_like(loss, float("nan"))
        return loss

    trainer.train_step = step
    return calls


# ------------------------------------------------------------ watchdog
def test_watchdog_fires_on_hang():
    hangs = []
    wd = StepWatchdog(timeout_s=0.15, on_hang=hangs.append, dump_stacks=False)
    wd.arm()
    time.sleep(0.5)
    wd.disarm()
    wd.close()
    assert wd.fired == 1
    assert len(hangs) == 1 and hangs[0] >= 0.15


def test_watchdog_quiet_on_fast_steps():
    wd = StepWatchdog(timeout_s=0.3, dump_stacks=False)
    for _ in range(5):
        with wd.watch():
            time.sleep(0.01)
    time.sleep(0.5)
    wd.close()
    assert wd.fired == 0


def test_watchdog_escalation_ladder():
    """warn, then dump, then abort (the callback) on one wedged section."""
    hangs = []
    wd = StepWatchdog(timeout_s=0.1, on_hang=hangs.append, dump_stacks=False,
                      escalation=("warn", "dump", "abort"))
    wd.arm()
    deadline = time.monotonic() + 5.0
    while wd.fired < 3 and time.monotonic() < deadline:
        time.sleep(0.02)
    wd.disarm()
    wd.close()
    assert wd.fired == 3 and wd.last_stage == "abort"
    assert len(hangs) == 1
    with pytest.raises(ValueError, match="escalation stages"):
        StepWatchdog(timeout_s=1.0, escalation=("warn", "explode"))


def test_watchdog_rearm_during_fire_cannot_double_fire():
    wd = None
    fires = []

    def rearm_on_hang(elapsed):
        fires.append(elapsed)
        wd.arm(10.0)

    wd = StepWatchdog(timeout_s=0.1, on_hang=rearm_on_hang, dump_stacks=False)
    wd.arm()
    deadline = time.monotonic() + 5.0
    while wd.fired < 1 and time.monotonic() < deadline:
        time.sleep(0.02)
    time.sleep(0.3)
    wd.disarm()
    wd.close()
    assert wd.fired == 1 and len(fires) == 1


def test_watchdog_flushes_ring_and_flight_recorder():
    from cs744_pytorch_distributed_tutorial_tpu_torch.obs.flight import (
        FlightRecorder,
        StragglerMonitor,
    )

    telemetry = Telemetry(None, every=1)
    for step in range(3):
        telemetry.emit_step(step, loss=1.0)
    mon = StragglerMonitor()
    for step in range(4):
        mon.record(step, 0.01)
    flight = FlightRecorder(telemetry=telemetry, straggler=mon)
    wd = StepWatchdog(timeout_s=0.1, dump_stacks=False, metric_ring=telemetry.ring,
                      flight_recorder=flight)
    wd.arm()
    time.sleep(0.4)
    wd.disarm()
    wd.close()
    events = [r for r in telemetry.ring.records() if r["kind"] == "event"]
    dumps = [e for e in events if e["event"] == "flight_dump"]
    assert len(dumps) == 1 and dumps[0]["reason"] == "watchdog"
    assert sum(e["event"] == "flight_step" for e in events) == 4


def test_hang_action_abort_exits_13():
    """hang_action="abort": a step that hangs past step_timeout_s ends the
    process with code 13 (in a subprocess, never in this one)."""
    script = (
        "import time\n"
        "from cs744_pytorch_distributed_tutorial_tpu_torch.config import TrainConfig\n"
        "from cs744_pytorch_distributed_tutorial_tpu_torch.train import Trainer\n"
        "tr = Trainer(TrainConfig(model='tiny_cnn', sync='none', num_devices=1,\n"
        "    global_batch_size=8, synthetic_data=True, synthetic_train_size=64,\n"
        "    synthetic_test_size=8, step_timeout_s=0.5, hang_action='abort', device='cpu'))\n"
        "orig, n = tr.train_step, [0]\n"
        "def step(x, y):\n"
        "    n[0] += 1\n"
        "    if n[0] == 3:\n"
        "        time.sleep(60)\n"
        "    return orig(x, y)\n"
        "tr.train_step = step\n"
        "tr.fit()\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 13, proc.stderr[-2000:]
    assert "watchdog" in proc.stdout


def test_first_step_is_exempt_from_the_watchdog():
    """The first step builds the kernels and runs unwatched; every later
    step runs inside an armed window (read from the watchdog's arm and
    disarm calls, not from timing)."""
    tr = Trainer(TrainConfig(**{**TINY, "synthetic_train_size": 96}, step_timeout_s=60.0,
                             device="cpu"))
    armed, seen = {"now": False}, []
    orig = tr.train_step

    def step(x, y):
        seen.append(armed["now"])
        return orig(x, y)

    tr.train_step = step
    real_arm, real_disarm = StepWatchdog.arm, StepWatchdog.disarm

    def arm(self, timeout_s=None):
        armed["now"] = True
        real_arm(self, timeout_s)

    def disarm(self):
        armed["now"] = False
        real_disarm(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(StepWatchdog, "arm", arm)
        mp.setattr(StepWatchdog, "disarm", disarm)
        tr.fit()
    assert seen == [False, True, True]
    assert not armed["now"]


# ------------------------------------------------------------ recovery
def test_fit_raises_on_nonfinite_loss_and_the_halt_can_be_disabled():
    tr = Trainer(TrainConfig(**TINY, device="cpu"))
    nan_at(tr, 2, transient=False)
    with pytest.raises(NonFiniteLossError) as ei:
        tr.fit()
    assert ei.value.step == 1
    tr = Trainer(TrainConfig(**TINY, device="cpu", halt_on_nonfinite=False))
    nan_at(tr, 2, transient=False)
    _, hist = tr.fit()
    assert tr.state.step == 4 and not np.isfinite(hist["train_loss"][-1][2])


def test_recovery_matches_jax(tmp_path):
    """A NaN once at the third step, a checkpoint every step: one restart
    in both, the same final step, parameters within rtol 1e-4, atol 1e-5."""
    mesh1 = make_mesh({"data": 1}, devices=jax.devices()[:1])
    jcfg = JaxConfig(**TINY, checkpoint_dir=str(tmp_path / "jax"), checkpoint_every=1)
    jtr = JaxTrainer(jcfg, mesh=mesh1)
    init = jtr.init()
    init = {"params": jax.tree.map(np.asarray, init.params),
            "batch_stats": jax.tree.map(lambda a: np.asarray(a)[0], init.batch_stats)}
    orig = jtr.train_step
    jcalls = {"n": 0}

    def jstep(*args):
        state, metrics = orig(*args)
        jcalls["n"] += 1
        if jcalls["n"] == 3:
            metrics = dict(metrics, loss=jnp.float32(float("nan")))
        return state, metrics

    jtr.train_step = jstep
    jstate, _, jrestarts = jax_failure.run_with_recovery(jtr, max_restarts=2)

    tr = Trainer(TrainConfig(**TINY, device="cpu", checkpoint_dir=str(tmp_path / "port"),
                             checkpoint_every=1))
    tr.model.load_state_dict(state_dict_from_jax(init, "tiny_cnn"))
    calls = nan_at(tr, 3, transient=True)
    state, hist, restarts = run_with_recovery(tr, max_restarts=2)

    assert restarts == jrestarts == 1 and calls["injected"]
    assert state.step == int(jax.device_get(jstate.step)) == 4
    assert np.isfinite(hist["eval"][-1]["avg_loss"])
    got = jax_from_state_dict(tr.model.state_dict(), "tiny_cnn")["params"]
    want = jax.tree.map(np.asarray, jstate.params)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_got) == len(flat_want)
    for path, a in flat_got:
        np.testing.assert_allclose(a, flat_want[path], rtol=1e-4, atol=1e-5, err_msg=str(path))


def test_recovery_gives_up_after_max_restarts(tmp_path):
    tr = Trainer(TrainConfig(**TINY, device="cpu", checkpoint_dir=str(tmp_path / "ck"),
                             checkpoint_every=1))
    nan_at(tr, 2, transient=False)
    sleeps, ring = [], RingSink()
    with pytest.raises(NonFiniteLossError):
        run_with_recovery(tr, max_restarts=2, backoff_s=0.5, sleep=sleeps.append,
                          telemetry=ring)
    assert sleeps == [0.5, 1.0]
    events = [r for r in ring.records() if r.get("kind") == "event"]
    assert [e["restart"] for e in events if e["event"] == "recovery_restart"] == [1, 2]
    giveups = [e for e in events if e["event"] == "recovery_giveup"]
    assert len(giveups) == 1 and giveups[0]["restarts"] == 2 and giveups[0]["traceback"]


def test_recovery_needs_a_tier():
    tr = Trainer(TrainConfig(**TINY, device="cpu"))
    with pytest.raises(ValueError, match="checkpoint_dir"):
        run_with_recovery(tr)


def test_memory_tier_recovery_reads_no_file():
    tr = Trainer(TrainConfig(**TINY, device="cpu", snapshot_every=1))
    calls = nan_at(tr, 3, transient=True)
    restores = Checkpointer.total_restores
    state, _, restarts = run_with_recovery(tr, max_restarts=1)
    assert restarts == 1 and calls["injected"] and state.step == 4
    assert Checkpointer.total_restores == restores
    assert tr.memstore.restores == 1


def test_failure_types_and_hang_action_validated():
    for cls in (NonFiniteLossError, DeviceLossError, ProcessLossError):
        assert issubclass(cls, TrainingFailure)
    assert issubclass(TrainingFailure, RuntimeError)
    assert DeviceLossError(3, lost=[1]).lost == (1,)
    assert ProcessLossError(0, dead=[2]).dead == (2,)
    with pytest.raises(ValueError, match="hang_action"):
        Trainer(TrainConfig(**TINY, device="cpu", hang_action="explode"))
    with pytest.raises(ValueError, match="hang_action"):
        JaxTrainer(JaxConfig(**TINY, hang_action="explode"),
                   mesh=make_mesh({"data": 1}, devices=jax.devices()[:1]))
    with pytest.raises(ValueError, match="max_to_keep"):
        Trainer(TrainConfig(**TINY, device="cpu", snapshot_every=1, snapshot_keep=0))


class _AlwaysFailing:
    def __init__(self, failure):
        self.cfg = SimpleNamespace(checkpoint_dir="unused")
        self.failure = failure

    def fit(self):
        raise self.failure(0, float("nan"))


@pytest.mark.parametrize("kw", [
    dict(),
    dict(backoff_factor=3.0, max_backoff_s=2.0),
    dict(backoff_jitter="decorrelated", jitter_seed=42),
    dict(backoff_jitter="decorrelated", jitter_seed=7, max_backoff_s=3.0),
], ids=["exponential", "exponential_capped", "decorrelated_42", "decorrelated_7_capped"])
def test_backoff_sequences_equal_jax(kw):
    def seq(module, failure):
        sleeps = []
        with pytest.raises(failure):
            module.run_with_recovery(_AlwaysFailing(failure), max_restarts=6, backoff_s=0.5,
                                     sleep=sleeps.append, **kw)
        return sleeps

    port = seq(sys.modules[run_with_recovery.__module__], NonFiniteLossError)
    want = seq(jax_failure, jax_failure.NonFiniteLossError)
    assert len(port) == 6 and port == want
    with pytest.raises(ValueError, match="backoff_jitter"):
        run_with_recovery(_AlwaysFailing(NonFiniteLossError), backoff_jitter="herd")
