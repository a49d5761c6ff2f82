"""The training chaos monkey (``utils/chaos.py``) and the re-mesh planner
(``parallel/elastic.py``) against the JAX package's.

- ``FaultSchedule``: validation and pops as JAX's; the seeded form gives
  JAX's schedule dict for the same seed, training kinds included.
- ``trap_sigterm`` turns a real SIGTERM into ``SigtermFailure``.
- ``process_kill`` fires only on the matching global rank, ``first_call``
  keeps the keys absolute steps, ``slow_step`` stalls only its target
  (``os.kill`` and ``sleep`` recorded, nothing sent).
- ``nan`` reaches ``NonFiniteLossError`` in both trainers (tiny_cnn and a
  1-layer LM, one CPU rank); with a snapshot every step the run recovers
  from host RAM with no checkpoint read, bitwise on the clean run. A
  real SIGTERM mid-run resumes the LM bitwise (JAX ``tests/
  test_chaos.py``'s cases at the port's size).
- ``surviving_mesh``'s errors are JAX's; ``default_remesh`` refuses an
  unknown trainer with ``TypeError``.
"""

from __future__ import annotations

import os
import signal

import numpy as np
import pytest
import torch

from cs744_pytorch_distributed_tutorial_tpu.utils import chaos as JC
from cs744_pytorch_distributed_tutorial_tpu_torch.config import TrainConfig
from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_tokens
from cs744_pytorch_distributed_tutorial_tpu_torch.train import Trainer
from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMConfig, LMTrainer
from cs744_pytorch_distributed_tutorial_tpu_torch.utils import chaos as C
from cs744_pytorch_distributed_tutorial_tpu_torch.utils.checkpoint import Checkpointer
from cs744_pytorch_distributed_tutorial_tpu_torch.utils.failure import (
    DeviceLossError,
    NonFiniteLossError,
)

torch.set_num_threads(1)
CIFAR = dict(model="tiny_cnn", sync="none", num_devices=1, global_batch_size=16,
             synthetic_data=True, synthetic_train_size=64, synthetic_test_size=16,
             augment=False, learning_rate=0.02, log_every=1, device="cpu")
LM = dict(vocab_size=32, num_layers=1, num_heads=2, d_model=16, d_ff=32, max_seq_len=64,
          seq_len=16, global_batch_size=8, attention_impl="dense", device="cpu")


# ------------------------------------------------------------ schedules
def test_fault_schedule_validates_and_pops_as_jax():
    spec = {3: "nan", 5: {"kind": "device_loss", "lost": [2]}, 7: "sigterm",
            9: {"kind": "process_kill", "rank": 1}, 11: "decode_nan"}
    s, js = C.FaultSchedule(spec), JC.FaultSchedule(spec)
    assert s.faults == js.faults and len(s) == 5
    assert s.pop(3) == {"kind": "nan"} and s.pop(3) is None and len(s) == 4
    assert C.FAULT_KINDS == JC.FAULT_KINDS
    for bad, match in (({1: "meteor_strike"}, "fault kind"),
                       ({1: "process_kill"}, "needs a target")):
        with pytest.raises(ValueError) as want:
            JC.FaultSchedule(bad)
        with pytest.raises(ValueError, match=match) as got:
            C.FaultSchedule(bad)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed,kw", [
    (7, dict(n_calls=50, rate=0.2, kinds=("nan", "sigterm"))),
    (8, dict(n_calls=50, rate=0.2, kinds=("nan", "sigterm"))),
    (3, dict(n_calls=40, rate=0.5, kinds=("device_loss", "nan"), lost=(2, 3))),
    (11, dict(n_calls=20, rate=1.0, kinds=("process_kill",), kill_rank=3, first_call=4)),
])
def test_seeded_schedule_is_jax(seed, kw):
    got, want = C.FaultSchedule.seeded(seed, **kw), JC.FaultSchedule.seeded(seed, **kw)
    assert got.faults == want.faults and len(got) > 0
    assert all(kw.get("first_call", 1) <= i < kw["n_calls"] for i in got.faults)


def test_trap_sigterm_converts_to_training_failure():
    with C.trap_sigterm():
        with pytest.raises(C.SigtermFailure):
            os.kill(os.getpid(), signal.SIGTERM)
            for _ in range(1000):  # the raise lands at a bytecode boundary
                pass
    assert issubclass(C.SigtermFailure, C.TrainingFailure)


# ------------------------------------------------------------ targeting
class _FakeTrainer:
    def __init__(self):
        self.steps = 0

    def train_step(self, *a, **k):
        self.steps += 1
        return torch.tensor(1.0)


def test_process_kill_fires_only_on_matching_rank(monkeypatch):
    kills = []
    monkeypatch.setattr(os, "kill", lambda pid, sig: kills.append((pid, sig)))
    bystander = _FakeTrainer()
    C.ChaosMonkey(C.FaultSchedule({2: {"kind": "process_kill", "rank": 0}}),
                  rank=1).install(bystander)
    for _ in range(4):
        bystander.train_step()
    assert bystander.steps == 4 and kills == []
    victim = _FakeTrainer()
    monkey = C.ChaosMonkey(C.FaultSchedule({2: {"kind": "process_kill", "rank": 0}}), rank=0)
    monkey.install(victim)
    victim.train_step()
    victim.train_step()
    assert kills == []
    victim.train_step()  # call index 2
    assert kills == [(os.getpid(), signal.SIGKILL)]
    assert monkey.injected == [(2, "process_kill")]


def test_first_call_keeps_absolute_step_keys(monkeypatch):
    kills = []
    monkeypatch.setattr(os, "kill", lambda pid, sig: kills.append(sig))
    survivor = _FakeTrainer()
    C.ChaosMonkey(C.FaultSchedule({4: {"kind": "process_kill", "rank": 2}}), rank=0,
                  first_call=4).install(survivor)
    survivor.train_step()  # absolute call 4: the target is dead, not us
    assert survivor.steps == 1 and kills == []
    victim = _FakeTrainer()
    C.ChaosMonkey(C.FaultSchedule({4: {"kind": "process_kill", "rank": 0}}), rank=0,
                  first_call=4).install(victim)
    victim.train_step()
    assert kills == [signal.SIGKILL]


def test_slow_step_stalls_only_its_target_and_device_loss_raises():
    sched = {s: {"kind": "slow_step", "rank": 3, "stall_s": 0.25} for s in range(3)}
    stalls = {}
    for rank in (1, 3):
        stalls[rank] = []
        tr = _FakeTrainer()
        m = C.ChaosMonkey(C.FaultSchedule(sched), rank=rank, sleep=stalls[rank].append)
        m.install(tr)
        for _ in range(3):
            tr.train_step()
        assert tr.steps == 3
    assert stalls == {1: [], 3: [0.25, 0.25, 0.25]}
    tr = _FakeTrainer()
    C.ChaosMonkey(C.FaultSchedule({1: {"kind": "device_loss", "lost": [2, 3]}})).install(tr)
    tr.train_step()
    with pytest.raises(DeviceLossError) as e:
        tr.train_step()
    assert e.value.lost == (2, 3) and tr.steps == 1  # raised before the step


# ----------------------------------------------------- through the trainers
def test_nan_reaches_nonfinite_in_both_trainers():
    tr = Trainer(TrainConfig(**CIFAR))
    C.ChaosMonkey(C.FaultSchedule({1: "nan"})).install(tr)
    with pytest.raises(NonFiniteLossError):
        tr.fit()
    lm = LMTrainer(LMConfig(**LM))
    C.ChaosMonkey(C.FaultSchedule({1: "nan"})).install(lm)
    with pytest.raises(NonFiniteLossError):
        lm.fit(synthetic_tokens(8, 16, 32, seed=0), steps=3)


def test_cifar_nan_recovers_from_memory_bitwise():
    clean_state, _ = Trainer(TrainConfig(**CIFAR)).fit()
    tr = Trainer(TrainConfig(**CIFAR, snapshot_every=1))
    disk = Checkpointer.total_restores
    state, _, restarts, monkey = C.run_chaos(tr, C.FaultSchedule({2: "nan"}), max_restarts=2)
    assert restarts == 1 and monkey.injected == [(2, "nan")]
    assert Checkpointer.total_restores == disk and tr.memstore.restores >= 1
    assert state.step == clean_state.step == 4 and monkey.calls > 4
    for a, b in zip(state.params, clean_state.params):
        assert torch.equal(a, b)


def test_lm_sigterm_resumes_bitwise():
    tokens = synthetic_tokens(8, 16, 32, seed=0)
    _, _, clean = LMTrainer(LMConfig(**LM)).fit(tokens, steps=5)
    tr = LMTrainer(LMConfig(**LM, snapshot_every=1))
    disk = Checkpointer.total_restores
    _, _, losses, restarts, monkey = C.run_chaos(tr, C.FaultSchedule({2: "sigterm"}),
                                                 fit_args=(tokens, 5), max_restarts=2)
    assert restarts == 1 and monkey.injected == [(2, "sigterm")]
    assert Checkpointer.total_restores == disk
    assert np.isfinite(losses).all()
    np.testing.assert_array_equal(np.asarray(losses), np.asarray(clean[-len(losses):]))


# ------------------------------------------------------------ re-meshing
@pytest.mark.parametrize("axes,lost", [
    ({"data": 4, "seq": 1}, [2, 3]), ({"data": 4, "seq": 2}, [1, 2]),
    ({"data": 2, "seq": 2}, [3]), ({"data": 4}, [0, 1, 2, 3]), ({"data": 4}, [])])
def test_surviving_mesh_is_jax(axes, lost):
    import jax

    from cs744_pytorch_distributed_tutorial_tpu.parallel import make_mesh
    from cs744_pytorch_distributed_tutorial_tpu.parallel.elastic import (
        surviving_mesh as jsurviving,
    )
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.elastic import surviving_mesh

    n = int(np.prod(list(axes.values())))
    mesh = make_mesh(axes, devices=jax.devices()[:n])
    try:
        want = jsurviving(mesh, [mesh.devices.flatten()[r].id for r in lost])
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            surviving_mesh(axes, lost)
        assert str(got.value) == str(e).replace(
            str(sorted(mesh.devices.flatten()[r].id for r in lost)), str(sorted(lost)))
        return
    survivors, sizes = surviving_mesh(axes, lost)
    assert sizes == dict(want.shape)
    assert survivors == [r for r in range(n) if r not in lost]


def test_default_remesh_refuses_an_unknown_trainer():
    from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.elastic import default_remesh

    with pytest.raises(TypeError, match="does not know how to rebuild object"):
        default_remesh(object(), DeviceLossError(step=0, lost=[1]))
