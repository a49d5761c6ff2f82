"""The LM trainer's run loop (``LMTrainer.fit``) against the JAX package's.

- Resume: a run cut after 3 of 6 steps and resumed from its checkpoint,
  and a run recovered from the in-memory snapshot tier after a NaN, give
  the uninterrupted run's losses and final state bit for bit (the batch
  at step k is a function of k; the state carries the parameters, both
  AdamW moments, the update count and the step).
- The same cut-and-resume against the JAX ``LMTrainer.fit`` from the same
  weights (the JAX suite's ``tests/test_lm_accum_ckpt.py:67`` recipe, one
  device, dense attention): the first leg's losses within rtol 1e-5 (the
  3-step trainer test's bound), the resumed leg's within 1e-4 (the JAX
  test's own bound for its resumed losses).
- The step records carry the JAX LM loop's keys; the manifest, the
  restore event and a profiler window's trace are written.
- ``run_with_recovery`` on the LM (JAX ``tests/test_lm_failure.py:55``):
  one NaN, one restart from disk, all steps finite, bitwise equal to the
  uninterrupted run; the pending/certify gate keeps a state whose own
  forward diverged off disk.
- ``lm_cli``'s run-loop flags have the JAX CLI's names and defaults, and
  ``--max-restarts`` recovers through the CLI.
"""

import json
import math

import pytest
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch import lm_cli
from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_tokens
from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import (
    LMConfig,
    LMTrainer,
    NonFiniteLossError,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.utils.checkpoint import Checkpointer
from cs744_pytorch_distributed_tutorial_tpu_torch.utils.failure import run_with_recovery

SMALL = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64, max_seq_len=16,
             seq_len=16, global_batch_size=4, use_rope=True, learning_rate=1e-3)
STEPS = 6


def _tokens():
    return synthetic_tokens(32, SMALL["seq_len"], SMALL["vocab_size"], seed=9)


def _trainer(**kw) -> LMTrainer:
    return LMTrainer(LMConfig(**SMALL, attention_impl="dense", device="cpu", **kw))


def _assert_states_bitwise(a: dict, b: dict) -> None:
    assert (a["step"], a["opt_count"]) == (b["step"], b["opt_count"])
    for key in ("params", "momentum", "opt_nu"):
        for u, v in zip(a[key], b[key], strict=True):
            assert torch.equal(u, v), key


@pytest.fixture(scope="module")
def full_run():
    tr = _trainer()
    _, _, losses = tr.fit(_tokens(), STEPS)
    return losses, tr.capture_state()


def test_resume_from_checkpoint_is_bitwise(full_run, tmp_path):
    losses_full, state_full = full_run
    cfg = dict(checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1)
    _, _, first = _trainer(**cfg).fit(_tokens(), 3)  # "crash" after step 3
    assert first == losses_full[:3]
    tr = _trainer(**cfg)
    _, _, rest = tr.fit(_tokens(), STEPS)
    assert rest == losses_full[3:]
    _assert_states_bitwise(tr.capture_state(), state_full)
    _, _, again = _trainer(**cfg).fit(_tokens(), STEPS)  # already at the end
    assert again == []


def test_snapshot_recovery_is_bitwise(full_run, tmp_path):
    losses_full, state_full = full_run
    tr = _trainer(snapshot_every=2, snapshot_keep=2)
    real, calls = tr.train_step, {"n": 0}

    def nan_once(x, y):
        m = real(x, y)
        calls["n"] += 1
        return dict(m, loss=torch.tensor(float("nan"))) if calls["n"] == 4 else m

    tr.train_step = nan_once
    restores = Checkpointer.total_restores
    _, _, losses, restarts = run_with_recovery(tr, fit_args=(_tokens(), STEPS), max_restarts=1)
    assert restarts == 1 and Checkpointer.total_restores == restores  # no file read
    assert tr.memstore.restores == 1 and tr.memstore.steps() == [4, STEPS]
    assert losses == losses_full[2:]  # resumed at step 2, the newest certified state
    _assert_states_bitwise(tr.capture_state(), state_full)


def test_run_with_recovery_restarts_from_disk(full_run, tmp_path):
    """A transient inf at the third call: the state after two updates is
    held until the next loss (the forward over it) comes back finite; that
    loss is the inf, so the state never reaches disk, and the replay from
    the state after one update lands on the uninterrupted run."""
    losses_full, state_full = full_run
    tr = _trainer(checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1, metrics_dir=str(
        tmp_path / "m"))
    real, calls = tr.train_step, {"n": 0}

    def flaky(x, y):
        m = real(x, y)
        calls["n"] += 1
        return dict(m, loss=torch.tensor(float("inf"))) if calls["n"] == 3 else m

    tr.train_step = flaky
    _, _, losses, restarts = run_with_recovery(tr, fit_args=(_tokens(), STEPS), max_restarts=2)
    assert restarts == 1 and all(math.isfinite(v) for v in losses)
    assert losses == losses_full[1:]
    _assert_states_bitwise(tr.capture_state(), state_full)
    events = [json.loads(line) for line in (tmp_path / "m" / "metrics.jsonl").open()]
    kinds = [(e["kind"], e.get("event")) for e in events]
    assert ("event", "non_finite_loss") in kinds and ("event", "restore") in kinds
    restore = next(e for e in events if e.get("event") == "restore")
    assert (restore["source"], restore["step"]) == ("disk", 1)


def test_nan_halts_and_the_flag_disables_it():
    tr = _trainer()
    real = tr.train_step
    tr.train_step = lambda x, y: dict(real(x, y), loss=torch.tensor(float("nan")))
    with pytest.raises(NonFiniteLossError) as exc:
        tr.fit(_tokens(), 3)
    assert exc.value.step == 0
    tr = _trainer(halt_on_nonfinite=False)
    real2 = tr.train_step
    tr.train_step = lambda x, y: dict(real2(x, y), loss=torch.tensor(float("nan")))
    _, _, losses = tr.fit(_tokens(), 3)
    assert len(losses) == 3 and all(math.isnan(v) for v in losses)


def test_losses_match_the_jax_fit_with_checkpoint_resume(tmp_path):
    import jax
    import numpy as np

    from cs744_pytorch_distributed_tutorial_tpu.parallel import make_mesh
    from cs744_pytorch_distributed_tutorial_tpu.train import LMConfig as JaxConfig
    from cs744_pytorch_distributed_tutorial_tpu.train import LMTrainer as JaxTrainer

    from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import lm_params_from_jax

    def jax_trainer(**kw):
        return JaxTrainer(JaxConfig(**SMALL, attention_impl="dense", **kw),
                          mesh=make_mesh({"data": 1, "seq": 1}, devices=jax.devices()[:1]))

    toks = _tokens()
    cfg = dict(checkpoint_every=1)
    _, _, want_a = jax_trainer(checkpoint_dir=str(tmp_path / "jax"), **cfg).fit(toks, 3)
    _, _, want_b = jax_trainer(checkpoint_dir=str(tmp_path / "jax"), **cfg).fit(toks, STEPS)
    init = lm_params_from_jax(jax.device_get(jax_trainer().init()[0]))

    def port_trainer():
        tr = _trainer(checkpoint_dir=str(tmp_path / "port"), **cfg)
        tr.init = lambda: LMTrainer.init(tr, state_dict=init)  # the JAX weights
        return tr

    _, _, got_a = port_trainer().fit(toks, 3)
    _, _, got_b = port_trainer().fit(toks, STEPS)
    assert len(got_b) == len(want_b) == STEPS - 3
    np.testing.assert_allclose(got_a, want_a, rtol=1e-5)
    np.testing.assert_allclose(got_b, want_b, rtol=1e-4)


def test_step_records_carry_the_jax_keys(tmp_path):
    import jax

    from cs744_pytorch_distributed_tutorial_tpu.parallel import make_mesh
    from cs744_pytorch_distributed_tutorial_tpu.train import LMConfig as JaxConfig
    from cs744_pytorch_distributed_tutorial_tpu.train import LMTrainer as JaxTrainer

    def step_keys(path):
        records = [json.loads(line) for line in (path / "metrics.jsonl").open()]
        steps = [r for r in records if r["kind"] == "step"]
        assert len(steps) == 2  # metrics_every 2 over 4 steps
        return set(steps[-1])

    toks = _tokens()
    JaxTrainer(JaxConfig(**SMALL, attention_impl="dense", metrics_dir=str(tmp_path / "jax"),
                         metrics_every=2),
               mesh=make_mesh({"data": 1, "seq": 1}, devices=jax.devices()[:1])).fit(toks, 4)
    tr = _trainer(metrics_dir=str(tmp_path / "port"), metrics_every=2,
                  profile_dir=str(tmp_path / "trace"), profile_start_step=1, profile_num_steps=2,
                  step_timeout_s=60.0)
    tr.fit(toks, 4)
    assert step_keys(tmp_path / "port") == step_keys(tmp_path / "jax")
    assert (tmp_path / "port" / "manifest.json").exists()
    assert len(list((tmp_path / "trace").glob("trace_rank0_*.json"))) == 1


def test_cli_flags_have_the_jax_names_and_defaults():
    from cs744_pytorch_distributed_tutorial_tpu import lm_cli as jax_cli

    flags = ("metrics_dir", "metrics_every", "checkpoint_dir", "checkpoint_every",
             "snapshot_every", "snapshot_keep", "max_restarts", "restart_backoff_s",
             "restart_jitter")

    def actions(parser):
        return {a.dest: a for a in parser._actions}

    port, want = actions(lm_cli.build_parser()), actions(jax_cli.build_parser())
    for dest in flags:
        assert port[dest].option_strings == want[dest].option_strings, dest
        assert port[dest].default == want[dest].default, dest
        assert port[dest].type == want[dest].type and port[dest].choices == want[dest].choices
    # The CIFAR CLI's names for the LMConfig fields the JAX LM CLI leaves unset.
    defaults = LMConfig()
    assert port["profile_start_step"].default == defaults.profile_start_step == 2
    assert port["profile_num_steps"].default == defaults.profile_num_steps == 3
    assert port["step_timeout_s"].default is defaults.step_timeout_s is None


CLI = ["--num-layers", "2", "--d-model", "32", "--num-heads", "4", "--d-ff", "64",
       "--vocab-size", "64", "--max-seq-len", "16", "--seq-len", "16", "--global-batch-size",
       "4", "--steps", "6", "--num-seqs", "32", "--attention-impl", "dense", "--json",
       "--device", "cpu"]


def test_cli_max_restarts_recovers(tmp_path, capsys, monkeypatch):
    from cs744_pytorch_distributed_tutorial_tpu_torch.train import lm as L

    assert lm_cli.main(CLI) == 0
    clean = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    real, calls = L.LMTrainer.train_step, {"n": 0}

    def nan_once(self, x, y):
        m = real(self, x, y)
        calls["n"] += 1
        return dict(m, loss=torch.tensor(float("nan"))) if calls["n"] == 5 else m

    monkeypatch.setattr(L.LMTrainer, "train_step", nan_once)
    assert lm_cli.main([*CLI, "--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every",
                        "2", "--max-restarts", "1", "--metrics-dir", str(tmp_path / "m")]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(out[-1])
    assert "recovered after 1 restart(s)" in out
    assert summary["final_loss"] == clean["final_loss"] and summary["finite"]
    assert summary["steps_run"] == 4  # the replay from step 2 (step 4's state diverged)
    assert (tmp_path / "m" / "manifest.json").exists()
