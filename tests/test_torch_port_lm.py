"""The port's LM training path against the JAX package's.

- ``LMTrainer``: 3 AdamW steps from the same weights (flax init carried
  by the converter) on the same tokens as the JAX ``LMTrainer`` (mesh
  data=1 seq=1), port flash (plain version on the CPU) against JAX
  dense: loss, grad_norm and param_norm within rtol 1e-5 (JAX's own
  dense and flash agree to 1e-7); parameters within 1e-5 but for at
  most one element in 10,000 (one of 74,752 here), which may be off by
  up to lr = 1e-3, and within 1e-6 on average (Adam divides each
  gradient by its own magnitude, so an element whose gradient sits at
  fp32 rounding level takes a step of either sign).
- The optimizers on their own: AdamW and SGD with a linear warmup
  against the optax chains, within 1e-6.
- Tokens byte-identical to the JAX package's.
- ``lm_cli``: its ``--json`` summary keys, its refusals.
"""

import json
import math

import numpy as np
import pytest
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch import lm_cli
from cs744_pytorch_distributed_tutorial_tpu_torch.data import (
    byte_corpus,
    synthetic_tokens,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import lm_params_from_jax
from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import (
    LMConfig,
    LMTrainer,
    NonFiniteLossError,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.train.state import make_lm_optimizer

LR = 1e-3
SMALL = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=64, d_ff=128, max_seq_len=32,
             seq_len=32, global_batch_size=4, use_rope=True, learning_rate=LR)


def test_trainer_matches_jax_lm_trainer():
    import jax

    from cs744_pytorch_distributed_tutorial_tpu.parallel import make_mesh
    from cs744_pytorch_distributed_tutorial_tpu.train import LMConfig as JaxConfig
    from cs744_pytorch_distributed_tutorial_tpu.train import LMTrainer as JaxTrainer

    jt = JaxTrainer(JaxConfig(**SMALL, attention_impl="dense"),
                    mesh=make_mesh({"data": 1, "seq": 1}, devices=jax.devices()[:1]))
    params, opt = jt.init()
    port = LMTrainer(LMConfig(**SMALL, attention_impl="flash", device="cpu"))
    port.init(state_dict=lm_params_from_jax(jax.device_get(params)))
    toks = synthetic_tokens(12, 32, 64, seed=1)
    for step in range(3):
        batch = toks[4 * step : 4 * (step + 1)]
        params, opt, want = jt.train_step(params, opt, *jt.shard_batch(batch), step)
        got = port.train_step(*port.split_batch(batch))
        assert set(got) == set(want) == {"loss", "grad_norm", "param_norm"}
        for key in want:
            assert float(got[key]) == pytest.approx(float(want[key]), rel=1e-5), (step, key)
    want_sd = lm_params_from_jax(jax.device_get(params))
    errs = torch.cat([(want_sd[k] - v).abs().flatten() for k, v in port.model.state_dict().items()])
    assert float(errs.max()) <= LR and float(errs.mean()) <= 1e-6
    assert int((errs > 1e-5).sum()) <= 1e-4 * errs.numel()


@pytest.mark.parametrize("name", ["adamw", "sgd"])
def test_optimizer_matches_optax_with_warmup(name):
    import jax.numpy as jnp
    import optax

    from cs744_pytorch_distributed_tutorial_tpu.config import TrainConfig as JaxTrainConfig
    from cs744_pytorch_distributed_tutorial_tpu.train.state import make_optimizer

    rng = np.random.default_rng(4)
    shapes = [(5, 3), (7,)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(4)]
    kw = dict(optimizer=name, learning_rate=0.05, warmup_steps=2, momentum=0.9,
              weight_decay=0.1)
    tx = make_optimizer(JaxTrainConfig(**kw))
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    params = [torch.from_numpy(p.copy()) for p in p0]
    opt = make_lm_optimizer(LMConfig(**kw), params)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(params, g):
            p.grad = torch.from_numpy(x)
        opt.step()
    for got, want in zip(params, jp):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_tokens_are_byte_identical_to_jax(tmp_path):
    from cs744_pytorch_distributed_tutorial_tpu.data import byte_corpus as jax_corpus
    from cs744_pytorch_distributed_tutorial_tpu.data import synthetic_tokens as jax_tokens

    for args, kw in (((400, 1024, 50304), dict(seed=0)), ((33, 17, 256), dict(seed=7))):
        got, want = synthetic_tokens(*args, **kw), jax_tokens(*args, **kw)
        assert got.dtype == want.dtype == np.int32
        assert got.tobytes() == want.tobytes()
    path = tmp_path / "corpus.txt"
    path.write_bytes(bytes(np.random.default_rng(0).integers(0, 256, 5000, dtype=np.uint8)))
    for kw in (dict(), dict(stride=7, max_seqs=50, seed=3), dict(shuffle=False)):
        assert byte_corpus(str(path), 31, **kw).tobytes() == jax_corpus(str(path), 31, **kw).tobytes()


def test_fit_follows_the_batch_plan_and_halts_on_nan():
    tr = LMTrainer(LMConfig(**SMALL, attention_impl="dense", device="cpu"))
    toks = synthetic_tokens(10, 32, 64, seed=2)
    seen = []
    real_step = tr.train_step

    def spy(x, y):
        seen.append(x[:, 0].tolist())
        return real_step(x, y)

    tr.train_step = spy
    _, _, losses = tr.fit(toks, 4)
    # lo = (step * 4) % (10 - 4 + 1): 0, 4, 1, 5
    assert seen == [toks[lo : lo + 4, 0].tolist() for lo in (0, 4, 1, 5)]
    assert len(losses) == 4 and all(math.isfinite(x) for x in losses)
    assert len(tr.history["grad_norm"]) == len(tr.history["param_norm"]) == 4
    ev = tr.evaluate(toks[:9])  # two batches, the tail of one dropped
    assert ev["perplexity"] == pytest.approx(math.exp(ev["loss"]))

    tr.train_step = lambda x, y: {"loss": torch.tensor(float("nan"))}
    with pytest.raises(NonFiniteLossError):
        tr.fit(toks, 2)


CLI_SMALL = ["--num-layers", "2", "--d-model", "32", "--num-heads", "4", "--d-ff", "64",
             "--vocab-size", "64", "--max-seq-len", "32", "--seq-len", "32",
             "--global-batch-size", "4", "--steps", "3", "--num-seqs", "24",
             "--eval-frac", "0.2", "--json", "--device", "cpu"]


@pytest.mark.parametrize("impl", ["flash", "ring"])
def test_cli_runs_on_cpu_with_the_jax_summary_keys(impl, capsys):
    assert lm_cli.main([*CLI_SMALL, "--attention-impl", impl, "--use-rope",
                        "--compute-dtype", "bfloat16"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(lines[-1])
    assert set(summary) == {"vocab_size", "mesh", "steps", "first_loss", "final_loss",
                            "finite", "steps_run", "eval", "sample"}
    assert summary["steps_run"] == 3 and summary["finite"] and summary["sample"] is None
    assert summary["mesh"] == {"data": 1, "seq": 1, "tensor": 1}
    assert set(summary["eval"]) == {"loss", "perplexity"}
    assert lines[0].startswith("0 loss:  ") and lines[-2].startswith("eval loss:  ")


def test_cli_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        lm_cli.main(CLI_SMALL[:-2])
    with pytest.raises(RuntimeError, match="cuda"):
        LMTrainer(LMConfig(**SMALL))


# --beam runs now (test_torch_port_lm_options.py), and so does expert
# parallelism (test_torch_port_lm_axes4.py), and the dropless MoE's
# ragged_dot backend: these flags, once refused as not yet ported, train
# (test_torch_port_gmm_groups.py holds the ragged path against JAX).
@pytest.mark.parametrize("flag", [
    ["--moe-experts", "4", "--moe-dispatch", "dropless", "--moe-gmm-impl", "ragged"],
    ["--moe-experts", "4", "--moe-dispatch", "dropless", "--moe-gmm-impl", "ragged",
     "--compute-dtype", "bfloat16"]])
def test_cli_flags_of_later_slices_say_not_yet_ported(flag, capsys):
    assert lm_cli.main([*CLI_SMALL, *flag]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["finite"] and summary["moe"]["moe_drop"][0] == 0.0


@pytest.mark.parametrize(
    "flag",
    # lion and the cosine schedules run now; the JAX CLI's choices end there.
    # --remat, --data-parallel, --zero1, --seq-parallel, --tensor-parallel and
    # the pipeline axis's flags are flags now (test_torch_port_pipeline.py);
    # these are choices neither CLI has.
    [["--pipeline-schedule", "zero_bubble"], ["--remat-policy", "offload"],
     ["--moe-gmm-impl", "triton"], ["--optimizer", "adagrad"], ["--lr-schedule", "step"]],
)
def test_cli_rejects_flags_it_does_not_have(flag):
    with pytest.raises(SystemExit) as exc:
        lm_cli.main([*CLI_SMALL, *flag])
    assert exc.value.code == 2


@pytest.mark.parametrize(
    "override",
    # remat, accum_steps and dropout_rate train now
    # (test_torch_port_lm_options.py), and so do data_parallel, zero1 and
    # grad_compress (test_torch_port_lm_dp4.py, test_torch_port_zero_lm.py)
    # and the sequence, tensor and expert axes (test_torch_port_lm_axes4.py):
    # in their places what JAX refuses of them with ValueError, before any
    # process group, and an accum_steps that does not divide the batch.
    [dict(tensor_parallel=3),
     dict(moe_experts=3, moe_expert_parallel=True, data_parallel=2),
     dict(seq_parallel=2, attention_impl="dense"), dict(seq_parallel=3), dict(accum_steps=3),
     dict(moe_experts=4, moe_dispatch="dropless", moe_expert_parallel=True, data_parallel=2),
     dict(tensor_parallel=2, grad_compress="int8")],
)
def test_config_options_of_later_slices_raise(override):
    match = {"tensor_parallel": "not divisible by tensor axis",
             "moe_experts": "not divisible by the data axis", "attention_impl": "incompatible",
             "seq_parallel": "not divisible by seq axis", "accum_steps": "accum_steps",
             "moe_dispatch": "does not compose with moe_expert_parallel",
             "grad_compress": "requires a data-parallel layout"}
    key = next(k for k in ("grad_compress", "moe_dispatch", "attention_impl", "moe_experts",
                           "tensor_parallel", "seq_parallel", "accum_steps") if k in override)
    with pytest.raises(ValueError, match=match[key]):
        LMTrainer(LMConfig(**SMALL, device="cpu", **override)).init()


@pytest.mark.parametrize(
    "override,match",
    [(dict(optimizer="lion"), None), (dict(lr_schedule="cosine"), "total_steps"),
     (dict(grad_clip_norm=1.0), None)],
)
def test_config_recipes_follow_jax(override, match):
    """Lion and the clip train (the JAX LM's registry); a cosine schedule
    without its horizon raises ValueError, as JAX's make_schedule does."""
    if match is not None:
        with pytest.raises(ValueError, match=match):
            LMTrainer(LMConfig(**SMALL, device="cpu", **override))
        return
    tr = LMTrainer(LMConfig(**SMALL, attention_impl="dense", device="cpu", **override))
    _, _, losses = tr.fit(synthetic_tokens(8, 32, 64, seed=3), 2)
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
