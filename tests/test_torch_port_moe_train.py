"""Training the port's MoE against the JAX package's.

Weights made by the flax init, with non-zero expert biases and a router
scaled up by 8 (so top-k choices are decided by clear margins and no
near-tie flips a route between the two frameworks' fp32 sums), go through
``models/convert.py`` into the port; the same numpy inputs go through
both:

- ``MoEFFN`` dropless, gradients of every parameter and of the input
  under ``sum(y * ct) + 0.3 * aux``, against flax with ``gmm_impl=
  "pallas"`` in interpret mode (block 8; JAX's ``"auto"`` takes
  ``ragged`` on the CPU, whose ``ragged_dot`` rounds before the bias and
  gelu, so it is not the oracle): fp32 within rtol/atol 1e-5 x
  max|JAX|; bf16 within 2e-2 x max|JAX| (every bf16 rounding point of the
  backward, ``z``, ``dlhs`` and ``drhs``, is taken on both sides, but
  their fp32 sums run in another order and a value on a rounding boundary
  may round to its neighbour, which the chain then carries);
- the capacity-slot dispatches ``scatter`` and ``einsum``, fp32, with a
  capacity factor that drops routes and several token groups: the
  output, ``moe_drop``, the aux loss and every gradient within 1e-5;
- ``LMTrainer``: 3 AdamW steps of a 2-layer MoE LM (d 32, E 4, top-2,
  dense attention, fp32) from the same weights on the same tokens as the
  JAX ``LMTrainer`` (``moe_gmm_impl="pallas"``), dropless and scatter:
  loss, grad_norm, param_norm, moe_aux, moe_drop and moe_load_entropy
  within rtol 1e-5, parameters as ``test_torch_port_lm.py`` holds them;
- ``lm_cli`` trains the MoE LM on ``--device cpu`` with each dispatch and
  reports the MoE metrics in its ``--json`` summary.
"""

import json
import math

import numpy as np
import pytest
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch import lm_cli
from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_tokens
from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import lm_params_from_jax
from cs744_pytorch_distributed_tutorial_tpu_torch.models.moe import MoEFFN
from cs744_pytorch_distributed_tutorial_tpu_torch.ops import gmm as G
from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMConfig, LMTrainer

E, D, F_ = 4, 16, 32
AUX = 0.3  # the aux loss's weight in the layer tests' objective
LR = 1e-3


def _randomize(params, seed):
    """Non-zero expert biases (flax inits them zero); routers scaled up."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key
        if name in ("b_in", "b_out"):
            return jnp.asarray(0.1 * rng.standard_normal(x.shape), x.dtype)
        if len(path) >= 2 and path[-2].key == "router":
            return x * 8.0
        return x

    return jax.tree_util.tree_map_with_path(leaf, params)


def _jax_layer_grads(dtype, x, ct, **kw):
    """flax ``MoEFFN``: (params, y, grads of params, grad of x, aux, drop)."""
    import jax
    import jax.numpy as jnp

    from cs744_pytorch_distributed_tutorial_tpu.models.moe import MoEFFN as JaxMoE

    jd = getattr(jnp, dtype)
    layer = JaxMoE(num_experts=E, d_ff=F_, top_k=2, dtype=jd, **kw)
    params = _randomize(layer.init(jax.random.key(0), jnp.zeros((1, 4, D)))["params"], 1)

    def objective(p, xx):
        y, mut = layer.apply({"params": p}, xx, mutable=["losses", "metrics"])
        aux = mut["losses"]["moe_aux"][0]
        loss = (y.astype(jnp.float32) * ct).sum() + AUX * aux
        return loss, (y, aux, mut["metrics"]["moe_drop"][0])

    (_, (y, aux, drop)), (gp, gx) = jax.jit(jax.value_and_grad(
        objective, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x).astype(jd))
    as_np = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))  # noqa: E731
    grads = {k: v.float().numpy() for k, v in lm_params_from_jax(jax.device_get(gp)).items()}
    return params, as_np(y), grads, as_np(gx), float(aux), float(drop)


def _port_layer_grads(params, dtype, x, ct, **kw):
    layer = MoEFFN(D, num_experts=E, d_ff=F_, top_k=2, **kw)
    layer.load_state_dict(lm_params_from_jax(params))
    td = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(td).requires_grad_()
    y = layer(xt, td)
    loss = (y.float() * torch.from_numpy(ct)).sum() + AUX * layer.aux_loss
    loss.backward()
    grads = {name: p.grad.float().numpy() for name, p in layer.named_parameters()}
    return (y.detach().float().numpy(), grads, xt.grad.float().numpy(),
            float(layer.aux_loss.detach()), float(layer.drop_rate))


def _inputs(b=2, t=12, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, D)).astype(np.float32),
            rng.standard_normal((b, t, D)).astype(np.float32))


def _close(got, want, rel):
    tol = rel * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rel, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropless_moe_gradients_match_jax_pallas(dtype):
    x, ct = _inputs()
    kw = dict(dispatch_impl="dropless", gmm_impl="pallas")
    params, y_want, g_want, gx_want, aux_want, drop_want = _jax_layer_grads(
        dtype, x, ct, **kw, gmm_interpret=True, gmm_block_m=8, gmm_block_n=8)
    G.reset_launch_count()
    y, grads, gx, aux, drop = _port_layer_grads(params, dtype, x, ct, **kw)
    assert G.launch_count() == 0  # CPU tensors take the plain versions
    rel = 1e-5 if dtype == "float32" else 2e-2
    _close(y, y_want, rel)
    _close(gx, gx_want, rel)
    assert set(grads) == set(g_want) == {"router.weight", "w_in", "b_in", "w_out", "b_out"}
    for name in grads:
        _close(grads[name], g_want[name], rel)
    assert aux == pytest.approx(aux_want, rel=1e-6) and drop == drop_want == 0.0


@pytest.mark.parametrize(
    "dispatch,capacity_factor,groups",
    [("scatter", 0.5, 2), ("einsum", 0.5, 2), ("scatter", 1.25, 1), ("einsum", 1.0, 3),
     ("scatter", 0.75, 0)],
)
def test_capacity_dispatch_matches_jax(dispatch, capacity_factor, groups):
    """Forward, moe_drop and gradients of the capacity-slot paths; routes
    drop where the capacity factor is below 1."""
    x, ct = _inputs(t=16, seed=groups + 3)
    kw = dict(dispatch_impl=dispatch, capacity_factor=capacity_factor, num_groups=groups)
    params, y_want, g_want, gx_want, aux_want, drop_want = _jax_layer_grads(
        "float32", x, ct, **kw)
    y, grads, gx, aux, drop = _port_layer_grads(params, "float32", x, ct, **kw)
    _close(y, y_want, 1e-5)
    _close(gx, gx_want, 1e-5)
    for name in g_want:
        _close(grads[name], g_want[name], 1e-5)
    assert aux == pytest.approx(aux_want, rel=1e-6)
    assert drop == pytest.approx(drop_want, abs=1e-7)
    if capacity_factor < 1:
        assert drop > 0


def test_capacity_groups_follow_jax():
    layer = MoEFFN(D, num_experts=E, d_ff=F_, top_k=2, capacity_factor=1.25, num_groups=0)
    assert layer.capacity_groups(4096) == (4, 640)  # ~1024 tokens a group
    layer.num_groups = 5
    assert layer.capacity_groups(24) == (4, 4)  # the largest divisor of 24 at most 5
    assert layer.capacity_groups(1) == (1, 1)  # decode: one token, one slot


TRAIN = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=32, d_ff=64, max_seq_len=16,
             seq_len=16, global_batch_size=4, learning_rate=LR, moe_experts=4, moe_top_k=2)


@pytest.mark.parametrize("moe", [dict(moe_dispatch="dropless", moe_gmm_impl="pallas"),
                                 dict(moe_dispatch="scatter", moe_capacity_factor=1.0,
                                      moe_groups=2)], ids=["dropless", "scatter"])
def test_moe_trainer_matches_jax_lm_trainer(moe):
    import jax

    from cs744_pytorch_distributed_tutorial_tpu.parallel import make_mesh
    from cs744_pytorch_distributed_tutorial_tpu.train import LMConfig as JaxConfig
    from cs744_pytorch_distributed_tutorial_tpu.train import LMTrainer as JaxTrainer

    jt = JaxTrainer(JaxConfig(**TRAIN, **moe, attention_impl="dense"),
                    mesh=make_mesh({"data": 1, "seq": 1}, devices=jax.devices()[:1]))
    params, opt = jt.init()
    params = _randomize(params, 4)  # AdamW's fresh state does not depend on the values
    port = LMTrainer(LMConfig(**TRAIN, **moe, attention_impl="dense", device="cpu"))
    port.init(state_dict=lm_params_from_jax(jax.device_get(params)))
    toks = synthetic_tokens(12, 16, 64, seed=5)
    keys = {"loss", "grad_norm", "param_norm", "moe_aux", "moe_drop", "moe_load_entropy"}
    for step in range(3):
        batch = toks[4 * step : 4 * (step + 1)]
        params, opt, want = jt.train_step(params, opt, *jt.shard_batch(batch), step)
        got = port.train_step(*port.split_batch(batch))
        assert set(got) == set(want) == keys
        for key in keys:
            assert float(got[key]) == pytest.approx(float(want[key]), rel=1e-5, abs=1e-7), (
                step, key)
    want_sd = lm_params_from_jax(jax.device_get(params))
    errs = torch.cat([(want_sd[k] - v).abs().flatten() for k, v in port.model.state_dict().items()])
    assert float(errs.max()) <= LR and float(errs.mean()) <= 1e-6
    assert int((errs > 1e-5).sum()) <= 1e-4 * errs.numel()


MOE_CLI = ["--num-layers", "2", "--d-model", "32", "--num-heads", "4", "--d-ff", "64",
           "--vocab-size", "128", "--max-seq-len", "32", "--seq-len", "16", "--use-rope",
           "--moe-experts", "4", "--global-batch-size", "4", "--steps", "3", "--num-seqs", "24",
           "--eval-frac", "0.2", "--json", "--device", "cpu"]


@pytest.mark.parametrize(
    "flags",
    [["--moe-dispatch", "dropless", "--attention-impl", "flash", "--compute-dtype", "bfloat16"],
     ["--moe-groups", "2"], ["--moe-dispatch", "einsum", "--moe-groups", "0"]],
    ids=["dropless", "scatter", "einsum"],
)
def test_lm_cli_trains_the_moe_lm_on_cpu(capsys, flags):
    assert lm_cli.main([*MOE_CLI, *flags]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(summary) == {"vocab_size", "mesh", "steps", "first_loss", "final_loss",
                            "finite", "steps_run", "eval", "sample", "moe"}
    assert summary["steps_run"] == 3 and summary["finite"]
    assert math.isfinite(summary["eval"]["loss"])
    moe = summary["moe"]
    assert set(moe) == {"moe_aux", "moe_drop", "moe_load_entropy"}
    assert all(len(v) == 3 and all(map(math.isfinite, v)) for v in moe.values())
    assert all(0.0 <= d < 1.0 for d in moe["moe_drop"])
    if "dropless" in flags:
        assert moe["moe_drop"] == [0.0, 0.0, 0.0]
