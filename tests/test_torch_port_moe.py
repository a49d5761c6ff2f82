"""The port's dropless MoE against the JAX package's.

Weights made by the flax init (expert biases and a random router drawn
from a numpy seed, so they enter the outputs) go through
``models/convert.py`` into the port; the same numpy inputs go through
both:

- ``MoEFFN``: fp32 against JAX ``gmm_impl="ragged"`` within 2e-5 (fp32
  sums in another order), the Switch aux loss and the load entropy
  within 1e-6; bf16 against JAX ``gmm_impl="pallas"`` in interpret mode
  (the TPU kernel's rounding: one rounding after the bias and gelu; JAX's
  ``ragged`` path rounds before them, which this limit tells apart),
  each element within one bf16 ulp plus 1e-5 x max|JAX| (the fp32
  reorder term, as in ``test_torch_port_gmm.py``);
- a 2-layer MoE ``TransformerLM``: fp32 logits within 2e-5;
- prefill + decode steps reproduce the full forward's logits within
  rtol/atol 1e-5 in fp32 (the port of the JAX package's
  ``test_moe_decode_logits_match_full_forward[dropless]``), and
  ``make_generator`` runs on the MoE model;
- the converter round trip, the JAX ``quantize_lm_params`` on a MoE tree,
  the flax init's fan_in of E * d on a 3-D expert kernel, the fp32 router
  and expert biases of a decode copy, and the rejections.

Training the MoE (gradients, the capacity-slot dispatches, the trainer)
is held in ``test_torch_port_moe_train.py``.
"""

import json

import numpy as np
import pytest
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch import lm_cli
from cs744_pytorch_distributed_tutorial_tpu_torch.infer import make_generator
from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import (
    jax_lm_params_from_state_dict,
    lm_params_from_jax,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.models.moe import MoEFFN
from cs744_pytorch_distributed_tutorial_tpu_torch.models.transformer import TransformerLM
from cs744_pytorch_distributed_tutorial_tpu_torch.ops import gmm as G
from cs744_pytorch_distributed_tutorial_tpu_torch.ops.quant import (
    quantize_lm_params,
    resolve_quant_modules,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMConfig, LMTrainer

E, D, F_ = 4, 16, 32
VOCAB = 64
LM = dict(vocab_size=VOCAB, num_layers=2, num_heads=2, d_model=32, d_ff=64, max_seq_len=32,
          num_experts=4, moe_top_k=2, moe_dispatch="dropless")


def _randomize(params, seed):
    """Non-zero expert biases (flax inits them zero) so they enter the
    outputs; routers scaled up so routing is decided by clear margins."""
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


def _jax_moe(dtype, impl, x):
    import jax
    import jax.numpy as jnp

    from cs744_pytorch_distributed_tutorial_tpu.models.moe import MoEFFN as JaxMoE

    layer = JaxMoE(num_experts=E, d_ff=F_, top_k=2, dispatch_impl="dropless", gmm_impl=impl,
                   gmm_interpret=True, gmm_block_m=8, gmm_block_n=8,
                   dtype=getattr(jnp, dtype))
    params = layer.init(jax.random.key(0), jnp.zeros((1, 4, D)))["params"]
    params = _randomize(params, 1)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    y, mut = layer.apply({"params": params}, jx, mutable=["losses", "metrics"])
    aux = float(mut["losses"]["moe_aux"][0])
    ent = float(mut["metrics"]["moe_load_entropy"][0])
    return params, np.asarray(y.astype(jnp.float32)), aux, ent


def _port_moe(params, dtype, x):
    layer = MoEFFN(D, num_experts=E, d_ff=F_, top_k=2, dispatch_impl="dropless")
    layer.load_state_dict(lm_params_from_jax(params))
    td = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(td)
    with torch.no_grad():
        y0 = layer(xt, td)
    # A no-grad call (prefill, decode) skips the trainer's statistics.
    assert layer.aux_loss is None and layer.load_entropy is None
    y = layer(xt, td).detach()
    assert y.dtype == td and torch.equal(y, y0)
    return layer, y.float().numpy()


@pytest.mark.parametrize("dtype,impl", [("float32", "ragged"), ("bfloat16", "pallas")])
def test_moe_ffn_matches_jax(dtype, impl):
    x = np.random.default_rng(2).standard_normal((2, 12, D)).astype(np.float32)
    params, want, aux, ent = _jax_moe(dtype, impl, x)
    G.reset_launch_count()
    layer, got = _port_moe(params, dtype, x)
    assert G.launch_count() == 0  # CPU tensors take the plain version
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    else:
        tol = 2**-7 * np.abs(want) + 1e-5 * np.abs(want).max()
        assert np.all(np.abs(got - want) <= tol)
    assert float(layer.aux_loss.detach()) == pytest.approx(aux, rel=1e-6)
    assert float(layer.load_entropy) == pytest.approx(ent, rel=1e-6)


def _jax_lm(**kw):
    import jax
    import jax.numpy as jnp

    from cs744_pytorch_distributed_tutorial_tpu.models.transformer import TransformerLM as JaxLM

    model = JaxLM(**LM, attention_impl="dense", **kw)
    params = model.init(jax.random.key(0), jnp.zeros((1, 4), jnp.int32))["params"]
    return model, _randomize(params, 3)


def _port_lm(params, **kw):
    model = TransformerLM(**LM, attention_impl="dense", **kw)
    model.load_state_dict(lm_params_from_jax(params))
    return model


def _tokens(seed, b, t):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, t)).astype(np.int32)


def test_moe_lm_logits_match_jax():
    import jax.numpy as jnp

    model, params = _jax_lm()
    toks = _tokens(4, 2, 17)
    want = np.asarray(model.apply({"params": params}, jnp.asarray(toks)))
    with torch.no_grad():
        got = _port_lm(params)(torch.from_numpy(toks).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_moe_decode_logits_match_full_forward():
    """Cached prefill + decode on the MoE LM reproduce the full forward's
    logits: at decode a token routes alone (N = 1), and dropless drops
    nothing by construction."""
    _, params = _jax_lm()
    model = _port_lm(params)
    tokens = torch.from_numpy(_tokens(5, 2, 10)).long()
    t0 = 4
    with torch.no_grad():
        full = model(tokens)
        cache = model.init_cache(2)
        pre = model(tokens[:, :t0], "prefill", cache=cache)
        torch.testing.assert_close(pre, full[:, :t0], rtol=1e-5, atol=1e-5)
        for pos in range(t0, tokens.shape[1]):
            step = model(tokens[:, pos : pos + 1], "decode", decode_pos=pos, cache=cache)
            torch.testing.assert_close(step[:, 0], full[:, pos], rtol=1e-5, atol=1e-5)
    out = make_generator(model, max_new_tokens=4, temperature=0.0, device="cpu")(tokens[:, :t0])
    assert out.shape == (2, 4) and bool(((out >= 0) & (out < VOCAB)).all())


def test_moe_converter_round_trip_and_quantize_match_jax():
    """JAX tree -> port state_dict -> JAX tree is the identity; the port's
    ``quantize_lm_params`` over the MoE state_dict gives the JAX
    ``quantize_lm_params`` tree (expert tensors and routers untouched)."""
    import jax

    from cs744_pytorch_distributed_tutorial_tpu.ops.quant import quantize_lm_params as jq

    _, params = _jax_lm()
    sd = lm_params_from_jax(params)
    assert sd["blocks.0.moe.router.weight"].shape == (E, 32)
    assert sd["blocks.1.moe.w_in"].shape == (E, 32, 64)
    assert "blocks.0.mlp_out_bias" not in sd
    back = jax_lm_params_from_state_dict(sd)
    flat_a = jax.tree_util.tree_leaves_with_path(jax.device_get(params))
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(leaf))
    modules = resolve_quant_modules("all")
    want = jax.device_get(jq(params, modules))
    got = jax_lm_params_from_state_dict(quantize_lm_params(sd, modules))
    want_flat = jax.tree_util.tree_leaves_with_path(want)
    got_flat = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(want_flat) == len(got_flat)
    for path, leaf in want_flat:
        if path[-1].key in ("w_in", "b_in", "w_out", "b_out") or path[-2].key == "router":
            np.testing.assert_array_equal(np.asarray(got_flat[path]), np.asarray(leaf))


def test_expert_init_counts_experts_in_fan_in():
    """flax's lecun_normal on [E, K, N] has fan_in E * K: the port draws the
    expert kernels from the same truncated normal (std (E * K)**-0.5)."""
    import jax

    shape = (8, 64, 128)
    flax_std = float(jax.nn.initializers.lecun_normal()(jax.random.key(0), shape).std())
    model = TransformerLM(vocab_size=VOCAB, num_layers=1, num_heads=2, d_model=64, d_ff=128,
                          max_seq_len=16, num_experts=8, moe_dispatch="dropless",
                          generator=torch.Generator().manual_seed(0))
    moe = model.blocks[0].moe
    std = float(moe.w_in.detach().std())
    assert std == pytest.approx((8 * 64) ** -0.5, rel=0.03)
    assert std == pytest.approx(flax_std, rel=0.03)
    assert float(moe.w_out.detach().std()) == pytest.approx((8 * 128) ** -0.5, rel=0.03)
    router = float(moe.router.weight.detach().std())
    assert router == pytest.approx(64**-0.5, rel=0.1)
    assert torch.all(moe.b_in == 0) and torch.all(moe.b_out == 0)


def test_moe_decode_copy_keeps_router_and_biases_fp32():
    tr = LMTrainer(LMConfig(vocab_size=VOCAB, num_layers=2, num_heads=2, d_model=32, d_ff=64,
                            max_seq_len=32, seq_len=16, compute_dtype="bfloat16",
                            moe_experts=4, moe_dispatch="dropless", device="cpu"))
    tr.init()
    model = tr.decode_model()
    moe = model.blocks[0].moe
    assert moe.router.weight.dtype == moe.b_in.dtype == moe.b_out.dtype == torch.float32
    assert moe.w_in.dtype == moe.w_out.dtype == torch.bfloat16
    assert model.blocks[0].attn.q.weight.dtype == torch.bfloat16
    toks = torch.from_numpy(_tokens(6, 2, 8)).long()
    with torch.no_grad():
        want = tr.model(toks)
        got = model(toks)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _build(**kw):
    return lambda: TransformerLM(**{**LM, **kw})


@pytest.mark.parametrize(
    "make,err,match",
    [(_build(moe_dispatch="scatter", moe_num_groups=-1), ValueError, "num_groups must be >= 0"),
     (lambda: MoEFFN(8, 4, 16, dispatch_impl="dropless", gmm_impl="ragged",
                     expert_axis="data"), ValueError, "does not compose with expert_axis"),
     (_build(moe_dispatch="sparse"), ValueError, "unknown dispatch_impl"),
     (_build(moe_capacity_factor=2.0), ValueError, "ignores capacity_factor"),
     (_build(moe_num_groups=4), ValueError, "ignores capacity_factor"),
     (_build(moe_num_groups=0), ValueError, "ignores capacity_factor"),
     (_build(moe_top_k=5), ValueError, "top_k 5 must be in"),
     (_build(moe_top_k=0), ValueError, "top_k 0 must be in"),
     (_build(mlp="swiglu"), ValueError, "does not compose with MoE"),
     (_build(moe_gmm_impl="sparse"), ValueError, "unknown gmm_impl"),
     (lambda: MoEFFN(8, 4, 16, dispatch_impl="dropless", expert_axis="data"), ValueError,
      "does not compose with expert_axis")],
)
def test_moe_rejections(make, err, match):
    with pytest.raises(err, match=match):
        make()


MOE_FLAGS = ["--num-layers", "2", "--d-model", "32", "--num-heads", "4", "--d-ff", "64",
             "--vocab-size", "128", "--max-seq-len", "64", "--use-rope", "--moe-experts", "4",
             "--moe-dispatch", "dropless", "--steps", "0", "--seq-len", "16", "--num-seqs", "8",
             "--generate", "6", "--prompt-len", "8", "--generate-batch", "3", "--temperature",
             "0", "--json", "--device", "cpu"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_cli_generates_from_moe_on_cpu(capsys, dtype):
    assert lm_cli.main([*MOE_FLAGS, "--compute-dtype", dtype]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    toks = np.asarray(summary["generation"]["tokens"])
    assert summary["steps_run"] == 0 and toks.shape == (3, 6)
    assert ((toks >= 0) & (toks < 128)).all()


def test_lm_cli_moe_expert_parallel_is_not_yet_ported():
    """Expert parallelism is ported (``test_torch_port_lm_axes4.py``); the
    CLI refuses it with dropless as JAX does, before any process group."""
    with pytest.raises(ValueError, match="does not compose with moe_expert_parallel"):
        lm_cli.main([*MOE_FLAGS, "--moe-expert-parallel", "--data-parallel", "2",
                     "--global-batch-size", "4"])
