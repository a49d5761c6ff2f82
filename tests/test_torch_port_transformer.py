"""The port's ``TransformerLM`` against the JAX package's flax model.

Weights made by the flax init go through ``models/convert.py`` into the
port; the same numpy tokens go through both models. Three variants, the
GPT-2 style (LayerNorm, gelu, learned positions), the same with biases on
the q/k/v/attn_out projections (every bias drawn non-zero from a numpy
seed, so they enter the logits), and the llama style (RoPE, RMSNorm,
swiglu, GQA with 2 KV heads, tied embeddings), each with
dense and with flash attention (the JAX side's Pallas kernels in
interpret mode, the port's plain versions). fp32 logits within 2e-5 and
the gradients of the mean cross-entropy within 2e-5 + 1e-4 relative
(fp32 sums in another order); one bf16 case within 5e-2 of the logits'
scale (bf16 rounds at other places in the two frameworks).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import (
    jax_lm_params_from_state_dict,
    lm_params_from_jax,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.models.transformer import (
    TransformerLM,
    apply_rope,
)

VOCAB = 64
SMALL = dict(vocab_size=VOCAB, num_layers=2, num_heads=4, d_model=32, d_ff=64, max_seq_len=32)
VARIANTS = {
    "gpt2": dict(norm="layernorm", mlp="gelu"),
    "gpt2_attn_bias": dict(norm="layernorm", mlp="gelu", attn_bias=True),
    "llama": dict(use_rope=True, norm="rmsnorm", mlp="swiglu", num_kv_heads=2,
                  tie_embeddings=True),
}


def _tokens(seed=0, b=2, t=17):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, t)).astype(np.int32)


def _jax_run(kw, impl, dtype, toks):
    """flax params, logits and d(mean CE)/d(params) on ``toks``."""
    import jax
    import jax.numpy as jnp
    import optax

    from cs744_pytorch_distributed_tutorial_tpu.models.transformer import (
        TransformerLM as JaxLM,
    )

    model = JaxLM(**SMALL, **kw, attention_impl=impl, dtype=dtype, flash_interpret=True)
    x, y = jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:])
    params = model.init(jax.random.key(0), x)["params"]
    if kw.get("attn_bias"):
        rng = np.random.default_rng(5)
        params = jax.tree_util.tree_map_with_path(
            lambda path, leaf: (jnp.asarray(0.1 * rng.standard_normal(leaf.shape), leaf.dtype)
                                if path[-1].key in ("bias", "mlp_out_bias") else leaf),
            params)

    def loss(p):
        logits = model.apply({"params": p}, x)
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean(), logits

    (_, logits), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return params, np.asarray(logits), grads


def _port_run(kw, impl, dtype, params, toks):
    model = TransformerLM(**SMALL, **kw, attention_impl=impl, dtype=dtype)
    model.load_state_dict(lm_params_from_jax(params))
    logits = model(torch.from_numpy(toks[:, :-1]).long())
    y = torch.from_numpy(toks[:, 1:]).long()
    F.cross_entropy(logits.reshape(-1, VOCAB), y.reshape(-1)).backward()
    return model, logits.detach().numpy()


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_logits_and_grads_match_flax(variant, impl):
    kw = VARIANTS[variant]
    toks = _tokens()
    params, want, jgrads = _jax_run(kw, impl, "float32", toks)
    model, got = _port_run(kw, impl, torch.float32, params, toks)
    assert got.dtype == np.float32 and got.shape == (2, 16, VOCAB)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    want_grads = lm_params_from_jax(jgrads)
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(want_grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_grads[k].numpy(), rtol=1e-4, atol=2e-5,
                                   err_msg=k)


def test_bfloat16_logits_close_to_flax():
    """flax ``dtype=bfloat16`` against the port's bf16 compute, flash
    attention: fp32 parameters in both, bf16 activations."""
    import jax.numpy as jnp

    kw = VARIANTS["gpt2"]
    toks = _tokens(1)
    params, want, _ = _jax_run(kw, "flash", jnp.bfloat16, toks)
    _, got = _port_run(kw, "flash", torch.bfloat16, params, toks)
    assert got.dtype == np.float32
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= 5e-2 * scale


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_converter_round_trip(variant):
    import jax

    kw = VARIANTS[variant]
    params, _, _ = _jax_run(kw, "dense", "float32", _tokens())
    back = jax_lm_params_from_state_dict(lm_params_from_jax(params))
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for path, leaf in flat:
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    model = TransformerLM(**SMALL, **kw)
    assert set(model.state_dict()) == set(lm_params_from_jax(params))
    with pytest.raises(ValueError, match="blocks"):
        lm_params_from_jax(params, cfg=type("Cfg", (), {"num_layers": 3}))


def test_rope_matches_jax():
    import jax.numpy as jnp

    from cs744_pytorch_distributed_tutorial_tpu.models.transformer import (
        apply_rope as jax_rope,
    )

    x = np.random.default_rng(2).standard_normal((2, 9, 3, 8)).astype(np.float32)
    want = jax_rope(jnp.asarray(x), jnp.arange(9) + 5)
    got = apply_rope(torch.from_numpy(x), torch.arange(9) + 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_init_distributions_follow_flax_defaults():
    model = TransformerLM(vocab_size=512, num_layers=1, num_heads=4, d_model=64, d_ff=256,
                          max_seq_len=16, generator=torch.Generator().manual_seed(3))
    emb = model.tok_embed.weight.detach()
    assert abs(float(emb.std()) - 64**-0.5) < 0.05 * 64**-0.5  # N(0, 1/d_model)
    w = model.blocks[0].mlp_in.weight.detach()  # lecun-normal, fan_in 64, truncated at 2 std
    assert abs(float(w.std()) - 64**-0.5) < 0.05 * 64**-0.5
    assert float(w.abs().max()) <= 2 * 64**-0.5 / 0.87962566103423978 + 1e-6
    assert torch.all(model.blocks[0].mlp_out_bias == 0)
    assert torch.all(model.blocks[0].ln1.weight == 1) and torch.all(model.ln_f.bias == 0)
    again = TransformerLM(vocab_size=512, num_layers=1, num_heads=4, d_model=64, d_ff=256,
                          max_seq_len=16, generator=torch.Generator().manual_seed(3))
    assert torch.equal(again.lm_head.weight, model.lm_head.weight)


@pytest.mark.parametrize(
    "option",
    # MoE's ragged_dot grouped matmul runs now (test_torch_port_gmm_groups.py):
    # in its place an unknown gmm_impl. remat, scan_layers and dropout build now (test_torch_port_lm_options.py,
    # test_torch_port_scan_layers.py), and so do the sequence and tensor
    # axes (test_torch_port_lm_axes4.py): in their places what JAX refuses
    # with ValueError (an unknown remat policy, scan_layers with MoE,
    # attn_bias with a tensor axis, heads that do not divide over it, dense
    # attention on a sequence-sharded axis).
    [dict(num_experts=4, moe_dispatch="dropless", moe_gmm_impl="sparse"),
     dict(remat=True, remat_policy="everything"), dict(scan_layers=True, num_experts=4),
     dict(tensor_axis_size=2, attn_bias=True), dict(tensor_axis_size=3),
     dict(seq_axis_size=2, attention_impl="dense")],
)
def test_later_options_raise(option):
    error, match = ValueError, "unknown gmm_impl"
    if "remat_policy" in option:
        error, match = ValueError, "remat_policy"
    elif option.get("scan_layers"):
        error, match = ValueError, "scan_layers does not compose"
    elif option.get("attn_bias"):
        error, match = ValueError, "attn_bias does not compose with a tensor axis"
    elif "tensor_axis_size" in option:
        error, match = ValueError, "not divisible by tensor axis"
    elif "seq_axis_size" in option:
        error, match = ValueError, "cannot run on a sequence-sharded axis"
    with pytest.raises(error, match=match):
        TransformerLM(**SMALL, **option)
