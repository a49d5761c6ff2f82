"""The port's inference modes against the JAX package's flax model.

Weights from the flax init (and, for ``quant_dense``, the JAX
``quantize_lm_params`` tree) go through ``models/convert.py`` into the
port; the same numpy tokens go through both models, 2 layers, d_model
64, 4 query heads over 2 KV heads, fp32, RoPE or learned positions:

- ``prefill`` then ``decode`` steps: logits within 2e-5 at every step,
  with float weights, int8 weights (scopes ``head`` and ``all``) and an
  int8 KV cache;
- ``paged_decode`` (gather) over shuffled page tables, slots at
  different depths and one parked on trash page 0: logits within 2e-5;
- inside the port, ``paged_decode`` through the gather path is bitwise
  equal to ``decode`` over the dense cache (float and int8 KV), as the
  JAX package's ``tests/test_serve.py`` holds for flax;
- ``make_generator`` greedy tokens equal to the JAX ``make_generator``'s,
  with every step's top-1/top-2 logit margin above 1e-3 so that no
  near-tie decides a token.
"""

import numpy as np
import pytest
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.infer import make_generator, sample_tokens
from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import lm_params_from_jax
from cs744_pytorch_distributed_tutorial_tpu_torch.models.transformer import TransformerLM
from cs744_pytorch_distributed_tutorial_tpu_torch.ops.quant import resolve_quant_modules

VOCAB = 96
SMALL = dict(vocab_size=VOCAB, num_layers=2, num_heads=4, num_kv_heads=2, d_model=64, d_ff=128,
             max_seq_len=32)
QUANT = {"float": {}, "head": dict(quant_dense=True, quant_modules=resolve_quant_modules("head")),
         "all": dict(quant_dense=True, quant_modules=resolve_quant_modules("all")),
         "kv": dict(quant_kv_cache=True)}


def _jax_model(rope: bool, **kw):
    import jax
    import jax.numpy as jnp

    from cs744_pytorch_distributed_tutorial_tpu.models.transformer import TransformerLM as JaxLM
    from cs744_pytorch_distributed_tutorial_tpu.ops.quant import quantize_lm_params

    model = JaxLM(**SMALL, use_rope=rope, attention_impl="dense")
    params = model.init(jax.random.key(0), jnp.zeros((1, 4), jnp.int32))["params"]
    if kw.get("quant_dense"):
        params = quantize_lm_params(params, kw["quant_modules"])
    return model.clone(**kw), params


def _port_model(rope: bool, params, **kw):
    model = TransformerLM(**SMALL, use_rope=rope, attention_impl="dense", **kw)
    model.load_state_dict(lm_params_from_jax(params))
    return model


def _tokens(seed, b, t):
    return np.random.default_rng(seed).integers(1, VOCAB, (b, t)).astype(np.int32)


@pytest.mark.parametrize("rope,variant", [(True, "float"), (False, "float"), (True, "head"),
                                          (True, "all"), (True, "kv")],
                         ids=["rope", "learned", "rope-int8-head", "rope-int8-all", "rope-int8-kv"])
def test_prefill_and_decode_logits_match_flax(rope, variant):
    import jax.numpy as jnp

    kw = QUANT[variant]
    jmodel, params = _jax_model(rope, **kw)
    model = _port_model(rope, params, **kw)
    toks = _tokens(1, 2, 9)
    want, cache = jmodel.apply({"params": params}, jnp.asarray(toks[:, :5]), mode="prefill",
                               mutable=["cache"])
    kv = model.init_cache(2)
    with torch.no_grad():
        got = model(torch.from_numpy(toks[:, :5]).long(), "prefill", cache=kv)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
        for pos in range(5, 9):
            want, cache = jmodel.apply({"params": params, "cache": cache["cache"]},
                                       jnp.asarray(toks[:, pos:pos + 1]), mode="decode",
                                       decode_pos=pos, mutable=["cache"])
            got = model(torch.from_numpy(toks[:, pos:pos + 1]).long(), "decode",
                        decode_pos=pos, cache=kv)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5,
                                       err_msg=f"decode step at {pos}")


def _jax_pages(jmodel, params, b, p):
    import jax
    import jax.numpy as jnp

    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.key(0), jnp.zeros((b, 1), jnp.int32), mode="paged_decode",
        decode_pos=jnp.zeros((b,), jnp.int32), page_table=jnp.zeros((b, p), jnp.int32))["pages"])
    return jax.tree_util.tree_map_with_path(
        lambda path, s: (jnp.ones if "scale" in path[-1].key else jnp.zeros)(s.shape, s.dtype),
        shapes)


@pytest.mark.parametrize("variant", ["float", "kv"])
@pytest.mark.parametrize("rope", [True, False], ids=["rope", "learned"])
def test_paged_decode_logits_match_flax(rope, variant):
    """Three slots, page 4: slot 0 from step 0, slot 1 from step 3 (parked
    on trash page 0 before), slot 2 parked throughout; tokens fed one a
    step, as the engine's decode step does; the active slots' logits
    within 2e-5."""
    import jax.numpy as jnp

    kw = QUANT[variant]
    ps, num_pages, p = 4, 13, 3
    jmodel, params = _jax_model(rope, **kw)
    jmodel = jmodel.clone(page_size=ps, num_pages=num_pages, paged_attention_impl="gather")
    model = _port_model(rope, params, **kw)
    pages = _jax_pages(jmodel, params, 3, p)
    pools = model.init_pages(num_pages, ps)
    rng = np.random.default_rng(2)
    own = (1 + rng.permutation(num_pages - 1)[:2 * p]).reshape(2, p).astype(np.int32)
    toks = _tokens(3, 3, 10)
    for step in range(10):
        start = np.asarray([0, 3, 10])
        active = step >= start
        pos = np.where(active, step - start, 0).astype(np.int32)
        table = np.zeros((3, p), np.int32)
        table[:2][active[:2]] = own[active[:2]]
        want, mutated = jmodel.apply({"params": params, "pages": pages},
                                     jnp.asarray(toks[:, step:step + 1]), mode="paged_decode",
                                     decode_pos=jnp.asarray(pos), page_table=jnp.asarray(table),
                                     mutable=["pages"])
        pages = mutated["pages"]
        with torch.no_grad():
            got = model(torch.from_numpy(toks[:, step:step + 1]).long(), "paged_decode",
                        decode_pos=torch.from_numpy(pos), page_table=torch.from_numpy(table),
                        cache=pools)
        # Parked slots share trash page 0, whose rows either framework may
        # leave from either slot: only the active slots' logits are defined.
        np.testing.assert_allclose(got.numpy()[active], np.asarray(want)[active], rtol=2e-5,
                                   atol=2e-5, err_msg=f"step {step}")


@pytest.mark.parametrize("quant_kv", [False, True], ids=["float", "int8_kv"])
def test_paged_decode_bitwise_equals_dense_decode(quant_kv):
    """Prefill into a dense cache, commit its rows to shuffled pages (page
    capacity = the cache's length), then 5 decode steps both ways."""
    model = TransformerLM(**SMALL, use_rope=True, attention_impl="dense",
                          quant_kv_cache=quant_kv, generator=torch.Generator().manual_seed(4))
    ps, p = 8, 4  # 4 pages of 8 = max_seq_len rows a slot
    toks = torch.from_numpy(_tokens(5, 2, 11)).long()
    cache, pools = model.init_cache(2), model.init_pages(2 * p + 1, ps)
    table = torch.tensor([[3, 8, 1, 6], [5, 2, 7, 4]], dtype=torch.int32)
    with torch.no_grad():
        model(toks[:, :6], "prefill", cache=cache)
        rows = torch.arange(model.max_seq_len)
        for layer, pool in zip(cache, pools):
            for b in range(2):
                pool.key[table[b, rows // ps].long(), rows % ps] = layer.key[b]
                pool.value[table[b, rows // ps].long(), rows % ps] = layer.value[b]
                if quant_kv:
                    pool.key_scale[table[b, rows // ps].long(), rows % ps] = layer.key_scale[b]
                    pool.value_scale[table[b, rows // ps].long(), rows % ps] = layer.value_scale[b]
        for pos in range(6, 11):
            dense = model(toks[:, pos:pos + 1], "decode", decode_pos=pos, cache=cache)
            paged = model(toks[:, pos:pos + 1], "paged_decode",
                          decode_pos=torch.full((2,), pos, dtype=torch.int32), page_table=table,
                          cache=pools)
            assert torch.equal(dense, paged), pos


def _margins(model, prompt, out):
    """Top-1 minus top-2 logit at every generated position, teacher-forced."""
    seq = torch.cat([torch.as_tensor(prompt).long(), torch.as_tensor(out).long()], dim=1)
    with torch.no_grad():
        logits = model(seq[:, :-1])[:, prompt.shape[1] - 1:]
    top2 = logits.topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]).min().item()


@pytest.mark.parametrize("variant", ["float", "kv"])
def test_make_generator_greedy_matches_jax(variant):
    import jax

    from cs744_pytorch_distributed_tutorial_tpu.infer import make_generator as jax_generator

    kw = QUANT[variant]
    jmodel, params = _jax_model(True, **kw)
    model = _port_model(True, params, **kw)
    prompt = _tokens(6, 3, 7)
    want = np.asarray(jax_generator(jmodel, max_new_tokens=12, temperature=0.0)(
        params, prompt, jax.random.key(0)))
    generate = make_generator(model, max_new_tokens=12, temperature=0.0, device="cpu")
    got = generate(prompt).numpy()
    assert _margins(_port_model(True, params), prompt, got) > 1e-3
    np.testing.assert_array_equal(got, want)
    assert generate.timing["decode_steps"] == 11


def test_generator_eos_pads_and_sampling_is_seeded():
    model = TransformerLM(**SMALL, use_rope=True, generator=torch.Generator().manual_seed(7))
    prompt = _tokens(8, 2, 5)
    greedy = make_generator(model, max_new_tokens=10, temperature=0.0, device="cpu")(prompt)
    eos = int(greedy[0, 3])
    first = int((greedy[0] == eos).nonzero()[0])
    out = make_generator(model, max_new_tokens=10, temperature=0.0, eos_id=eos, pad_id=0,
                         device="cpu")(prompt)
    assert torch.equal(out[0, :first + 1], greedy[0, :first + 1])
    assert (out[0, first + 1:] == 0).all()
    gen = make_generator(model, max_new_tokens=6, temperature=0.8, top_k=20, top_p=0.9,
                         device="cpu")
    a = gen(prompt, torch.Generator().manual_seed(1))
    assert torch.equal(a, gen(prompt, torch.Generator().manual_seed(1)))
    assert ((a >= 0) & (a < VOCAB)).all()
    with pytest.raises(ValueError, match="max_seq_len"):
        make_generator(model, max_new_tokens=30, device="cpu")(prompt)


def test_sample_tokens_masks_like_jax():
    """top-k then top-p in the JAX order: with uniforms that favour the
    last token, only the kept ones can win; top_k=1 is greedy."""
    logits = torch.tensor([[3.0, 2.0, 1.0, 0.0, -1.0]])
    u = torch.tensor([[0.01, 0.01, 0.01, 0.01, 0.999999]])
    assert int(sample_tokens(logits, u, temperature=1.0)) == 4
    assert int(sample_tokens(logits, u, temperature=1.0, top_k=3)) in (0, 1, 2)
    assert int(sample_tokens(logits, u, temperature=1.0, top_p=0.5)) == 0
    assert int(sample_tokens(logits, u, temperature=1.0, top_k=1)) == 0
    assert int(sample_tokens(logits, None, temperature=0.0)) == 0
