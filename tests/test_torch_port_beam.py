"""The port's beam search (``infer/beam.py``) against the JAX package's
``make_beam_searcher`` on the same weights and prompts.

2 layers, d_model 64, 4 query heads over 2 KV heads, vocab 96, RoPE,
fp32; the flax init carried by ``models/convert.py``:

- tokens equal and scores within rtol 1e-5 for K 1, 2 and 4, plain and
  with ``eos_id`` (an out-of-vocab ``pad_id``) and a length penalty; the
  same with the int8 head (``quantize_lm_params`` scope ``head``) and
  with the int8 KV cache (both caches' scales reordered with the beams);
- the JAX properties (``tests/test_beam.py``) on the port: beam 1 is
  greedy ``make_generator``, the score is the teacher-forced log-prob
  (rel and abs 1e-4), a wider beam is never worse, EOS pads the tail,
  rows are independent (scores rel 1e-5);
- the guard rails.
"""

import numpy as np
import pytest
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.infer import make_beam_searcher, make_generator
from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import lm_params_from_jax
from cs744_pytorch_distributed_tutorial_tpu_torch.models.transformer import TransformerLM
from cs744_pytorch_distributed_tutorial_tpu_torch.ops.quant import resolve_quant_modules

VOCAB, NEW = 96, 6
SMALL = dict(vocab_size=VOCAB, num_layers=2, num_heads=4, num_kv_heads=2, d_model=64, d_ff=128,
             max_seq_len=32, use_rope=True, attention_impl="dense")
VARIANTS = {"float": {}, "int8-head": dict(quant_dense=True,
                                           quant_modules=resolve_quant_modules("head")),
            "int8-kv": dict(quant_kv_cache=True)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def flax_params():
    import jax
    import jax.numpy as jnp

    from cs744_pytorch_distributed_tutorial_tpu.models.transformer import TransformerLM as JaxLM

    return JaxLM(**SMALL).init(jax.random.key(0), jnp.zeros((1, 4), jnp.int32))["params"]


def _models(flax_params, variant):
    """(JAX model, its params, the port's model) for a variant."""
    from cs744_pytorch_distributed_tutorial_tpu.models.transformer import TransformerLM as JaxLM
    from cs744_pytorch_distributed_tutorial_tpu.ops.quant import quantize_lm_params

    kw = VARIANTS[variant]
    params = flax_params
    if kw.get("quant_dense"):
        params = quantize_lm_params(params, kw["quant_modules"])
    model = TransformerLM(**SMALL, **kw)
    model.load_state_dict(lm_params_from_jax(params))
    return JaxLM(**SMALL, **kw), params, model.eval()


def _prompt(seed, b=2, t=5):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, t)).astype(np.int32)


@pytest.fixture(scope="module")
def port_model(flax_params):
    return _models(flax_params, "float")[2]


CASES = [("float", 1, False), ("float", 2, False), ("float", 4, False), ("float", 1, True),
         ("float", 2, True), ("float", 4, True), ("int8-head", 3, True), ("int8-kv", 3, True)]


@pytest.mark.parametrize("variant,k,eos", CASES,
                         ids=[f"{v}-K{k}" + ("-eos-lp" if e else "") for v, k, e in CASES])
def test_tokens_and_scores_match_jax(flax_params, variant, k, eos):
    from cs744_pytorch_distributed_tutorial_tpu.infer import make_beam_searcher as jax_beam

    jmodel, params, model = _models(flax_params, variant)
    prompt = _prompt(1)
    kw = {}
    if eos:
        # EOS: a token the plain search emits mid-way, so beams finish.
        plain, _ = make_beam_searcher(model, beam_size=k, max_new_tokens=NEW, device="cpu")(prompt)
        kw = dict(eos_id=int(plain[0, 2]), pad_id=VOCAB + 3, length_penalty=0.6)
    want_tok, want_score = jax_beam(jmodel, beam_size=k, max_new_tokens=NEW, **kw)(params, prompt)
    tok, score = make_beam_searcher(model, beam_size=k, max_new_tokens=NEW, device="cpu",
                                    **kw)(prompt)
    assert tok.dtype == torch.int64 and tok.shape == (2, NEW)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(want_tok))
    np.testing.assert_allclose(score.numpy(), np.asarray(want_score), rtol=1e-5)
    if eos:
        assert (tok == kw["eos_id"]).any()


def _sequence_logprob(model, prompt, generated):
    full = torch.cat([torch.as_tensor(prompt).long(), generated], dim=1)
    with torch.no_grad():
        logp = torch.log_softmax(model(full).float(), dim=-1)
    t0 = prompt.shape[1]
    return float(sum(logp[torch.arange(full.shape[0]), t0 + i - 1, full[:, t0 + i]].sum()
                     for i in range(generated.shape[1])))


def test_beam_1_equals_greedy(port_model):
    prompt = _prompt(2)
    greedy = make_generator(port_model, max_new_tokens=NEW, temperature=0.0, device="cpu")(prompt)
    tok, _ = make_beam_searcher(port_model, beam_size=1, max_new_tokens=NEW, device="cpu")(prompt)
    assert torch.equal(tok, greedy)


def test_score_is_the_model_logprob(port_model):
    prompt = _prompt(3, b=1)
    tok, score = make_beam_searcher(port_model, beam_size=3, max_new_tokens=5, device="cpu")(prompt)
    assert float(score[0]) == pytest.approx(_sequence_logprob(port_model, prompt, tok), rel=1e-4,
                                            abs=1e-4)


def test_wider_beam_never_worse(port_model):
    prompt = _prompt(4, b=1, t=4)
    _, s1 = make_beam_searcher(port_model, beam_size=1, max_new_tokens=NEW, device="cpu")(prompt)
    _, s4 = make_beam_searcher(port_model, beam_size=4, max_new_tokens=NEW, device="cpu")(prompt)
    assert float(s4[0]) >= float(s1[0]) - 1e-5


def test_eos_pads_the_tail(port_model):
    """EOS = row 0's first token: that beam finishes at once with the best
    one-token score, which no longer sequence beats; its tail is the
    out-of-vocab pad."""
    prompt = _prompt(5, t=4)
    ref, _ = make_beam_searcher(port_model, beam_size=2, max_new_tokens=NEW, device="cpu")(prompt)
    eos, pad = int(ref[0, 0]), VOCAB + 3
    seq, _ = make_beam_searcher(port_model, beam_size=2, max_new_tokens=NEW, eos_id=eos,
                                pad_id=pad, device="cpu")(prompt)
    assert int(seq[0, 0]) == eos and bool((seq[0, 1:] == pad).all())
    for row in seq:
        hits = torch.nonzero(row == eos).flatten()
        if len(hits):
            assert bool((row[hits[0] + 1:] == pad).all())


def test_rows_are_independent(port_model):
    prompts = _prompt(6, b=3)
    search = make_beam_searcher(port_model, beam_size=3, max_new_tokens=4, device="cpu")
    joint, joint_scores = search(prompts)
    for i in range(3):
        solo, solo_score = search(prompts[i:i + 1])
        assert torch.equal(joint[i], solo[0])
        assert float(joint_scores[i]) == pytest.approx(float(solo_score[0]), rel=1e-5)


def test_beam_wider_than_the_vocabulary(port_model):
    tok, score = make_beam_searcher(port_model, beam_size=VOCAB + 4, max_new_tokens=2,
                                    device="cpu")(_prompt(7, b=1))
    assert tok.shape == (1, 2) and bool(torch.isfinite(score).all())


def test_guard_rails(port_model):
    with pytest.raises(ValueError, match="beam_size"):
        make_beam_searcher(port_model, beam_size=0, max_new_tokens=4, device="cpu")
    with pytest.raises(ValueError, match="max_new_tokens"):
        make_beam_searcher(port_model, beam_size=2, max_new_tokens=0, device="cpu")
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        make_beam_searcher(port_model, beam_size=2, max_new_tokens=30, device="cpu")(_prompt(8))
    with pytest.raises(ValueError, match="the shard_map decode path needs param_specs"):
        make_beam_searcher(port_model, beam_size=2, max_new_tokens=4, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="does not carry the model's tensor axis None"):
        make_beam_searcher(port_model, beam_size=2, max_new_tokens=4, device="cpu", mesh=object(),
                           param_specs=port_model.param_specs)
    with pytest.raises(TypeError, match="TransformerLM"):
        make_beam_searcher(object(), beam_size=2, max_new_tokens=4, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            make_beam_searcher(port_model, beam_size=2, max_new_tokens=4)
