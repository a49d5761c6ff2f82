"""The port's speculative decoding (``infer/speculative.py``) against the
JAX package's ``make_speculative_generator`` (JAX
``tests/test_speculative.py``).

A 2-layer target and a 1-layer draft (d_model 64, 4 query heads over 2
KV heads, vocab 64, RoPE, fp32), their flax inits carried by
``models/convert.py``:

- a ``decode`` chunk of 8 tokens after a prefill reproduces the
  teacher-forced forward within rtol and atol 2e-5;
- greedy tokens and ``target_calls`` equal JAX's exactly, and the tokens
  equal the port's plain greedy ``make_generator``, for the random draft
  at k 1, 2 and 4 and for the target as its own draft (3 calls for 12
  tokens at k 3: every round accepts all);
- EOS masking and the guard rails;
- rejection sampling, held in distribution (``jax.random`` cannot be
  reproduced in PyTorch): the (t1, t2) pairs of 4,000 generations on an
  8-token vocabulary (1-layer models with learned positions) against
  the target's own p(t1) p(t2 | t1), chi-square below its 0.001 quantile (Wilson-Hilferty), cells with fewer than 5
  expected pooled; a different draft is rejected at times (accept rate
  below 0.95), the target as its own draft never is;
- ``speculative_accept_rate`` equals JAX's over a grid.
"""

import numpy as np
import pytest
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.infer import (
    make_generator,
    make_speculative_generator,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import lm_params_from_jax
from cs744_pytorch_distributed_tutorial_tpu_torch.models.transformer import TransformerLM
from cs744_pytorch_distributed_tutorial_tpu_torch.obs.metrics import speculative_accept_rate

BASE = dict(vocab_size=64, num_heads=4, num_kv_heads=2, d_model=64, d_ff=128, max_seq_len=64,
            use_rope=True, attention_impl="dense")
NEW = 12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(params, layers, **kw):
    model = TransformerLM(**{**BASE, **kw}, num_layers=layers)
    model.load_state_dict(lm_params_from_jax(params))
    return model.eval()


@pytest.fixture(scope="module")
def setup():
    """JAX target and draft with their params, the port's copies, the
    prompt and JAX's plain greedy tokens."""
    import jax

    from cs744_pytorch_distributed_tutorial_tpu.infer import make_generator as jax_generator
    from cs744_pytorch_distributed_tutorial_tpu.models.transformer import TransformerLM as JaxLM

    target, draft = JaxLM(**BASE, num_layers=2), JaxLM(**BASE, num_layers=1)
    prompt = np.asarray(jax.random.randint(jax.random.key(0), (1, 8), 0, 64), dtype=np.int32)
    tp = target.init(jax.random.key(1), prompt)["params"]
    dp = draft.init(jax.random.key(2), prompt)["params"]
    want = np.asarray(jax_generator(target, max_new_tokens=NEW, temperature=0.0)(
        tp, prompt, jax.random.key(3)))
    return dict(jax=(target, draft, tp, dp), target=_port(tp, 2), draft=_port(dp, 1),
                prompt=prompt, want=want)


def test_chunked_decode_matches_teacher_forcing(setup):
    model = setup["target"]
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 64, (1, 16))).long()
    with torch.no_grad():
        full = model(toks)
        cache = model.init_cache(1)
        model(toks[:, :8], "prefill", cache=cache)
        chunk = model(toks[:, 8:], "decode", decode_pos=8, cache=cache)
    np.testing.assert_allclose(chunk.numpy(), full[:, 8:].numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("draft,k", [("random", 1), ("random", 2), ("random", 4), ("self", 3)])
def test_greedy_tokens_and_calls_equal_jax(setup, draft, k):
    from cs744_pytorch_distributed_tutorial_tpu.infer.speculative import (
        make_speculative_generator as jax_speculative,
    )

    jtarget, jdraft, tp, dp = setup["jax"]
    if draft == "self":
        jdraft, dp = jtarget, tp
    want, want_calls = jax_speculative(jtarget, jdraft, max_new_tokens=NEW, k=k,
                                       return_stats=True)(tp, dp, setup["prompt"])
    port_draft = setup["target"] if draft == "self" else setup["draft"]
    got, calls = make_speculative_generator(setup["target"], port_draft, max_new_tokens=NEW, k=k,
                                            return_stats=True, device="cpu")(setup["prompt"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), setup["want"])
    assert calls == int(want_calls)
    plain = make_generator(setup["target"], max_new_tokens=NEW, temperature=0.0,
                           device="cpu")(setup["prompt"])
    assert torch.equal(got, plain)
    if draft == "self":
        assert calls == 3  # ceil(11 / 4): every round accepts all k


def test_eos_masks_the_tail(setup):
    eos = int(setup["want"][0, 4])
    got = make_speculative_generator(setup["target"], setup["draft"], max_new_tokens=NEW, k=3,
                                     eos_id=eos, pad_id=0, device="cpu")(setup["prompt"])[0]
    first = int(torch.argmax((got == eos).long()))
    assert int(got[first]) == eos and bool((got[first + 1:] == 0).all())
    np.testing.assert_array_equal(got[:first + 1].numpy(), setup["want"][0, :first + 1])


def test_guard_rails(setup):
    target, draft = setup["target"], setup["draft"]
    with pytest.raises(ValueError, match="k must be"):
        make_speculative_generator(target, draft, max_new_tokens=4, k=0, device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        make_speculative_generator(target, TransformerLM(**{**BASE, "vocab_size": 32},
                                                         num_layers=1),
                                   max_new_tokens=4, device="cpu")
    with pytest.raises(ValueError, match="temperature"):
        make_speculative_generator(target, draft, max_new_tokens=4, temperature=-1.0,
                                   device="cpu")
    with pytest.raises(ValueError, match="max_new_tokens"):
        make_speculative_generator(target, draft, max_new_tokens=0, device="cpu")
    spec = make_speculative_generator(target, draft, max_new_tokens=4, k=2, device="cpu")
    with pytest.raises(ValueError, match="batch-1"):
        spec(np.zeros((2, 8), np.int32))
    with pytest.raises(ValueError, match="exceeds"):
        make_speculative_generator(target, draft, max_new_tokens=60, k=4,
                                   device="cpu")(setup["prompt"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            make_speculative_generator(target, draft, max_new_tokens=4)


def _chi2_threshold(df: int, z: float = 3.09) -> float:
    """Wilson-Hilferty chi-square quantile (z 3.09: alpha ~ 0.001)."""
    a = 2.0 / (9.0 * df)
    return df * (1.0 - a + z * a ** 0.5) ** 3


def test_sampling_is_distributed_as_the_target():
    vocab, temp, n_samples = 8, 1.3, 4000
    # Learned positions: at this size RoPE is most of a model call's host
    # time, and the test is of the sampler.
    small = dict(vocab_size=vocab, num_heads=2, num_kv_heads=2, max_seq_len=32,
                 attention_impl="dense")
    target = TransformerLM(**small, num_layers=1, d_model=32, d_ff=64,
                           generator=torch.Generator().manual_seed(10)).eval()
    draft = TransformerLM(**small, num_layers=1, d_model=16, d_ff=32,
                          generator=torch.Generator().manual_seed(11)).eval()
    prompt = torch.tensor([[1, 5, 2, 7]])
    with torch.no_grad():
        p1 = torch.softmax(target(prompt)[0, -1] / temp, -1)
        ext = torch.cat([prompt.expand(vocab, 4), torch.arange(vocab)[:, None]], dim=1)
        p2 = torch.softmax(target(ext)[:, -1] / temp, -1)
    joint = (p1[:, None] * p2).double().numpy()
    gen = make_speculative_generator(target, draft, max_new_tokens=2, k=2, temperature=temp,
                                     generator=torch.Generator().manual_seed(42), device="cpu")
    outs = np.stack([gen(prompt)[0].numpy() for _ in range(n_samples)])
    counts = np.zeros((vocab, vocab))
    np.add.at(counts, (outs[:, 0], outs[:, 1]), 1)
    exp, obs = joint.ravel() * n_samples, counts.ravel()
    big = exp >= 5.0
    obs_b = np.append(obs[big], obs[~big].sum())
    exp_b = np.append(exp[big], exp[~big].sum())
    keep = exp_b > 0
    chi2 = float((((obs_b - exp_b) ** 2) / np.where(keep, exp_b, 1.0))[keep].sum())
    df = int(keep.sum()) - 1
    assert chi2 < _chi2_threshold(df), (chi2, _chi2_threshold(df), df)


def test_sampling_rejects_a_different_draft(setup):
    gen = make_speculative_generator(setup["target"], setup["draft"], max_new_tokens=24, k=4,
                                     temperature=1.0, return_stats=True, device="cpu")
    toks, calls = gen(setup["prompt"], torch.Generator().manual_seed(0))
    assert toks.shape == (1, 24)
    assert 0.0 <= speculative_accept_rate(24, calls, 4) < 0.95


def test_sampling_self_draft_accepts_everything(setup):
    gen = make_speculative_generator(setup["target"], setup["target"], max_new_tokens=16, k=3,
                                     temperature=0.8, return_stats=True, device="cpu")
    _, calls = gen(setup["prompt"], torch.Generator().manual_seed(1))
    assert calls == -(-(16 - 1) // 4)


def test_accept_rate_equals_jax():
    from cs744_pytorch_distributed_tutorial_tpu.obs.metrics import (
        speculative_accept_rate as jax_rate,
    )

    for new in (1, 7, 12, 128):
        for calls in (-1, 0, 1, 3, 26, 127, 200):
            for k in (0, 1, 4):
                assert speculative_accept_rate(new, calls, k) == jax_rate(new, calls, k)
