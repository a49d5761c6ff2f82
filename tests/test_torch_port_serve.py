"""The port's serving engine (``serve/``) against the JAX package's.

- ``PagePool``: the trash page, LIFO reuse, ``high_water`` and the bad
  frees, as ``tests/test_serve.py`` holds them.
- ``make_poisson_workload``: the JAX package's arrays for the same seed.
- ``ServingEngine`` (the gather path; on CPU tensors the ``kernel`` path
  is its plain version, the same code): greedy output equal to the
  port's ``make_generator`` token for token, with a pool small enough to
  preempt, and equal to the JAX engine's on the same trace from the same
  weights, each step's top-1/top-2 logit margin above 1e-3. EOS held
  against the JAX engine for an ``eos_id`` whose first occurrence in the
  greedy stream is at a known index.
- Sampled decoding (temperature 0.8, top-k 20) gives the same tokens
  with and without forced preemption: token t of request r draws from
  uniforms keyed by (seed, r, t).
"""

import numpy as np
import pytest
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.infer import make_generator
from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import lm_params_from_jax
from cs744_pytorch_distributed_tutorial_tpu_torch.models.transformer import TransformerLM
from cs744_pytorch_distributed_tutorial_tpu_torch.serve import (
    PagePool,
    Request,
    ServeConfig,
    ServingEngine,
    make_poisson_workload,
)

VOCAB = 61
TINY = dict(vocab_size=VOCAB, num_layers=2, num_heads=2, d_model=32, d_ff=64, max_seq_len=64,
            use_rope=True)
# (prompt length, budget); with 3 slots over 8 allocatable pages of 4
# rows, slots want up to 7 pages each: preemption is forced.
CASES = [(6, 18), (10, 14), (8, 16), (5, 20), (12, 12)]
TIGHT = dict(num_slots=3, page_size=4, num_pages=9, max_pages_per_slot=7)
AMPLE = dict(num_slots=3, page_size=4, num_pages=33, max_pages_per_slot=8)


class _ListSink:
    def __init__(self):
        self.records = []

    def emit(self, record):
        self.records.append(dict(record))


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, JAX params, the port's model with the same weights)."""
    import jax
    import jax.numpy as jnp

    from cs744_pytorch_distributed_tutorial_tpu.models.transformer import TransformerLM as JaxLM

    jmodel = JaxLM(**TINY, attention_impl="dense")
    params = jmodel.init(jax.random.key(0), jnp.zeros((1, 4), jnp.int32))["params"]
    model = TransformerLM(**TINY, attention_impl="dense")
    model.load_state_dict(lm_params_from_jax(params))
    return jmodel, params, model


def _prompts(seed=13, cases=CASES):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, VOCAB, size=plen).astype(np.int32), budget)
            for plen, budget in cases]


def _serve(model, prompts, **cfg):
    eng = ServingEngine(model, ServeConfig(**{"paged_attention_impl": "gather", **cfg}),
                        device="cpu")
    reqs = [eng.submit(Request(prompt=p, max_new_tokens=n)) for p, n in prompts]
    eng.run()
    # Preemption moves early tokens into the prompt: the produced stream.
    return eng, [list(r.prompt[r.orig_prompt_len:]) + r.generated for r in reqs]


def _margin(model, prompt, out):
    seq = torch.as_tensor(np.concatenate([prompt, out]))[None].long()
    with torch.no_grad():
        logits = model(seq[:, :-1])[0, len(prompt) - 1:]
    top2 = logits.topk(2, dim=-1).values
    return float((top2[:, 0] - top2[:, 1]).min())


def test_page_pool_trash_lifo_and_high_water():
    pool = PagePool(num_pages=6, page_size=4)
    assert pool.free_pages == 5 and 0 not in pool.alloc(5)
    pool = PagePool(num_pages=9, page_size=4)
    a = pool.alloc(3)
    assert a == [1, 2, 3]
    b = pool.alloc(2)
    pool.free(a)
    assert pool.alloc(1) == [1] and pool.high_water == 5
    assert pool.allocated_pages == 3 and pool.check_invariants()
    for bad in ([0], [9], [2, 2], [7]):
        with pytest.raises(ValueError):
            pool.free(bad)
    pool.free(b)
    assert [pool.pages_for(n) for n in (1, 4, 5, 8, 9)] == [1, 1, 2, 2, 3]
    with pytest.raises(RuntimeError, match="exhausted"):
        pool.alloc(9)
    with pytest.raises(ValueError, match="trash"):
        PagePool(num_pages=1, page_size=4)


def test_poisson_workload_equals_jax():
    from cs744_pytorch_distributed_tutorial_tpu.serve.loadgen import (
        make_poisson_workload as jax_workload,
    )

    kw = dict(num_requests=9, rate_rps=5.0, prompt_len=(3, 17), output_len=(2, 9),
              vocab_size=VOCAB, seed=4)
    want, got = jax_workload(**kw), make_poisson_workload(**kw)
    np.testing.assert_array_equal(got.arrivals, want.arrivals)
    np.testing.assert_array_equal(got.max_new_tokens, want.max_new_tokens)
    assert len(got) == len(want)
    for a, b in zip(got.prompts, want.prompts):
        np.testing.assert_array_equal(a, b)


def test_engine_greedy_matches_make_generator_under_preemption(tiny):
    _, _, model = tiny
    prompts = _prompts()
    eng, out = _serve(model, prompts, **TIGHT)
    stats = eng.stats()
    assert stats["preemptions"] > 0 and stats["paged_attention_impl"] == "gather"
    assert eng.pool.allocated_pages == 0 and 0 < eng.pool.high_water <= 8
    for (prompt, budget), got in zip(prompts, out):
        assert len(got) == budget
        want = make_generator(model, max_new_tokens=budget, temperature=0.0,
                              device="cpu")(prompt[None])[0].tolist()
        assert _margin(model, prompt, want) > 1e-3
        assert got == want


def test_engine_greedy_and_eos_match_jax_engine(tiny):
    """The Poisson trace's prompts through both engines (3 slots, page 4):
    greedy outputs equal; then an eos_id first seen at a known index of
    one request's greedy stream stops that request there, and both
    engines give the same outputs."""
    from cs744_pytorch_distributed_tutorial_tpu.serve import Request as JaxRequest
    from cs744_pytorch_distributed_tutorial_tpu.serve import ServeConfig as JaxServeConfig
    from cs744_pytorch_distributed_tutorial_tpu.serve import ServingEngine as JaxEngine

    jmodel, params, model = tiny
    trace = make_poisson_workload(num_requests=5, rate_rps=10.0, prompt_len=(3, 14),
                                  output_len=(4, 10), vocab_size=VOCAB, seed=2)
    prompts = list(zip(trace.prompts, trace.max_new_tokens.tolist()))

    def jax_serve(**cfg):
        eng = JaxEngine(jmodel, params, JaxServeConfig(**cfg, paged_attention_impl="gather"))
        reqs = [eng.submit(JaxRequest(prompt=p, max_new_tokens=n)) for p, n in prompts]
        eng.run()
        return [list(r.prompt[r.orig_prompt_len:]) + r.generated for r in reqs]

    want = jax_serve(**AMPLE)
    _, got = _serve(model, prompts, **AMPLE)
    for (prompt, _), tokens in zip(prompts, got):
        assert _margin(model, prompt, tokens) > 1e-3
    assert [[int(t) for t in w] for w in want] == got

    # The first (request, index >= 2) whose token has not appeared before
    # in that request's stream: with it as eos_id, that request stops there.
    r, i = next((r, i) for r, toks in enumerate(got) for i in range(2, len(toks))
                if toks[i] not in toks[:i])
    eos = got[r][i]
    want = jax_serve(**AMPLE, eos_id=eos)
    sink = _ListSink()
    eng = ServingEngine(model, ServeConfig(**AMPLE, eos_id=eos), device="cpu", sink=sink)
    reqs = [eng.submit(Request(prompt=p, max_new_tokens=n)) for p, n in prompts]
    eng.run()
    assert reqs[r].generated == got[r][:i + 1]
    assert [[int(t) for t in w] for w in want] == [x.generated for x in reqs]
    done = {x["id"]: x for x in sink.records if x.get("event") == "request"}
    assert done[r]["output_tokens"] == i + 1


def test_sampled_tokens_survive_preemption(tiny):
    _, _, model = tiny
    sample = dict(temperature=0.8, top_k=20, seed=3)
    prompts = _prompts()
    tight, tight_out = _serve(model, prompts, **TIGHT, **sample)
    ample, ample_out = _serve(model, prompts, **AMPLE, **sample)
    assert tight.stats()["preemptions"] > 0 and ample.stats()["preemptions"] == 0
    assert tight_out == ample_out
    greedy = _serve(model, prompts, **AMPLE)[1]
    assert ample_out != greedy  # the draws are not argmax


def test_engine_streams_tokens_and_validates(tiny):
    _, _, model = tiny
    seen = []
    eng = ServingEngine(model, ServeConfig(**AMPLE), device="cpu",
                        on_token=lambda r, t: seen.append((r.req_id, t)))
    (p0, n0), (p1, n1) = _prompts(5, [(4, 6), (9, 8)])
    a = eng.submit(Request(prompt=p0, max_new_tokens=n0))
    b = eng.submit(Request(prompt=p1, max_new_tokens=n1))
    streamed = list(eng.iter_tokens(a))
    assert streamed == a.generated and len(a.token_times) == n0
    eng.run()
    assert [t for r, t in seen if r == b.req_id] == b.generated
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(Request(prompt=np.zeros((0,), np.int32), max_new_tokens=4))
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit(Request(prompt=np.ones((4,), np.int32), max_new_tokens=0))
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        eng.submit(Request(prompt=np.ones((60,), np.int32), max_new_tokens=8))
    with pytest.raises(ValueError, match="caps a slot at 8 pages"):
        eng.submit(Request(prompt=np.ones((30,), np.int32), max_new_tokens=8))
