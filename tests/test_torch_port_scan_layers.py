"""``scan_layers`` in the port against the JAX package's (JAX
``tests/test_scan_layers.py``): the stacked layout is exactly a layout
change.

- The flax model with ``scan_layers`` and the port's, on the same
  stacked tree through ``models/convert.py``: logits within rtol 1e-6 /
  atol 1e-5, gradients of the mean cross-entropy within rtol and atol
  1e-5; with remat ``dots`` as well.
- ``stack_block_params`` / ``unstack_block_params`` on the port's
  ``state_dict`` round-trip bitwise and equal the JAX functions' trees
  mapped; the converter maps the stacked tree, in both directions,
  bitwise as the unrolled tree mapped then stacked.
- Prefill and decode through the stacked model match its full forward
  (prefill within 1e-5, each decode step within 1e-4, the JAX bounds), and
  equal the unrolled model's bit for bit.
- Each layer draws its own dropout mask; MoE raises ``ValueError``.
- ``LMTrainer``: 3 AdamW steps with ``scan_layers`` and remat ``dots``
  against the JAX trainer with the same options (as
  ``test_torch_port_lm.py``: rtol 1e-5 on loss and norms, parameters
  within lr, 1e-5 but for one element in 10,000, 1e-6 on average); the
  scanned trainer against the unrolled one from the same weights, losses
  within rtol 2e-5 (the JAX bound; here bitwise); decode copies of a
  scanned trainer, float and int8, decode as the unrolled trainer's.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cs744_pytorch_distributed_tutorial_tpu_torch.data import synthetic_tokens
from cs744_pytorch_distributed_tutorial_tpu_torch.infer import make_generator
from cs744_pytorch_distributed_tutorial_tpu_torch.models import transformer as T
from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import (
    jax_lm_params_from_state_dict,
    lm_params_from_jax,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.train.lm import LMConfig, LMTrainer

L, VOCAB = 3, 128
MODEL = dict(vocab_size=VOCAB, num_layers=L, num_heads=4, d_model=64, d_ff=128, max_seq_len=64,
             use_rope=True, attention_impl="dense")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def flax():
    """The flax unrolled params and their JAX-stacked tree."""
    import jax
    import jax.numpy as jnp

    from cs744_pytorch_distributed_tutorial_tpu.models.transformer import (
        TransformerLM as JaxLM,
    )
    from cs744_pytorch_distributed_tutorial_tpu.models.transformer import stack_block_params

    params = JaxLM(**MODEL, flash_interpret=True).init(
        jax.random.key(0), jnp.zeros((2, 16), jnp.int32))["params"]
    return params, stack_block_params(params, L)


def _toks(seed, t=17):
    return np.random.default_rng(seed).integers(0, VOCAB, (2, t)).astype(np.int32)


@pytest.mark.parametrize("remat", [False, True], ids=["scan", "scan+remat-dots"])
def test_logits_and_grads_match_flax_scanned(flax, remat):
    import jax
    import jax.numpy as jnp
    import optax

    from cs744_pytorch_distributed_tutorial_tpu.models.transformer import (
        TransformerLM as JaxLM,
    )

    _, stacked = flax
    opts = dict(scan_layers=True, remat=remat, remat_policy="dots")
    jmodel = JaxLM(**MODEL, flash_interpret=True, **opts)
    toks = _toks(1)
    x, y = jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:])

    def loss(p):
        logits = jmodel.apply({"params": p}, x)
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean(), logits

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(stacked)
    model = T.TransformerLM(**MODEL, **opts)
    model.load_state_dict(lm_params_from_jax(stacked))
    logits = model(torch.from_numpy(toks[:, :-1]).long())
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)
    F.cross_entropy(logits.reshape(-1, VOCAB), torch.from_numpy(toks[:, 1:]).long().flatten()
                    ).backward()
    want_grads = lm_params_from_jax(jgrads)
    assert set(want_grads) == {k for k, _ in model.named_parameters()}
    for k, p in model.named_parameters():
        assert p.shape[0] == L or not k.startswith("blocks."), k
        np.testing.assert_allclose(p.grad.numpy(), want_grads[k].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_stack_unstack_and_the_converter_are_bitwise(flax):
    import jax

    from cs744_pytorch_distributed_tutorial_tpu.models.transformer import unstack_block_params

    params, stacked = flax
    sd = lm_params_from_jax(params)
    mine = T.stack_block_params(sd, L)
    theirs = lm_params_from_jax(stacked)
    assert set(mine) == set(theirs) and T.is_stacked(mine) and not T.is_stacked(sd)
    assert all(torch.equal(mine[k], theirs[k]) for k in mine)
    back = T.unstack_block_params(mine)
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    # The reverse mapping of the stacked layout is the JAX stacked tree.
    tree = jax_lm_params_from_state_dict(mine)
    assert jax.tree.structure(tree) == jax.tree.structure(stacked)
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                                 jax.tree_util.tree_flatten_with_path(stacked)[0]):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(path))
    unstacked = lm_params_from_jax(unstack_block_params(stacked))
    assert all(torch.equal(unstacked[k], sd[k]) for k in sd)
    # The model's own layout: a scanned model holds the stack of the
    # unrolled model it was drawn as.
    gen = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    unrolled = T.TransformerLM(**MODEL, generator=gen()).state_dict()
    scanned = T.TransformerLM(**MODEL, scan_layers=True, generator=gen()).state_dict()
    want = T.stack_block_params(unrolled)
    assert set(scanned) == set(want) and all(torch.equal(scanned[k], want[k]) for k in want)
    with pytest.raises(ValueError, match="num_layers"):
        T.stack_block_params(sd, L + 1)
    with pytest.raises(ValueError, match="non-contiguous"):
        T.stack_block_params({k: v for k, v in sd.items() if not k.startswith("blocks.1.")})
    with pytest.raises(ValueError, match="blocks"):
        lm_params_from_jax(stacked, cfg=type("Cfg", (), {"num_layers": L + 1}))


def test_prefill_and_decode_through_the_stacked_model(flax):
    params, stacked = flax
    model = T.TransformerLM(**MODEL, scan_layers=True)
    model.load_state_dict(lm_params_from_jax(stacked))
    unrolled = T.TransformerLM(**MODEL)
    unrolled.load_state_dict(lm_params_from_jax(params))
    toks = torch.from_numpy(_toks(5, 24)).long()
    with torch.no_grad():
        full = model(toks)
        caches = [model.init_cache(2), unrolled.init_cache(2)]
        outs = [m(toks[:, :16], "prefill", cache=c) for m, c in zip((model, unrolled), caches)]
        np.testing.assert_allclose(outs[0].numpy(), full[:, :16].numpy(), rtol=1e-5, atol=1e-5)
        assert torch.equal(*outs)
        for pos in range(16, 24):
            steps = [m(toks[:, pos:pos + 1], "decode", decode_pos=pos, cache=c)
                     for m, c in zip((model, unrolled), caches)]
            np.testing.assert_allclose(steps[0][:, 0].numpy(), full[:, pos].numpy(), rtol=1e-4,
                                       atol=1e-4)
            assert torch.equal(*steps)


def test_each_layer_draws_its_own_dropout_mask(monkeypatch):
    seen = []
    real = T.dropout_mask

    def spy(key, shape, rate, device):
        mask = real(key, shape, rate, device)
        seen.append((key, mask))
        return mask

    monkeypatch.setattr(T, "dropout_mask", spy)
    model = T.TransformerLM(**MODEL, scan_layers=True, dropout_rate=0.5)
    out = model(torch.zeros((2, 16), dtype=torch.long), dropout=(7, 0, 0))
    assert bool(torch.isfinite(out).all())
    attn = [mask for key, mask in seen if key[4] == 0]
    assert [key[3] for key, _ in seen if key[4] == 0] == list(range(L))
    for i in range(1, L):
        assert not torch.equal(attn[0], attn[i]), i


def test_scan_layers_rejects_moe():
    with pytest.raises(ValueError, match="scan_layers does not compose"):
        T.TransformerLM(**MODEL, scan_layers=True, num_experts=4)


SMALL = dict(vocab_size=VOCAB, num_layers=L, num_heads=4, d_model=64, d_ff=128, max_seq_len=64,
             seq_len=32, global_batch_size=4, use_rope=True, learning_rate=1e-3)


def test_trainer_scanned_with_remat_dots_matches_jax():
    import jax

    from cs744_pytorch_distributed_tutorial_tpu.parallel import make_mesh
    from cs744_pytorch_distributed_tutorial_tpu.train import LMConfig as JaxConfig
    from cs744_pytorch_distributed_tutorial_tpu.train import LMTrainer as JaxTrainer

    opts = dict(scan_layers=True, remat=True, remat_policy="dots")
    jt = JaxTrainer(JaxConfig(**SMALL, attention_impl="dense", **opts),
                    mesh=make_mesh({"data": 1, "seq": 1}, devices=jax.devices()[:1]))
    params, opt = jt.init()
    port = LMTrainer(LMConfig(**SMALL, attention_impl="flash", device="cpu", **opts))
    port.init(state_dict=lm_params_from_jax(jax.device_get(params)))
    toks = synthetic_tokens(12, 32, VOCAB, seed=1)
    for step in range(3):
        batch = toks[4 * step: 4 * (step + 1)]
        params, opt, want = jt.train_step(params, opt, *jt.shard_batch(batch), step)
        got = port.train_step(*port.split_batch(batch))
        for key in want:
            assert float(got[key]) == pytest.approx(float(want[key]), rel=1e-5), (step, key)
    want_sd = lm_params_from_jax(jax.device_get(params))
    errs = torch.cat([(want_sd[k] - v).abs().flatten() for k, v in port.model.state_dict().items()])
    assert float(errs.max()) <= 1e-3 and float(errs.mean()) <= 1e-6
    assert int((errs > 1e-5).sum()) <= 1e-4 * errs.numel()


def test_trainer_scanned_matches_unrolled_and_decodes():
    toks = synthetic_tokens(16, 32, VOCAB, seed=0)
    cfg = LMConfig(**SMALL, attention_impl="flash", device="cpu")
    unrolled = LMTrainer(cfg)
    unrolled.init()
    scanned = LMTrainer(cfg.replace(scan_layers=True))
    scanned.init(state_dict=T.stack_block_params(unrolled.model.state_dict()))
    losses = {}
    for label, tr in (("unrolled", unrolled), ("scanned", scanned)):
        losses[label] = [float(tr.train_step(*tr.split_batch(toks[4 * s: 4 * s + 4]))["loss"])
                         for s in range(3)]
    np.testing.assert_allclose(losses["scanned"], losses["unrolled"], rtol=2e-5)
    assert T.is_stacked(scanned.model.state_dict())
    prompt = toks[:2, :8]
    for build in (lambda tr: tr.decode_model(), lambda tr: tr.quantized_decode_model("all"),
                  lambda tr: tr.decode_model(kv_cache=True)):
        outs = [make_generator(build(tr), max_new_tokens=6, temperature=0, device="cpu")(prompt)
                for tr in (unrolled, scanned)]
        assert torch.equal(*outs)
