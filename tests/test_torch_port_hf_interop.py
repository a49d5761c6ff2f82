"""The port's HuggingFace checkpoint import (``models/hf_interop.py``)
against the JAX package's and against ``transformers``.

``GPT2LMHeadModel`` and ``LlamaForCausalLM`` are built from configs in
code (random weights from a torch seed, nothing downloaded), the JAX
tests' configs (``tests/test_hf_interop.py``): GPT-2 at vocab 256, d 128,
2 layers, 2 heads, 64 positions; Llama at vocab 128, d 64, 2 layers, 4
heads over 2 KV heads, d_ff 128. The port's flax trees equal JAX's bit
for bit and its ``TransformerLM`` kwargs equal JAX's; the converted port
LM's logits meet ``transformers``' at rtol/atol 1e-4 (GPT-2) and 2e-4
(Llama), the JAX tests' tolerances; greedy decoding equals
``generate``; a bf16 checkpoint converts to float32; a state_dict of the
wrong family is refused with JAX's message; a Llama checkpoint without
``lm_head.weight`` loads as the tied model.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")


@pytest.fixture(scope="module")
def hf_gpt2():
    cfg = transformers.GPT2Config(vocab_size=256, n_positions=64, n_embd=128, n_layer=2,
                                  n_head=2, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    torch.manual_seed(11)
    return transformers.GPT2LMHeadModel(cfg).eval()


@pytest.fixture(scope="module")
def hf_llama():
    cfg = transformers.LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                                   num_hidden_layers=2, num_attention_heads=4,
                                   num_key_value_heads=2, max_position_embeddings=64,
                                   rope_theta=10000.0, attention_dropout=0.0)
    torch.manual_seed(13)
    return transformers.LlamaForCausalLM(cfg).eval()


def _port_lm(cfg: dict, state_dict: dict):
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.transformer import TransformerLM

    with torch.device("meta"):
        model = TransformerLM(**cfg)
    model.load_state_dict(state_dict, assign=True)
    return model.eval()


def _assert_trees_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k])
        else:
            assert a[k].dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("family", ["gpt2", "llama", "llama_tied", "gpt2_bf16"])
def test_trees_and_configs_are_jax_s(family, hf_gpt2, hf_llama):
    from cs744_pytorch_distributed_tutorial_tpu.models import hf_interop as J
    from cs744_pytorch_distributed_tutorial_tpu_torch.models import hf_interop as H

    if family.startswith("gpt2"):
        sd = hf_gpt2.state_dict()
        if family == "gpt2_bf16":
            sd = {k: v.to(torch.bfloat16) if v.is_floating_point() else v for k, v in sd.items()}
        _assert_trees_equal(H.lm_params_from_hf_gpt2(sd), J.lm_params_from_hf_gpt2(sd))
        assert H.gpt2_model_config(sd) == J.gpt2_model_config(sd)
        assert H.gpt2_model_config(sd, num_heads=4) == J.gpt2_model_config(sd, num_heads=4)
        if family == "gpt2_bf16":
            assert H.lm_params_from_hf_gpt2(sd)["tok_embed"]["embedding"].dtype == np.float32
            assert H.lm_state_dict_from_hf_gpt2(sd)["tok_embed.weight"].dtype == torch.float32
        return
    sd = hf_llama.state_dict()
    if family == "llama_tied":
        sd = {k: v for k, v in sd.items() if k != "lm_head.weight"}
    _assert_trees_equal(H.lm_params_from_hf_llama(sd), J.lm_params_from_hf_llama(sd))
    for kw in (dict(max_seq_len=64), dict(max_seq_len=32, rope_base=5e5, rms_norm_eps=1e-5)):
        assert H.llama_model_config(sd, 4, **kw) == J.llama_model_config(sd, 4, **kw)


def test_gpt2_logits_and_greedy_decode_meet_transformers(hf_gpt2):
    from cs744_pytorch_distributed_tutorial_tpu_torch.infer import make_generator
    from cs744_pytorch_distributed_tutorial_tpu_torch.models import hf_interop as H

    sd = hf_gpt2.state_dict()
    cfg = H.gpt2_model_config(sd)
    assert cfg["norm_eps"] == 1e-5 and cfg["tie_embeddings"] and cfg["attn_bias"]
    model = _port_lm(cfg, H.lm_state_dict_from_hf_gpt2(sd))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 16)))
    with torch.no_grad():
        got = model(tokens).numpy()
        want = hf_gpt2(tokens).logits.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    prompt = np.random.default_rng(1).integers(0, 256, (1, 8))
    ours = make_generator(model, max_new_tokens=6, temperature=0.0, device="cpu")(prompt)
    with torch.no_grad():
        hf = hf_gpt2.generate(torch.from_numpy(prompt), max_new_tokens=6, do_sample=False,
                              pad_token_id=0).numpy()[:, 8:]
    np.testing.assert_array_equal(ours.numpy(), hf)


def test_llama_logits_and_greedy_decode_meet_transformers(hf_llama):
    from cs744_pytorch_distributed_tutorial_tpu_torch.infer import make_generator
    from cs744_pytorch_distributed_tutorial_tpu_torch.models import hf_interop as H

    sd = hf_llama.state_dict()
    cfg = H.llama_model_config(sd, num_heads=4, max_seq_len=64)
    assert cfg["num_kv_heads"] == 2 and not cfg["tie_embeddings"]
    model = _port_lm(cfg, H.lm_state_dict_from_hf_llama(sd))
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, 128, (2, 16)))
    with torch.no_grad():
        got = model(tokens).numpy()
        want = hf_llama(tokens).logits.numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    prompt = np.random.default_rng(3).integers(0, 128, (1, 8))
    ours = make_generator(model, max_new_tokens=6, temperature=0.0, device="cpu")(prompt)
    with torch.no_grad():
        hf = hf_llama.generate(torch.from_numpy(prompt), max_new_tokens=6, do_sample=False,
                               pad_token_id=0).numpy()[:, 8:]
    np.testing.assert_array_equal(ours.numpy(), hf)


def test_llama_tied_checkpoint_loads_as_the_tied_model(hf_llama):
    from cs744_pytorch_distributed_tutorial_tpu_torch.models import hf_interop as H

    sd = {k: v for k, v in hf_llama.state_dict().items() if k != "lm_head.weight"}
    cfg = H.llama_model_config(sd, num_heads=4, max_seq_len=64)
    assert cfg["tie_embeddings"] is True
    converted = H.lm_state_dict_from_hf_llama(sd)
    assert not any(k.startswith("lm_head") for k in converted)
    model = _port_lm(cfg, converted)  # strict: every tensor of the tied model, no other
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, 128, (1, 8)))
    with torch.no_grad():
        logits = model(tokens)
    assert logits.shape == (1, 8, 128) and torch.isfinite(logits).all()


@pytest.mark.parametrize("fn,kw", [
    ("lm_params_from_hf_gpt2", {}), ("gpt2_model_config", {}),
    ("lm_params_from_hf_llama", {}), ("llama_model_config", {"num_heads": 2}),
])
def test_wrong_family_is_refused_as_jax_refuses_it(fn, kw, hf_gpt2, hf_llama):
    from cs744_pytorch_distributed_tutorial_tpu.models import hf_interop as J
    from cs744_pytorch_distributed_tutorial_tpu_torch.models import hf_interop as H

    other = hf_llama.state_dict() if "gpt2" in fn else hf_gpt2.state_dict()
    with pytest.raises(ValueError) as want:
        getattr(J, fn)(other, **kw)
    with pytest.raises(ValueError) as got:
        getattr(H, fn)(other, **kw)
    assert str(got.value) == str(want.value)


def test_config_refusals_are_jax_s(hf_gpt2, hf_llama):
    from cs744_pytorch_distributed_tutorial_tpu.models import hf_interop as J
    from cs744_pytorch_distributed_tutorial_tpu_torch.models import hf_interop as H

    cases = [("gpt2_model_config", hf_gpt2.state_dict(), {"num_heads": 3}),
             ("llama_model_config", hf_llama.state_dict(), {"num_heads": 1}),
             ("llama_model_config", hf_llama.state_dict(), {"num_heads": 3})]
    for fn, sd, kw in cases:
        with pytest.raises(ValueError) as want:
            getattr(J, fn)(sd, **kw)
        with pytest.raises(ValueError) as got:
            getattr(H, fn)(sd, **kw)
        assert str(got.value) == str(want.value)


def test_exported_from_the_models_package():
    from cs744_pytorch_distributed_tutorial_tpu_torch import models

    for name in ("gpt2_model_config", "llama_model_config", "lm_params_from_hf_gpt2",
                 "lm_params_from_hf_llama", "lm_state_dict_from_hf_gpt2",
                 "lm_state_dict_from_hf_llama"):
        assert name in models.__all__ and callable(getattr(models, name))
