"""HuggingFace GPT-2 and Llama checkpoint import, ported from the JAX
package's ``models/hf_interop.py``.

A ``transformers`` ``GPT2LMHeadModel`` or ``LlamaForCausalLM``
``state_dict`` (any mapping of arrays: torch tensors, bf16 ones too, or
numpy) converts into the LM's weights. No ``transformers`` import is
needed; the tests build the HF models from configs in code.

- ``gpt2_model_config`` / ``llama_model_config``: the
  ``models/transformer.py::TransformerLM`` keyword arguments that match a
  checkpoint (dims from the tensors; GPT-2's conventions: learned
  positions, tied embeddings, LayerNorm eps 1e-5, biases on every
  projection, the tanh GELU; Llama's: RMSNorm, SwiGLU, RoPE, GQA with the
  KV head count from ``k_proj``'s width, tied when ``lm_head.weight`` is
  absent).
- ``lm_params_from_hf_gpt2`` / ``lm_params_from_hf_llama``: the JAX
  function's flax ``params`` tree of numpy arrays (GPT-2's fused
  ``c_attn`` [d, 3d] Conv1D split column-wise into q/k/v, Conv1D weights
  already ``[in, out]``; Llama's ``Linear`` weights transposed; the
  ``mlp_out`` bias as the separate ``mlp_out_bias``; Llama's absent
  ``mlp_in`` and ``mlp_out`` biases zero).
- ``lm_state_dict_from_hf_gpt2`` / ``lm_state_dict_from_hf_llama``: the
  port LM's ``state_dict``, the tree through
  ``models/convert.py::lm_params_from_jax``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _np(t: Any) -> np.ndarray:
    """Anything ``np.asarray`` reads; a torch tensor is detached, moved to
    the host and, if floating (bf16 and half have no numpy dtype),
    widened to float32."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.is_floating_point():
            t = t.float()
        t = t.numpy()
    return np.asarray(t)


def _require_layout(state_dict: Mapping[str, Any], sentinel: str, family: str) -> None:
    if sentinel not in state_dict:
        raise ValueError(
            f"no {sentinel.rsplit('.0.', 1)[0]}.{{i}} blocks found — not a {family} state_dict "
            "(expected transformers' key layout)")


def gpt2_model_config(state_dict: Mapping[str, Any], num_heads: int | None = None) -> dict:
    """The ``TransformerLM`` kwargs matching a GPT-2 ``state_dict``.
    ``num_heads`` is not recoverable from the shapes (``c_attn`` is [d,
    3d] for any head count): by default GPT-2's head_dim of 64."""
    _require_layout(state_dict, "transformer.h.0.ln_1.weight", "GPT2LMHeadModel")
    wte = _np(state_dict["transformer.wte.weight"])
    wpe = _np(state_dict["transformer.wpe.weight"])
    c_fc = _np(state_dict["transformer.h.0.mlp.c_fc.weight"])
    n_layers = 0
    while f"transformer.h.{n_layers}.ln_1.weight" in state_dict:
        n_layers += 1
    d_model = wte.shape[1]
    if num_heads is None:
        if d_model % 64:
            raise ValueError(
                f"d_model {d_model} is not a GPT-2-family width (expected a multiple of the "
                "fixed head_dim 64); pass num_heads explicitly")
        num_heads = d_model // 64
    elif d_model % num_heads:
        raise ValueError(f"num_heads {num_heads} does not divide d_model {d_model}")
    return dict(vocab_size=wte.shape[0], num_layers=n_layers, num_heads=num_heads,
                d_model=d_model, d_ff=c_fc.shape[1], max_seq_len=wpe.shape[0], use_rope=False,
                tie_embeddings=True, norm="layernorm", mlp="gelu", norm_eps=1e-5,
                attn_bias=True, attention_impl="dense")


def lm_params_from_hf_gpt2(state_dict: Mapping[str, Any]) -> dict:
    """A ``GPT2LMHeadModel.state_dict()`` -> the flax ``params`` tree of the
    matching LM (numpy arrays); the tied ``lm_head.weight`` is ignored."""
    _require_layout(state_dict, "transformer.h.0.ln_1.weight", "GPT2LMHeadModel")
    sd = state_dict
    params: dict = {
        "tok_embed": {"embedding": _np(sd["transformer.wte.weight"])},
        "pos_embed": {"embedding": _np(sd["transformer.wpe.weight"])},
        "ln_f": {"scale": _np(sd["transformer.ln_f.weight"]),
                 "bias": _np(sd["transformer.ln_f.bias"])},
    }
    i = 0
    while f"transformer.h.{i}.ln_1.weight" in sd:
        pre = f"transformer.h.{i}"
        d = _np(sd[f"{pre}.ln_1.weight"]).shape[0]
        ca_w = _np(sd[f"{pre}.attn.c_attn.weight"])
        ca_b = _np(sd[f"{pre}.attn.c_attn.bias"])
        if ca_w.shape != (d, 3 * d):
            raise ValueError(f"{pre}.attn.c_attn.weight has shape {ca_w.shape}, expected "
                             f"{(d, 3 * d)} — not a GPT-2 checkpoint?")
        params[f"block_{i}"] = {
            "ln1": {"scale": _np(sd[f"{pre}.ln_1.weight"]), "bias": _np(sd[f"{pre}.ln_1.bias"])},
            "ln2": {"scale": _np(sd[f"{pre}.ln_2.weight"]), "bias": _np(sd[f"{pre}.ln_2.bias"])},
            "attn": {
                "q": {"kernel": ca_w[:, :d], "bias": ca_b[:d]},
                "k": {"kernel": ca_w[:, d:2 * d], "bias": ca_b[d:2 * d]},
                "v": {"kernel": ca_w[:, 2 * d:], "bias": ca_b[2 * d:]},
                "attn_out": {"kernel": _np(sd[f"{pre}.attn.c_proj.weight"]),
                             "bias": _np(sd[f"{pre}.attn.c_proj.bias"])},
            },
            "mlp_in": {"kernel": _np(sd[f"{pre}.mlp.c_fc.weight"]),
                       "bias": _np(sd[f"{pre}.mlp.c_fc.bias"])},
            "mlp_out": {"kernel": _np(sd[f"{pre}.mlp.c_proj.weight"])},
            "mlp_out_bias": _np(sd[f"{pre}.mlp.c_proj.bias"]),
        }
        i += 1
    return params


def llama_model_config(state_dict: Mapping[str, Any], num_heads: int, max_seq_len: int = 2048,
                       rope_base: float = 10000.0, rms_norm_eps: float = 1e-6) -> dict:
    """The ``TransformerLM`` kwargs matching a ``LlamaForCausalLM``
    ``state_dict``; ``num_heads`` is required, ``max_seq_len``,
    ``rope_base`` and ``rms_norm_eps`` come from the HF config."""
    _require_layout(state_dict, "model.layers.0.input_layernorm.weight", "LlamaForCausalLM")
    embed = _np(state_dict["model.embed_tokens.weight"])
    d_model = embed.shape[1]
    if d_model % num_heads:
        raise ValueError(f"num_heads {num_heads} does not divide d_model {d_model}")
    head_dim = d_model // num_heads
    kv_width = _np(state_dict["model.layers.0.self_attn.k_proj.weight"]).shape[0]
    if kv_width % head_dim:
        raise ValueError(
            f"k_proj width {kv_width} is not a multiple of head_dim {head_dim} (d_model "
            f"{d_model} / num_heads {num_heads}) — wrong num_heads?")
    d_ff = _np(state_dict["model.layers.0.mlp.gate_proj.weight"]).shape[0]
    n_layers = 0
    while f"model.layers.{n_layers}.input_layernorm.weight" in state_dict:
        n_layers += 1
    return dict(vocab_size=embed.shape[0], num_layers=n_layers, num_heads=num_heads,
                num_kv_heads=kv_width // head_dim, d_model=d_model, d_ff=d_ff,
                max_seq_len=max_seq_len, use_rope=True, rope_base=rope_base,
                tie_embeddings="lm_head.weight" not in state_dict, norm="rmsnorm",
                mlp="swiglu", norm_eps=rms_norm_eps, attn_bias=False, attention_impl="dense")


def lm_params_from_hf_llama(state_dict: Mapping[str, Any]) -> dict:
    """A ``LlamaForCausalLM.state_dict()`` -> the flax ``params`` tree of the
    matching LM (numpy arrays): ``Linear`` weights transposed to ``[in,
    out]`` kernels, the ``mlp_in`` bias and ``mlp_out_bias`` zero."""
    _require_layout(state_dict, "model.layers.0.input_layernorm.weight", "LlamaForCausalLM")
    sd = state_dict
    params: dict = {
        "tok_embed": {"embedding": _np(sd["model.embed_tokens.weight"])},
        "ln_f": {"scale": _np(sd["model.norm.weight"])},
    }
    if "lm_head.weight" in sd:
        params["lm_head"] = {"kernel": _np(sd["lm_head.weight"]).T}
    i = 0
    while f"model.layers.{i}.input_layernorm.weight" in sd:
        pre = f"model.layers.{i}"

        def lin(name: str) -> np.ndarray:
            return _np(sd[f"{pre}.{name}.weight"]).T

        gate = lin("mlp.gate_proj")
        d_model, d_ff = gate.shape
        params[f"block_{i}"] = {
            "ln1": {"scale": _np(sd[f"{pre}.input_layernorm.weight"])},
            "ln2": {"scale": _np(sd[f"{pre}.post_attention_layernorm.weight"])},
            "attn": {
                "q": {"kernel": lin("self_attn.q_proj")},
                "k": {"kernel": lin("self_attn.k_proj")},
                "v": {"kernel": lin("self_attn.v_proj")},
                "attn_out": {"kernel": lin("self_attn.o_proj")},
            },
            "mlp_gate": {"kernel": gate},
            "mlp_in": {"kernel": lin("mlp.up_proj"), "bias": np.zeros(d_ff, np.float32)},
            "mlp_out": {"kernel": lin("mlp.down_proj")},
            "mlp_out_bias": np.zeros(d_model, np.float32),
        }
        i += 1
    return params


def lm_state_dict_from_hf_gpt2(state_dict: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A GPT-2 ``state_dict`` -> the port LM's (``gpt2_model_config``)."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import lm_params_from_jax

    return lm_params_from_jax(lm_params_from_hf_gpt2(state_dict))


def lm_state_dict_from_hf_llama(state_dict: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A Llama ``state_dict`` -> the port LM's (``llama_model_config``)."""
    from cs744_pytorch_distributed_tutorial_tpu_torch.models.convert import lm_params_from_jax

    return lm_params_from_jax(lm_params_from_hf_llama(state_dict))
