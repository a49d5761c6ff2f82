"""Beam search over the KV cache, ported from the JAX package's
``infer/beam.py``.

Batch ``B`` and ``K`` beams flatten to ``B*K`` rows for the model (row
``b*K + k``). Scores are accumulated fp32 log-probs. A finished beam
(it emitted ``eos_id``) may only continue with one candidate at zero
cost, the ``frozen`` distribution, so its score stops moving while live
beams compete; its token is rewritten to ``pad_id`` after selection.
After each step every tensor of each layer's ``KVCache`` (the int8
cache's scales included) is reordered by the parent beams with
``index_select`` over the flattened rows.

The JAX search is one jitted ``lax.scan``; here it is a Python loop over
the model's ``prefill`` and ``decode`` modes with no host fetch inside
it. Candidates are ranked by a stable descending sort, so equal scores
go to the lower index, as ``lax.top_k`` and ``argmax`` break ties: beam
1 is greedy decoding, token for token.

The tensor-parallel path (``mesh=``, ``param_specs=``) is
``infer/generate.py``'s: an ``LMTrainer.tp_decode_model()`` on every
rank of the mesh, each rank's cache at its ``Hkv / T`` heads (reordered
as above), the logits and so every top-k choice the same on the tensor
ranks, the prompt's rows split over the data axis and the tokens and
scores gathered back to the global [B, ...] on every rank.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.infer.generate import (
    check_decode_mesh,
    check_decode_model,
    data_rows,
    model_device,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import collectives as C
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.mesh import DATA_AXIS

_NEG = -1e30


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values of each row and their indices, ties to the
    lower index (``lax.top_k``'s order)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def make_beam_searcher(model: Any, *, beam_size: int, max_new_tokens: int,
                       eos_id: int | None = None, pad_id: int = 0, length_penalty: float = 0.0,
                       device: str = "cuda", mesh: Any = None, param_specs: Any = None):
    """``search(prompt [B, T0]) -> (tokens [B, max_new_tokens] int64,
    scores [B] fp32)`` for a decode ``TransformerLM`` on ``device``
    (``cuda``, or ``cpu`` when asked): the best beam a row after length
    normalisation (``score / len**length_penalty``, ``len`` the tokens up
    to and including the first EOS; 0.0 ranks by raw log-prob) and its raw
    accumulated log-prob. ``search.timing`` holds the last call's
    ``prefill_s``, ``decode_s`` and ``decode_steps`` on the host clock
    after a device synchronise. With ``mesh`` and ``param_specs``, the
    tensor-parallel path (the module docstring): every rank calls
    ``search`` with the same global prompt."""
    check_decode_model(model, "beam search", allow_tensor=mesh is not None)
    if beam_size < 1:
        raise ValueError(f"beam_size must be >= 1, got {beam_size}")
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if mesh is not None:
        check_decode_mesh(model, mesh, param_specs)
    dev = model_device(model, device)
    K = beam_size

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    @torch.no_grad()
    def search(prompt) -> tuple[torch.Tensor, torch.Tensor]:
        prompt = torch.as_tensor(np.asarray(prompt) if not torch.is_tensor(prompt) else prompt,
                                 dtype=torch.long, device=dev)
        if mesh is not None:
            prompt = data_rows(prompt, mesh)
        b, t0 = prompt.shape
        if t0 + max_new_tokens > model.max_seq_len:
            raise ValueError(f"prompt ({t0}) + max_new_tokens ({max_new_tokens}) exceeds "
                             f"max_seq_len ({model.max_seq_len})")
        t_start = time.perf_counter()
        cache = model.init_cache(b, device=dev)
        logp = torch.log_softmax(model(prompt, "prefill", cache=cache)[:, -1].float(), dim=-1)
        vocab = logp.shape[-1]
        k_eff = min(K, vocab)
        # First expansion: the prompt's K best next tokens.
        scores, tok0 = _top_k(logp, k_eff)  # [B, K]
        if k_eff < K:  # a beam wider than the vocabulary: pad with dead beams
            scores = torch.cat([scores, scores.new_full((b, K - k_eff), _NEG)], dim=1)
            tok0 = torch.cat([tok0, tok0.new_zeros((b, K - k_eff))], dim=1)
        # Row b's cache -> rows b*K .. b*K+K-1.
        for c in cache:
            for name in ("key", "value", "key_scale", "value_scale"):
                if getattr(c, name) is not None:
                    setattr(c, name, getattr(c, name).repeat_interleave(K, dim=0))
        sync()
        t_prefill = time.perf_counter()
        seqs = torch.full((b, K, max_new_tokens), pad_id, dtype=torch.long, device=dev)
        seqs[:, :, 0] = tok0
        finished = tok0 == (-1 if eos_id is None else eos_id)
        # A finished beam's one candidate: slot 0 at zero cost.
        frozen = torch.full((vocab,), _NEG, device=dev)
        frozen[0] = 0.0
        rows = torch.arange(b, device=dev)[:, None] * K
        last = tok0
        for step in range(1, max_new_tokens):
            # ``last`` was chosen at step - 1 and sits at position t0 + step - 1.
            # A finished beam's logits are not read (frozen below), so its
            # pad, which may lie outside the vocabulary, is fed clamped.
            fed = last.clamp(0, vocab - 1).reshape(b * K, 1)
            logits = model(fed, "decode", decode_pos=t0 + step - 1, cache=cache)
            logp = torch.log_softmax(logits[:, 0].float(), dim=-1).reshape(b, K, vocab)
            logp = torch.where(finished[:, :, None], frozen, logp)
            total = scores[:, :, None] + logp  # [B, K, V]
            scores, flat = _top_k(total.reshape(b, K * vocab), K)
            parent = flat // vocab  # [B, K] the beam each continues
            token = flat % vocab
            # A finished parent's only candidate was the frozen slot; it emits padding.
            parent_finished = torch.gather(finished, 1, parent)
            token = torch.where(parent_finished, pad_id, token)
            flat_parent = (rows + parent).reshape(-1)
            for c in cache:
                for name in ("key", "value", "key_scale", "value_scale"):
                    if getattr(c, name) is not None:
                        setattr(c, name, getattr(c, name).index_select(0, flat_parent))
            seqs = torch.gather(seqs, 1, parent[:, :, None].expand_as(seqs))
            seqs[:, :, step] = token
            finished = parent_finished
            if eos_id is not None:
                finished = finished | (token == eos_id)
            last = token
        # Length-normalised selection: the length runs up to and including EOS.
        if eos_id is not None:
            is_eos = seqs == eos_id
            first_eos = torch.argmax(is_eos.to(torch.int8), dim=-1)
            lengths = torch.where(is_eos.any(dim=-1), first_eos + 1, max_new_tokens)
        else:
            lengths = torch.full((b, K), max_new_tokens, device=dev)
        norm = scores / lengths.clamp(min=1).float() ** length_penalty
        best = torch.argmax(norm, dim=-1)  # [B]
        best_seq = torch.gather(seqs, 1, best[:, None, None].expand(b, 1, max_new_tokens))[:, 0]
        best_score = torch.gather(scores, 1, best[:, None])[:, 0]
        if mesh is not None:
            best_seq = C.axis_gather_rows(best_seq, mesh, DATA_AXIS)
            best_score = C.axis_gather_rows(best_score, mesh, DATA_AXIS)
        sync()
        search.timing = {"prefill_s": t_prefill - t_start,
                         "decode_s": time.perf_counter() - t_prefill,
                         "decode_steps": max_new_tokens - 1}
        return best_seq, best_score

    search.timing = None
    return search
