"""Speculative decoding: a draft model proposes, the target verifies,
ported from the JAX package's ``infer/speculative.py``.

Each round the draft proposes ``k`` tokens by ``k`` one-token decode
steps, and the target scores the last emitted token and the ``k``
proposals in one ``decode`` chunk of ``k + 1`` tokens (the model's
decode mode takes a chunk with a per-row causal mask). Greedy mode
(temperature 0) emits the longest prefix of proposals that equal the
target's argmax at their positions, then the target's own next token:
every emitted token is the target's argmax, so the output is plain
greedy decoding of the target for any draft. The chunked and the
one-token programs sum in different orders, so a near-tie can flip an
argmax between them (the caveat every speculative implementation has).
Rejection sampling (temperature > 0) accepts draft token ``x`` with
probability ``min(1, p(x) / q(x))``, the target's and the draft's
softmax at the temperature, and closes the round with a draw from the
residual ``norm(max(p - q, 0))`` at the first rejection, or from the
target's bonus row when all ``k`` were accepted: the output is
distributed as sampling from the target alone.

Both models write K/V at every position they are fed; rows of rejected
proposals go stale and are rewritten before they are read again, and
the decode mask hides rows past each query. After its ``k`` proposals
the draft is fed its last one too (the row at ``pos + k``), which a
fully accepted round resumes past.

The JAX generator is one ``lax.while_loop``; here the loop runs on the
host and fetches one number a round, the accepted count, and nothing a
draft token. Batch 1 only: a latency technique, and per-row acceptance
would need per-row cache offsets.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.infer.generate import (
    check_decode_model,
    model_device,
)


def make_speculative_generator(target_model: Any, draft_model: Any, *, max_new_tokens: int,
                               k: int = 4, temperature: float = 0.0, eos_id: int | None = None,
                               pad_id: int = 0, return_stats: bool = False,
                               generator: torch.Generator | None = None, device: str = "cuda"):
    """``generate(prompt [1, T0], generator=None) -> tokens [1,
    max_new_tokens]`` (int64, on the models' device), or ``(tokens,
    target_calls)`` with ``return_stats``: the verification chunks run
    (the accept rate is ``(max_new_tokens / target_calls - 1) / k``).
    ``target_model`` and ``draft_model`` are decode ``TransformerLM``s on
    ``device`` sharing the vocabulary. Greedy at temperature 0; above it,
    rejection sampling at that temperature (no top-k or top-p: truncation
    would break the identity the accept ratio rests on), its uniforms
    from ``generator`` (a per-call one overrides it; default seed 0 on
    the device). ``eos_id`` rewrites everything after the first EOS to
    ``pad_id``; the loop runs to ``max_new_tokens`` all the same.
    ``generate.timing`` holds the last call's ``prefill_s``, ``decode_s``
    and ``decode_steps`` (the target calls after the prefill)."""
    check_decode_model(target_model, "speculative decoding")
    check_decode_model(draft_model, "speculative decoding (draft)")
    if target_model.vocab_size != draft_model.vocab_size:
        raise ValueError(f"target vocab {target_model.vocab_size} != draft vocab "
                         f"{draft_model.vocab_size}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    dev = model_device(target_model, device)
    model_device(draft_model, device)
    sampling = temperature > 0.0
    default_gen = generator

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def categorical(logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        """One draw a row from softmax(logits) (Gumbel-max)."""
        u = torch.rand(logits.shape, generator=gen, device=dev)
        return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)

    def draft_propose(d_cache, last: torch.Tensor, pos: int, gen):
        """k draft tokens [k] fed from ``last`` at ``pos``, and for
        sampling their draft distributions [k, V]; the last proposal is
        fed too, at ``pos + k``."""
        toks, qs = [], []
        tok = last
        for i in range(k):
            logits = draft_model(tok.reshape(1, 1), "decode", decode_pos=pos + i,
                                 cache=d_cache)[0, 0].float()
            if sampling:
                qs.append(torch.softmax(logits / temperature, dim=-1))
                tok = categorical(logits / temperature, gen)
            else:
                tok = torch.argmax(logits, dim=-1)
            toks.append(tok)
        draft_model(tok.reshape(1, 1), "decode", decode_pos=pos + k, cache=d_cache)
        return torch.stack(toks), (torch.stack(qs) if sampling else None)

    @torch.no_grad()
    def generate(prompt, generator: torch.Generator | None = None):
        prompt = torch.as_tensor(np.asarray(prompt) if not torch.is_tensor(prompt) else prompt,
                                 dtype=torch.long, device=dev)
        b, t0 = prompt.shape
        if b != 1:
            raise ValueError("speculative decoding is batch-1 (a latency optimization; per-row "
                             f"acceptance would need scatter cache writes), got batch {b}")
        # The verification chunk reaches position pos + k; the last full
        # chunk starts at most at t0 + max_new_tokens - 1.
        need = t0 + max_new_tokens + k
        for name, model in (("target", target_model), ("draft", draft_model)):
            if need > model.max_seq_len:
                raise ValueError(f"prompt ({t0}) + max_new_tokens ({max_new_tokens}) + k ({k}) "
                                 f"exceeds {name} max_seq_len ({model.max_seq_len})")
        gen = generator or default_gen
        if gen is None and sampling:
            gen = torch.Generator(device=dev).manual_seed(0)
        t_start = time.perf_counter()
        t_cache = target_model.init_cache(1, device=dev)
        d_cache = draft_model.init_cache(1, device=dev)
        t_logits = target_model(prompt, "prefill", cache=t_cache)[0, -1].float()
        draft_model(prompt, "prefill", cache=d_cache)
        last = (categorical(t_logits / temperature, gen) if sampling
                else torch.argmax(t_logits, dim=-1))
        # Padded by k + 1 so a round can write its whole window.
        out = torch.full((max_new_tokens + k + 1,), pad_id, dtype=torch.long, device=dev)
        out[0] = last
        sync()
        t_prefill = time.perf_counter()
        n, calls = 1, 0
        while n < max_new_tokens:
            pos = t0 + n - 1  # the position of ``last``
            drafts, qs = draft_propose(d_cache, last, pos, gen)
            chunk = torch.cat([last.reshape(1), drafts])[None, :]
            # Row i of the chunk's logits predicts the token at pos + i + 1.
            v_logits = target_model(chunk, "decode", decode_pos=pos, cache=t_cache)[0].float()
            calls += 1
            if sampling:
                ps = torch.softmax(v_logits / temperature, dim=-1)  # [k+1, V]
                p_tok = ps[:k].gather(1, drafts[:, None])[:, 0]
                q_tok = qs.gather(1, drafts[:, None])[:, 0]
                u = torch.rand(k, generator=gen, device=dev)
                accept = u < torch.clamp(p_tok / q_tok.clamp(min=1e-20), max=1.0)
            else:
                greedy = torch.argmax(v_logits, dim=-1)  # [k+1]
                accept = drafts == greedy[:k]
            m = int(torch.cumprod(accept.long(), 0).sum())  # the round's one host fetch
            if sampling:
                # The residual at the first rejection; past a full acceptance
                # the bonus row p_k (its residual against a zero q).
                resid = ps[m] - (qs[m] if m < k else 0.0)
                resid = resid.clamp(min=0.0)
                resid = resid / resid.sum().clamp(min=1e-20)
                closing = categorical(torch.log(resid.clamp(min=1e-30)), gen)
            else:
                closing = greedy[m]
            out[n:n + m] = drafts[:m]
            out[n + m] = closing
            n, last = n + m + 1, closing
        tokens = out[:max_new_tokens]
        if eos_id is not None:
            is_eos = (tokens == eos_id).long()
            tokens = torch.where(torch.cumsum(is_eos, 0) - is_eos > 0, pad_id, tokens)
        sync()
        generate.timing = {"prefill_s": t_prefill - t_start,
                           "decode_s": time.perf_counter() - t_prefill, "decode_steps": calls}
        return (tokens[None, :], calls) if return_stats else tokens[None, :]

    generate.timing = None
    return generate
