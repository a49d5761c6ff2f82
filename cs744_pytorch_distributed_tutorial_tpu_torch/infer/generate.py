"""Autoregressive generation: a prefill pass over the prompt, then one
decode step a token against a preallocated KV cache.

Port of the JAX package's ``infer/generate.py``. The JAX generator is
one jitted ``lax.scan``; here it is a Python loop over the model's
``prefill`` and ``decode`` modes with the cache of
``TransformerLM.init_cache`` updated in place, and the same semantics:
a row that emits ``eos_id`` is done and its later tokens are ``pad_id``,
and the loop runs ``max_new_tokens`` steps. The last sampled token is
not fed back, so a call makes ``max_new_tokens`` model calls (one
prefill and ``max_new_tokens - 1`` decode steps).

Sampling is ``sample_tokens``: greedy at temperature 0, else the logits
over the temperature, masked by top-k and then top-p in the JAX order,
and one draw by the Gumbel-max rule from uniforms the caller gives.
``jax.random`` cannot be reproduced in PyTorch, so only greedy decoding
is held token for token against JAX; ``make_generator`` draws its
uniforms from a ``torch.Generator``, and the serving engine from
``stream_uniforms``, a counter-based hash keyed by (seed, request,
token index) that gives the same numbers on every device.

The tensor-parallel path (``mesh=``, ``param_specs=``; JAX's
``_shard_map_decode``): the model is an ``LMTrainer.tp_decode_model()``,
this rank's slices of the weights on a ``parallel/mesh.py::Mesh``, every
rank runs the loop, and each projects and caches only its ``H / T``
query and ``Hkv / T`` KV heads; the two sums a layer keep the logits,
and so every decision, the same on the tensor ranks. The prompt's rows
split over the data axis (replicated over the others) and every rank
returns the global [B, N] tokens (an all-gather over data). A sampled
row draws from a generator seeded from (the caller's generator, the
rank's data coordinate), JAX's ``fold_in``: tensor ranks draw the same
numbers, data shards different ones. ``param_specs`` must be the
model's (``LMTrainer.param_specs``): the port's modules carry their
slices, so it is checked, not used.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.config import resolve_device
from cs744_pytorch_distributed_tutorial_tpu_torch.models.transformer import _key_seed
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import collectives as C
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.mesh import DATA_AXIS, TENSOR_AXIS

_NEG = -1e30  # the mask value: exp() underflows to exactly 0.0, no NaNs
_M32 = 0xFFFFFFFF


def check_decode_model(model: Any, what: str, allow_tensor: bool = False) -> None:
    """A decode model is a ``TransformerLM`` (``init_cache``, the decode
    modes) with no sequence axis: the KV cache holds the whole sequence.
    A tensor axis is allowed only on the mesh path (``allow_tensor``,
    ``mesh=`` given to the decoders): each rank then caches its heads and
    the sums a layer keep the logits the same on every tensor rank. The
    JAX ``check_decode_model``, its messages too."""
    if not hasattr(model, "init_cache"):
        raise TypeError(f"{what} needs a TransformerLM, got {type(model).__name__}")
    if getattr(model, "seq_size", 1) > 1:
        raise ValueError(
            f"{what} needs a model with seq_axis=None; construct a decode "
            "copy of the model (same dims) — trained params drop in directly"
        )
    if getattr(model, "tensor_size", 1) > 1 and not allow_tensor:
        raise ValueError(
            f"{what} with a tensor-parallel model needs the shard_map path: "
            "pass mesh= and param_specs= (see LMTrainer.tp_decode_model), or "
            "construct a decode copy with tensor_axis=None from gathered "
            "full params"
        )


def check_decode_mesh(model: Any, mesh: Any, param_specs: Any) -> None:
    """The mesh path's checks (JAX ``_shard_map_decode``'s, with its
    messages): ``param_specs`` given and the model's, and a mesh that
    carries the model's tensor axis, laid out as the model's."""
    if param_specs is None:
        raise ValueError("the shard_map decode path needs param_specs")
    tensor = getattr(model, "tensor_size", 1)
    sizes = dict(getattr(mesh, "sizes", {}))
    if tensor == 1 or sizes.get(TENSOR_AXIS) != tensor:
        axis = TENSOR_AXIS if tensor > 1 else None
        raise ValueError(f"mesh {sizes} does not carry the model's tensor axis {axis!r}")
    if sizes != model.mesh.sizes:
        raise ValueError(f"mesh {sizes} is not the model's mesh {model.mesh.sizes}")
    if param_specs != model.param_specs:
        raise ValueError("param_specs are not the model's slices: pass the LMTrainer.param_specs "
                         "of the trainer whose tp_decode_model() this is")


def data_rows(x: torch.Tensor, mesh: Any) -> torch.Tensor:
    """This rank's rows of a global batch on the mesh path: the batch cut
    over the data axis (JAX's ``PartitionSpec(data)``), the whole of it on
    a data axis of one."""
    n = mesh.size(DATA_AXIS)
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} not divisible by the data axis ({n})")
    b, i = x.shape[0] // n, mesh.axis_index(DATA_AXIS)
    return x[i * b:(i + 1) * b]


def shard_generator(gen: torch.Generator, mesh: Any, device: torch.device) -> torch.Generator:
    """A generator for this rank's data shard: seeded from one draw of
    ``gen`` (the same on every rank) and the rank's data coordinate (JAX's
    ``fold_in(key, axis_index(data))``), so tensor ranks draw the same
    numbers and data shards different ones; ``gen`` itself on a data axis
    of one."""
    if mesh.size(DATA_AXIS) == 1:
        return gen
    seed = int(torch.randint(0, 2**62, (1,), generator=gen, device=gen.device))
    return torch.Generator(device=device).manual_seed(
        _key_seed((seed, mesh.axis_index(DATA_AXIS))))


def model_device(model: torch.nn.Module, device: str | torch.device) -> torch.device:
    """``device`` resolved (``cuda`` without a GPU raises), and the model's
    weights checked to lie there."""
    dev = resolve_device(str(device))
    where = next(model.parameters()).device
    if where.type != dev.type:
        raise ValueError(f"the model is on {where}, but device {str(device)!r} was asked for")
    return where


def sample_tokens(logits: torch.Tensor, uniforms: torch.Tensor | None = None, *,
                  temperature: float = 1.0, top_k: int | None = None,
                  top_p: float | None = None) -> torch.Tensor:
    """Token ids [B] from logits [B, V]. Temperature 0 is greedy argmax
    (``uniforms`` unused). Otherwise top-k keeps the k highest logits,
    top-p then the smallest set whose probability reaches p (the top
    token always kept), both by masking, and the draw is
    ``argmax(logits + Gumbel(uniforms))`` with ``uniforms`` [B, V] in
    [0, 1)."""
    logits = logits.float()
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k is not None:
        if top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits >= kth, logits, _NEG)
    if top_p is not None:
        if not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        # Keep a sorted position while the mass before it is < p.
        kept = torch.cumsum(probs, dim=-1) - probs < top_p
        cutoff = torch.where(kept, sorted_logits, torch.inf).amin(dim=-1, keepdim=True)
        logits = torch.where(logits >= cutoff, logits, _NEG)
    if uniforms is None:
        raise ValueError("sampling at temperature > 0 needs uniforms")
    gumbel = -torch.log(-torch.log(uniforms.float()))
    return torch.argmax(logits + gumbel, dim=-1)


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash of int64 values in [0, 2**32) (products stay
    below 2**63, so nothing overflows)."""
    x = ((x >> 16) ^ x) * 0x45D9F3B & _M32
    x = ((x >> 16) ^ x) * 0x45D9F3B & _M32
    return (x >> 16) ^ x


def stream_uniforms(seed: int, req_ids: torch.Tensor, tok_idx: torch.Tensor,
                    vocab: int) -> torch.Tensor:
    """[B, vocab] uniforms in (0, 1) for token ``tok_idx[b]`` of request
    ``req_ids[b]``: a pure function of (seed, request, token index, vocab
    id), so a request's token t is drawn from the same numbers whenever
    and in whichever slot it is produced, on any device."""
    key = _hash32(torch.full_like(req_ids, seed, dtype=torch.long) & _M32)
    key = _hash32(key ^ (req_ids.long() & _M32))
    key = _hash32(key ^ (tok_idx.long() & _M32))
    ids = _hash32(torch.arange(vocab, device=req_ids.device, dtype=torch.long))
    bits = _hash32(key[:, None] ^ ids[None, :])
    return ((bits >> 8).float() + 0.5) * 2.0**-24


def make_generator(model: Any, *, max_new_tokens: int, temperature: float = 1.0,
                   top_k: int | None = None, top_p: float | None = None,
                   eos_id: int | None = None, pad_id: int = 0,
                   generator: torch.Generator | None = None, device: str = "cuda",
                   mesh: Any = None, param_specs: Any = None):
    """``generate(prompt [B, T0], generator=None) -> [B, max_new_tokens]``
    int64 token ids on the model's device, for a ``TransformerLM`` on
    ``device`` (``cuda``, or ``cpu`` when asked). Sampled tokens draw
    their uniforms from ``generator`` (a per-call one overrides it;
    default seed 0 on the device). ``generate.timing`` holds the last
    call's ``prefill_s``, ``decode_s`` and ``decode_steps``, on the host
    clock after a device synchronise. With ``mesh`` and ``param_specs``
    the model is a ``tp_decode_model()`` and every rank of the mesh calls
    ``generate`` with the same global prompt (the module docstring)."""
    check_decode_model(model, "generation", allow_tensor=mesh is not None)
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if mesh is not None:
        check_decode_mesh(model, mesh, param_specs)
    dev = model_device(model, device)
    default_gen = generator

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    @torch.no_grad()
    def generate(prompt, generator: torch.Generator | None = None) -> torch.Tensor:
        prompt = torch.as_tensor(np.asarray(prompt) if not torch.is_tensor(prompt) else prompt,
                                 dtype=torch.long, device=dev)
        b, t0 = prompt.shape
        if t0 + max_new_tokens > model.max_seq_len:
            raise ValueError(
                f"prompt ({t0}) + max_new_tokens ({max_new_tokens}) exceeds max_seq_len "
                f"({model.max_seq_len}), the cache and positions size"
            )
        gen = generator or default_gen
        if gen is None and temperature != 0.0:
            gen = torch.Generator(device=dev).manual_seed(0)
        if mesh is not None:
            prompt = data_rows(prompt, mesh)
            b = prompt.shape[0]
            if gen is not None:
                gen = shard_generator(gen, mesh, dev)
        t_start = time.perf_counter()
        cache = model.init_cache(b, device=dev)
        logits = model(prompt, "prefill", cache=cache)[:, -1]
        sync()
        t_prefill = time.perf_counter()
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        out = torch.empty((b, max_new_tokens), dtype=torch.long, device=dev)
        for i in range(max_new_tokens):
            u = None
            if temperature != 0.0:
                u = torch.rand(logits.shape, generator=gen, device=dev)
            tok = sample_tokens(logits, u, temperature=temperature, top_k=top_k, top_p=top_p)
            tok = torch.where(done, pad_id, tok)
            if eos_id is not None:
                done = done | (tok == eos_id)
            out[:, i] = tok
            if i + 1 < max_new_tokens:
                logits = model(tok[:, None], "decode", decode_pos=t0 + i, cache=cache)[:, 0]
        if mesh is not None:
            out = C.axis_gather_rows(out, mesh, DATA_AXIS)
        sync()
        generate.timing = {"prefill_s": t_prefill - t_start,
                           "decode_s": time.perf_counter() - t_prefill,
                           "decode_steps": max_new_tokens - 1}
        return out

    generate.timing = None
    return generate
