"""Mixture-of-Experts FFN, the dropless path of the JAX package's
``models/moe.py::MoEFFN``.

Called on ``x [B, T, d]`` in the compute dtype; returns the combined
expert outputs [B, T, d] (the caller adds them to the residual stream).

- **Router, in fp32** (parameters and arithmetic): ``nn.Linear(d, E,
  bias=False)`` on the tokens cast to fp32, softmax, ``topk``, and for
  k > 1 the chosen gates renormalised to sum to 1. A bf16 router, or a
  TF32 product, would flip top-k choices, so ``cast_for_decode_`` leaves
  it alone and the port computes fp32 products in full fp32.
- **Switch aux loss and load entropy** (JAX ``:188-211``) over all
  tokens: ``aux = E * sum_e f_e * P_e`` with ``f_e`` the share of
  tokens whose first choice is e and ``P_e`` the mean router
  probability; the normalised entropy of ``f``. Kept as the attributes
  ``aux_loss`` and ``load_entropy`` after each call made with grad
  enabled, for the trainer of a later slice; a no-grad call (prefill,
  decode, serving) skips their dozen small launches and leaves them
  ``None``.
- **Dropless dispatch**: the (token, choice) pairs sorted by expert
  (``argsort(stable=True)``, so within an expert the pairs keep batch
  order), the per-expert counts on the device (a ``scatter_add_`` into
  ``zeros(E)``: ``torch.bincount`` sizes its output from a ``max()`` on
  the host and would synchronise), the token rows gathered, two fused
  grouped matmuls (``ops/gmm.py``: gelu on ``w_in`` with ``b_in``, then
  ``w_out`` with ``b_out``), and the gate-weighted rows added back to
  their tokens in the compute dtype. Nothing here waits for the host.
- **Experts** ``w_in [E, d, F]``, ``b_in [E, F]``, ``w_out [E, F, d]``,
  ``b_out [E, d]``: the kernels read ``[E, K, N]`` as it is; the biases
  stay fp32, since the kernel adds an fp32 bias.

The layer owns its init (``reset_parameters``) and its decode cast
(``cast_for_decode_``: only ``w_in``/``w_out`` move to the compute
dtype, the router and the biases stay fp32); ``TransformerLM`` hands
both to it and does not look inside.

Trap: flax's ``lecun_normal`` on a 3-D ``[E, fan_in, fan_out]`` kernel
counts E as a receptive field, so its fan_in is E * d (std 0.015625 for
``(8, 512, 1024)``, not 512**-0.5); ``reset_parameters`` draws from the
same truncated normal.

``dispatch_impl`` ``scatter`` (the JAX default) and ``einsum`` (capacity
slots) and ``gmm_impl="ragged"`` are not ported yet; ``auto`` and
``pallas`` take the CUDA kernel on CUDA tensors and its plain version on
CPU tensors.
"""

from __future__ import annotations

import torch
from torch import nn

from cs744_pytorch_distributed_tutorial_tpu_torch.models.vgg import _lecun_normal_
from cs744_pytorch_distributed_tutorial_tpu_torch.obs.metrics import expert_load_entropy
from cs744_pytorch_distributed_tutorial_tpu_torch.ops.gmm import grouped_matmul_fused

DISPATCH_IMPLS = ("einsum", "scatter", "dropless")
GMM_IMPLS = ("auto", "ragged", "pallas")
# The JAX defaults of the capacity knobs, which dropless must keep.
CAPACITY_FACTOR, NUM_GROUPS = 1.25, 1


class MoEFFN(nn.Module):
    def __init__(self, d_model: int, num_experts: int, d_ff: int, *, top_k: int = 2,
                 capacity_factor: float = CAPACITY_FACTOR, num_groups: int = NUM_GROUPS,
                 dispatch_impl: str = "scatter", gmm_impl: str = "auto",
                 expert_axis: str | None = None):
        super().__init__()
        e, k = num_experts, top_k
        if k < 1 or k > e:
            raise ValueError(f"top_k {k} must be in [1, {e}]")
        if dispatch_impl not in DISPATCH_IMPLS:
            raise ValueError(f"unknown dispatch_impl {dispatch_impl!r}; "
                             "choose 'einsum', 'scatter' or 'dropless'")
        if dispatch_impl != "dropless":
            raise NotImplementedError(
                f"MoE dispatch_impl={dispatch_impl!r} (capacity slots; 'scatter' is the "
                "JAX default) is not yet ported; use 'dropless'")
        if expert_axis is not None:
            raise ValueError(
                "dispatch_impl='dropless' does not compose with expert_axis: EP's "
                "all_to_all needs static per-destination counts (capacity slots)")
        if capacity_factor != CAPACITY_FACTOR or num_groups != NUM_GROUPS:
            raise ValueError(
                "dispatch_impl='dropless' ignores capacity_factor and num_groups (got "
                f"capacity_factor={capacity_factor}, num_groups={num_groups}); leave them "
                f"at the defaults ({CAPACITY_FACTOR}, {NUM_GROUPS})")
        if gmm_impl not in GMM_IMPLS:
            raise ValueError(f"unknown gmm_impl {gmm_impl!r}; choose from {GMM_IMPLS}")
        if gmm_impl == "ragged":
            raise NotImplementedError("MoE gmm_impl='ragged' (lax.ragged_dot) is not yet "
                                      "ported; 'auto' and 'pallas' take the CUDA kernel")
        self.num_experts, self.top_k, self.d_ff = e, k, d_ff
        self.router = nn.Linear(d_model, e, bias=False)
        self.w_in = nn.Parameter(torch.empty(e, d_model, d_ff))
        self.b_in = nn.Parameter(torch.zeros(e, d_ff))
        self.w_out = nn.Parameter(torch.empty(e, d_ff, d_model))
        self.b_out = nn.Parameter(torch.zeros(e, d_model))
        self.aux_loss: torch.Tensor | None = None
        self.load_entropy: torch.Tensor | None = None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's defaults: lecun-normal (truncated) with fan_in E * K for
        the [E, K, N] expert kernels and d for the router, zero biases."""
        e, d, f = self.w_in.shape
        _lecun_normal_(self.router.weight, d, generator)
        _lecun_normal_(self.w_in, e * d, generator)
        _lecun_normal_(self.w_out, e * f, generator)
        self.b_in.zero_()
        self.b_out.zero_()

    @torch.no_grad()
    def cast_for_decode_(self, dtype: torch.dtype) -> None:
        """Hold the expert kernels in the compute dtype; the router and the
        biases stay fp32."""
        self.w_in.data = self.w_in.data.to(dtype)
        self.w_out.data = self.w_out.data.to(dtype)

    def route(self, tokens: torch.Tensor):
        """The fp32 router on tokens [n, d]: ``(gates [n, E], topk_gate
        [n, k], topk_idx [n, k])``, the chosen gates renormalised for
        k > 1."""
        logits = tokens.float() @ self.router.weight.float().t()
        gates = torch.softmax(logits, dim=-1)
        topk_gate, topk_idx = torch.topk(gates, self.top_k, dim=-1)
        if self.top_k > 1:
            topk_gate = topk_gate / topk_gate.sum(-1, keepdim=True).clamp_min(1e-9)
        return gates, topk_gate, topk_idx

    @staticmethod
    def group_by_expert(topk_idx: torch.Tensor, num_experts: int):
        """The (token, choice) pairs sorted by expert: ``(order [n*k],
        group_sizes int32 [E], tok_ids [n*k])``, ``tok_ids`` the token row
        of each sorted pair. All on the device."""
        k = topk_idx.shape[-1]
        expert_flat = topk_idx.reshape(-1)
        order = torch.argsort(expert_flat, stable=True)
        group_sizes = torch.zeros(num_experts, dtype=torch.int32, device=topk_idx.device)
        group_sizes.scatter_add_(0, expert_flat, torch.ones_like(expert_flat, dtype=torch.int32))
        return order, group_sizes, order // k

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        b, t, d = x.shape
        e, n = self.num_experts, b * t
        tokens = x.reshape(n, d)
        gates, topk_gate, topk_idx = self.route(tokens)

        # Switch aux loss and load entropy over all tokens, for a trainer
        # only. The first-choice counts come from a scatter-add (F.one_hot
        # checks its input's range on the host).
        self.aux_loss = self.load_entropy = None
        if torch.is_grad_enabled():
            top1 = torch.zeros(e, device=x.device).scatter_add_(
                0, topk_idx[:, 0], torch.ones(n, device=x.device)) / n
            self.aux_loss = e * (top1 * gates.mean(0)).sum()
            self.load_entropy = expert_load_entropy(top1)

        order, group_sizes, tok_ids = self.group_by_expert(topk_idx, e)
        xs = tokens[tok_ids].to(dtype)
        h = grouped_matmul_fused(xs, self.w_in.to(dtype), self.b_in, group_sizes,
                                 activation="gelu")
        out = grouped_matmul_fused(h, self.w_out.to(dtype), self.b_out, group_sizes)
        gate_flat = topk_gate.reshape(-1)[order].to(out.dtype)
        # With top-2 each token row receives two addends onto zero, and
        # a + b rounds the same in either order, so index_add_'s atomics
        # stay deterministic in bf16. With top_k > 2 the order would show.
        y = torch.zeros((n, d), dtype=out.dtype, device=x.device)
        y.index_add_(0, tok_ids, out * gate_flat[:, None])
        return y.reshape(b, t, d).to(dtype)
