"""Mixture-of-Experts FFN, the JAX package's ``models/moe.py::MoEFFN``,
on one device or expert-parallel over a mesh axis (``expert_axis``).

Called on ``x [B, T, d]`` in the compute dtype; returns the combined
expert outputs [B, T, d] (the caller adds them to the residual stream;
a dropped route rides the residual alone).

- **Router, in fp32** (parameters and arithmetic): ``nn.Linear(d, E,
  bias=False)`` on the tokens cast to fp32, softmax, ``topk``, and for
  k > 1 the chosen gates renormalised to sum to 1. A bf16 router, or a
  TF32 product, would flip top-k choices, so ``cast_for_decode_`` leaves
  it alone and the port computes fp32 products in full fp32.
- **Statistics for the trainer** (JAX ``:188-211``, ``:288``, ``:311``),
  kept as attributes after each call made with grad enabled: the Switch
  aux loss over all tokens, ``aux = E * sum_e f_e * P_e`` with ``f_e`` the
  share of tokens whose first choice is e and ``P_e`` the mean router
  probability (``aux_loss``); the normalised entropy of ``f``
  (``load_entropy``); the share of routes dropped for capacity
  (``drop_rate``, 0 for dropless). A no-grad call (prefill, decode,
  serving, eval) skips their dozen small launches and leaves them
  ``None``.
- **Dropless dispatch** (``dispatch_impl="dropless"``): the (token,
  choice) pairs sorted by expert (``argsort(stable=True)``, so within an
  expert the pairs keep batch order), the per-expert counts on the device
  (a ``scatter_add_`` into ``zeros(E)``: ``torch.bincount`` sizes its
  output from a ``max()`` on the host and would synchronise), the token
  rows gathered, two fused grouped matmuls (``ops/gmm.py``: gelu on
  ``w_in`` with ``b_in``, then ``w_out`` with ``b_out``; their backward
  the ``gmm``/``tgmm``/``colsum`` kernels), and the gate-weighted rows
  added back to their tokens in the compute dtype. Nothing here waits for
  the host.
- **Capacity slots** (``scatter``, the JAX default, and ``einsum``): the
  tokens in ``num_groups`` groups (0: about 1024 tokens a group; the
  largest divisor of B*T at most the request), ``capacity = max(1,
  ceil(k * n * capacity_factor / E))`` slots an expert a group, slot
  positions from a k-major cumsum (every token's first choice ranks
  before any second choice, so top-1 routes drop last), routes past the
  capacity dropped. ``scatter`` adds each kept route's token into its
  slot of a [G, E, C, d] buffer (a dropped route goes to a spare slot
  that is cut away) and gathers each route's slot output back, weighted
  by ``gate * keep``; ``einsum`` builds the one-hot dispatch and combine
  tensors [G, N, E, C] and contracts them. The expert FFN is a batched
  product ``[E, G*C, d] @ w_in`` plus ``b_in``, gelu, ``@ w_out`` plus
  ``b_out``, all in the compute dtype, as JAX computes it outside any
  kernel.
- **Experts** ``w_in [E, d, F]``, ``b_in [E, F]``, ``w_out [E, F, d]``,
  ``b_out [E, d]``: the kernels read ``[E, K, N]`` as it is; the biases
  stay fp32, since the kernel adds an fp32 bias.
- **Expert parallelism** (``expert_axis`` of ``expert_axis_size`` > 1
  ranks, the trainer's data axis, on ``mesh``): the parameters are drawn
  at the global [E, ...] shapes and the model keeps this rank's ``E / n``
  experts (``TransformerLM`` cuts them); the router stays whole. Each
  rank routes its own tokens into the [E, G*C, d] slot blocks, one tiled
  all-to-all (``parallel/collectives.py::AllToAll``, split dim 0, concat
  dim 1) hands every rank the slots of its experts from all ranks, the
  batched FFN runs on its local experts, and the inverse all-to-all
  sends the outputs home; autograd's transposes route the gradients, so
  an expert's gradient is the sum over its data row. ``dropless`` raises
  under expert parallelism, as in JAX.

The layer owns its init (``reset_parameters``) and its decode cast
(``cast_for_decode_``: only ``w_in``/``w_out`` move to the compute
dtype, the router and the biases stay fp32); ``TransformerLM`` hands
both to it and does not look inside.

Trap: flax's ``lecun_normal`` on a 3-D ``[E, fan_in, fan_out]`` kernel
counts E as a receptive field, so its fan_in is E * d (std 0.015625 for
``(8, 512, 1024)``, not 512**-0.5); ``reset_parameters`` draws from the
same truncated normal.

``gmm_impl``: ``auto`` and ``pallas`` take the fused grouped matmuls
(the CUDA kernels on CUDA tensors, their plain versions on CPU tensors);
``ragged`` is the JAX ``lax.ragged_dot`` path (``ops/gmm.py::ragged_dot``,
a plain product on either device, which reads the group offsets on the
host): each product rounded to the compute dtype, then the bias and the
gelu in it. Any number of experts runs on either path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cs744_pytorch_distributed_tutorial_tpu_torch.models.vgg import _lecun_normal_
from cs744_pytorch_distributed_tutorial_tpu_torch.obs.metrics import expert_load_entropy
from cs744_pytorch_distributed_tutorial_tpu_torch.ops.gmm import (
    grouped_matmul,
    grouped_matmul_fused,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.collectives import AllToAll

DISPATCH_IMPLS = ("einsum", "scatter", "dropless")
GMM_IMPLS = ("auto", "ragged", "pallas")
# The JAX defaults of the capacity knobs, which dropless must keep.
CAPACITY_FACTOR, NUM_GROUPS = 1.25, 1
TOKENS_PER_GROUP = 1024  # num_groups=0 picks about this many tokens a group


class MoEFFN(nn.Module):
    def __init__(self, d_model: int, num_experts: int, d_ff: int, *, top_k: int = 2,
                 capacity_factor: float = CAPACITY_FACTOR, num_groups: int = NUM_GROUPS,
                 dispatch_impl: str = "scatter", gmm_impl: str = "auto",
                 expert_axis: str | None = None, expert_axis_size: int = 1, mesh=None):
        super().__init__()
        e, k = num_experts, top_k
        if k < 1 or k > e:
            raise ValueError(f"top_k {k} must be in [1, {e}]")
        if dispatch_impl not in DISPATCH_IMPLS:
            raise ValueError(f"unknown dispatch_impl {dispatch_impl!r}; "
                             "choose 'einsum', 'scatter' or 'dropless'")
        dropless = dispatch_impl == "dropless"
        ep = expert_axis is not None and expert_axis_size > 1
        if dropless and (ep or expert_axis is not None):
            raise ValueError(
                "dispatch_impl='dropless' does not compose with expert_axis: EP's "
                "all_to_all needs static per-destination counts (capacity slots)")
        if dropless and (capacity_factor != CAPACITY_FACTOR or num_groups != NUM_GROUPS):
            raise ValueError(
                "dispatch_impl='dropless' ignores capacity_factor and num_groups (got "
                f"capacity_factor={capacity_factor}, num_groups={num_groups}); leave them "
                f"at the defaults ({CAPACITY_FACTOR}, {NUM_GROUPS})")
        if num_groups < 0:
            raise ValueError(f"num_groups must be >= 0, got {num_groups}")
        if e % (expert_axis_size if ep else 1):
            raise ValueError(f"num_experts {e} not divisible by expert axis {expert_axis_size}")
        if ep and mesh is None:
            raise ValueError(f"expert_axis={expert_axis!r} of size {expert_axis_size} needs a "
                             "parallel.mesh.Mesh (mesh=)")
        if gmm_impl not in GMM_IMPLS:
            raise ValueError(f"unknown gmm_impl {gmm_impl!r}; choose from {GMM_IMPLS}")
        self.num_experts, self.top_k, self.d_ff = e, k, d_ff
        self.expert_axis = expert_axis if ep else None
        self.mesh = mesh
        self.dispatch_impl, self.gmm_impl = dispatch_impl, gmm_impl
        self.capacity_factor, self.num_groups = capacity_factor, num_groups
        self.router = nn.Linear(d_model, e, bias=False)
        self.w_in = nn.Parameter(torch.empty(e, d_model, d_ff))
        self.b_in = nn.Parameter(torch.zeros(e, d_ff))
        self.w_out = nn.Parameter(torch.empty(e, d_ff, d_model))
        self.b_out = nn.Parameter(torch.zeros(e, d_model))
        self.aux_loss: torch.Tensor | None = None
        self.load_entropy: torch.Tensor | None = None
        self.drop_rate: torch.Tensor | None = None

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

    def capacity_groups(self, n_tokens: int) -> tuple[int, int]:
        """``(groups, capacity)`` for ``n_tokens`` tokens, as JAX derives
        them: the requested groups (0: about TOKENS_PER_GROUP tokens a
        group) cut to the largest divisor of ``n_tokens``, then the slots
        an expert has in each group."""
        g = self.num_groups or max(1, n_tokens // TOKENS_PER_GROUP)
        g = min(g, n_tokens)
        while n_tokens % g:
            g -= 1
        n = n_tokens // g
        return g, max(1, int(-(-(self.top_k * n * self.capacity_factor) // self.num_experts)))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        b, t, d = x.shape
        e, n = self.num_experts, b * t
        tokens = x.reshape(n, d)
        gates, topk_gate, topk_idx = self.route(tokens)

        # Switch aux loss and load entropy over all tokens, for a trainer
        # only. The first-choice counts come from a scatter-add (F.one_hot
        # checks its input's range on the host).
        stats = torch.is_grad_enabled()
        self.aux_loss = self.load_entropy = self.drop_rate = None
        if stats:
            top1 = torch.zeros(e, device=x.device).scatter_add_(
                0, topk_idx[:, 0], torch.ones(n, device=x.device)) / n
            self.aux_loss = e * (top1 * gates.mean(0)).sum()
            self.load_entropy = expert_load_entropy(top1)

        if self.dispatch_impl == "dropless":
            y = self._dropless(tokens, topk_gate, topk_idx, dtype)
            if stats:
                self.drop_rate = torch.zeros((), device=x.device)
        else:
            y, keep = self._capacity(tokens, topk_gate, topk_idx, dtype)
            if stats:
                self.drop_rate = 1.0 - keep.mean()
        return y.reshape(b, t, d).to(dtype)

    def _dropless(self, tokens, topk_gate, topk_idx, dtype):
        n, d = tokens.shape
        order, group_sizes, tok_ids = self.group_by_expert(topk_idx, self.num_experts)
        xs = tokens[tok_ids].to(dtype)
        if self.gmm_impl == "ragged":
            # XLA's ragged_dot, rounded to the compute dtype before the bias
            # and the gelu, which run in it (JAX's unfused path).
            sorted_e = topk_idx.reshape(-1)[order]
            h = grouped_matmul(xs, self.w_in.to(dtype), group_sizes, impl="ragged")
            h = F.gelu(h + self.b_in[sorted_e].to(h.dtype), approximate="tanh")
            out = grouped_matmul(h.to(dtype), self.w_out.to(dtype), group_sizes, impl="ragged")
            out = out + self.b_out[sorted_e].to(out.dtype)
        else:
            h = grouped_matmul_fused(xs, self.w_in.to(dtype), self.b_in, group_sizes,
                                     activation="gelu")
            out = grouped_matmul_fused(h, self.w_out.to(dtype), self.b_out, group_sizes)
        gate_flat = topk_gate.reshape(-1)[order].to(out.dtype)
        # With top-2 each token row receives two addends onto zero, and
        # a + b rounds the same in either order, so index_add_'s atomics
        # stay deterministic in bf16. With top_k > 2 the order would show.
        y = torch.zeros((n, d), dtype=out.dtype, device=tokens.device)
        y.index_add_(0, tok_ids, out * gate_flat[:, None])
        return y

    def _capacity(self, tokens, topk_gate, topk_idx, dtype):
        """The capacity-slot dispatch (``scatter`` or ``einsum``): ``(y [n,
        d] in dtype, keep [G, N, K])``."""
        n_tokens, d = tokens.shape
        e, k = self.num_experts, self.top_k
        g, cap = self.capacity_groups(n_tokens)
        n, dev = n_tokens // g, tokens.device
        idx = topk_idx.reshape(g, n, k)
        gate = topk_gate.reshape(g, n, k)
        onehot = torch.zeros((g, n, k, e), device=dev).scatter_(-1, idx[..., None], 1.0)
        flat = onehot.transpose(1, 2).reshape(g, k * n, e)  # k-major priority
        pos = (torch.cumsum(flat, dim=1) - 1.0).reshape(g, k, n, e).transpose(1, 2)
        pos_k = (pos * onehot).sum(-1)  # [G, N, K] slot of each route
        keep = (pos_k < cap).float()
        xg = tokens.to(dtype).reshape(g, n, d)
        if self.dispatch_impl == "scatter":
            # Each kept route owns one slot; a dropped one goes to the spare
            # slot C, cut away below.
            pos_i = pos_k.long()
            g_ar = torch.arange(g, device=dev)[:, None, None].expand(g, n, k)
            slot = torch.where(keep > 0, pos_i, cap)
            buf = torch.zeros((g, e, cap + 1, d), dtype=dtype, device=dev).index_put(
                (g_ar, idx, slot), xg[:, :, None, :].expand(g, n, k, d), accumulate=True)
            expert_in = buf[:, :, :cap].transpose(0, 1).reshape(e, g * cap, d)
        else:
            routed = onehot * keep[..., None]  # [G, N, K, E]
            slots = (pos_k.long()[..., None] == torch.arange(cap, device=dev)).float()
            dispatch = torch.einsum("gnke,gnkc->gnec", routed, slots)
            combine = torch.einsum("gnk,gnke,gnkc->gnec", gate, routed, slots)
            expert_in = torch.einsum("gnec,gnd->egcd", dispatch.to(dtype), xg).reshape(
                e, g * cap, d)

        if self.expert_axis is not None:
            # Experts -> tokens: this rank gets its experts' slots from all
            # ranks, [E_local, n*G*C, d].
            expert_in = AllToAll.apply(expert_in, self.mesh, self.expert_axis, 0, 1)
        h = torch.bmm(expert_in, self.w_in.to(dtype)) + self.b_in[:, None, :].to(dtype)
        h = F.gelu(h, approximate="tanh")
        out = torch.bmm(h, self.w_out.to(dtype)) + self.b_out[:, None, :].to(dtype)
        if self.expert_axis is not None:  # back to [E, G*C, d], this rank's tokens' slots
            out = AllToAll.apply(out, self.mesh, self.expert_axis, 1, 0)
        out = out.reshape(e, g, cap, d)

        if self.dispatch_impl == "scatter":
            picked = out.transpose(0, 1)[g_ar, idx, pos_i.clamp(0, cap - 1)]  # [G, N, K, d]
            y = (picked * (gate * keep).to(dtype)[..., None]).sum(2)
        else:
            y = torch.einsum("gnec,egcd->gnd", combine.to(dtype), out)
        return y.reshape(n_tokens, d), keep
