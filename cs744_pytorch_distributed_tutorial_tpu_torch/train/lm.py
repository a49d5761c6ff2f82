"""LM training engine on one device, ported from the JAX package's
``train/lm.py`` at a data, sequence and tensor axis of size 1.

A step: the model's forward on [B, T] token ids (``models/
transformer.py``; bf16 compute when ``compute_dtype="bfloat16"``, by
explicit casts inside each module, fp32 parameters, fp32 logits), the
mean cross-entropy (the JAX ``_smoothed_xent``, label smoothing
included; with ``fused_xent`` the CUDA kernels of ``ops/fused_xent.py``,
which compute plain CE, so label smoothing then raises), ``backward()``,
and the optimizer update (``adamw``, ``sgd`` or ``lion`` at a constant,
warmup or cosine lr, behind an optional global-norm clip, with optax's
semantics; ``train/state.py::make_lm_optimizer``). The
step returns ``{loss, grad_norm, param_norm}`` as 0-d tensors on the
device: the global L2 norms of the gradient and of the updated
parameters.

With ``moe_experts > 0`` each block's FFN is a routed ``MoEFFN``
(``models/moe.py``; dispatch ``scatter``, the JAX default, ``einsum`` or
``dropless``, the grouped-matmul kernels), the objective is ``ce +
moe_aux_coef * sum of the layers' Switch aux losses`` (JAX
``train/lm.py:1009-1021``; ``loss`` is that total) and the step also
returns ``moe_aux`` (the sum over layers), ``moe_drop`` and
``moe_load_entropy`` (each the mean over layers).

``fit`` follows the JAX batch plan (batch k starts at sequence
``(k * B) % max(N - B + 1, 1)``), records every step metric in
``history`` and stops on a non-finite loss.

For generation and serving, ``decode_model`` and
``quantized_decode_model`` build a decode copy of the model (dense
attention for the prompt pass, the float weights already in the compute
dtype, int8 projections and/or an int8 KV cache on request) from the
trainer's weights or from a ``state_dict``; ``quantize_for_decode``
makes the int8 ``state_dict`` and ``gather_for_decode`` is the identity
on one device.

Options of later slices raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.config import resolve_device, resolve_dtype
from cs744_pytorch_distributed_tutorial_tpu_torch.models.transformer import (
    ATTENTION_IMPLS,
    TransformerLM,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.ops.fused_xent import fused_cross_entropy
from cs744_pytorch_distributed_tutorial_tpu_torch.ops.quant import (
    quantize_lm_params,
    resolve_quant_modules,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.train.engine import _smoothed_xent
from cs744_pytorch_distributed_tutorial_tpu_torch.train.state import (
    check_recipe,
    make_lm_optimizer,
)


class NonFiniteLossError(RuntimeError):
    def __init__(self, step: int, loss: float):
        super().__init__(f"non-finite loss {loss} at step {step}")
        self.step, self.loss = step, loss


@dataclasses.dataclass
class LMConfig:
    """Model dims and training recipe, with the JAX package's names and
    defaults, plus ``device``."""

    vocab_size: int = 1024
    num_layers: int = 2
    num_heads: int = 8
    d_model: int = 128
    d_ff: int = 512
    max_seq_len: int = 2048
    attention_impl: str = "ring"  # ring | ulysses | ulysses_flash | dense | flash
    compute_dtype: str = "float32"
    tie_embeddings: bool = False
    norm: str = "layernorm"
    mlp: str = "gelu"
    use_rope: bool = False
    num_kv_heads: int | None = None

    # MoE (models/moe.py): moe_experts > 0 swaps each block's dense FFN
    # for a routed expert mixture; moe_aux_coef weighs its aux loss.
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_groups: int = 1
    moe_dispatch: str = "scatter"  # einsum | scatter | dropless
    moe_gmm_impl: str = "auto"  # auto | ragged | pallas
    moe_aux_coef: float = 0.01
    # The CUDA fused softmax-CE (ops/fused_xent.py): one pass over the
    # logits, no [N, V] log-softmax. Incompatible with label smoothing.
    fused_xent: bool = False

    global_batch_size: int = 8
    seq_len: int = 256
    learning_rate: float = 1e-3
    seed: int = 0
    optimizer: str = "adamw"  # "adamw" | "sgd" | "lion"
    lr_schedule: str = "constant"  # | "cosine" | "warmup_cosine"
    warmup_steps: int = 0
    # cosine schedules need total_steps, warmup ramps linearly from 0 first.
    total_steps: int | None = None
    grad_clip_norm: float | None = None
    momentum: float = 0.9  # adamw b1; sgd momentum
    weight_decay: float = 1e-4
    label_smoothing: float = 0.0
    halt_on_nonfinite: bool = True

    # Options of later slices, accepted only at their "off" value.
    data_parallel: int = 1
    seq_parallel: int = 1
    tensor_parallel: int = 1
    moe_expert_parallel: bool = False
    grad_compress: str = "none"
    sync_overlap: str = "off"
    remat: bool = False
    zero1: bool = False
    fsdp: bool = False
    scan_layers: bool = False
    dropout_rate: float = 0.0
    accum_steps: int = 1
    checkpoint_dir: str | None = None
    snapshot_every: int = 0
    step_timeout_s: float | None = None
    metrics_dir: str | None = None
    profile_dir: str | None = None

    # "cuda" (default) or "cpu".
    device: str = "cuda"

    def replace(self, **kw: Any) -> "LMConfig":
        return dataclasses.replace(self, **kw)


_LATER_FIELDS = (
    "data_parallel", "seq_parallel", "tensor_parallel", "moe_expert_parallel", "grad_compress", "sync_overlap", "remat", "zero1", "fsdp", "scan_layers", "dropout_rate",
    "accum_steps", "checkpoint_dir", "snapshot_every", "step_timeout_s", "metrics_dir",
    "profile_dir",
)


def _check_config(cfg: LMConfig) -> None:
    off = LMConfig()
    for name in _LATER_FIELDS:
        if getattr(cfg, name) != getattr(off, name):
            raise NotImplementedError(f"{name}={getattr(cfg, name)!r} is not yet ported")
    if cfg.attention_impl not in ATTENTION_IMPLS:
        raise ValueError(
            f"unknown attention_impl {cfg.attention_impl!r}; choose from {ATTENTION_IMPLS}"
        )
    if cfg.seq_len > cfg.max_seq_len:
        raise ValueError(f"seq_len {cfg.seq_len} exceeds max_seq_len {cfg.max_seq_len}")
    if not 0.0 <= cfg.label_smoothing < 1.0:
        raise ValueError(f"label_smoothing must be in [0, 1), got {cfg.label_smoothing}")
    check_recipe(cfg)
    if cfg.label_smoothing and cfg.fused_xent:
        raise ValueError("label_smoothing is incompatible with fused_xent: the fused kernel "
                         "computes plain CE")


def _global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every element's square, in fp32."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class LMTrainer:
    """``TransformerLM`` training on one device: ``init``, ``split_batch``,
    ``train_step``, ``eval_step``, ``evaluate`` and ``fit``."""

    def __init__(self, cfg: LMConfig):
        _check_config(cfg)
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.dtype = resolve_dtype(cfg.compute_dtype)
        self.model: TransformerLM | None = None
        self.optimizer = None

    def init(self, seed: int | None = None, state_dict: dict | None = None):
        """Build the model (parameters from ``seed``, default
        ``cfg.seed``, or loaded from ``state_dict``) and its optimizer;
        returns ``(model, optimizer)``."""
        cfg = self.cfg
        gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
        self.model = TransformerLM(
            **self._model_kw(), attention_impl=cfg.attention_impl, generator=gen,
        ).to(self.device)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self.optimizer = make_lm_optimizer(self.cfg, list(self.model.parameters()))
        return self.model, self.optimizer

    def _model_kw(self) -> dict:
        cfg = self.cfg
        return dict(
            vocab_size=cfg.vocab_size, num_layers=cfg.num_layers, num_heads=cfg.num_heads,
            d_model=cfg.d_model, d_ff=cfg.d_ff, max_seq_len=cfg.max_seq_len, dtype=self.dtype,
            tie_embeddings=cfg.tie_embeddings, use_rope=cfg.use_rope,
            num_kv_heads=cfg.num_kv_heads, norm=cfg.norm, mlp=cfg.mlp,
            num_experts=cfg.moe_experts, moe_top_k=cfg.moe_top_k,
            moe_capacity_factor=cfg.moe_capacity_factor, moe_num_groups=cfg.moe_groups,
            moe_dispatch=cfg.moe_dispatch, moe_gmm_impl=cfg.moe_gmm_impl,
        )

    def gather_for_decode(self, params: dict | None = None) -> dict:
        """The full weights for a decode copy: ``params``, or the trainer's
        model's ``state_dict`` (built by ``init()`` if there is none yet).
        One device holds them whole, so nothing is gathered."""
        if params is not None:
            return params
        if self.model is None:
            self.init()
        return self.model.state_dict()

    def _decode_copy(self, params: dict, **options) -> TransformerLM:
        """A ``TransformerLM`` with dense attention for the prompt pass,
        built without an init and loaded with copies of ``params`` on the
        trainer's device, its float weights cast to the compute dtype."""
        with torch.device("meta"):
            model = TransformerLM(**self._model_kw(), attention_impl="dense", **options)
        model.load_state_dict(
            {k: v.detach().to(self.device, copy=True) for k, v in params.items()}, assign=True)
        return model.cast_for_decode_()

    def decode_model(self, params: dict | None = None, *, kv_cache: bool = False) -> TransformerLM:
        """The decode copy for ``infer/generate.py`` and ``serve/`` (the
        JAX ``decode_model``; with ``kv_cache=True`` its
        ``clone(quant_kv_cache=True)``), holding ``params`` (a float
        ``state_dict``, default the trainer's weights)::

            trainer.fit(tokens, steps)
            generate = make_generator(trainer.decode_model(), max_new_tokens=64,
                                      temperature=0.8)
            out = generate(prompt)
        """
        return self._decode_copy(self.gather_for_decode(params), quant_kv_cache=kv_cache)

    def quantized_decode_model(self, modules: str = "head", kv_cache: bool = False,
                               params: dict | None = None) -> TransformerLM:
        """``decode_model`` with int8 projections (``ops/quant.py``): scope
        ``head`` (default) quantizes ``lm_head`` only, ``all`` every
        projection; ``kv_cache=True`` also stores the KV cache int8.
        ``params`` is a ``quantize_for_decode(..., modules)`` ``state_dict``
        (default: the trainer's weights, quantized). With tied embeddings
        there is no ``lm_head``, so scope ``head`` gives the KV-only model
        when ``kv_cache`` is set and raises otherwise, as in JAX."""
        if self.cfg.tie_embeddings and modules == "head":
            if kv_cache:
                return self.decode_model(params, kv_cache=True)
            raise ValueError(
                "int8-decode scope 'head' is a no-op with tied embeddings (no lm_head "
                "exists; the embedding head stays float): use modules='all', or "
                "kv_cache=True, which needs no weight scope"
            )
        if params is None:
            params = self.quantize_for_decode(self.gather_for_decode(), modules)
        return self._decode_copy(params, quant_dense=True,
                                 quant_modules=resolve_quant_modules(modules),
                                 quant_kv_cache=kv_cache)

    @staticmethod
    def quantize_for_decode(params: dict, modules: str = "head") -> dict:
        """A float ``state_dict`` -> the int8 one a
        ``quantized_decode_model(modules)`` loads (``ops/quant.py::
        quantize_lm_params``)."""
        return quantize_lm_params(params, resolve_quant_modules(modules))

    def split_batch(self, tokens) -> tuple[torch.Tensor, torch.Tensor]:
        """[B, seq_len + 1] tokens -> (inputs [:, :-1], targets [:, 1:]) as
        int64 tensors on the device."""
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int64)
        tokens = tokens.to(self.device, non_blocking=True)
        return tokens[:, :-1], tokens[:, 1:]

    def _loss(self, inputs: torch.Tensor, targets: torch.Tensor, smoothing: float,
              fused: bool = False):
        logits = self.model(inputs)
        v = logits.shape[-1]
        if fused:
            return fused_cross_entropy(logits.reshape(-1, v), targets.reshape(-1)).mean()
        return _smoothed_xent(logits.reshape(-1, v), targets.reshape(-1), smoothing)

    def _moe_stats(self) -> dict[str, torch.Tensor]:
        """The MoE layers' statistics of the last forward made with grad:
        ``moe_aux`` summed over layers, ``moe_drop`` and
        ``moe_load_entropy`` averaged (JAX ``moe_aux_loss`` and
        ``sown_scalar_mean``)."""
        layers = [b.moe for b in self.model.blocks]
        return {
            "moe_aux": torch.stack([m.aux_loss for m in layers]).sum(),
            "moe_drop": torch.stack([m.drop_rate for m in layers]).mean(),
            "moe_load_entropy": torch.stack([m.load_entropy for m in layers]).mean(),
        }

    def train_step(self, inputs: torch.Tensor, targets: torch.Tensor) -> dict[str, torch.Tensor]:
        params = list(self.model.parameters())
        for p in params:
            p.grad = None
        loss = self._loss(inputs, targets, self.cfg.label_smoothing, fused=self.cfg.fused_xent)
        moe = self._moe_stats() if self.cfg.moe_experts > 0 else {}
        if moe:
            loss = loss + self.cfg.moe_aux_coef * moe["moe_aux"]
        loss.backward()
        grad_norm = _global_norm([p.grad for p in params])
        self.optimizer.step()
        with torch.no_grad():
            param_norm = _global_norm(params)
        return {"loss": loss.detach(), "grad_norm": grad_norm, "param_norm": param_norm,
                **{k: v.detach() for k, v in moe.items()}}

    @torch.no_grad()
    def eval_step(self, inputs: torch.Tensor, targets: torch.Tensor) -> dict[str, torch.Tensor]:
        """Plain mean cross-entropy (no label smoothing, and not the fused
        kernel, as the JAX ``local_eval``)."""
        return {"loss": self._loss(inputs, targets, 0.0)}

    def evaluate(self, tokens) -> dict[str, float]:
        """Mean next-token cross-entropy and perplexity over ``tokens``
        [N, seq_len + 1], in batches of ``global_batch_size``; a ragged
        tail is dropped."""
        b = self.cfg.global_batch_size
        n_batches = len(tokens) // b
        if n_batches == 0:
            raise ValueError(f"need at least global_batch_size={b} sequences, got {len(tokens)}")
        total = 0.0
        for i in range(n_batches):
            x, y = self.split_batch(tokens[i * b : (i + 1) * b])
            total += float(self.eval_step(x, y)["loss"])
        mean_loss = total / n_batches
        return {"loss": mean_loss, "perplexity": math.exp(mean_loss)}

    def fit(self, tokens, steps: int):
        """Train ``steps`` steps from a fresh ``init()`` over batches of
        ``tokens`` [N, seq_len + 1]; returns ``(model, optimizer,
        losses)``. ``self.history`` holds every step's metrics."""
        cfg = self.cfg
        model, optimizer = self.init()
        losses: list[float] = []
        self.history: dict[str, list[float]] = {"loss": losses}
        n, b = len(tokens), cfg.global_batch_size
        for step in range(steps):
            lo = (step * b) % max(n - b + 1, 1)
            x, y = self.split_batch(tokens[lo : lo + b])
            m = self.train_step(x, y)
            loss = float(m["loss"])
            if cfg.halt_on_nonfinite and not math.isfinite(loss):
                raise NonFiniteLossError(step, loss)
            losses.append(loss)
            for key, value in m.items():
                if key != "loss":
                    self.history.setdefault(key, []).append(float(value))
        return model, optimizer, losses
