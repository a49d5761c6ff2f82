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

``remat`` (with ``remat_policy`` ``none`` or ``dots``), ``scan_layers``
and ``dropout_rate`` are the model's options (``models/transformer.py``).
Dropout is keyed by (seed, step, microbatch): ``train_step`` takes the
step index (default ``self.step``, which ``fit`` keeps), as the JAX
trainer folds it into its dropout key, so a resumed run draws the masks
the uninterrupted one drew. ``accum_steps`` splits the batch into that
many contiguous microbatches, each with its own forward and backward
(and its own dropout key), then divides the gradient sum, the loss sum
and the MoE statistics' sums by ``accum_steps`` (JAX
``train/lm.py:1044-1077``).

With ``moe_experts > 0`` each block's FFN is a routed ``MoEFFN``
(``models/moe.py``; dispatch ``scatter``, the JAX default, ``einsum`` or
``dropless``, the grouped-matmul kernels), the objective is ``ce +
moe_aux_coef * sum of the layers' Switch aux losses`` (JAX
``train/lm.py:1009-1021``; ``loss`` is that total) and the step also
returns ``moe_aux`` (the sum over layers), ``moe_drop`` and
``moe_load_entropy`` (each the mean over layers).

``fit`` is the JAX ``LMTrainer.fit`` run loop: the JAX batch plan (batch
k starts at sequence ``(k * B) % max(N - B + 1, 1)``, a pure function of
k, so a restored run replays the same remaining plan), every step metric
in ``history``, and the two recovery tiers (disk checkpoints,
``utils/checkpoint.py``, every ``checkpoint_every`` steps; host-RAM
snapshots, ``utils/memstore.py``, every ``snapshot_every``), the newer
restored at entry (memory on a tie) behind the divergence-safe
pending/certify gate; the metric stream and run manifest
(``obs/metrics.py``, every ``metrics_every`` steps), the flight recorder
(``obs/flight.py``), the step watchdog (``step_timeout_s``, the first
step exempt), a profiler window (``profile_dir``, steps
``[profile_start_step, + profile_num_steps)``) and the non-finite halt.
``capture_state``/``restore_state`` carry the parameters, the
optimizer's moments and count, and the step, copied into the live
tensors.

For generation and serving, ``decode_model`` and
``quantized_decode_model`` build a decode copy of the model (dense
attention for the prompt pass, the float weights already in the compute
dtype, int8 projections and/or an int8 KV cache on request, no remat,
the unrolled layout) from the trainer's weights or from a
``state_dict``; ``quantize_for_decode`` makes the int8 ``state_dict``
and ``gather_for_decode`` gives the unrolled weights (one device holds
them whole).

Options of later slices (the parallel layouts, the gradient wire,
ZeRO/FSDP) raise ``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Any

import numpy as np
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.config import resolve_device, resolve_dtype
from cs744_pytorch_distributed_tutorial_tpu_torch.models.transformer import (
    ATTENTION_IMPLS,
    TransformerLM,
    is_stacked,
    resolve_remat_policy,
    unstack_block_params,
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
from cs744_pytorch_distributed_tutorial_tpu_torch.utils.failure import NonFiniteLossError
from cs744_pytorch_distributed_tutorial_tpu_torch.utils.memstore import ReplicatedSnapshot

__all__ = ["LMConfig", "LMTrainer", "NonFiniteLossError"]


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
    # Rematerialization of each block in the backward: remat_policy "none"
    # recomputes everything, "dots" keeps the matrix products' outputs.
    remat: bool = False
    remat_policy: str = "none"
    # The layer-stacked parameter layout (one ``blocks`` with a leading
    # [num_layers] axis; models/transformer.py::stack_block_params).
    scan_layers: bool = False
    # Residual dropout on each block's attention and MLP outputs, keyed by
    # (seed, step, microbatch); 0.0 is the dropout-free path exactly.
    dropout_rate: float = 0.0
    # Gradient accumulation: this many microbatches a step (must divide
    # global_batch_size); the gradient is the mean of theirs.
    accum_steps: int = 1

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
    # The run loop (fit), with the JAX LMConfig's names and defaults:
    # checkpoints every checkpoint_every steps (0: only at the end) when
    # checkpoint_dir is set; host-RAM snapshots every snapshot_every
    # steps (0: off), snapshot_keep kept; NaN/inf losses raise
    # NonFiniteLossError; step_timeout_s arms the hang watchdog around
    # each step after the first; metrics_dir writes manifest.json and
    # metrics.jsonl every metrics_every steps; profile_dir traces steps
    # [profile_start_step, + profile_num_steps).
    halt_on_nonfinite: bool = True
    checkpoint_dir: str | None = None
    checkpoint_every: int = 0
    snapshot_every: int = 0
    snapshot_keep: int = 2
    step_timeout_s: float | None = None
    metrics_dir: str | None = None
    metrics_every: int = 1
    profile_dir: str | None = None
    profile_start_step: int = 2
    profile_num_steps: int = 3

    # Options of later slices, accepted only at their "off" value.
    data_parallel: int = 1
    seq_parallel: int = 1
    tensor_parallel: int = 1
    moe_expert_parallel: bool = False
    grad_compress: str = "none"
    sync_overlap: str = "off"
    zero1: bool = False
    fsdp: bool = False

    # "cuda" (default) or "cpu".
    device: str = "cuda"

    def replace(self, **kw: Any) -> "LMConfig":
        return dataclasses.replace(self, **kw)


_LATER_FIELDS = (
    "data_parallel", "seq_parallel", "tensor_parallel", "moe_expert_parallel", "grad_compress",
    "sync_overlap", "zero1", "fsdp",
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
    if cfg.accum_steps < 1 or cfg.global_batch_size % cfg.accum_steps:
        raise ValueError(f"accum_steps {cfg.accum_steps} must divide the per-device batch shard "
                         f"({cfg.global_batch_size} sequences)")
    if cfg.remat:
        resolve_remat_policy(cfg.remat_policy)
    check_recipe(cfg)
    if cfg.label_smoothing and cfg.fused_xent:
        raise ValueError("label_smoothing is incompatible with fused_xent: the fused kernel "
                         "computes plain CE")


def _global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every element's square, in fp32."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class LMTrainer:
    """``TransformerLM`` training on one device: ``init``, ``split_batch``,
    ``train_step``, ``eval_step``, ``evaluate`` and ``fit``. ``memstore``
    is the in-memory snapshot tier; without one, ``cfg.snapshot_every``
    builds it."""

    def __init__(self, cfg: LMConfig, memstore: ReplicatedSnapshot | None = None):
        _check_config(cfg)
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.dtype = resolve_dtype(cfg.compute_dtype)
        if memstore is None and cfg.snapshot_every:
            memstore = ReplicatedSnapshot(max_to_keep=cfg.snapshot_keep)
        self.memstore = memstore
        self.model: TransformerLM | None = None
        self.optimizer = None
        self.step = 0

    def init(self, seed: int | None = None, state_dict: dict | None = None):
        """Build the model (parameters from ``seed``, default
        ``cfg.seed``, or copies of ``state_dict``'s, in this
        configuration's layout: stacked under ``scan_layers``) and its
        optimizer; returns ``(model, optimizer)``."""
        cfg = self.cfg
        kw = dict(self._model_kw(), attention_impl=cfg.attention_impl)
        if state_dict is None:
            gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
            self.model = TransformerLM(**kw, generator=gen).to(self.device)
        else:  # no init drawn: the weights are the given ones
            with torch.device("meta"):
                self.model = TransformerLM(**kw)
            self.model.load_state_dict(
                {k: v.detach().to(self.device, copy=True) for k, v in state_dict.items()},
                assign=True)
        self.optimizer = make_lm_optimizer(self.cfg, list(self.model.parameters()))
        self.step = 0
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
            remat=cfg.remat, remat_policy=cfg.remat_policy, scan_layers=cfg.scan_layers,
            dropout_rate=cfg.dropout_rate,
        )

    def gather_for_decode(self, params: dict | None = None) -> dict:
        """The full weights for a decode copy, in the unrolled layout:
        ``params``, or the trainer's model's ``state_dict`` (built by
        ``init()`` if there is none yet), unstacked if stacked. One device
        holds them whole, so nothing is gathered."""
        if params is None:
            if self.model is None:
                self.init()
            params = self.model.state_dict()
        return unstack_block_params(params) if is_stacked(params) else params

    def _decode_copy(self, params: dict, **options) -> TransformerLM:
        """A ``TransformerLM`` with dense attention for the prompt pass, no
        remat and the unrolled layout, built without an init and loaded
        with copies of ``params`` on the trainer's device, its float
        weights cast to the compute dtype."""
        params = unstack_block_params(params) if is_stacked(params) else params
        kw = dict(self._model_kw(), remat=False, scan_layers=False)
        with torch.device("meta"):
            model = TransformerLM(**kw, attention_impl="dense", **options)
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
              fused: bool = False, dropout: tuple[int, ...] | None = None):
        logits = self.model(inputs, dropout=dropout)
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

    def objective(self, inputs: torch.Tensor, targets: torch.Tensor, step: int | None = None,
                  microbatch: int = 0) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """The training loss (cross-entropy, label-smoothed or through the
        fused kernels, plus ``moe_aux_coef`` times the MoE aux loss) and
        the MoE statistics of its forward (empty for a dense model), read
        right after the forward (a remat recompute in the backward sets
        them again). Dropout, when on, is keyed by (seed, ``step``,
        default ``self.step``, ``microbatch``)."""
        cfg = self.cfg
        key = None
        if cfg.dropout_rate > 0.0:
            key = (cfg.seed, self.step if step is None else step, microbatch)
        loss = self._loss(inputs, targets, cfg.label_smoothing, fused=cfg.fused_xent, dropout=key)
        moe = self._moe_stats() if cfg.moe_experts > 0 else {}
        if moe:
            loss = loss + cfg.moe_aux_coef * moe["moe_aux"]
        return loss, moe

    def train_step(self, inputs: torch.Tensor, targets: torch.Tensor,
                   step: int | None = None) -> dict[str, torch.Tensor]:
        """One update on a batch; ``step`` keys the dropout masks (default
        ``self.step``; inert at ``dropout_rate`` 0)."""
        params = list(self.model.parameters())
        for p in params:
            p.grad = None
        step = self.step if step is None else step
        accum = self.cfg.accum_steps
        if accum == 1:
            loss, moe = self.objective(inputs, targets, step)
            loss.backward()
        else:
            # Microbatch i is rows [i B/a, (i+1) B/a); the sums are divided
            # by accum_steps, as JAX's scan carry.
            loss, moe = None, {}
            for i, (x, y) in enumerate(zip(inputs.chunk(accum), targets.chunk(accum))):
                mb_loss, mb_moe = self.objective(x, y, step, microbatch=i)
                mb_loss.backward()
                loss = mb_loss.detach() if loss is None else loss + mb_loss.detach()
                for k, v in mb_moe.items():
                    moe[k] = v.detach() if k not in moe else moe[k] + v.detach()
            torch._foreach_div_([p.grad for p in params], accum)
            loss = loss / accum
            moe = {k: v / accum for k, v in moe.items()}
        grad_norm = _global_norm([p.grad for p in params])
        self.optimizer.step()
        self.step += 1
        with torch.no_grad():
            param_norm = _global_norm(params)
        return {"loss": loss.detach(), "grad_norm": grad_norm, "param_norm": param_norm,
                **{k: v.detach() for k, v in moe.items()}}

    @torch.no_grad()
    def capture_state(self, *, clone: bool = False) -> dict[str, Any]:
        """Everything a bitwise resume needs (the checkpoint's and the
        snapshot's content): the step, the parameters, the optimizer's
        first moments (``momentum``), AdamW's second moments and the
        update count. ``clone`` copies the tensors on their device."""
        take = (lambda t: t.detach().clone()) if clone else (lambda t: t.detach())
        opt = self.optimizer
        return {
            "step": int(self.step),
            "world_size": 1,
            "params": [take(p) for p in opt.params],
            "momentum": [take(m) for m in opt.momentum],
            "opt_nu": [take(v) for v in opt.tx.nu],
            "opt_count": int(opt.tx.count),
        }

    @torch.no_grad()
    def restore_state(self, state: dict[str, Any]) -> None:
        """Load ``capture_state``'s dict by copying into the live tensors."""
        opt = self.optimizer
        for key, live in (("params", opt.params), ("momentum", opt.momentum),
                          ("opt_nu", opt.tx.nu)):
            saved = state[key]
            if len(live) != len(saved) or any(a.shape != b.shape for a, b in zip(live, saved)):
                raise ValueError(f"saved {key} do not match this trainer's configuration")
            for dst, src in zip(live, saved):
                dst.copy_(src)
        opt.tx.count = int(state["opt_count"])
        self.step = int(state["step"])

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

    def _telemetry(self) -> tuple[Any, int]:
        """The run's Telemetry (manifest written) and its analytic
        data-parallel wire bytes a step (0 on one device)."""
        from cs744_pytorch_distributed_tutorial_tpu_torch.obs.flops import (
            transformer_train_flops_per_token,
        )
        from cs744_pytorch_distributed_tutorial_tpu_torch.obs.metrics import Telemetry
        from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.sync import sync_wire_bytes

        cfg = self.cfg
        n_params = sum(p.numel() for p in self.optimizer.params)
        wire_bytes = sync_wire_bytes(self.optimizer.params, "allreduce", cfg.data_parallel,
                                     cfg.grad_compress)
        on_card = self.device.type == "cuda"
        telemetry = Telemetry(
            cfg.metrics_dir, every=cfg.metrics_every, run="lm",
            flops_per_step=(transformer_train_flops_per_token(n_params)
                            * cfg.global_batch_size * cfg.seq_len),
            n_chips=1, device_kind=torch.cuda.get_device_name(self.device) if on_card else "cpu",
            device=self.device,
        )
        telemetry.write_manifest(config=cfg, n_params=n_params, grad_sync_bytes_per_step=wire_bytes)
        return telemetry, wire_bytes

    def fit(self, tokens, steps: int):
        """Train until ``steps`` steps have run, over batches of ``tokens``
        [N, seq_len + 1], from a fresh ``init()`` or from the newest
        recoverable state (the in-memory snapshot when it is at least as
        new as the newest checkpoint); returns ``(model, optimizer,
        losses)``, the losses of the steps this call ran.
        ``self.history`` holds their metrics.

        The JAX ``LMTrainer.fit``, step for step: every loss is fetched
        (the non-finite check and the step records ride that fetch); a
        due checkpoint or snapshot is held, under ``halt_on_nonfinite``,
        until the next finite loss (the forward over its parameters)
        certifies it, and the final state is certified by one eval
        forward before the last save; the watchdog spares the first step,
        which builds the kernels."""
        from cs744_pytorch_distributed_tutorial_tpu_torch.obs.flight import (
            FlightRecorder,
            HbmHighWater,
            StragglerMonitor,
        )
        from cs744_pytorch_distributed_tutorial_tpu_torch.train.state import make_schedule
        from cs744_pytorch_distributed_tutorial_tpu_torch.utils import profiling
        from cs744_pytorch_distributed_tutorial_tpu_torch.utils.checkpoint import Checkpointer
        from cs744_pytorch_distributed_tutorial_tpu_torch.utils.failure import StepWatchdog

        cfg = self.cfg
        model, optimizer = self.init()
        mem = self.memstore
        ckpt = Checkpointer(cfg.checkpoint_dir) if cfg.checkpoint_dir else None
        mem_step = mem.latest_step() if mem is not None else None
        disk_step = ckpt.latest_step() if ckpt is not None else None
        restored = source = None
        if mem_step is not None and (disk_step is None or disk_step <= mem_step):
            restored, source = mem.restore_latest(), "memory"
        elif disk_step is not None:
            restored, source = ckpt.restore_latest(), "disk"
        if restored is not None:
            self.restore_state(restored)
        start_step = self.step
        losses: list[float] = []
        self.history: dict[str, list[float]] = {"loss": losses}
        n, b = len(tokens), cfg.global_batch_size

        telemetry, wire_bytes = self._telemetry()
        if source is not None:
            telemetry.emit_event("restore", source=source, step=start_step)
        lr_at = make_schedule(cfg)
        straggler = StragglerMonitor()
        flight = FlightRecorder(telemetry=telemetry, straggler=straggler,
                                hbm=HbmHighWater([self.device] if self.device.type == "cuda"
                                                 else []))
        flight.install()
        watchdog = None
        if cfg.step_timeout_s:
            watchdog = StepWatchdog(cfg.step_timeout_s, metric_ring=telemetry.ring,
                                    flight_recorder=flight)
        capture: profiling.Trace | None = None

        def stop_profile() -> None:
            nonlocal capture
            if capture is not None:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                capture.stop()
                capture = None

        # Divergence-safe saves: the loss fetched at step k is the forward
        # over the parameters the previous update made, so a due state is
        # held as (state cloned on the device, to disk, to memory) and
        # persisted once a later finite loss certifies it.
        pending: tuple[dict, bool, bool] | None = None
        x = y = None
        prev_mono = None  # per-step wall clock for the straggler ring
        step = start_step
        try:
            for step in range(start_step, steps):
                lo = (step * b) % max(n - b + 1, 1)
                fetch_ctx = (profiling.annotate("input_fetch") if capture is not None
                             else contextlib.nullcontext())
                with fetch_ctx:
                    x, y = self.split_batch(tokens[lo : lo + b])
                if (cfg.profile_dir and capture is None and cfg.profile_start_step
                        <= step < cfg.profile_start_step + cfg.profile_num_steps):
                    capture = profiling.Trace(cfg.profile_dir)
                    capture.start()
                arm_now = watchdog is not None and step > start_step
                if arm_now:
                    watchdog.arm()
                step_ctx = (profiling.step_annotation("lm", step) if capture is not None
                            else contextlib.nullcontext())
                try:
                    with step_ctx:
                        m = self.train_step(x, y)
                        self.step = step + 1
                        # (wall, mono) around the blocking fetch, as the
                        # JAX loop records them.
                        sync_enter_wall, sync_enter_mono = time.time(), time.monotonic()
                        loss = float(m["loss"])
                        sync_exit_wall, sync_exit_mono = time.time(), time.monotonic()
                finally:
                    if arm_now:
                        watchdog.disarm()
                now_mono = time.monotonic()
                if prev_mono is not None:
                    outlier = straggler.record(step, now_mono - prev_mono)
                    if outlier is not None:
                        telemetry.emit_event("straggler", **outlier)
                prev_mono = now_mono
                if capture is not None and step + 1 >= cfg.profile_start_step + cfg.profile_num_steps:
                    stop_profile()
                if cfg.halt_on_nonfinite and not math.isfinite(loss):
                    telemetry.emit_event("non_finite_loss", step=step, loss=loss)
                    raise NonFiniteLossError(step, loss)
                if pending is not None:  # this finite loss certifies it
                    pstate, to_disk, to_mem = pending
                    if to_disk:
                        ckpt.save(pstate)
                    if to_mem:
                        mem.save(pstate)
                    pending = None
                losses.append(loss)
                fields = {key: float(value) for key, value in m.items() if key != "loss"}
                for key, value in fields.items():
                    self.history.setdefault(key, []).append(value)
                if telemetry.due(step):
                    telemetry.emit_step(
                        step, loss=loss, lr=float(lr_at(step)), grad_sync_bytes=wire_bytes,
                        sync_enter_wall=sync_enter_wall, sync_enter_mono=sync_enter_mono,
                        sync_exit_wall=sync_exit_wall, sync_exit_mono=sync_exit_mono, **fields,
                    )
                ckpt_due = bool(ckpt and cfg.checkpoint_every
                                and (step + 1) % cfg.checkpoint_every == 0)
                snap_due = bool(mem is not None and cfg.snapshot_every
                                and (step + 1) % cfg.snapshot_every == 0)
                if ckpt_due or snap_due:
                    if cfg.halt_on_nonfinite:
                        pending = (self.capture_state(clone=True), ckpt_due, snap_due)
                    else:
                        if ckpt_due:
                            ckpt.save(self.capture_state())
                        if snap_due:
                            mem.save(self.capture_state())
            if ckpt is not None or mem is not None:
                if cfg.halt_on_nonfinite and steps > start_step:
                    # Certify the final parameters with one eval forward
                    # (no later train step will).
                    f_loss = float(self.eval_step(x, y)["loss"])
                    if not math.isfinite(f_loss):
                        raise NonFiniteLossError(steps, f_loss)
                if ckpt is not None:
                    ckpt.save(self.capture_state(), force=True)
                if mem is not None:
                    mem.save(self.capture_state())
        except BaseException as e:
            flight.dump("exception", error=repr(e), step=step)
            raise
        finally:
            stop_profile()
            flight.uninstall()
            if watchdog is not None:
                watchdog.close()
            if ckpt is not None:
                ckpt.close()
            telemetry.close()
        return model, optimizer, losses
