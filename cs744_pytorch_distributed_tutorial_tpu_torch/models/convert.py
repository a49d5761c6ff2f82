"""Weights across frameworks: JAX-package variable trees <-> this port's
``state_dict``.

The JAX package keeps a model's weights as flax collections
``{"params": {"Conv_i", "BatchNorm_i", "Dense_0"}, "batch_stats": ...}``
of arrays (taken here as anything ``np.asarray`` reads, so this module
needs no JAX). The port's VGG modules carry the reference ``_VGG``'s
``state_dict`` keys (``layers.N.*``, ``fc1.*``). The conversions:

- conv kernels HWIO (flax NHWC convs) <-> OIHW (``nn.Conv2d``);
- BatchNorm ``scale``/``bias`` <-> ``weight``/``bias``, and
  ``batch_stats`` ``mean``/``var`` <-> ``running_mean``/``running_var``
  (values copied as they are: flax stores the biased variance, torch
  updates with the Bessel-corrected one; ``num_batches_tracked`` has no
  flax counterpart and is 0);
- the Dense kernel ``[in, out]`` <-> Linear ``[out, in]``. The JAX model
  flattens its NHWC map in (h, w, c) order, the port its NCHW map in
  (c, h, w) order, so the rows are permuted between the two. At 32x32
  VGG flattens a 1x1x512 map and the permutation is the identity;
  ``tiny_cnn`` flattens 8x8x16 and needs it.

ResNet (``models/resnet.py``) is a table, scope by scope:

    flax                               port state_dict
    Conv_0 (stem)                      conv0.weight
    BatchNorm_0 (stem)                 bn0.*
    BasicBlock_i / BottleneckBlock_i   blocks.i.
      Conv_j                             convj.weight
      BatchNorm_j                        bnj.*
    Dense_0                            fc.*

with the same kernel, BatchNorm and Dense conversions. Its head takes
the global average pool, so the Dense rows need no permutation. The
block class name comes from ``arch``; the number of blocks and which
have a projection (``Conv_2`` in a BasicBlock, ``Conv_3`` in a
bottleneck) come from the tree, so cut-down stage tables convert too.

The ViT (``models/vit.py``, ``vit_state_dict_from_jax`` and its inverse):
``patch_embed`` a conv (HWIO <-> OIHW), ``cls_token`` and ``pos_embed``
as they are, and its blocks, ``ln_f`` and ``head`` by the LM's rules below.

The transformer LM (``models/transformer.py``), flax ``params`` only:

    flax                                  port state_dict
    tok_embed/embedding, pos_embed/...    tok_embed.weight, pos_embed.weight
    block_i/ln1, ln2 {scale, bias}        blocks.i.ln1.{weight, bias}, ...
    block_i/attn/{q,k,v,attn_out}/...     blocks.i.attn.q.{weight, bias}, ...
    block_i/{mlp_in,mlp_gate,mlp_out}     blocks.i.mlp_in.{weight, bias}, ...
    block_i/mlp_out_bias                  blocks.i.mlp_out_bias
    ln_f {scale, bias}                    ln_f.{weight, bias}
    lm_head/kernel                        lm_head.weight
    block_i/moe/router/kernel             blocks.i.moe.router.weight
    block_i/moe/{w_in,b_in,w_out,b_out}   blocks.i.moe.{w_in, b_in, w_out, b_out}

with Dense kernels ``[in, out]`` (the MoE router's too) transposed into
``Linear.weight [out, in]``; norm scales, embeddings and the MoE expert
tensors (``[E, K, N]`` kernels, ``[E, N]`` biases: the layout the
grouped-matmul kernel reads) copied as they are.

Sharded state (``parallel/zero.py``): ZeRO-1's momentum and FSDP's
parameters are, on each side, rank ``r``'s row of a tensor's flat
zero-padded ``[n, ceil(size / n)]`` layout. The flat order is each
framework's own (HWIO against OIHW), so a JAX ``[n, chunk]`` leaf maps
to the port's rows through the full tensor: ``zero_rows_from_jax`` and
``jax_rows_from_zero`` (per leaf ``shard_row`` and ``unshard_rows``,
which the Trainer's FSDP ``load_state_dict`` uses too). With ``arch="lm"``
they take the LM's trees (Dense kernels ``[in, out]`` against ``Linear``
``[out, in]``: the rows hold other elements on each side), and
``lm_zero_state_from_jax`` / ``jax_lm_zero_state`` carry a whole ZeRO
state of the LM trainer: ``mu`` and ``nu`` (``mu`` alone for lion and
sgd), fsdp's parameter rows and ``count``, between the JAX trainer's
``[dp, chunk]`` leaves and each rank's rows by parameter name.

The pipeline trainer's tree (``parallel/pipeline.py``): the JAX
``PipelineLMTrainer``'s ``{embed, pos, blocks, ln_f_scale, ln_f_bias,
head}`` with ``blocks`` the flax ``Block`` parameters stacked over the
layers (storage order) <-> the port's ``embed``, ``pos``, ``ln_f_scale``,
``ln_f_bias``, ``head`` as they are and ``blocks.<Block parameter>``
stacked, by the LM's block rules (``pipeline_params_from_jax``,
``jax_pipeline_params_from_torch``); its ZeRO rows, the JAX ``[dp, S(,
T), chunk]`` leaves chunked per (pipe[, tensor]) coordinate, to a rank's
rows (``pipeline_zero_rows_from_jax``).

The LM across the sequence, tensor and expert axes: ``lm_shard_from_jax``
gives a rank's ``state_dict`` from the JAX global tree (each tensor- or
expert-split parameter cut to the slice at the rank's coordinates,
``models/transformer.py::lm_param_specs``), and ``lm_unshard`` /
``jax_lm_params_from_shards`` join the ranks' slices back into the global
``state_dict`` / tree.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.models import MODEL_CFGS
from cs744_pytorch_distributed_tutorial_tpu_torch.models.transformer import (
    lm_param_specs,
    shard_tensor,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.models.vgg import feature_map_size
from cs744_pytorch_distributed_tutorial_tpu_torch.parallel.zero import _shard_flat, _unshard


def _np(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _tensor(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(_np(x), order="C"))  # a writable copy


def _conv_to_torch(kernel: Any) -> torch.Tensor:
    return _tensor(_np(kernel).transpose(3, 2, 0, 1))  # HWIO -> OIHW


def _conv_to_jax(weight: Any) -> np.ndarray:
    return _np(weight).transpose(2, 3, 1, 0)  # OIHW -> HWIO


def _bn_to_torch(prefix: str, bn: Mapping, bs: Mapping) -> dict[str, torch.Tensor]:
    """A flax BatchNorm's params and batch_stats -> ``nn.BatchNorm2d``
    state under ``prefix``."""
    n = _np(bn["scale"]).shape[0]
    return {
        prefix + "weight": _tensor(bn["scale"]),
        prefix + "bias": _tensor(bn["bias"]),
        prefix + "running_mean": _tensor(bs.get("mean", np.zeros(n, np.float32))),
        prefix + "running_var": _tensor(bs.get("var", np.ones(n, np.float32))),
        prefix + "num_batches_tracked": torch.tensor(0, dtype=torch.int64),
    }


def _bn_to_jax(state_dict: Mapping[str, Any], prefix: str) -> tuple[dict, dict]:
    """The reverse: (params, batch_stats) of one flax BatchNorm."""
    return (
        {"scale": _np(state_dict[prefix + "weight"]), "bias": _np(state_dict[prefix + "bias"])},
        {"mean": _np(state_dict[prefix + "running_mean"]),
         "var": _np(state_dict[prefix + "running_var"])},
    )


# ResNet arch -> the flax class name of its blocks.
RESNET_BLOCKS = {
    "resnet18": "BasicBlock",
    "resnet34": "BasicBlock",
    "resnet50": "BottleneckBlock",
}


def _cfg(arch: str) -> Sequence[Any]:
    if arch not in MODEL_CFGS:
        raise ValueError(f"unknown arch {arch!r}; choose from {sorted(MODEL_CFGS)}")
    return MODEL_CFGS[arch]


def _seq_indices(cfg: Sequence[Any]):
    """Yield (flax_index, sequential_index) per conv block: conv, bn, relu
    per entry, one maxpool per 'M' (``master/part1/model.py:11-27``)."""
    ti = fi = 0
    for entry in cfg:
        if entry == "M":
            ti += 1
        else:
            yield fi, ti
            fi += 1
            ti += 3


def state_dict_from_jax(
    variables: Mapping[str, Any], arch: str = "vgg11", image_size: int = 32
) -> dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` -> the port model's ``state_dict``."""
    if arch in RESNET_BLOCKS:
        return _resnet_state_dict_from_jax(variables, RESNET_BLOCKS[arch])
    cfg = _cfg(arch)
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: dict[str, torch.Tensor] = {}
    for fi, ti in _seq_indices(cfg):
        out[f"layers.{ti}.weight"] = _conv_to_torch(params[f"Conv_{fi}"]["kernel"])
        out[f"layers.{ti}.bias"] = _tensor(params[f"Conv_{fi}"]["bias"])
        out.update(_bn_to_torch(f"layers.{ti + 1}.", params[f"BatchNorm_{fi}"],
                                stats.get(f"BatchNorm_{fi}", {})))
    c, side = feature_map_size(cfg, image_size)
    kernel = _np(params["Dense_0"]["kernel"])  # [(h, w, c), out]
    k = kernel.shape[1]
    kernel = kernel.reshape(side, side, c, k).transpose(2, 0, 1, 3).reshape(-1, k)
    out["fc1.weight"] = _tensor(kernel.T)
    out["fc1.bias"] = _tensor(params["Dense_0"]["bias"])
    return out


def jax_from_state_dict(
    state_dict: Mapping[str, Any], arch: str = "vgg11", image_size: int = 32
) -> dict:
    """The reverse: a port ``state_dict`` -> flax ``{"params",
    "batch_stats"}`` of numpy arrays."""
    if arch in RESNET_BLOCKS:
        return _resnet_jax_from_state_dict(state_dict, RESNET_BLOCKS[arch])
    cfg = _cfg(arch)
    params: dict = {}
    stats: dict = {}
    for fi, ti in _seq_indices(cfg):
        params[f"Conv_{fi}"] = {
            "kernel": _conv_to_jax(state_dict[f"layers.{ti}.weight"]),
            "bias": _np(state_dict[f"layers.{ti}.bias"]),
        }
        params[f"BatchNorm_{fi}"], stats[f"BatchNorm_{fi}"] = _bn_to_jax(
            state_dict, f"layers.{ti + 1}."
        )
    c, side = feature_map_size(cfg, image_size)
    weight = _np(state_dict["fc1.weight"])  # [out, (c, h, w)]
    k = weight.shape[0]
    kernel = weight.T.reshape(c, side, side, k).transpose(1, 2, 0, 3).reshape(-1, k)
    params["Dense_0"] = {
        "kernel": np.ascontiguousarray(kernel),
        "bias": _np(state_dict["fc1.bias"]),
    }
    return {"params": params, "batch_stats": stats}


def _resnet_state_dict_from_jax(variables: Mapping[str, Any], block: str) -> dict:
    out: dict[str, torch.Tensor] = {}

    def walk(params: Mapping, stats: Mapping, prefix: str) -> None:
        for name, leaf in params.items():
            kind, _, j = name.rpartition("_")
            if kind == block:
                walk(leaf, stats.get(name, {}), f"blocks.{j}.")
            elif kind == "Conv":
                out[f"{prefix}conv{j}.weight"] = _conv_to_torch(leaf["kernel"])
            elif kind == "BatchNorm":
                out.update(_bn_to_torch(f"{prefix}bn{j}.", leaf, stats.get(name, {})))
            elif kind == "Dense":
                out["fc.weight"] = _tensor(_np(leaf["kernel"]).T)
                out["fc.bias"] = _tensor(leaf["bias"])
            else:
                raise ValueError(f"unexpected ResNet scope {prefix}{name!r}")

    walk(variables["params"], variables.get("batch_stats", {}), "")
    return out


def _resnet_jax_from_state_dict(state_dict: Mapping[str, Any], block: str) -> dict:
    params: dict = {}
    stats: dict = {}
    for key in state_dict:
        if not key.endswith(".weight"):
            continue
        *scope, module, _ = key.split(".")
        prefix = key[: -len("weight")]
        p_scope, s_scope = params, stats
        if scope:  # ["blocks", i]
            name = f"{block}_{scope[1]}"
            p_scope, s_scope = params.setdefault(name, {}), stats.setdefault(name, {})
        if module == "fc":
            params["Dense_0"] = {
                "kernel": np.ascontiguousarray(_np(state_dict[key]).T),
                "bias": _np(state_dict["fc.bias"]),
            }
        elif module.startswith("conv"):
            p_scope[f"Conv_{module[4:]}"] = {"kernel": _conv_to_jax(state_dict[key])}
        elif module.startswith("bn"):
            name = f"BatchNorm_{module[2:]}"
            p_scope[name], s_scope[name] = _bn_to_jax(state_dict, prefix)
        else:
            raise ValueError(f"unexpected ResNet state_dict key {key!r}")
    return {"params": params, "batch_stats": stats}


# The port's LM module names whose ``weight`` is a flax norm ``scale`` or
# an ``Embed`` table (every other ``weight`` is a Dense kernel).
_LM_SCALES = ("ln1", "ln2", "ln_f")
_LM_EMBEDS = ("tok_embed", "pos_embed")
# Parameters copied as they are under their own name: the MoE experts'.
_LM_AS_IS = ("mlp_out_bias", "w_in", "b_in", "w_out", "b_out")


def _flatten(tree: Mapping, prefix: tuple = ()):
    for name, leaf in tree.items():
        if isinstance(leaf, Mapping):
            yield from _flatten(leaf, prefix + (name,))
        else:
            yield prefix + (name,), leaf


def lm_params_from_jax(params: Mapping[str, Any], cfg: Any = None) -> dict[str, torch.Tensor]:
    """A flax ``TransformerLM`` ``params`` tree -> the port's
    ``state_dict``. With ``cfg`` (anything with ``num_layers``), the
    tree's block count is checked against it. A quantized tree (the JAX
    ``quantize_lm_params``: ``qkernel`` int8 [K, N] and ``scale`` [N] in
    a ``QuantDense``) gives ``QuantLinear``'s ``qweight`` [K, N] and
    ``scale`` as they are. The ``scan_layers`` tree (one ``blocks``
    subtree, leaves with a leading [L] axis) gives the port's stacked
    layout, ``blocks.*`` with the same leading axis: bitwise the
    unrolled tree's mapping, stacked."""
    out: dict[str, torch.Tensor] = {}
    flat = list(_flatten(params))
    quant_scopes = {path[:-1] for path, _ in flat if path[-1] == "qkernel"}
    for path, leaf in flat:
        scope = [f"blocks.{p[len('block_'):]}" if p.startswith("block_") else p
                 for p in path[:-1]]
        name = path[-1]
        if name == "kernel":  # [(L,) in, out] -> [(L,) out, in]
            out[".".join(scope + ["weight"])] = _tensor(np.swapaxes(_np(leaf), -1, -2))
        elif name == "qkernel":
            out[".".join(scope + ["qweight"])] = _tensor(leaf)
        elif name == "scale" and path[:-1] in quant_scopes:
            out[".".join(scope + ["scale"])] = _tensor(leaf)
        elif name in ("scale", "embedding"):
            out[".".join(scope + ["weight"])] = _tensor(leaf)
        elif name == "bias" or name in _LM_AS_IS:
            out[".".join(scope + [name])] = _tensor(leaf)
        else:
            raise ValueError(f"unexpected LM param {'/'.join(path)!r}")
    if cfg is not None:
        if "blocks" in params:
            blocks = range(len(_np(next(_flatten(params["blocks"]))[1])))
        else:
            blocks = {k.split(".")[1] for k in out if k.startswith("blocks.")}
        if len(blocks) != cfg.num_layers:
            raise ValueError(f"params hold {len(blocks)} blocks, cfg.num_layers is {cfg.num_layers}")
    return out


def jax_lm_params_from_state_dict(state_dict: Mapping[str, Any]) -> dict:
    """The reverse: the port LM's ``state_dict`` -> a flax ``params``
    tree of numpy arrays (a ``QuantLinear``'s ``qweight``/``scale`` to
    ``qkernel``/``scale``; the stacked layout to the ``scan_layers``
    tree)."""
    params: dict = {}
    for key, value in state_dict.items():
        *scope, name = key.split(".")
        if scope[:1] == ["blocks"] and len(scope) > 1 and scope[1].isdigit():
            scope = [f"block_{scope[1]}", *scope[2:]]
        node = params
        for part in scope:
            node = node.setdefault(part, {})
        if name == "weight":
            module = scope[-1]
            if module in _LM_SCALES:
                node["scale"] = _np(value)
            elif module in _LM_EMBEDS:
                node["embedding"] = _np(value)
            else:
                node["kernel"] = np.ascontiguousarray(np.swapaxes(_np(value), -1, -2))
        elif name == "qweight":
            node["qkernel"] = _np(value)
        elif name in ("bias", "scale") or name in _LM_AS_IS:
            node[name] = _np(value)
        else:
            raise ValueError(f"unexpected LM state_dict key {key!r}")
    return params


# The ViT's own parameters, outside the blocks, ``ln_f`` and ``head`` (which
# take the LM's rules).
_VIT_AS_IS = ("cls_token", "pos_embed")


def vit_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A flax ``ViT`` ``params`` tree -> the port ViT's ``state_dict``:
    ``patch_embed`` (kernel HWIO [p, p, 3, d] -> OIHW [d, 3, p, p], and its
    bias), ``cls_token`` [1, 1, d] and ``pos_embed`` [1, n + 1, d] as they
    are; ``block_i``, ``ln_f`` and ``head`` by the LM's rules
    (``lm_params_from_jax``)."""
    out = {"patch_embed.weight": _conv_to_torch(params["patch_embed"]["kernel"]),
           "patch_embed.bias": _tensor(params["patch_embed"]["bias"])}
    out.update({name: _tensor(params[name]) for name in _VIT_AS_IS})
    rest = {k: v for k, v in params.items() if k not in ("patch_embed", *_VIT_AS_IS)}
    out.update(lm_params_from_jax(rest))
    return out


def jax_vit_params_from_state_dict(state_dict: Mapping[str, Any]) -> dict:
    """The reverse: the port ViT's ``state_dict`` -> a flax ``params`` tree
    of numpy arrays."""
    params = {"patch_embed": {"kernel": _conv_to_jax(state_dict["patch_embed.weight"]),
                              "bias": _np(state_dict["patch_embed.bias"])}}
    params.update({name: _np(state_dict[name]) for name in _VIT_AS_IS})
    rest = {k: v for k, v in state_dict.items()
            if not k.startswith("patch_embed.") and k not in _VIT_AS_IS}
    params.update(jax_lm_params_from_state_dict(rest))
    return params


# ------------------------------------------------------------ sharded state
def shard_row(x: Any, rank: int, world_size: int) -> torch.Tensor:
    """Row ``rank`` of ``x``'s flat zero-padded ``[n, chunk]`` layout."""
    x = x if isinstance(x, torch.Tensor) else _tensor(x)
    return _shard_flat(x.detach(), world_size)[rank].clone()


def unshard_rows(rows: Any, shape: Sequence[int]) -> torch.Tensor:
    """``[n, chunk]`` rows (every rank's, in rank order) -> the tensor."""
    rows = rows if isinstance(rows, torch.Tensor) else _tensor(rows)
    return _unshard(rows.contiguous(), shape).clone()


def _map_leaves(tree: Mapping, like: Mapping, fn) -> dict:
    return {k: _map_leaves(v, like[k], fn) if isinstance(v, Mapping) else fn(v, like[k])
            for k, v in tree.items()}


def zero_rows_from_jax(rows_params: Mapping, like_params: Mapping, arch: str, rank: int,
                       image_size: int = 32) -> dict[str, torch.Tensor]:
    """A flax params tree of JAX ``[n, chunk]`` leaves (zero1's momentum,
    fsdp's parameters; ``like_params`` gives each leaf's shape) -> rank
    ``rank``'s ``[chunk]`` rows in the port's layout, by parameter name."""
    full = _map_leaves(rows_params, like_params,
                       lambda rows, like: _np(unshard_rows(rows, _np(like).shape)))
    n = _np(next(_flatten(rows_params))[1]).shape[0]
    if arch == "lm":
        sd = lm_params_from_jax(full)
    else:
        sd = state_dict_from_jax({"params": full}, arch, image_size)
    return {k: shard_row(sd[k], rank, n) for k in sd if _is_param(k)}


def jax_rows_from_zero(rows_by_rank: Sequence[Mapping[str, Any]], shapes: Mapping[str, Sequence],
                       arch: str, image_size: int = 32) -> dict:
    """The reverse: each rank's rows by parameter name (rank order) and
    the parameters' shapes -> the flax params tree of ``[n, chunk]``
    leaves."""
    n = len(rows_by_rank)
    sd: dict[str, Any] = {}
    for name, shape in shapes.items():
        sd[name] = unshard_rows(torch.stack([_tensor(r[name]) for r in rows_by_rank]), shape)
        if arch == "lm":
            continue
        if name.endswith("bias"):  # BatchNorm statistics the conversion reads, unused here
            for stat in ("running_mean", "running_var"):
                sd.setdefault(name[: -len("bias")] + stat, torch.zeros(shape[0]))
    if arch == "lm":
        params = jax_lm_params_from_state_dict(sd)
    else:
        params = jax_from_state_dict(sd, arch, image_size)["params"]
    return _map_leaves(params, params, lambda x, _: _np(_shard_flat(_tensor(x), n)))


def lm_zero_state_from_jax(opt_state: Mapping, params_like: Mapping, rank: int,
                           fsdp_params: Mapping | None = None) -> dict:
    """The JAX LM trainer's ZeRO state (``{"mu", ["nu",] "count"}`` of
    ``[dp, chunk]`` leaves; fsdp's ``[dp, chunk]`` parameters) -> rank
    ``rank``'s rows by parameter name: ``{"mu": {...}, ["nu": {...},]
    "count": int[, "params": {...}]}``. ``params_like`` gives each leaf's
    full shape."""
    out: dict[str, Any] = {name: zero_rows_from_jax(opt_state[name], params_like, "lm", rank)
                           for name in ("mu", "nu") if name in opt_state}
    out["count"] = int(_np(opt_state["count"]))
    if fsdp_params is not None:
        out["params"] = zero_rows_from_jax(fsdp_params, params_like, "lm", rank)
    return out


def jax_lm_zero_state(states_by_rank: Sequence[Mapping], shapes: Mapping[str, Sequence]) -> dict:
    """The reverse: every rank's ``lm_zero_state_from_jax`` dict (rank
    order) and the parameters' shapes by name -> the JAX trainer's
    ``{"mu", ["nu",] "count"}`` of ``[dp, chunk]`` leaves (and, where the
    dicts hold ``params``, fsdp's parameter rows under ``"params"``)."""
    first = states_by_rank[0]
    out: dict[str, Any] = {
        name: jax_rows_from_zero([st[name] for st in states_by_rank], shapes, "lm")
        for name in ("mu", "nu", "params") if name in first}
    out["count"] = np.int32(first["count"])
    return out


def _is_param(key: str) -> bool:
    return not key.endswith(("running_mean", "running_var", "num_batches_tracked"))


# ------------------------------------------------ the LM's model-shard slices
def _lm_specs(state_dict: Mapping, sizes: Mapping[str, int]) -> dict:
    return lm_param_specs(state_dict, "tensor" if sizes.get("tensor", 1) > 1 else None,
                          "data" if sizes.get("expert", 1) > 1 else None)


def lm_shard_from_jax(params: Mapping[str, Any], coords: Mapping[str, int],
                      sizes: Mapping[str, int]) -> dict[str, torch.Tensor]:
    """A flax ``TransformerLM`` global ``params`` tree -> the ``state_dict``
    of the rank at ``coords`` (``{"data", "seq", "tensor"}``) on a mesh of
    ``sizes`` (the same keys, plus ``"expert"`` > 1 when the experts split
    over the data axis): each split parameter's slice at the rank's
    tensor (or, for an expert, data) coordinate."""
    sd = lm_params_from_jax(params)
    specs = _lm_specs(sd, sizes)
    return {k: shard_tensor(v, specs[k], coords, sizes).clone() for k, v in sd.items()}


def lm_unshard(shards: Sequence[tuple[Mapping[str, int], Mapping[str, Any]]],
               sizes: Mapping[str, int]) -> dict[str, torch.Tensor]:
    """Every rank's ``(coords, state_dict)`` -> the global ``state_dict``:
    a split parameter's slices joined along its split dimension in
    coordinate order (any rank's copy of a replicated one)."""
    first = shards[0][1]
    specs = _lm_specs(first, sizes)
    out = {}
    for name, spec in specs.items():
        split = [(dim, axis) for dim, axis in enumerate(spec) if axis is not None]
        if not split:
            out[name] = _tensor(first[name])
            continue
        (dim, axis), = split
        by_coord = {c[axis]: sd[name] for c, sd in shards}
        out[name] = torch.cat([_tensor(by_coord[i]) for i in sorted(by_coord)], dim=dim)
    return out


def jax_lm_params_from_shards(shards: Sequence[tuple[Mapping[str, int], Mapping[str, Any]]],
                              sizes: Mapping[str, int]) -> dict:
    """The reverse of ``lm_shard_from_jax``: the ranks' slices -> the flax
    global ``params`` tree."""
    return jax_lm_params_from_state_dict(lm_unshard(shards, sizes))


# ------------------------------------------------------ the pipeline's tree
_PIPELINE_AS_IS = ("embed", "pos", "ln_f_scale", "ln_f_bias", "head")


def pipeline_params_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The JAX ``PipelineLMTrainer``'s params tree -> the port trainer's
    (``parallel/pipeline.py``): ``blocks`` by the LM's rules (stacked:
    ``blocks.<name>``, kernels transposed), the rest as they are."""
    out = lm_params_from_jax({"blocks": params["blocks"]})
    out.update({k: _tensor(params[k]) for k in _PIPELINE_AS_IS if k in params})
    return out


def jax_pipeline_params_from_torch(state: Mapping[str, Any]) -> dict:
    """The reverse: the port pipeline trainer's tree -> the JAX one, numpy
    arrays."""
    out = jax_lm_params_from_state_dict({k: v for k, v in state.items()
                                         if k.startswith("blocks.")})
    out.update({k: _np(state[k]) for k in _PIPELINE_AS_IS if k in state})
    return out


def pipeline_zero_rows_from_jax(rows_params: Mapping, local_like: Mapping,
                                coords: Mapping[str, int]) -> dict[str, torch.Tensor]:
    """The JAX pipeline trainer's ZeRO leaves (``[dp, S(, T), chunk]`` for a
    block tensor, ``[dp(, T), chunk]`` for the head, ``[dp, chunk]`` for a
    replicated one; ``local_like`` gives each leaf's LOCAL shape at a
    (pipe, tensor) coordinate, the JAX ``local_chunk_shapes``) -> the rows
    of the rank at ``coords`` (``{"data", "pipe", "tensor"}``) in the
    port's layout, by parameter name: the coordinate's local tensor is
    rebuilt from its dp rows, converted, and cut into the port's rows."""
    n = _np(next(_flatten(rows_params))[1]).shape[0]

    def local(axes):
        def fn(rows, like):
            rows = _np(rows)
            index = tuple(coords[a] for a in axes[:rows.ndim - 2])
            return _np(unshard_rows(rows[(slice(None), *index)], _np(like).shape))
        return fn

    full = {k: (_map_leaves(v, local_like[k], local(("pipe", "tensor"))) if k == "blocks"
                else local(("tensor",) if k == "head" else ())(v, local_like[k]))
            for k, v in rows_params.items()}
    sd = pipeline_params_from_jax(full)
    return {k: shard_row(v, coords["data"], n) for k, v in sd.items()}
