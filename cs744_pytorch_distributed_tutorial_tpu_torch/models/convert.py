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
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.models import MODEL_CFGS
from cs744_pytorch_distributed_tutorial_tpu_torch.models.vgg import feature_map_size


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
