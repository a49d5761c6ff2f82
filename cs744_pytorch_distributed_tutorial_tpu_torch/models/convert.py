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
    cfg = _cfg(arch)
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: dict[str, torch.Tensor] = {}

    def put(key: str, a: np.ndarray) -> None:
        out[key] = torch.from_numpy(np.array(a, order="C"))  # a writable copy

    for fi, ti in _seq_indices(cfg):
        conv = params[f"Conv_{fi}"]
        put(f"layers.{ti}.weight", _np(conv["kernel"]).transpose(3, 2, 0, 1))
        put(f"layers.{ti}.bias", _np(conv["bias"]))
        bn = params[f"BatchNorm_{fi}"]
        n = _np(bn["scale"]).shape[0]
        put(f"layers.{ti + 1}.weight", _np(bn["scale"]))
        put(f"layers.{ti + 1}.bias", _np(bn["bias"]))
        bs = stats.get(f"BatchNorm_{fi}", {})
        put(f"layers.{ti + 1}.running_mean", _np(bs.get("mean", np.zeros(n, np.float32))))
        put(f"layers.{ti + 1}.running_var", _np(bs.get("var", np.ones(n, np.float32))))
        out[f"layers.{ti + 1}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    c, side = feature_map_size(cfg, image_size)
    kernel = _np(params["Dense_0"]["kernel"])  # [(h, w, c), out]
    k = kernel.shape[1]
    kernel = kernel.reshape(side, side, c, k).transpose(2, 0, 1, 3).reshape(-1, k)
    put("fc1.weight", kernel.T)
    put("fc1.bias", _np(params["Dense_0"]["bias"]))
    return out


def jax_from_state_dict(
    state_dict: Mapping[str, Any], arch: str = "vgg11", image_size: int = 32
) -> dict:
    """The reverse: a port ``state_dict`` -> flax ``{"params",
    "batch_stats"}`` of numpy arrays."""
    cfg = _cfg(arch)
    params: dict = {}
    stats: dict = {}
    for fi, ti in _seq_indices(cfg):
        params[f"Conv_{fi}"] = {
            "kernel": _np(state_dict[f"layers.{ti}.weight"]).transpose(2, 3, 1, 0),
            "bias": _np(state_dict[f"layers.{ti}.bias"]),
        }
        params[f"BatchNorm_{fi}"] = {
            "scale": _np(state_dict[f"layers.{ti + 1}.weight"]),
            "bias": _np(state_dict[f"layers.{ti + 1}.bias"]),
        }
        stats[f"BatchNorm_{fi}"] = {
            "mean": _np(state_dict[f"layers.{ti + 1}.running_mean"]),
            "var": _np(state_dict[f"layers.{ti + 1}.running_var"]),
        }
    c, side = feature_map_size(cfg, image_size)
    weight = _np(state_dict["fc1.weight"])  # [out, (c, h, w)]
    k = weight.shape[0]
    kernel = weight.T.reshape(c, side, side, k).transpose(1, 2, 0, 3).reshape(-1, k)
    params["Dense_0"] = {
        "kernel": np.ascontiguousarray(kernel),
        "bias": _np(state_dict["fc1.bias"]),
    }
    return {"params": params, "batch_stats": stats}
