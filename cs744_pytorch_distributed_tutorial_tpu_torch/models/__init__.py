"""Model zoo and registry.

The VGG table and ``tiny_cnn``, the small net the fast tests run. Every
other model of the JAX package's registry raises "not yet ported".
"""

from __future__ import annotations

from typing import Any, Callable

from torch import nn

from cs744_pytorch_distributed_tutorial_tpu_torch.models.vgg import (
    VGG,
    VGG_CFGS,
    vgg11,
    vgg13,
    vgg16,
    vgg19,
)

# The JAX package's TinyCNN (models/__init__.py:56-80): conv8+BN+ReLU+pool,
# conv16+BN+ReLU+pool, dense — a VGG with this two-entry table.
TINY_CNN_CFG = (8, "M", 16, "M")


def tiny_cnn(**kw: Any) -> VGG:
    return VGG(TINY_CNN_CFG, **kw)


MODEL_CFGS: dict[str, tuple] = {**VGG_CFGS, "tiny_cnn": TINY_CNN_CFG}

MODEL_REGISTRY: dict[str, Callable[..., nn.Module]] = {
    "vgg11": vgg11,
    "vgg13": vgg13,
    "vgg16": vgg16,
    "vgg19": vgg19,
    "tiny_cnn": tiny_cnn,
}

# In the JAX package's registry, still to port.
_NOT_YET_PORTED = (
    "resnet18", "resnet34", "resnet50", "vit_tiny", "vit_small", "vit_wide_p8",
)


def get_model(name: str, **kw: Any) -> nn.Module:
    if name in _NOT_YET_PORTED:
        raise NotImplementedError(f"model {name!r} is not yet ported")
    try:
        factory = MODEL_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown model {name!r}; choose from {sorted(MODEL_REGISTRY)}"
        ) from None
    return factory(**kw)


__all__ = [
    "MODEL_CFGS",
    "MODEL_REGISTRY",
    "TINY_CNN_CFG",
    "VGG",
    "VGG_CFGS",
    "get_model",
    "tiny_cnn",
    "vgg11",
    "vgg13",
    "vgg16",
    "vgg19",
]
