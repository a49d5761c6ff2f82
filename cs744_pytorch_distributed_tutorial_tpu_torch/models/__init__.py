"""Model zoo and registry.

The VGG table, ``tiny_cnn`` (the small net the fast tests run),
ResNet-18/34/50 and the ViT family: the JAX package's registry; and the
HuggingFace GPT-2/Llama checkpoint import (``hf_interop``), exported as
the JAX package exports it.
"""

from __future__ import annotations

from typing import Any, Callable

from torch import nn

from cs744_pytorch_distributed_tutorial_tpu_torch.models.hf_interop import (
    gpt2_model_config,
    llama_model_config,
    lm_params_from_hf_gpt2,
    lm_params_from_hf_llama,
    lm_state_dict_from_hf_gpt2,
    lm_state_dict_from_hf_llama,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.models.resnet import (
    ResNet,
    resnet18,
    resnet34,
    resnet50,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.models.vgg import (
    VGG,
    VGG_CFGS,
    vgg11,
    vgg13,
    vgg16,
    vgg19,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.models.vit import (
    ViT,
    vit_small,
    vit_tiny,
    vit_wide_p8,
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
    "resnet18": resnet18,
    "resnet34": resnet34,
    "resnet50": resnet50,
    "tiny_cnn": tiny_cnn,
    "vit_tiny": vit_tiny,
    "vit_small": vit_small,
    "vit_wide_p8": vit_wide_p8,
}


def get_model(name: str, **kw: Any) -> nn.Module:
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
    "ResNet",
    "TINY_CNN_CFG",
    "VGG",
    "VGG_CFGS",
    "ViT",
    "get_model",
    "gpt2_model_config",
    "llama_model_config",
    "lm_params_from_hf_gpt2",
    "lm_params_from_hf_llama",
    "lm_state_dict_from_hf_gpt2",
    "lm_state_dict_from_hf_llama",
    "resnet18",
    "resnet34",
    "resnet50",
    "tiny_cnn",
    "vgg11",
    "vgg13",
    "vgg16",
    "vgg19",
    "vit_small",
    "vit_tiny",
    "vit_wide_p8",
]
