"""Model registry (counterpart of ``dfu_multimodal_tpu/models/zoo.py``).

Every JAX entry: the three reference models — the flagship
``multimodal`` fusion model, the ``thermal_only`` ViT classifier and the
``rgb_only`` ResNet-50 classifier —, the ResNet-18 distillation students
``resnet18_rgb`` and ``resnet18_thermal``, the legacy lineage
(``efficientnet_rgb``, ``efficientnet_thermal``, ``legacy_gated_fusion``,
``legacy_rgb_resnet_fusion``) and the small smoke models ``tiny_rgb``,
``tiny_thermal`` and ``tiny_fusion``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, Dict, Optional, Tuple, Union

import torch
from torch import nn

from dfu_multimodal_tpu_torch.models.efficientnet import (
    EfficientNetClassifier)
from dfu_multimodal_tpu_torch.models.fusion import (
    LegacyGatedFusionClassifier, LegacyResNetEfficientNetFusion,
    MultimodalFusionClassifier)
from dfu_multimodal_tpu_torch.models.resnet import ResNetClassifier
from dfu_multimodal_tpu_torch.models.tiny import TinyCNN, TinyFusion
from dfu_multimodal_tpu_torch.models.vit import ViT, ViTClassifier


@dataclass(frozen=True)
class ModelSpec:
    name: str
    make: Callable[..., nn.Module]
    inputs: Tuple[str, ...]           # keys of the batch dict it consumes


_REGISTRY: Dict[str, ModelSpec] = {}


def register(spec: ModelSpec) -> ModelSpec:
    _REGISTRY[spec.name] = spec
    return spec


register(ModelSpec("tiny_rgb", TinyCNN, ("rgb",)))
register(ModelSpec("tiny_thermal", TinyCNN, ("thermal",)))
register(ModelSpec("tiny_fusion", TinyFusion, ("rgb", "thermal")))
register(ModelSpec("rgb_only", ResNetClassifier, ("rgb",)))
# the ResNet-18 students (11M parameters, 512-d features) for distillation
register(ModelSpec("resnet18_rgb", partial(ResNetClassifier,
                                           trunk="resnet18"), ("rgb",)))
register(ModelSpec("resnet18_thermal", partial(ResNetClassifier,
                                               trunk="resnet18"),
                   ("thermal",)))
register(ModelSpec("thermal_only", ViTClassifier, ("thermal",)))
register(ModelSpec("multimodal", MultimodalFusionClassifier,
                   ("rgb", "thermal")))
# the legacy lineage (early-files trainers, cli/train_legacy.py)
register(ModelSpec("efficientnet_rgb", EfficientNetClassifier, ("rgb",)))
register(ModelSpec("efficientnet_thermal", EfficientNetClassifier,
                   ("thermal",)))
register(ModelSpec("legacy_gated_fusion", LegacyGatedFusionClassifier,
                   ("rgb", "thermal")))
register(ModelSpec("legacy_rgb_resnet_fusion",
                   LegacyResNetEfficientNetFusion, ("rgb", "thermal")))


# models whose thermal/primary trunk is a ViT: the set --token-merge
# applies to (the Trainer guard and the predict/serve CLIs consult this
# constant, as in the JAX package)
VIT_TRUNK_MODELS = frozenset({"thermal_only", "multimodal"})


def get(name: str) -> ModelSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; have {sorted(_REGISTRY)}")


def build(name: str, *, num_classes: int = 2,
          drop_rate: Optional[float] = None,
          dtype: Union[str, torch.dtype] = torch.float32,
          **kwargs) -> Tuple[nn.Module, ModelSpec]:
    """``drop_rate=None`` keeps the model class's own default.  Extra
    kwargs go to the model class: ``image_size``; for ``thermal_only``
    the trunk's ``block_impl`` (``"fused"``, ``"flax"``, ``"fused_q8"``,
    ``"fused_q8s"``), ``attention_impl`` (``"auto"``, ``"pallas"``,
    ``"xla"``; the flax block's attention) and cut-down widths
    (``depth``...); for ``multimodal`` the thermal branch's ``block_impl``
    and ``attention_impl``; for both the ViT's ``token_merge`` and
    ``tome_prop_attn`` (serving only); for ``rgb_only`` the trunk's
    ``block_impl`` (``"auto"``, ``"flax"``, ``"fused"``, ``"int8"``), for
    the ResNet-18 students ``"int8"`` (their basic blocks run on cuDNN
    otherwise)."""
    spec = get(name)
    dr = {} if drop_rate is None else {"drop_rate": drop_rate}
    return spec.make(num_classes=num_classes, dtype=dtype, **dr,
                     **kwargs), spec


# std of a unit normal truncated to [-2, 2] (flax's variance_scaling
# "truncated_normal" divides its stddev by this constant)
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_model(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialise every parameter and buffer in place from
    ``generator`` (which must live on the module's device), with the JAX
    package's initialisers: LeCun-normal Linear/conv weights (flax's
    ``lecun_normal``: a normal truncated at ±2σ, σ chosen so that the
    truncated draw has variance 1/fan_in), zero biases, identity
    LayerNorm/BatchNorm (running mean 0, var 1), zero CLS token and a
    N(0, 0.02) position embedding."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            # fan_in = in (Linear) or cin·kh·kw (conv), flax's kh·kw·cin
            s = m.weight[0].numel() ** -0.5 / _TRUNC_STD
            nn.init.trunc_normal_(m.weight, 0.0, s, -2.0 * s, 2.0 * s,
                                  generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
                m.num_batches_tracked.zero_()
        elif isinstance(m, ViT):
            m.cls_token.zero_()
            m.pos_embed.normal_(0.0, 0.02, generator=generator)
    return module


def param_count(module: nn.Module) -> int:
    """Trainable parameters (BatchNorm running stats are buffers, as they
    are ``batch_stats`` rather than ``params`` in the JAX count)."""
    return sum(p.numel() for p in module.parameters())
