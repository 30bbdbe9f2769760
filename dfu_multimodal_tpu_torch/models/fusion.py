"""The multimodal late-fusion classifier (counterpart of the
``FusionMLP`` / ``MultimodalFusionClassifier`` of
``dfu_multimodal_tpu/models/fusion.py``).

ResNet50(RGB) ⊕ ViT-B/16(thermal) -> concat (2816) -> MLP 512 -> 256 -> 2
with ReLU + Dropout (drawn from an explicit generator in train mode).
Submodule names follow the reference's torch model
(``rgb_branch``, ``thermal_branch``, ``fusion.{0,3,6}``), the keys
``tools/convert_torch.py::convert_state_dict("multimodal", ...)`` reads.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from dfu_multimodal_tpu_torch.models.common import (Taps, canonical_dtype,
                                                    dropout)
from dfu_multimodal_tpu_torch.models.resnet import ResNet50
from dfu_multimodal_tpu_torch.models.vit import ViTBase16
from dfu_multimodal_tpu_torch.ops.fused_mlp import (FusedMlp,
                                                    fusion_mlp_params)


class FusionMLP(nn.Sequential):
    """Linear, ReLU, Dropout, Linear, ReLU, Dropout, Linear (the
    Sequential fixes the reference's keys).  In eval mode the three layers
    run as the one fused kernel (``ops.fused_mlp``) in the features'
    dtype, differentiable through its plain version (``FusedMlp``: an
    explanation's gradient goes through the eval head).  In train mode they run one by one, as the flax head does: the
    first two Linears in ``dtype``, the last in fp32, each dropout drawn
    from the ``generator`` given to forward (required then)."""

    def __init__(self, in_dim: int = 2816, num_classes: int = 2,
                 drop_rate: float = 0.5,
                 dtype: Union[str, torch.dtype] = torch.float32):
        super().__init__(
            nn.Linear(in_dim, 512), nn.ReLU(), nn.Dropout(drop_rate),
            nn.Linear(512, 256), nn.ReLU(), nn.Dropout(drop_rate),
            nn.Linear(256, num_classes))
        self.drop_rate = drop_rate
        self.dtype = canonical_dtype(dtype)

    @property
    def fc1(self) -> nn.Linear:
        return self[0]

    @property
    def fc2(self) -> nn.Linear:
        return self[3]

    @property
    def fc3(self) -> nn.Linear:
        return self[6]

    def forward(self, fused: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.training:
            return self._train_forward(fused, generator)
        w1, b1, w2, b2, w3, b3 = fusion_mlp_params(self)
        dt = fused.dtype
        return FusedMlp.apply(fused, w1.to(dt), b1, w2.to(dt), b2,
                              w3.to(dt), b3)

    def _train_forward(self, fused: torch.Tensor,
                       generator: Optional[torch.Generator]) -> torch.Tensor:
        if self.drop_rate > 0.0 and generator is None:
            raise ValueError("FusionMLP in train mode draws its dropout "
                             "from an explicit generator")
        dt = self.dtype
        x = fused
        for fc in (self.fc1, self.fc2):
            x = F.relu(F.linear(x.to(dt), fc.weight.to(dt), fc.bias.to(dt)))
            x = dropout(x, self.drop_rate, generator)
        return self.fc3(x.float())


class MultimodalFusionClassifier(nn.Module):
    """Late fusion of ResNet50 (RGB) and ViT-B/16 (thermal); inputs are
    NHWC images already normalised, returns (B, num_classes) logits.
    ``block_impl`` and ``attention_impl`` go to the thermal branch's ViT,
    as in the JAX fusion model, and so do ``token_merge`` and
    ``tome_prop_attn`` (its inference-only ToMe path, ``models/vit.py``);
    ``rgb_impl`` picks the RGB trunk: ``"auto"`` the float ResNet-50 on
    cuDNN, ``"fused"`` the same weights with its stride-1 bottlenecks on
    the fused kernel in eval mode (``models/resnet.py``'s
    ``block_impl="fused"``, K11; a port option), ``"int8"`` the int8
    serving trunk (``models/resnet_q8.py::Int8ResNet50``, weights from
    ``quantize_rgb_trunks``)."""

    def __init__(self, num_classes: int = 2, drop_rate: float = 0.5,
                 dtype: Union[str, torch.dtype] = torch.float32,
                 image_size: int = 224, block_impl: str = "fused",
                 attention_impl: str = "auto", rgb_impl: str = "auto",
                 token_merge: Optional[Tuple[int, int]] = None,
                 tome_prop_attn: bool = False):
        super().__init__()
        dtype = canonical_dtype(dtype)
        if rgb_impl == "int8":
            from dfu_multimodal_tpu_torch.models.resnet_q8 import (
                Int8ResNet50)
            self.rgb_branch = Int8ResNet50(dtype=dtype)
        elif rgb_impl in ("auto", "fused"):
            self.rgb_branch = ResNet50(dtype=dtype, block_impl=rgb_impl)
        else:
            raise ValueError(f"unknown rgb_impl {rgb_impl!r}; have 'auto', "
                             "'fused', 'int8'")
        self.thermal_branch = ViTBase16(dtype=dtype, image_size=image_size,
                                        block_impl=block_impl,
                                        attention_impl=attention_impl,
                                        token_merge=token_merge,
                                        tome_prop_attn=tome_prop_attn)
        self.fusion = FusionMLP(2048 + 768, num_classes, drop_rate, dtype)

    def forward(self, rgb: torch.Tensor, thermal: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                taps: Taps = None) -> torch.Tensor:
        """In train mode the head's dropout draws from ``generator``
        (required then, as in ``ResNetClassifier``).  ``taps`` goes to both
        branches: ``stage1``..``stage4`` of the ResNet, ``blocks`` of the
        ViT."""
        fused = torch.cat([self.rgb_branch(rgb, taps),
                           self.thermal_branch(thermal, taps=taps)],
                          dim=-1)                      # (B, 2816) fp32
        return self.fusion(fused, generator)
