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
                                                    dropout, tap)
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
                taps: Taps = None, features: Taps = None) -> torch.Tensor:
        """In train mode the head's dropout draws from ``generator``
        (required then, as in ``ResNetClassifier``).  ``taps`` goes to both
        branches: ``stage1``..``stage4`` of the ResNet, ``blocks`` of the
        ViT.  ``features`` records each branch's features, ``rgb_branch``
        (B, 2048) and ``thermal_branch`` (B, 768): the halves of the head's
        input."""
        rgb_feats = tap(features, "rgb_branch", self.rgb_branch(rgb, taps))
        thermal_feats = tap(features, "thermal_branch",
                            self.thermal_branch(thermal, taps=taps))
        fused = torch.cat([rgb_feats, thermal_feats],
                          dim=-1)                      # (B, 2816) fp32
        return self.fusion(fused, generator)


# ------------------------------------------------------------ the legacy
#
# The early-files lineage (reference models/{models,fusion,classifier}.py
# and notebooks/early files/*): counterparts of the JAX package's
# ``LegacyConcatFusion``, ``GatedFusion``, ``LegacyGatedFusionClassifier``,
# ``LegacyResNetEfficientNetFusion`` and ``LegacyClassifier``, with their
# scope names as keys.  The legacy heads of the reference emit one sigmoid
# unit trained with BCE; the two fusion classifiers are standardised on
# the 2-class softmax contract, as in the JAX package (SURVEY §7f).  Dense
# layers run in the compute dtype but the last, which is fp32; dropout in
# train mode draws from the ``generator`` given to forward.


def _dense(x: torch.Tensor, fc: nn.Linear, dtype: torch.dtype
           ) -> torch.Tensor:
    return F.linear(x.to(dtype), fc.weight.to(dtype), fc.bias.to(dtype))


def _train_dropout(module: nn.Module, x: torch.Tensor, rate: float,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    if not module.training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError(f"{type(module).__name__} in train mode draws its "
                         "dropout from an explicit generator")
    return dropout(x, rate, generator)


class LegacyConcatFusion(nn.Module):
    """concat -> fc1 -> ReLU -> Dropout(0.3) -> fc2 (1) -> sigmoid."""

    def __init__(self, rgb_dim: int = 2048, thermal_dim: int = 768,
                 hidden_dim: int = 512,
                 dtype: Union[str, torch.dtype] = torch.float32):
        super().__init__()
        self.dtype = canonical_dtype(dtype)
        self.fc1 = nn.Linear(rgb_dim + thermal_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, 1)

    def forward(self, rgb_feat: torch.Tensor, thermal_feat: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = F.relu(_dense(torch.cat([rgb_feat, thermal_feat], dim=-1),
                          self.fc1, self.dtype))
        x = _train_dropout(self, x, 0.3, generator)
        return torch.sigmoid(self.fc2(x.float()))


class GatedFusion(nn.Module):
    """g = sigmoid(gate_fc2(ReLU(gate_fc1(concat)))), in fp32;
    g·rgb + (1 − g)·thermal."""

    def __init__(self, feat_dim: int = 1280,
                 dtype: Union[str, torch.dtype] = torch.float32):
        super().__init__()
        self.dtype = canonical_dtype(dtype)
        self.gate_fc1 = nn.Linear(2 * feat_dim, feat_dim)
        self.gate_fc2 = nn.Linear(feat_dim, feat_dim)

    def forward(self, rgb_feat: torch.Tensor,
                th_feat: torch.Tensor) -> torch.Tensor:
        combined = torch.cat([rgb_feat.float(), th_feat.float()], dim=-1)
        g = F.relu(_dense(combined, self.gate_fc1, self.dtype))
        g = torch.sigmoid(_dense(g, self.gate_fc2, self.dtype).float())
        return g * rgb_feat + (1.0 - g) * th_feat


class _LegacyFusionHead(nn.Module):
    """The legacy classifiers' tail: gated fusion -> cls_fc1 (256) ->
    ReLU -> Dropout -> head (fp32)."""

    def __init__(self, num_classes: int, drop_rate: float, feat_dim: int,
                 dtype: torch.dtype):
        super().__init__()
        self.drop_rate = drop_rate
        self.dtype = dtype
        self.fusion = GatedFusion(feat_dim, dtype)
        self.cls_fc1 = nn.Linear(feat_dim, 256)
        self.head = nn.Linear(256, num_classes)

    def classify(self, rgb_feat: torch.Tensor, th_feat: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
        x = F.relu(_dense(self.fusion(rgb_feat, th_feat), self.cls_fc1,
                          self.dtype))
        x = _train_dropout(self, x, self.drop_rate, generator)
        return self.head(x.float())


class LegacyGatedFusionClassifier(_LegacyFusionHead):
    """Two EfficientNet-B0 encoders (``rgb_encoder``, ``thermal_encoder``)
    -> gated fusion -> 256 -> head (``legacy_gated_fusion``)."""

    def __init__(self, num_classes: int = 2, drop_rate: float = 0.3,
                 feat_dim: int = 1280,
                 dtype: Union[str, torch.dtype] = torch.float32,
                 image_size: int = 224):
        from dfu_multimodal_tpu_torch.models.efficientnet import (
            EfficientNetB0)
        del image_size
        dtype = canonical_dtype(dtype)
        super().__init__(num_classes, drop_rate, feat_dim, dtype)
        self.rgb_encoder = EfficientNetB0(dtype)
        self.thermal_encoder = EfficientNetB0(dtype)

    def forward(self, rgb: torch.Tensor, thermal: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                features: Taps = None) -> torch.Tensor:
        """``features`` records each encoder's (B, 1280) features,
        ``rgb_encoder`` and ``thermal_encoder``."""
        return self.classify(
            tap(features, "rgb_encoder", self.rgb_encoder(rgb, generator)),
            tap(features, "thermal_encoder",
                self.thermal_encoder(thermal, generator)), generator)


class LegacyResNetEfficientNetFusion(_LegacyFusionHead):
    """ResNet-50 (``rgb_encoder``, torchvision keys) projected 2048 ->
    1280 (``rgb_proj``) and an EfficientNet-B0 ``thermal_encoder`` ->
    gated fusion -> 256 -> head (``legacy_rgb_resnet_fusion``)."""

    def __init__(self, num_classes: int = 2, drop_rate: float = 0.3,
                 feat_dim: int = 1280,
                 dtype: Union[str, torch.dtype] = torch.float32,
                 image_size: int = 224):
        from dfu_multimodal_tpu_torch.models.efficientnet import (
            EfficientNetB0)
        del image_size
        dtype = canonical_dtype(dtype)
        super().__init__(num_classes, drop_rate, feat_dim, dtype)
        self.rgb_encoder = ResNet50(dtype=dtype)
        self.rgb_proj = nn.Linear(2048, feat_dim)
        self.thermal_encoder = EfficientNetB0(dtype)

    def forward(self, rgb: torch.Tensor, thermal: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                features: Taps = None) -> torch.Tensor:
        """``features`` records each encoder's features: ``rgb_encoder``
        the ResNet-50's (B, 2048), before ``rgb_proj``, and
        ``thermal_encoder`` the EfficientNet's (B, 1280)."""
        rgb_feat = tap(features, "rgb_encoder", self.rgb_encoder(rgb))
        return self.classify(
            _dense(rgb_feat, self.rgb_proj, self.dtype),
            tap(features, "thermal_encoder",
                self.thermal_encoder(thermal, generator)), generator)


class LegacyClassifier(nn.Module):
    """1280 -> fc1 (256) -> ReLU -> Dropout(0.3) -> fc2 (1) -> sigmoid."""

    def __init__(self, feat_dim: int = 1280,
                 dtype: Union[str, torch.dtype] = torch.float32):
        super().__init__()
        self.dtype = canonical_dtype(dtype)
        self.fc1 = nn.Linear(feat_dim, 256)
        self.fc2 = nn.Linear(256, 1)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = F.relu(_dense(x, self.fc1, self.dtype))
        x = _train_dropout(self, x, 0.3, generator)
        return torch.sigmoid(self.fc2(x.float()))
