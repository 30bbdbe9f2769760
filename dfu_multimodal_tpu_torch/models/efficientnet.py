"""EfficientNet-B0, the legacy encoder lineage (counterpart of
``dfu_multimodal_tpu/models/efficientnet.py``).

The reference's ``EfficientNetEncoder`` is torchvision's
``efficientnet_b0`` without its classifier (1280-d pooled features), so
the keys here are torchvision's: ``features.0`` the stem (conv ``.0``,
BatchNorm ``.1``), ``features.{s+1}.{i}.block`` the MBConv blocks of
stage ``s`` (an expand conv/BN pair when the expand ratio is not 1, the
depthwise pair, ``SqueezeExcitation`` ``fc1`` / ``fc2``, the project
pair), ``features.8`` the 1x1 head conv and its BatchNorm.

As in the JAX model: BatchNorm eps 1e-3 and flax ``momentum=0.9``
(torch's 0.1) with flax's train-mode statistics
(``models/resnet.py::BatchNorm2d``), SiLU, the depthwise convolutions on
cuDNN (``groups`` = channels), and torchvision's stochastic depth in
train mode: a residual block's branch dropped per sample with a
probability ramped 0 -> 0.2 over the blocks, scaled by 1/keep, drawn from
the ``generator`` given to forward.  NHWC input, channels-last convs in
the compute dtype with the fp32 weights cast per call; fp32 features out.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from dfu_multimodal_tpu_torch.models.common import (Taps, canonical_dtype,
                                                    dropout, tap)
from dfu_multimodal_tpu_torch.models.resnet import BatchNorm2d

# (expand_ratio, channels, repeats, stride, kernel) per stage: B0
B0_STAGES: Tuple[Tuple[int, int, int, int, int], ...] = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)
BN_EPS, BN_MOMENTUM = 1e-3, 0.1


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` (no bias) on channels-last x, its weight cast to x's
    dtype; the depthwise convs pass ``groups``."""
    w = torch.empty_like(conv.weight, dtype=x.dtype,
                         memory_format=torch.channels_last).copy_(conv.weight)
    return F.conv2d(x, w, None, conv.stride, conv.padding, 1, conv.groups)


class ConvNormAct(nn.Sequential):
    """torchvision's ``Conv2dNormActivation`` keys: conv ``0``, BN ``1``
    (the activation is applied by the caller)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 groups: int = 1):
        super().__init__(
            nn.Conv2d(cin, cout, kernel, stride, kernel // 2, groups=groups,
                      bias=False),
            BatchNorm2d(cout, eps=BN_EPS, momentum=BN_MOMENTUM))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self[1](_conv(self[0], x))


class SqueezeExcitation(nn.Module):
    """Global mean -> 1x1 conv -> SiLU -> 1x1 conv -> sigmoid gate."""

    def __init__(self, channels: int, squeeze: int):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, squeeze, 1)
        self.fc2 = nn.Conv2d(squeeze, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = F.silu(F.conv2d(s, self.fc1.weight.to(x.dtype),
                            self.fc1.bias.to(x.dtype)))
        s = F.conv2d(s, self.fc2.weight.to(x.dtype),
                     self.fc2.bias.to(x.dtype))
        return x * torch.sigmoid(s)


class MBConv(nn.Module):
    """Inverted residual: [expand 1x1, SiLU], depthwise kxk, SiLU,
    squeeze-excite, project 1x1 (+ the residual, with stochastic depth,
    when the shape is kept)."""

    def __init__(self, cin: int, cout: int, expand_ratio: int, stride: int,
                 kernel: int, sd_rate: float = 0.0, se_ratio: float = 0.25):
        super().__init__()
        mid = cin * expand_ratio
        layers = []
        if expand_ratio != 1:
            layers.append(ConvNormAct(cin, mid, 1))
        layers += [ConvNormAct(mid, mid, kernel, stride, groups=mid),
                   SqueezeExcitation(mid, max(1, int(cin * se_ratio))),
                   ConvNormAct(mid, cout, 1)]
        self.block = nn.Sequential(*layers)
        self.residual = stride == 1 and cin == cout
        self.sd_rate = sd_rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        y = x
        for i, layer in enumerate(self.block):
            y = layer(y)
            # SiLU after the expand and the depthwise pairs
            if isinstance(layer, ConvNormAct) and i < len(self.block) - 1:
                y = F.silu(y)
        if not self.residual:
            return y
        if self.training and self.sd_rate > 0.0:
            if generator is None:
                raise ValueError("MBConv in train mode draws its stochastic "
                                 "depth from an explicit generator")
            keep = 1.0 - self.sd_rate
            mask = stochastic_depth_mask(generator, keep, y.shape[0])
            y = y * mask.to(y.dtype)[:, None, None, None] / keep
        return y + x


def stochastic_depth_mask(generator: torch.Generator, keep: float,
                          batch: int) -> torch.Tensor:
    """Per-sample {0, 1} keep mask (probability ``keep``) of a residual
    branch, drawn from ``generator`` on its device."""
    return (torch.rand(batch, generator=generator, device=generator.device)
            < keep).float()


class EfficientNetB0(nn.Module):
    """The trunk: NHWC (B, H, W, 3) -> pooled (B, 1280) fp32 features.
    ``taps`` records ``features``, the last stage's output (B, H, W,
    320), before the head conv, as the JAX tap."""

    def __init__(self, dtype: Union[str, torch.dtype] = torch.float32,
                 stages: Sequence[Tuple[int, int, int, int, int]] = B0_STAGES
                 ):
        super().__init__()
        self.dtype = canonical_dtype(dtype)
        layers = [ConvNormAct(3, 32, 3, 2)]
        total = sum(r for _, _, r, _, _ in stages)
        cin, block_id = 32, 0
        for expand, feats, repeats, stride, kernel in stages:
            blocks = []
            for bi in range(repeats):
                blocks.append(MBConv(cin, feats, expand,
                                     stride if bi == 0 else 1, kernel,
                                     sd_rate=0.2 * block_id / total))
                cin = feats
                block_id += 1
            layers.append(nn.Sequential(*blocks))
        layers.append(ConvNormAct(cin, 1280, 1))
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                taps: Taps = None) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)      # channels-last NCHW
        x = F.silu(self.features[0](x))
        for stage in self.features[1:-1]:
            for block in stage:
                x = block(x, generator)
        x = tap(taps, "features", x, channels_last=True)
        x = F.silu(self.features[-1](x))
        return x.mean(dim=(2, 3)).float()


class EfficientNetClassifier(nn.Module):
    """EfficientNet-B0 + Dropout + Linear head in fp32 (the legacy
    single-modality trainer's model: ``efficientnet_rgb``,
    ``efficientnet_thermal``); trunk keys under ``encoder.``.  Dropout and
    stochastic depth draw from the ``generator`` given to forward in train
    mode.  ``image_size`` is accepted for the Trainer's uniform model
    arguments."""

    def __init__(self, num_classes: int = 2, drop_rate: float = 0.2,
                 dtype: Union[str, torch.dtype] = torch.float32,
                 image_size: int = 224):
        super().__init__()
        del image_size
        self.drop_rate = drop_rate
        self.encoder = EfficientNetB0(dtype)
        self.head = nn.Linear(1280, num_classes)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                taps: Taps = None, features: Taps = None) -> torch.Tensor:
        """``taps`` records the trunk's ``features``; ``features`` records
        ``trunk``, the pooled (B, 1280) features: the head's input."""
        feats = tap(features, "trunk", self.encoder(x, generator, taps))
        if self.training and self.drop_rate > 0.0:
            if generator is None:
                raise ValueError("EfficientNetClassifier in train mode "
                                 "draws its dropout from an explicit "
                                 "generator")
            feats = dropout(feats, self.drop_rate, generator)
        return self.head(feats)
