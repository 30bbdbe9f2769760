"""The registry's small smoke models (counterpart of the ``tiny_*``
entries of ``dfu_multimodal_tpu/models/zoo.py``): ``TinyCNN``
(``tiny_rgb``, ``tiny_thermal``) and the two-trunk ``TinyFusion``
(``tiny_fusion``).  Not in the reference; they let the CLIs and the
engine run in seconds on a CPU.

Two convs (16, 32 channels, 3x3, stride 2, with bias), each followed by
BatchNorm and ReLU, a global mean and a dropout, then a fp32 Linear head.
flax's ``padding="SAME"`` at stride 2 pads (0, 1) on an even input and
(1, 1) on an odd one, so the padding is explicit; flax's BatchNorm
``momentum=0.5`` is torch's ``momentum=0.5``.  The input is NHWC uint8
normalised to the compute dtype, as for the other models.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from dfu_multimodal_tpu_torch.models.common import (Taps, canonical_dtype,
                                                    dropout, tap)
from dfu_multimodal_tpu_torch.models.resnet import BatchNorm2d


def _same_pad(n: int, k: int = 3, s: int = 2) -> tuple:
    """flax/XLA "SAME" padding (lo, hi) of one spatial axis."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _dropout(model: nn.Module, x: torch.Tensor,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    if not model.training or model.drop_rate == 0.0:
        return x
    if generator is None:
        raise ValueError(f"{type(model).__name__} in train mode draws its "
                         "dropout from an explicit generator")
    return dropout(x, model.drop_rate, generator)


class TinyTrunk(nn.Module):
    """Two conv/BN/ReLU stages and a global mean: (B, H, W, 3) ->
    (B, 32) fp32 features."""

    def __init__(self, dtype: Union[str, torch.dtype] = torch.float32):
        super().__init__()
        self.dtype = canonical_dtype(dtype)
        self.conv0 = nn.Conv2d(3, 16, 3, stride=2)
        self.bn0 = BatchNorm2d(16, momentum=0.5)
        self.conv1 = nn.Conv2d(16, 32, 3, stride=2)
        self.bn1 = BatchNorm2d(32, momentum=0.5)

    def forward(self, x: torch.Tensor, taps: Taps = None) -> torch.Tensor:
        """``taps`` records ``features``, the last ReLU's (B, H, W, 32)."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)            # NCHW view
        for conv, bn in ((self.conv0, self.bn0), (self.conv1, self.bn1)):
            (top, bottom), (left, right) = (_same_pad(x.shape[2]),
                                            _same_pad(x.shape[3]))
            x = F.conv2d(F.pad(x, (left, right, top, bottom)),
                         conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                         stride=2)
            x = F.relu(bn(x))
        x = tap(taps, "features", x, channels_last=True)
        return x.mean(dim=(2, 3)).float()


class TinyCNN(TinyTrunk):
    """``tiny_rgb`` / ``tiny_thermal``: the trunk's layers (keys
    ``conv0``, ``bn0``, ``conv1``, ``bn1``, as the JAX scopes), dropout and
    ``head``.  Dropout draws from the ``generator`` given to forward in
    train mode.  ``image_size`` is accepted for the Trainer's uniform
    arguments."""

    def __init__(self, num_classes: int = 2, drop_rate: float = 0.2,
                 dtype: Union[str, torch.dtype] = torch.float32,
                 image_size: int = 224):
        super().__init__(dtype)
        del image_size
        self.drop_rate = drop_rate
        self.head = nn.Linear(32, num_classes)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                taps: Taps = None, features: Taps = None) -> torch.Tensor:
        """``features`` records ``trunk``, the pooled (B, 32) fp32
        features: the head's input."""
        feats = tap(features, "trunk", super().forward(x, taps))
        return self.head(_dropout(self, feats, generator))


class TinyFusion(nn.Module):
    """``tiny_fusion``: ``rgb_branch`` and ``thermal_branch`` trunks, their
    features concatenated (B, 64), dropout and ``head``.  Its trunks have
    no tap point, as in JAX: ``taps`` is taken and left empty.
    ``features`` records each trunk's (B, 32) features, ``rgb_branch``
    and ``thermal_branch``."""

    def __init__(self, num_classes: int = 2, drop_rate: float = 0.2,
                 dtype: Union[str, torch.dtype] = torch.float32,
                 image_size: int = 224):
        super().__init__()
        del image_size
        self.drop_rate = drop_rate
        self.rgb_branch = TinyTrunk(dtype)
        self.thermal_branch = TinyTrunk(dtype)
        self.head = nn.Linear(64, num_classes)

    def forward(self, rgb: torch.Tensor, thermal: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                taps: Taps = None, features: Taps = None) -> torch.Tensor:
        del taps
        fused = torch.cat([tap(features, "rgb_branch", self.rgb_branch(rgb)),
                           tap(features, "thermal_branch",
                               self.thermal_branch(thermal))], dim=-1)
        return self.head(_dropout(self, fused, generator))
