"""ResNet-50 in PyTorch, torchvision key layout, eval on cuDNN.

Counterpart of ``dfu_multimodal_tpu/models/resnet.py`` (``ResNet50`` on the
flax/XLA conv path, which is the JAX default: its Pallas bottleneck is
opt-in).  torchvision "v1.5" bottleneck (stride on the 3x3 conv), keys
``conv1``, ``bn1``, ``layer{1-4}.{i}.conv{1,2,3}/bn{1,2,3}`` and
``layer{s}.0.downsample.{0,1}``.  BN eps 1e-5; flax ``momentum=0.9`` is
torch's ``momentum=0.1`` (the default).

The public input is NHWC like the JAX trunk; it is viewed as channels-last
NCHW (no copy) and the convs run channels-last in the compute dtype, with
the fp32 weights cast per call.  Returns fp32 pooled features (B, 2048).
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from dfu_multimodal_tpu_torch.models.common import canonical_dtype


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    w = torch.empty_like(conv.weight, dtype=x.dtype,
                         memory_format=torch.channels_last).copy_(conv.weight)
    return F.conv2d(x, w, None, conv.stride, conv.padding)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, width: int, stride: int = 1):
        super().__init__()
        cout = width * self.expansion
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, cout, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride=stride, bias=False),
                nn.BatchNorm2d(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(_conv(self.conv1, x)))
        y = F.relu(self.bn2(_conv(self.conv2, y)))
        y = self.bn3(_conv(self.conv3, y))
        shortcut = x
        if self.downsample is not None:
            shortcut = self.downsample[1](_conv(self.downsample[0], x))
        return F.relu(y + shortcut)


class ResNet(nn.Module):
    """Bottleneck ResNet trunk returning pooled fp32 features
    (B, 4·widths[-1])."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 widths: Sequence[int] = (64, 128, 256, 512),
                 dtype: Union[str, torch.dtype] = torch.float32):
        super().__init__()
        self.dtype = canonical_dtype(dtype)
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cin = 64
        for i, (blocks, width) in enumerate(zip(stage_sizes, widths),
                                            start=1):
            layer = []
            for j in range(blocks):
                stride = 2 if i > 1 and j == 0 else 1
                layer.append(Bottleneck(cin, width, stride))
                cin = width * Bottleneck.expansion
            self.add_module(f"layer{i}", nn.Sequential(*layer))
        self.num_stages = len(stage_sizes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, 3) NHWC -> (B, C) fp32."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)      # channels-last NCHW
        x = F.relu(self.bn1(_conv(self.conv1, x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for i in range(1, self.num_stages + 1):
            x = getattr(self, f"layer{i}")(x)
        return x.mean(dim=(2, 3)).float()


def ResNet50(dtype: Union[str, torch.dtype] = torch.float32) -> ResNet:
    return ResNet((3, 4, 6, 3), (64, 128, 256, 512), dtype=dtype)
