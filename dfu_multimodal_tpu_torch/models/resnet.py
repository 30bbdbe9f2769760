"""ResNet-50 and the ResNet-18 student in PyTorch, torchvision key
layout, and their classifiers (``rgb_only``, ``resnet18_rgb``,
``resnet18_thermal``).

Counterpart of ``dfu_multimodal_tpu/models/resnet.py`` (``ResNet50``,
``ResNet18``, ``BasicBlock``, ``FusedBottleneck``, ``ResNetClassifier``).
torchvision "v1.5" bottleneck (stride on the 3x3 conv), keys ``conv1``,
``bn1``, ``layer{1-4}.{i}.conv{1,2,3}/bn{1,2,3}`` and
``layer{s}.0.downsample.{0,1}``; the ResNet-18 basic block (3x3 with the
stride, then 3x3; a 1x1 projection shortcut when the shape changes) has
torchvision's ``layer{s}.{i}.conv{1,2}/bn{1,2}`` and
``downsample.{0,1}``.
BN eps 1e-5; flax ``momentum=0.9`` is torch's ``momentum=0.1`` (the
default).  In train mode :class:`BatchNorm2d` keeps flax's statistics:
it normalises with the biased batch variance, as torch does, but moves
its running variance by the biased variance too (torch's ``BatchNorm2d``
moves it by the unbiased one, n/(n-1) larger).

The public input is NHWC like the JAX trunk; it is viewed as channels-last
NCHW (no copy) and the convs run channels-last in the compute dtype, with
the fp32 weights cast per call.  Returns fp32 pooled features (B, 2048).

``block_impl`` picks the bottleneck, as in JAX: ``"flax"`` runs every
block on cuDNN convs with BatchNorm; ``"fused"`` runs each stride-1
bottleneck in eval mode through the fused kernel (``ops/resnet_block.py``,
K11), BatchNorm folded into the convs per call; strided blocks and train
mode stay on cuDNN.  ``"auto"`` resolves to ``"flax"`` on every device, as
the JAX default does.  Both impls hold the same parameters and buffers.
Basic blocks have no kernel (as in JAX): they run on cuDNN whatever the
impl.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from dfu_multimodal_tpu_torch.models.common import (Taps, canonical_dtype,
                                                    dropout, tap)
from dfu_multimodal_tpu_torch.ops.resnet_block import FusedBottleneck

BLOCK_IMPLS = ("auto", "flax", "fused")


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    w = torch.empty_like(conv.weight, dtype=x.dtype,
                         memory_format=torch.channels_last).copy_(conv.weight)
    return F.conv2d(x, w, None, conv.stride, conv.padding)


def _fold_bn(conv: nn.Conv2d, bn: nn.BatchNorm2d
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval-time BN is affine per channel: fold it into the conv, in fp32.
    Returns the folded OIHW weight and the fp32 bias."""
    s = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    return conv.weight * s[:, None, None, None], bn.bias - bn.running_mean * s


def _dense(conv: nn.Conv2d, bn: nn.BatchNorm2d, dtype: torch.dtype
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A folded 1x1 conv as the kernel's (Cin, Cout) weight in ``dtype``."""
    w, b = _fold_bn(conv, bn)
    return w[:, :, 0, 0].t().to(dtype).contiguous(), b.contiguous()


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax ``nn.BatchNorm``'s train-mode
    statistics: the batch is normalised with its biased variance, and the
    running buffers move by ``momentum`` towards the batch mean and the
    biased variance.  ``F.batch_norm`` computes the batch statistics once
    (in fp32 for every input dtype) and moves the buffers by the unbiased
    variance; the batch's share of the running variance is then rescaled
    by (n − 1)/n, a per-channel fix.  Every row of the batch counts,
    padding rows included, as in JAX.  Eval mode is ``nn.BatchNorm2d``'s.

    A channel with one value (N·H·W = 1, which ``F.batch_norm`` refuses in
    train mode) is normalised as flax does: its batch variance is 0, so
    the output is the bias, the input and weight gradients are 0, and the
    running variance moves towards 0."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if x.numel() == x.shape[1]:
            return self._one_value(x)
        # the op keeps the variance for its backward: move a copy
        var = self.running_var.detach().clone()
        y = F.batch_norm(x, self.running_mean, var, self.weight, self.bias,
                         training=True, momentum=self.momentum, eps=self.eps)
        with torch.no_grad():
            n = x.numel() // x.shape[1]
            self.running_var.mul_(1.0 - self.momentum).lerp_(var,
                                                            (n - 1) / n)
            self.num_batches_tracked.add_(1)
        return y

    def _one_value(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode on an (1, C, 1, 1) batch, in fp32 as flax's
        statistics are: y = (x − mean)·rsqrt(var + eps)·w + b with the
        biased variance (0 here), written out so that autograd gives
        flax's gradients."""
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3), keepdim=True)
        var = (xf - mean).square().mean(dim=(0, 2, 3), keepdim=True)
        shape = (1, -1, 1, 1)
        y = ((xf - mean) * torch.rsqrt(var + self.eps)
             * self.weight.view(shape) + self.bias.view(shape))
        with torch.no_grad():
            m = self.momentum
            self.running_mean.lerp_(mean.flatten(), m)
            self.running_var.lerp_(var.flatten(), m)
            self.num_batches_tracked.add_(1)
        return y.to(x.dtype)


def _record(calibration: Optional[Dict[str, torch.Tensor]], key: str,
            x: torch.Tensor) -> None:
    """Fold max|x| (fp32) into ``calibration[key]`` (a running max)."""
    if calibration is None:
        return
    m = x.detach().float().abs().amax()
    calibration[key] = (m if key not in calibration
                        else torch.maximum(calibration[key], m))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, width: int, stride: int = 1):
        super().__init__()
        cout = width * self.expansion
        self.stride = stride
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, cout, 1, bias=False)
        self.bn3 = BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride=stride, bias=False),
                BatchNorm2d(cout))

    def forward(self, x: torch.Tensor,
                calibration: Optional[Dict[str, torch.Tensor]] = None
                ) -> torch.Tensor:
        """``calibration``: a dict in which the block keeps the running
        absmax of each conv input (``conv1_in``, ``conv2_in``,
        ``conv3_in``: the JAX ``calibrate=True`` keys; the projection
        reads conv1's input)."""
        _record(calibration, "conv1_in", x)
        y = F.relu(self.bn1(_conv(self.conv1, x)))
        _record(calibration, "conv2_in", y)
        y = F.relu(self.bn2(_conv(self.conv2, y)))
        _record(calibration, "conv3_in", y)
        y = self.bn3(_conv(self.conv3, y))
        shortcut = x
        if self.downsample is not None:
            shortcut = self.downsample[1](_conv(self.downsample[0], x))
        return F.relu(y + shortcut)

    def folded_weights(self, dtype: torch.dtype) -> Tuple[torch.Tensor, ...]:
        """The block in the fused kernels' layouts, BN folded into the
        convs in fp32: (w1, b1, w2, b2, w3, b3), plus (wd, bd) with a
        projection shortcut; weights in ``dtype``, biases fp32
        (``ops/resnet_block.py``).  Differentiable in the parameters."""
        w1, b1 = _dense(self.conv1, self.bn1, dtype)
        w2, b2 = _fold_bn(self.conv2, self.bn2)
        cmid = w2.shape[0]
        # row-stacked 3x3 taps, (dy, dx) row-major: HWIO reshaped
        w2 = w2.permute(2, 3, 1, 0).reshape(9 * cmid, cmid).to(dtype)
        w3, b3 = _dense(self.conv3, self.bn3, dtype)
        if self.downsample is None:
            return w1, b1, w2, b2, w3, b3
        return (w1, b1, w2, b2, w3, b3,
                *_dense(self.downsample[0], self.downsample[1], dtype))

    def forward_fused(self, x: torch.Tensor) -> torch.Tensor:
        """The same block through the fused kernel (stride 1, eval): BN
        folded into the convs, weights in x's dtype, biases fp32.  x and
        the result are channels-last NCHW; the kernel sees their NHWC
        views, so no copy is made either way."""
        if self.stride != 1:
            raise ValueError("the fused bottleneck is stride-1 only")
        w = self.folded_weights(x.dtype)
        out = FusedBottleneck.apply(x.permute(0, 2, 3, 1), *w,
                                    *(None,) * (8 - len(w)))
        return out.permute(0, 3, 1, 2)


class BasicBlock(nn.Module):
    """The ResNet-18/34 block (the JAX ``BasicBlock``, torchvision keys):
    relu(bn1(conv1 3x3, stride)), bn2(conv2 3x3), plus the shortcut (the
    block input, or bn(1x1 conv, stride) when the shape changes), ReLU."""

    expansion = 1

    def __init__(self, cin: int, width: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(cin, width, 3, stride=stride, padding=1,
                               bias=False)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(width)
        self.downsample = None
        if stride != 1 or cin != width:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, width, 1, stride=stride, bias=False),
                BatchNorm2d(width))

    def forward(self, x: torch.Tensor,
                calibration: Optional[Dict[str, torch.Tensor]] = None
                ) -> torch.Tensor:
        """``calibration`` as :meth:`Bottleneck.forward`'s: ``conv1_in``
        (which the projection shares) and ``conv2_in``."""
        _record(calibration, "conv1_in", x)
        shortcut = x
        if self.downsample is not None:
            shortcut = self.downsample[1](_conv(self.downsample[0], x))
        y = F.relu(self.bn1(_conv(self.conv1, x)))
        _record(calibration, "conv2_in", y)
        y = self.bn2(_conv(self.conv2, y))
        return F.relu(y + shortcut)


BLOCK_TYPES = {"bottleneck": Bottleneck, "basic": BasicBlock}


class ResNet(nn.Module):
    """ResNet trunk returning pooled fp32 features (B, widths[-1] x the
    block's expansion): bottleneck blocks (ResNet-50) or basic blocks
    (``block_type="basic"``, the ResNet-18 student)."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 widths: Sequence[int] = (64, 128, 256, 512),
                 dtype: Union[str, torch.dtype] = torch.float32,
                 block_impl: str = "auto", block_type: str = "bottleneck"):
        super().__init__()
        if block_impl not in BLOCK_IMPLS:
            raise ValueError(f"unknown block_impl {block_impl!r}; have "
                             f"{BLOCK_IMPLS}")
        block_cls = BLOCK_TYPES[block_type]
        self.dtype = canonical_dtype(dtype)
        self.block_impl = block_impl
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        cin = 64
        for i, (blocks, width) in enumerate(zip(stage_sizes, widths),
                                            start=1):
            layer = []
            for j in range(blocks):
                stride = 2 if i > 1 and j == 0 else 1
                layer.append(block_cls(cin, width, stride))
                cin = width * block_cls.expansion
            self.add_module(f"layer{i}", nn.Sequential(*layer))
        self.num_stages = len(stage_sizes)

    def forward(self, x: torch.Tensor, taps: Taps = None,
                calibration: Optional[Dict[str, Dict[str, torch.Tensor]]]
                = None) -> torch.Tensor:
        """x (B, H, W, 3) NHWC -> (B, C) fp32.  ``taps`` records
        ``stage1``..``stage4``, each stage's output as (B, H, W, C).
        ``calibration`` (a dict) receives, per block scope
        ``stage{s}_block{i}``, the running absmax of each conv input
        (:meth:`Bottleneck.forward`; the int8 trunk's calibration,
        ``models/resnet_q8.py``); the blocks then run on cuDNN."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)      # channels-last NCHW
        x = F.relu(self.bn1(_conv(self.conv1, x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        # eval only: train-mode BN needs batch statistics
        fused = (self.block_impl == "fused" and not self.training
                 and calibration is None)
        for i in range(1, self.num_stages + 1):
            for j, block in enumerate(getattr(self, f"layer{i}")):
                if fused and block.stride == 1 and isinstance(block,
                                                              Bottleneck):
                    x = block.forward_fused(x)
                elif calibration is not None:
                    x = block(x, calibration.setdefault(
                        f"stage{i}_block{j}", {}))
                else:
                    x = block(x)
            x = tap(taps, f"stage{i}", x, channels_last=True)
        return x.mean(dim=(2, 3)).float()


def ResNet50(dtype: Union[str, torch.dtype] = torch.float32,
             block_impl: str = "auto") -> ResNet:
    return ResNet((3, 4, 6, 3), (64, 128, 256, 512), dtype=dtype,
                  block_impl=block_impl)


def ResNet18(dtype: Union[str, torch.dtype] = torch.float32) -> ResNet:
    """The 11.2M-parameter trunk (512-d features): the distillation
    student."""
    return ResNet((2, 2, 2, 2), (64, 128, 256, 512), dtype=dtype,
                  block_type="basic")


class ResNetClassifier(nn.Module):
    """ResNet-50 trunk + Dropout + Linear(2048 -> num_classes) head in
    fp32: the reference's ``RGBOnlyModel`` (the ``rgb_only`` zoo model);
    ``trunk="resnet18"`` the ResNet-18 student with a 512-wide head
    (``resnet18_rgb``, ``resnet18_thermal``).  The trunk's keys carry the
    ``resnet.`` prefix, the head is ``head``.  Dropout is active in train
    mode and draws from the ``generator`` given to forward (required
    then).  ``block_impl`` picks the ResNet-50's bottleneck
    (:class:`ResNet`; the student's basic blocks have no kernel and
    ignore it, as in JAX), or ``"int8"`` the int8 serving trunk
    (``models/resnet_q8.py::Int8ResNet50`` / ``Int8ResNet18``, weights
    from ``quantize_rgb_trunks``).  ``image_size`` is accepted for the
    Trainer's uniform model arguments; the trunk pools any size."""

    def __init__(self, num_classes: int = 2, drop_rate: float = 0.5,
                 dtype: Union[str, torch.dtype] = torch.float32,
                 image_size: int = 224, block_impl: str = "auto",
                 trunk: str = "resnet50"):
        super().__init__()
        if trunk not in ("resnet50", "resnet18"):
            raise ValueError(f"unknown trunk {trunk!r}; have 'resnet50', "
                             "'resnet18'")
        del image_size
        self.drop_rate = drop_rate
        student = trunk == "resnet18"
        if block_impl == "int8":
            from dfu_multimodal_tpu_torch.models.resnet_q8 import (
                Int8ResNet18, Int8ResNet50)
            self.resnet = (Int8ResNet18 if student else Int8ResNet50)(
                dtype=dtype)
        elif student:
            self.resnet = ResNet18(dtype=dtype)
        else:
            self.resnet = ResNet50(dtype=dtype, block_impl=block_impl)
        self.head = nn.Linear(512 if student else 2048, num_classes)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                taps: Taps = None, features: Taps = None) -> torch.Tensor:
        """``taps`` records the trunk's ``stage1``..``stage4``;
        ``features`` records ``trunk``, its pooled (B, C) fp32 features:
        the head's input."""
        feats = tap(features, "trunk", self.resnet(x, taps))
        if self.training and self.drop_rate > 0.0:
            if generator is None:
                raise ValueError("ResNetClassifier in train mode draws its "
                                 "dropout from an explicit generator")
            feats = dropout(feats, self.drop_rate, generator)
        return self.head(feats)
