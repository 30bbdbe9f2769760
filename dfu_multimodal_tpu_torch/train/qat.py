"""Quantization-aware training: straight-through fake-quant on the int8
serving grid (counterpart of ``dfu_multimodal_tpu/train/qat.py``).

The int8 serving paths quantise weights per output channel, symmetric,
at load time: the ViT encoder's four dense layers
(``ops/vit_block_q8.py::quantize_weight``) and the ResNet stage convs
after BatchNorm folding (``models/resnet_q8.py::quantize_conv_weight``).
QAT computes the loss through weights snapped to exactly that grid
(round and clip in the forward, identity gradient: w + (fq(w) − w)
detached), so the trained weights are robust to the conversion, and a
snapped weight requantises losslessly (its absmax element maps to
±127·scale, so the scale is reproduced).

The transform is functional: :func:`fake_quant_trunks` maps the model's
parameters by name to snapped tensors, and the Trainer runs the module on
them through ``torch.func.functional_call``.  The optimizer, the EMA copy
and checkpoints keep the real weights; the fused blocks' autograd
Functions read their weights from the module at call time and so receive
the snapped ones.  Scope (JAX's): every ViT encoder block's ``attn.qkv``,
``attn.proj``, ``mlp.fc1`` and ``mlp.fc2`` weight (an ``nn.Linear``'s
(out, in): the absmax runs over ``in``, JAX's axis -2 of (in, out)), and
every ResNet stage conv (``conv1..3`` and the ``downsample.0``
projection; OIHW: the absmax runs over (I, H, W), JAX's (H, W, I) of
HWIO).  The stem, BatchNorm, biases, LayerNorms, the patch embedding and
the heads stay as they are.  Folding BatchNorm before the snap is not
needed: per-channel symmetric quantisation commutes with the fold's
per-output-channel scalar (quantdequant(w·s) = quantdequant(w)·s).
Activation scales stay post-training calibration.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Sequence

import torch

from dfu_multimodal_tpu_torch.ops.vit_block_q8 import Q_MAX, over_qmax

Params = Dict[str, torch.Tensor]

VIT_TRUNKS = ("vit.", "thermal_branch.")
RESNET_TRUNKS = ("rgb_branch.", "resnet.")
# the encoder's quantised dense layers and the ResNet's stage convs
_VIT_DENSE = re.compile(r"blocks\.\d+\.(attn\.qkv|attn\.proj|mlp\.fc1|"
                        r"mlp\.fc2)\.weight")
_STAGE_CONV = re.compile(r"layer\d+\.\d+\.(conv\d|downsample\.0)\.weight")


def _snap(w: torch.Tensor, dims) -> torch.Tensor:
    """w snapped per output channel (absmax over ``dims``) to the int8
    grid, with an identity gradient."""
    wf = w.float()
    s = over_qmax(wf.abs().amax(dim=dims, keepdim=True)).clamp_min(1e-12)
    dq = torch.round(wf / s).clamp(-Q_MAX, Q_MAX) * s
    return (wf + (dq - wf).detach()).to(w.dtype)


def fake_quant_weight(w: torch.Tensor) -> torch.Tensor:
    """An ``nn.Linear`` weight (out, in) on the serving grid of
    ``quantize_weight`` (scale = absmax over ``in`` / 127), straight
    through."""
    return _snap(w, -1)


def fake_quant_conv_weight(w: torch.Tensor) -> torch.Tensor:
    """An OIHW conv weight on the serving grid of ``quantize_conv_weight``
    (scale = absmax over (I, H, W) / 127), straight through."""
    return _snap(w, (1, 2, 3))


def _apply(params: Mapping[str, torch.Tensor], prefixes: Sequence[str],
           pattern: re.Pattern, needs: str, fn) -> Params:
    new = dict(params)
    for prefix in prefixes:
        if prefix + needs not in params:
            continue
        for name, w in params.items():
            if name.startswith(prefix) and pattern.fullmatch(
                    name[len(prefix):]):
                new[name] = fn(w)
    return new


def fake_quant_vit_trunks(params: Mapping[str, torch.Tensor],
                          trunk_prefixes: Sequence[str] = VIT_TRUNKS
                          ) -> Params:
    """Snap every ViT trunk's encoder dense weights (``vit.`` of
    ``thermal_only``, ``thermal_branch.`` of ``multimodal``); int8 blocks
    (no ``weight``) and models without a ViT trunk pass through."""
    return _apply(params, trunk_prefixes, _VIT_DENSE, "cls_token",
                  fake_quant_weight)


def fake_quant_resnet_trunks(params: Mapping[str, torch.Tensor],
                             trunk_prefixes: Sequence[str] = RESNET_TRUNKS
                             ) -> Params:
    """Snap every ResNet trunk's stage convs (``resnet.`` of ``rgb_only``,
    ``rgb_branch.`` of ``multimodal``); the stem conv is untouched and
    models without a ResNet trunk pass through."""
    return _apply(params, trunk_prefixes, _STAGE_CONV, "conv1.weight",
                  fake_quant_conv_weight)


def fake_quant_trunks(params: Mapping[str, torch.Tensor]) -> Params:
    """The whole ``--qat`` transform: ViT encoder weights and ResNet stage
    convs on their int8 serving grids."""
    return fake_quant_resnet_trunks(fake_quant_vit_trunks(params))
