"""Shared model utilities (counterpart of ``dfu_multimodal_tpu/models/
common.py``): dtype plumbing, the classifiers' dropout from an explicit
generator, and Grad-CAM tap points.  The port's kernels have no
partitioner limit, so the Mosaic/SPMD gating has no counterpart.

Tap points: every forward takes an optional ``taps`` record (a dict) and
fills it with its named activations, as the JAX models ``sow`` them into
``intermediates``.  The recorded tensor is the one the forward goes on
with, so it stays in the autograd graph and ``torch.autograd.grad`` of a
score with respect to it is d score / d activation: no hook, no second
forward, and no zero perturbation (JAX adds one only because ``jax.grad``
differentiates with respect to inputs).
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch

Taps = Optional[Dict[str, torch.Tensor]]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def canonical_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """'float32' / 'bfloat16' / a torch dtype -> the torch dtype."""
    if isinstance(dtype, str):
        try:
            return _DTYPES[dtype]
        except KeyError:
            raise ValueError(f"unknown compute dtype {dtype!r}; have "
                             f"{sorted(_DTYPES)}") from None
    return dtype


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout drawn from an explicit generator (on x's device):
    keep with probability 1 - rate and scale by 1/(1 - rate), as flax's
    ``nn.Dropout``."""
    if rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return x * keep.to(x.dtype) / (1.0 - rate)


def tap(taps: Taps, name: str, x: torch.Tensor,
        channels_last: bool = False) -> torch.Tensor:
    """Record ``x`` as tap ``name`` in ``taps`` (when given) and return
    the tensor the forward goes on with.  ``channels_last``: ``x`` is a
    channels-last NCHW activation; its NHWC view is recorded (the JAX
    tap's (B, H, W, C) layout, no copy) and the forward continues from
    that view, so the recorded tensor is on the path to the output."""
    if taps is None:
        return x
    if channels_last:
        nhwc = x.permute(0, 2, 3, 1)
        taps[name] = nhwc
        return nhwc.permute(0, 3, 1, 2)
    taps[name] = x
    return x
