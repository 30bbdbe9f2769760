"""Shared model utilities (counterpart of ``dfu_multimodal_tpu/models/
common.py``).  Only dtype plumbing is ported, plus the classifiers'
dropout from an explicit generator: the port's kernels have no
partitioner limit, so the Mosaic/SPMD gating has no counterpart."""

from __future__ import annotations

from typing import Optional, Union

import torch

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
