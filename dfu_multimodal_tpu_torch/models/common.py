"""Shared model utilities (counterpart of ``dfu_multimodal_tpu/models/
common.py``).  Only dtype plumbing is ported: the port's kernels have no
partitioner limit, so the Mosaic/SPMD gating has no counterpart."""

from __future__ import annotations

from typing import Union

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
