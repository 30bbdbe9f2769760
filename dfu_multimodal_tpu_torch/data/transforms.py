"""Device-side eval transform (counterpart of the ``normalize`` /
``eval_normalize`` half of ``dfu_multimodal_tpu/data/transforms.py``).
Training augmentation is not ported yet."""

from __future__ import annotations

from typing import Sequence

import torch

from dfu_multimodal_tpu.config import ModalityConfig


def normalize(images: torch.Tensor, mean: Sequence[float],
              std: Sequence[float],
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8/float [0, 255] NHWC -> (x/255 - mean)/std NHWC in ``dtype``,
    computed in fp32 on the images' device."""
    x = images.float() / 255.0
    m = torch.tensor(mean, dtype=torch.float32, device=images.device)
    s = torch.tensor(std, dtype=torch.float32, device=images.device)
    return ((x - m) / s).to(dtype)


def eval_normalize(images: torch.Tensor, modality: ModalityConfig,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Eval-time transform: normalize only (resize happened at load)."""
    return normalize(images, modality.mean, modality.std, dtype)
