"""Typed configuration of the port (counterpart of
``dfu_multimodal_tpu/config.py``).

A copy, field for field, of the dataclasses and factories the port uses:
the normalisation constants, ``AugmentConfig``, ``ModalityConfig`` with
``rgb_modality`` / ``thermal_modality``, and ``TrainConfig``.  The port
imports nothing of the JAX package; ``tests/test_torch_models.py`` checks
that these defaults equal the JAX package's, so the copy cannot drift.

``MeshConfig`` is kept only as an inert field of ``TrainConfig`` (so the
two configs stay field-for-field equal): the port trains on one device,
and ``train.engine.Trainer`` raises ``NotImplementedError`` for any mesh
other than the single-device default.  The argparse glue and
``DataConfig`` belong to the CLIs and are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

# Normalisation constants (reference scripts/dataloader.py:157-159, 180-183)
RGB_MEAN = (0.485, 0.456, 0.406)
RGB_STD = (0.229, 0.224, 0.225)
THERMAL_MEAN = (0.5, 0.5, 0.5)
THERMAL_STD = (0.5, 0.5, 0.5)


@dataclass(frozen=True)
class AugmentConfig:
    """Device-side augmentation parameters (the reference training
    transforms): h/v flip p=0.5, rotation ±30°, then with probability
    ``aug_prob`` a colour jitter and/or an affine (±20°, translate 0.1,
    scale 0.8–1.2), and for thermal a Gaussian blur."""

    horizontal_flip_prob: float = 0.5
    vertical_flip_prob: float = 0.5
    rotation_degrees: float = 30.0
    aug_prob: float = 0.6
    color_jitter: bool = True
    brightness: float = 0.3
    contrast: float = 0.3
    saturation: float = 0.3
    affine: bool = True
    affine_degrees: float = 20.0
    affine_translate: float = 0.1
    affine_scale: Tuple[float, float] = (0.8, 1.2)
    gaussian_blur: bool = False
    blur_kernel_size: int = 3
    blur_sigma: Tuple[float, float] = (0.1, 0.5)
    # fill out-of-coverage pixels with the modality mean instead of black
    # (the early-files lineage that augments after Normalize)
    fill_with_mean: bool = False


def rgb_augment() -> AugmentConfig:
    return AugmentConfig(color_jitter=True, gaussian_blur=False)


def thermal_augment(blur: bool = True) -> AugmentConfig:
    return AugmentConfig(color_jitter=False, gaussian_blur=blur)


@dataclass(frozen=True)
class ModalityConfig:
    name: str = "rgb"
    mean: Tuple[float, float, float] = RGB_MEAN
    std: Tuple[float, float, float] = RGB_STD
    augment: AugmentConfig = field(default_factory=rgb_augment)


def rgb_modality() -> ModalityConfig:
    return ModalityConfig("rgb", RGB_MEAN, RGB_STD, rgb_augment())


def thermal_modality(blur: bool = True) -> ModalityConfig:
    return ModalityConfig("thermal", THERMAL_MEAN, THERMAL_STD,
                          thermal_augment(blur))


@dataclass(frozen=True)
class MeshConfig:
    """Inert in the port (see the module docstring): ``data`` -1 or 1,
    ``model`` 1 and ``fsdp`` False mean "this one device"."""

    data: int = -1
    model: int = 1
    fsdp: bool = False


@dataclass(frozen=True)
class TrainConfig:
    """Reference constants: train_rgb_only.py (batch 32),
    train_thermal_only.py (batch 16), train_multimodal_fusion.py (batch 6).
    ``qat`` and ``mesh`` raise in the port's train step
    (``train.engine.Trainer``)."""

    batch_size: int = 32
    num_epochs: int = 10
    learning_rate: float = 1e-4
    weight_decay: float = 1e-4
    drop_rate: float = 0.5
    save_best_after_epoch: int = 3
    seed: int = 42
    compute_dtype: str = "bfloat16"
    # AdamW first-moment storage dtype (the second moment stays fp32)
    optimizer_mu_dtype: str = "bfloat16"
    grad_accum: int = 1
    qat: bool = False
    lr_schedule: str = "constant"          # 'constant' | 'cosine'
    warmup_epochs: float = 0.0
    steps_per_epoch: int = 0
    ema_decay: float = 0.0
    early_stop_patience: int = 0
    async_checkpoint: bool = False
    save_last: bool = False
    loss: str = "ce"                       # 'ce' | 'focal'
    focal_gamma: float = 2.0
    mixup_alpha: float = 0.0
    eval_batch_size: Optional[int] = None  # defaults to batch_size
    weighted_sampling: bool = True         # WeightedRandomSampler equivalent
    class_weighted_loss: bool = True       # class-weighted CE equivalent
    mesh: MeshConfig = field(default_factory=MeshConfig)

    @property
    def eval_bs(self) -> int:
        return self.eval_batch_size or self.batch_size
