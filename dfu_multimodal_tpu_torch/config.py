"""Typed configuration of the port (counterpart of
``dfu_multimodal_tpu/config.py``).

A copy, field for field, of the dataclasses and factories the port uses:
the normalisation constants, ``AugmentConfig``, ``ModalityConfig`` with
``rgb_modality`` / ``thermal_modality`` and the legacy lineage's
``legacy_augment`` / ``legacy_rgb_modality`` / ``legacy_thermal_modality``,
and ``TrainConfig``.  The port
imports nothing of the JAX package; ``tests/test_torch_models.py`` checks
that these defaults equal the JAX package's, so the copy cannot drift.

``MeshConfig`` is the trainers' ``(data, model)`` mesh and FSDP switch
(``parallel/mesh.py``): outside a process group only the one device
exists, so a larger mesh raises; under ``torchrun`` ``data = -1`` takes
every rank.

The CLIs' argparse glue (``DataConfig``, ``add_common_args``,
``train_config_from_args``, ``data_config_from_args``) has the JAX
package's flags, defaults and help, and two flags of the port's own:
``--device`` (default ``cuda``), how a caller asks for the CPU, and
``--mesh-model``, the tensor-parallel axis the JAX package sets only in
code.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Tuple

IMAGE_SIZE = 224

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


def legacy_augment() -> AugmentConfig:
    """The early-files pipeline (reference scripts/early files/
    dataloader.py:123-147): h/v flips and rotation ±15° only, applied
    after Normalize, hence the mean-valued rotation fill."""
    return AugmentConfig(rotation_degrees=15.0, color_jitter=False,
                         affine=False, gaussian_blur=False,
                         fill_with_mean=True)


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


def legacy_rgb_modality() -> ModalityConfig:
    return ModalityConfig("rgb", RGB_MEAN, RGB_STD, legacy_augment())


def legacy_thermal_modality() -> ModalityConfig:
    return ModalityConfig("thermal", THERMAL_MEAN, THERMAL_STD,
                          legacy_augment())


@dataclass(frozen=True)
class MeshConfig:
    """``data`` ranks split the batch (-1: every rank ÷ ``model``),
    ``model`` ranks split the ViT blocks' Linears, ``fsdp`` shards the
    parameters over ``data`` (``parallel/``)."""

    data: int = -1
    model: int = 1
    fsdp: bool = False


@dataclass(frozen=True)
class TrainConfig:
    """Reference constants: train_rgb_only.py (batch 32),
    train_thermal_only.py (batch 16), train_multimodal_fusion.py (batch 6).
    ``mesh`` raises in the port's train step (``train.engine.Trainer``);
    ``qat`` trains through the int8 serving grids (``train/qat.py``)."""

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


@dataclass(frozen=True)
class DataConfig:
    data_dir: Path = Path.home() / "CompVis" / "Dataset" / "data"
    checkpoint_root: Path = Path("logs")
    image_size: int = IMAGE_SIZE
    cache_images: bool = True      # decode+resize once, keep uint8 in RAM
    prefetch: int = 2              # device prefetch depth (double buffering)
    # Persistent mmap-backed decode cache (data/cache.py): decode once
    # ACROSS runs, bounded-RAM build, datasets larger than host memory.
    # None = in-RAM decode per run (fine at reference scale).
    cache_dir: Optional[Path] = None


def add_common_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--data-dir", type=Path, default=None,
                        help="Root containing rgb/ and thermal/ split dirs")
    parser.add_argument("--checkpoint-root", type=Path, default=Path("logs"),
                        help="Directory for checkpoints and result artifacts")
    parser.add_argument("--cache-dir", type=Path, default=None,
                        help="persistent mmap-backed decode cache directory "
                             "(decode once across runs; datasets larger "
                             "than RAM). Also settable as DFU_CACHE_DIR.")
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--weight-decay", type=float, default=None)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--save-best-after", type=int, default=None,
                        help="first epoch eligible for best-checkpoint save "
                             "(reference: 3)")
    parser.add_argument("--compute-dtype", choices=["bfloat16", "float32"],
                        default="bfloat16")
    parser.add_argument("--optimizer-mu-dtype",
                        choices=["bfloat16", "float32"], default="bfloat16",
                        help="AdamW first-moment storage dtype (bf16 halves "
                             "the m-state HBM traffic; float32 for "
                             "bit-level optax parity)")
    parser.add_argument("--mesh-data", type=int, default=-1,
                        help="DP axis size (-1 = all devices)")
    parser.add_argument("--lr-schedule", choices=["constant", "cosine"],
                        default="constant",
                        help="constant (reference behavior) or cosine "
                             "decay over the full run")
    parser.add_argument("--warmup-epochs", type=float, default=0.0,
                        help="linear LR warmup over this many epochs "
                             "(fractional ok; composes with either "
                             "schedule)")
    parser.add_argument("--fsdp", action="store_true",
                        help="fully-sharded data parallelism: params + "
                             "optimizer state shard over the data axis "
                             "(ZeRO-3 memory scaling; XLA inserts the "
                             "per-use all-gathers)")
    parser.add_argument("--grad-accum", type=int, default=1,
                        help="microbatches per optimizer step (exact "
                             "full-batch gradients, ~N× lower activation "
                             "memory; batch size must divide evenly)")
    parser.add_argument("--ema-decay", type=float, default=0.0,
                        help="model EMA decay (e.g. 0.999): validate and "
                             "checkpoint with exponentially-averaged "
                             "weights; 0 = off (reference behavior)")
    parser.add_argument("--early-stop-patience", type=int, default=0,
                        help="stop after this many epochs without val-F1 "
                             "improvement; 0 = off (reference always "
                             "runs the full epoch budget)")
    parser.add_argument("--save-last", action="store_true",
                        help="also checkpoint every epoch as last_model.* "
                             "so --resume continues from the last "
                             "completed epoch (preemption-safe); the "
                             "best_model contract is unchanged")
    parser.add_argument("--async-checkpoint", action="store_true",
                        help="write best-model checkpoints in a "
                             "background thread over an on-device "
                             "snapshot (overlaps the device->host fetch "
                             "and disk write with the next epoch)")
    parser.add_argument("--qat", action="store_true",
                        help="quantization-aware training: loss through "
                             "ViT encoder kernels and ResNet stage convs "
                             "snapped to their int8 serving grids "
                             "(straight-through estimator), making "
                             "predict --int8 conversion ~lossless")
    parser.add_argument("--loss", choices=["ce", "focal"], default="ce",
                        help="training loss: class-weighted CE (reference "
                             "default) or focal loss (down-weights easy "
                             "examples; eval stays CE)")
    parser.add_argument("--focal-gamma", type=float, default=2.0,
                        help="focal-loss focusing exponent (with "
                             "--loss focal)")
    parser.add_argument("--mixup-alpha", type=float, default=0.0,
                        help="mixup Beta(a, a) strength (e.g. 0.2); "
                             "0 = off (reference behavior)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (default cuda, the "
                             "card); 'cpu' runs on the host")
    parser.add_argument("--mesh-model", type=int, default=1,
                        help="tensor-parallel axis size (Megatron splits "
                             "of the ViT blocks' Linears over this many "
                             "ranks; the data axis takes the rest)")


def train_config_from_args(args: argparse.Namespace,
                           defaults: TrainConfig) -> TrainConfig:
    updates = {}
    if args.batch_size is not None:
        updates["batch_size"] = args.batch_size
    if args.epochs is not None:
        updates["num_epochs"] = args.epochs
    if args.lr is not None:
        updates["learning_rate"] = args.lr
    if args.weight_decay is not None:
        updates["weight_decay"] = args.weight_decay
    if args.save_best_after is not None:
        updates["save_best_after_epoch"] = args.save_best_after
    updates["seed"] = args.seed
    updates["compute_dtype"] = args.compute_dtype
    updates["optimizer_mu_dtype"] = args.optimizer_mu_dtype
    updates["grad_accum"] = args.grad_accum
    updates["qat"] = args.qat
    updates["loss"] = getattr(args, "loss", "ce")
    updates["focal_gamma"] = getattr(args, "focal_gamma", 2.0)
    updates["mixup_alpha"] = getattr(args, "mixup_alpha", 0.0)
    updates["lr_schedule"] = getattr(args, "lr_schedule", "constant")
    updates["warmup_epochs"] = getattr(args, "warmup_epochs", 0.0)
    updates["ema_decay"] = getattr(args, "ema_decay", 0.0)
    updates["early_stop_patience"] = getattr(args, "early_stop_patience", 0)
    updates["async_checkpoint"] = getattr(args, "async_checkpoint", False)
    updates["save_last"] = getattr(args, "save_last", False)
    updates["mesh"] = MeshConfig(data=args.mesh_data,
                                 model=getattr(args, "mesh_model", 1),
                                 fsdp=getattr(args, "fsdp", False))
    return dataclasses.replace(defaults, **updates)


def data_config_from_args(args: argparse.Namespace) -> DataConfig:
    kwargs = {}
    if args.data_dir is not None:
        kwargs["data_dir"] = args.data_dir
    kwargs["checkpoint_root"] = args.checkpoint_root
    if getattr(args, "cache_dir", None) is not None:
        kwargs["cache_dir"] = args.cache_dir
        # Process-wide so every decode_all in this run — dataset loads,
        # predict/serve calibration batches — hits the same cache.
        import os
        os.environ["DFU_CACHE_DIR"] = str(args.cache_dir)
    return DataConfig(**kwargs)
