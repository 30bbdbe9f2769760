"""Thermal-only training entry point (ViT-B/16), the port's counterpart of
``dfu_multimodal_tpu/cli/train_thermal_only.py`` and of the reference's
notebooks/train_thermal_only.py: batch 16, thermal normalization
(0.5/0.5), Gaussian-blur augmentation; on the card the ViT blocks train
through the port's fused kernels.

    python -m dfu_multimodal_tpu_torch.cli.train_thermal_only --data-dir <root>
"""

from __future__ import annotations

from dfu_multimodal_tpu_torch import config
from dfu_multimodal_tpu_torch.cli._train_common import TrainRecipe, run_training
from dfu_multimodal_tpu_torch.data.loader import load_single_modality


def _load(data_cfg, args):
    return {split: load_single_modality(
        data_cfg.data_dir / "thermal", split, data_cfg.image_size, "thermal")
        for split in ("train", "val", "test")}


RECIPE = TrainRecipe(
    name="thermal_only",
    model="thermal_only",
    title="Training Thermal-only model (ViT-Base)",
    modalities={"thermal": config.thermal_modality(blur=True)},
    defaults=config.TrainConfig(batch_size=16),
    load_datasets=_load,
)


def main(argv=None):
    return run_training(RECIPE, argv)


if __name__ == "__main__":
    main()
