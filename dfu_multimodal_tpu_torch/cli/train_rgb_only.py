"""RGB-only training entry point (ResNet50), the port's counterpart of
``dfu_multimodal_tpu/cli/train_rgb_only.py`` and of the reference's
notebooks/train_rgb_only.py: batch 32, 10 epochs, AdamW 1e-4/1e-4,
dropout 0.5, best-after-epoch 3, the same data layout, leakage gate and
output files.

    python -m dfu_multimodal_tpu_torch.cli.train_rgb_only --data-dir <root>
"""

from __future__ import annotations

from dfu_multimodal_tpu_torch import config
from dfu_multimodal_tpu_torch.cli._train_common import TrainRecipe, run_training
from dfu_multimodal_tpu_torch.data.loader import load_single_modality


def _load(data_cfg, args):
    return {split: load_single_modality(
        data_cfg.data_dir / "rgb", split, data_cfg.image_size, "rgb")
        for split in ("train", "val", "test")}


RECIPE = TrainRecipe(
    name="rgb_only",
    model="rgb_only",
    title="Training RGB-only model (ResNet50)",
    modalities={"rgb": config.rgb_modality()},
    defaults=config.TrainConfig(batch_size=32),
    load_datasets=_load,
)


def main(argv=None):
    return run_training(RECIPE, argv)


if __name__ == "__main__":
    main()
