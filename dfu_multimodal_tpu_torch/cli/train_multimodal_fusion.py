"""Multimodal late-fusion training entry point (ResNet50 + ViT-B/16), the
port's counterpart of ``dfu_multimodal_tpu/cli/train_multimodal_fusion.py``
and of the reference's notebooks/train_multimodal_fusion.py: the
pseudo-paired loader with modulo cycling seeded by ``--seed`` (:109-137),
batch 6, the dual-modality leakage gate, the 2816->512->256->2 fusion
head and the parameter-count report (:333-336).  The thermal
augmentation has the affine but no blur or jitter, as :191-199.

    python -m dfu_multimodal_tpu_torch.cli.train_multimodal_fusion --data-dir <root>
"""

from __future__ import annotations

import torch

from dfu_multimodal_tpu_torch import config
from dfu_multimodal_tpu_torch.cli._train_common import TrainRecipe, run_training
from dfu_multimodal_tpu_torch.data.loader import load_paired
from dfu_multimodal_tpu_torch.models import zoo


def _load(data_cfg, args):
    return {split: load_paired(
        data_cfg.data_dir, split, data_cfg.image_size, strategy="pseudo",
        seed=args.seed)
        for split in ("train", "val", "test")}


RECIPE = TrainRecipe(
    name="multimodal",
    model="multimodal",
    title="Training Multimodal Fusion model (ResNet50 + ViT)",
    modalities={"rgb": config.rgb_modality(),
                "thermal": config.thermal_modality(blur=False)},
    defaults=config.TrainConfig(batch_size=6),
    load_datasets=_load,
)


def main(argv=None):
    # parameter-count report, like the reference (:333-336); on the meta
    # device, so no weights are allocated for it
    with torch.device("meta"):
        module, _ = zoo.build(RECIPE.model)
    print(f"Total parameters: {zoo.param_count(module):,}")
    return run_training(RECIPE, argv)


if __name__ == "__main__":
    main()
