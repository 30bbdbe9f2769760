"""Legacy-lineage training entry point, the early-files trainers
(counterpart of ``dfu_multimodal_tpu/cli/train_legacy.py``):

- ``--variant gated_fusion``      dual-EfficientNet gated fusion
  (train_RGB_Thermal_Unimodal_fusion.py, aligned pairing)
- ``--variant rgb_resnet_fusion`` ResNet-50 (-> 1280) + EfficientNet
  gated fusion with label-matched random pairing
  (train_rgb_resnet_fusion.py)
- ``--variant single_rgb``        the single-modality EfficientNet
  baseline (train_singleRGB.py)
- ``--variant smoke``             2 epochs of the single-RGB baseline
  (traiin_testfirst.py)

The legacy heads are standardised on the 2-class softmax contract (the
reference's one sigmoid unit with BCE is the documented divergence,
``models/fusion.py``).  The rest are the train CLIs' flags and artifacts
(``cli/_train_common.py``), on ``--device`` (default ``cuda``)::

    python -m dfu_multimodal_tpu_torch.cli.train_legacy \\
        --variant gated_fusion --data-dir <root>
"""

from __future__ import annotations

import argparse

from dfu_multimodal_tpu_torch import config
from dfu_multimodal_tpu_torch.cli._train_common import (TrainRecipe,
                                                         run_training)
from dfu_multimodal_tpu_torch.data.loader import (load_paired,
                                                  load_single_modality)

VARIANTS = {
    "gated_fusion": dict(model="legacy_gated_fusion", paired=True,
                         strategy="aligned", epochs=10),
    "rgb_resnet_fusion": dict(model="legacy_rgb_resnet_fusion", paired=True,
                              strategy="random", epochs=10),
    "single_rgb": dict(model="efficientnet_rgb", paired=False, epochs=10),
    "smoke": dict(model="efficientnet_rgb", paired=False, epochs=2),
}


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--variant", choices=sorted(VARIANTS),
                     default="gated_fusion")
    pre_args, rest = pre.parse_known_args(argv)
    variant = VARIANTS[pre_args.variant]

    def load(data_cfg, args):
        if variant["paired"]:
            return {split: load_paired(
                data_cfg.data_dir, split, data_cfg.image_size,
                strategy=variant["strategy"], seed=args.seed)
                for split in ("train", "val", "test")}
        return {split: load_single_modality(
            data_cfg.data_dir / "rgb", split, data_cfg.image_size, "rgb")
            for split in ("train", "val", "test")}

    recipe = TrainRecipe(
        name=f"legacy_{pre_args.variant}",
        model=variant["model"],
        title=f"Training legacy variant: {pre_args.variant}",
        # the early-files transforms: flips and rotation ±15° after
        # Normalize (mean fill), no jitter, affine or blur
        modalities={"rgb": config.legacy_rgb_modality(),
                    "thermal": config.legacy_thermal_modality()},
        defaults=config.TrainConfig(
            batch_size=16, num_epochs=variant["epochs"],
            # the legacy trainers: plain CE and plain shuffling
            class_weighted_loss=False, weighted_sampling=False,
            drop_rate=0.3),
        load_datasets=load,
    )
    return run_training(recipe, list(rest))


if __name__ == "__main__":
    main()
