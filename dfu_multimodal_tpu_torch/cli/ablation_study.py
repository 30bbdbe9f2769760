"""Ablation study: single-modality baselines vs multimodal fusion (the
port's counterpart of ``dfu_multimodal_tpu/cli/ablation_study.py``).

Counterpart of reference notebooks/ablation_study.py: train the
RGB (ResNet50) and thermal (ViT) baselines for 15 epochs at batch 32 with
plain (unweighted) CE on the ``*_standardized`` directories, report best val
F1 per model and print the synergy interpretation (:331-347).  The reference
trains the multimodal model separately (its §3 prints a note); here the
``--with-multimodal`` flag optionally includes it in the same run.  Each
model's weights are drawn by ``zoo.init_model`` from ``--seed`` and
``Trainer.fit`` runs with no checkpoint directory, on ``--device``
(default ``cuda``; ``cpu`` asks for the host).

    python -m dfu_multimodal_tpu_torch.cli.ablation_study --data-dir <root>
"""

from __future__ import annotations

import argparse

from typing import Dict

import torch

from dfu_multimodal_tpu_torch import config as cfg_mod
from dfu_multimodal_tpu_torch.cli._train_common import (VIT_MODELS,
                                                        resolve_device)
from dfu_multimodal_tpu_torch.config import TrainConfig
from dfu_multimodal_tpu_torch.data.loader import (load_paired,
                                                  load_single_modality)
from dfu_multimodal_tpu_torch.models import zoo
from dfu_multimodal_tpu_torch.train.engine import Trainer


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Ablation study")
    cfg_mod.add_common_args(parser)
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--attention-impl", default="auto",
                        choices=["auto", "xla", "pallas"])
    parser.add_argument("--standardized-suffix", default="_standardized",
                        help="directory suffix; '' to use plain rgb/thermal")
    parser.add_argument("--with-multimodal", action="store_true",
                        help="also train the fusion model in this run")
    parser.add_argument("--rgb-model", default="rgb_only")
    parser.add_argument("--thermal-model", default="thermal_only")
    parser.add_argument("--multimodal-model", default="multimodal")
    return parser


def _train_one(name: str, zoo_name: str, datasets, modalities, cfg,
               attention_impl: str, image_size: int, device: torch.device):
    print(f"\n{name}")
    print("-" * 70)
    kwargs = ({"attention_impl": attention_impl}
              if zoo_name in VIT_MODELS else {})
    trainer = Trainer(zoo_name, cfg, modalities, device=device,
                      image_size=image_size, **kwargs)
    zoo.init_model(trainer.module,
                   torch.Generator(device=device).manual_seed(cfg.seed))
    history, best_f1 = trainer.fit(datasets["train"], datasets["val"],
                                   checkpoint_dir=None)
    return history, best_f1


def ablation_config(args) -> TrainConfig:
    """The reference ablation hyperparameters, overridden by the
    flags."""
    # reference ablation hyperparameters: 15 epochs, batch 32, AdamW 1e-4,
    # wd 1e-4, plain CE, plain shuffle (:172-173, 286)
    # `is not None` (not `or`): an explicit 0 — e.g. --weight-decay 0,
    # a legitimate no-decay ablation — must not be silently replaced by
    # the reference default
    return TrainConfig(
        batch_size=args.batch_size if args.batch_size is not None else 32,
        num_epochs=args.epochs if args.epochs is not None else 15,
        learning_rate=args.lr if args.lr is not None else 1e-4,
        weight_decay=(args.weight_decay
                      if args.weight_decay is not None else 1e-4),
        class_weighted_loss=False, weighted_sampling=False,
        save_best_after_epoch=1, seed=args.seed,
        compute_dtype=args.compute_dtype,
        mesh=cfg_mod.MeshConfig(data=args.mesh_data))


def main(argv=None) -> Dict[str, float]:
    args = build_parser().parse_args(argv)
    data_cfg = cfg_mod.data_config_from_args(args)
    device = resolve_device(args.device)
    base_cfg = ablation_config(args)
    size = args.image_size
    sfx = args.standardized_suffix

    print("=" * 70)
    print("ABLATION STUDY: MULTIMODAL FUSION EFFECTIVENESS")
    print("=" * 70)
    print(f"Device: {device}")

    def load_modality(modality):
        d = data_cfg.data_dir / f"{modality}{sfx}"
        if not d.exists():
            print(f"  ({d} not found; falling back to "
                  f"{data_cfg.data_dir / modality})")
            d = data_cfg.data_dir / modality
        return {split: load_single_modality(d, split, size, modality)
                for split in ("train", "val")}

    results: Dict[str, float] = {}

    print("\n1) RGB-ONLY BASELINE")
    _, rgb_f1 = _train_one("RGB-Only (ResNet50)", args.rgb_model,
                           load_modality("rgb"),
                           {"rgb": cfg_mod.rgb_modality()}, base_cfg,
                           args.attention_impl, size, device)
    results["rgb_only"] = rgb_f1

    print("\n2) THERMAL-ONLY BASELINE")
    _, th_f1 = _train_one("Thermal-Only (ViT)", args.thermal_model,
                          load_modality("thermal"),
                          {"thermal": cfg_mod.thermal_modality()}, base_cfg,
                          args.attention_impl, size, device)
    results["thermal_only"] = th_f1

    mm_f1 = None
    if args.with_multimodal:
        print("\n3) MULTIMODAL FUSION")
        datasets = {split: load_paired(data_cfg.data_dir, split, size,
                                       strategy="pseudo", seed=args.seed)
                    for split in ("train", "val")}
        _, mm_f1 = _train_one(
            "Multimodal Fusion", args.multimodal_model, datasets,
            {"rgb": cfg_mod.rgb_modality(),
             "thermal": cfg_mod.thermal_modality(blur=False)}, base_cfg,
            args.attention_impl, size, device)
        results["multimodal"] = mm_f1
    else:
        print("\n3) MULTIMODAL FUSION")
        print("Note: This requires paired RGB+Thermal dataset")
        print("Current implementation uses pseudo-pairing "
              "(different sources)")

    print("\n" + "=" * 70)
    print("ABLATION STUDY RESULTS")
    print("=" * 70)
    print("\nBEST VALIDATION F1-SCORES:")
    print(f"  RGB-Only (ResNet50):     {rgb_f1:.4f}")
    print(f"  Thermal-Only (ViT):      {th_f1:.4f}")
    if mm_f1 is not None:
        print(f"  Multimodal Fusion:       {mm_f1:.4f}")
    else:
        print("  Multimodal Fusion:       [Train separately - see below]")

    print("\nINTERPRETATION:")
    print("  If Multimodal F1 > max(RGB, Thermal):")
    print("    -> TRUE multimodal synergy exists")
    print("  If Multimodal F1 ~= max(RGB, Thermal):")
    print("    -> Fusion acts as ensemble (not complementary)")
    print("  If Multimodal F1 < sum(RGB, Thermal)/2:")
    print("    -> Single modalities better than fusion")
    return results


if __name__ == "__main__":
    main()
