"""Test-time augmentation robustness evaluation over all three checkpoints
(the port's counterpart of
``dfu_multimodal_tpu/cli/test_time_augmentation.py``).

Counterpart of reference notebooks/test_time_augmentation.py:
clean (1x, no aug) vs TTA (5x light-aug) evaluation per model, robustness
comparison with the reference's verdict thresholds, and a
``tta_results.pt`` = {'model', 'clean_metrics', 'tta_metrics'} artifact in
each checkpoint dir (:535-539).  Multimodal evaluates aligned pairs;
every model runs at eval batch 8 (``eval/tta.py``), on ``--device``
(default ``cuda``; ``cpu`` asks for the host).

    python -m dfu_multimodal_tpu_torch.cli.test_time_augmentation --data-dir <root>
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict

from dfu_multimodal_tpu_torch import config as cfg_mod
from dfu_multimodal_tpu_torch.cli._train_common import resolve_device
from dfu_multimodal_tpu_torch.cli.extended_metrics import make_eval_trainer
from dfu_multimodal_tpu_torch.config import TrainConfig
from dfu_multimodal_tpu_torch.data.loader import (load_paired,
                                                  load_single_modality)
from dfu_multimodal_tpu_torch.eval.tta import (evaluate_with_tta,
                                               print_tta_comparison)
from dfu_multimodal_tpu_torch.utils import checkpoint as ckpt_mod
from dfu_multimodal_tpu_torch.utils.artifacts import save_pt

MODELS = (
    ("checkpoints_rgb_only", "rgb_only", "rgb_only", "RGB-Only (ResNet50)"),
    ("checkpoints_thermal_only", "thermal_only", "thermal_only",
     "Thermal-Only (ViT)"),
    ("checkpoints_multimodal", "multimodal", "multimodal",
     "Multimodal (ResNet50+ViT)"),
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Test-time augmentation evaluation")
    cfg_mod.add_common_args(parser)
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--num-tta", type=int, default=5)
    parser.add_argument("--attention-impl", default="auto",
                        choices=["auto", "xla", "pallas"])
    parser.add_argument("--models", nargs="*", default=None)
    parser.add_argument("--model-overrides", nargs="*", default=[],
                        metavar="NAME=ZOO")
    return parser


def main(argv=None) -> Dict[str, Dict]:
    args = build_parser().parse_args(argv)
    data_cfg = cfg_mod.data_config_from_args(args)
    device = resolve_device(args.device)
    overrides = dict(kv.split("=", 1) for kv in args.model_overrides)
    selected = set(args.models) if args.models else None
    size = args.image_size

    print("=" * 70)
    print("TEST-TIME AUGMENTATION EVALUATION")
    print("=" * 70)
    print(f"Device: {device}")

    # lazy per-model loading: with --models a subset, the other splits
    # are never decoded (and need not exist on disk)
    loaders = {
        "rgb_only": lambda: load_single_modality(
            data_cfg.data_dir / "rgb", "test", size, "rgb"),
        "thermal_only": lambda: load_single_modality(
            data_cfg.data_dir / "thermal", "test", size, "thermal"),
        "multimodal": lambda: load_paired(data_cfg.data_dir, "test", size,
                                          strategy="aligned"),
    }
    datasets = {}

    def get_dataset(subdir):
        if subdir not in datasets:
            datasets[subdir] = loaders[subdir]()
            print(f"Test set size ({subdir}): {len(datasets[subdir])}")
        return datasets[subdir]

    results: Dict[str, Dict] = {}
    for ckpt_name, subdir, zoo_default, display in MODELS:
        if selected is not None and subdir not in selected:
            continue
        ckpt_dir = Path(data_cfg.checkpoint_root) / ckpt_name
        print(f"\nEVALUATING {display.upper()}")
        if not ckpt_mod.best_checkpoint_exists(ckpt_dir):
            print(f"  Checkpoint not found: {ckpt_dir}")
            continue
        zoo_name = overrides.get(
            subdir, ckpt_mod.load_meta(ckpt_dir).get("model") or zoo_default)
        cfg = TrainConfig(batch_size=8, eval_batch_size=8,
                          compute_dtype=args.compute_dtype,
                          mesh=cfg_mod.MeshConfig(data=args.mesh_data))
        trainer = make_eval_trainer(zoo_name, args, size, device, cfg)
        print(f"Loading checkpoint: {ckpt_dir}")
        trainer.restore(ckpt_dir)

        print("\nRunning clean evaluation...")
        ds = get_dataset(subdir)
        clean = evaluate_with_tta(trainer, ds,
                                  num_tta=1, use_augmentation=False,
                                  seed=args.seed)
        print("Running TTA evaluation...")
        tta = evaluate_with_tta(trainer, ds,
                                num_tta=args.num_tta, use_augmentation=True,
                                seed=args.seed)
        print_tta_comparison(clean, tta, display)
        save_pt({"model": display.split(" ")[0],
                 "clean_metrics": clean, "tta_metrics": tta},
                ckpt_dir / "tta_results.pt")
        print("\nResults saved to tta_results.pt")
        results[subdir] = {"clean": clean, "tta": tta}
    return results


if __name__ == "__main__":
    main()
