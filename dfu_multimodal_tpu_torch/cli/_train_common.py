"""Shared implementation of the three training entry points (counterpart
of ``dfu_multimodal_tpu/cli/_train_common.py``).

The reference scripts share one skeleton with per-model edits; here the
skeleton lives once and each CLI supplies a recipe: model name,
modalities, defaults, dataset loading.  Output contract, the JAX
package's with the port's checkpoints:
``<checkpoint-root>/checkpoints_<name>/`` holds ``best_model.pt`` (and
``last_model.pt`` with ``--save-last``) with their ``*.meta.json``,
``test_results.pt`` with keys test_preds / test_labels / test_probs /
test_acc / test_f1 / test_loss (reference notebooks/train_rgb_only.py:
372-379), ``run_info.json`` and ``drift_baseline.json``.

The run trains on ``--device`` (default ``cuda``; ``cpu`` asks for the
host).  The weights are drawn by ``zoo.init_model`` from ``--seed`` unless
``--resume`` or ``--init-from`` loads them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from dfu_multimodal_tpu_torch import config as cfg_mod
from dfu_multimodal_tpu_torch import native
from dfu_multimodal_tpu_torch.config import (DataConfig, ModalityConfig,
                                             TrainConfig)
from dfu_multimodal_tpu_torch.data.leakage import check_split_leakage
from dfu_multimodal_tpu_torch.data.loader import ArrayDataset
from dfu_multimodal_tpu_torch.eval import drift as drift_mod
from dfu_multimodal_tpu_torch.eval import metrics as metrics_mod
from dfu_multimodal_tpu_torch.models import zoo
from dfu_multimodal_tpu_torch.train.engine import (Trainer,
                                                   class_weights_from_labels)
from dfu_multimodal_tpu_torch.utils import checkpoint as ckpt_mod
from dfu_multimodal_tpu_torch.utils.artifacts import save_pt

VIT_MODELS = ("thermal_only", "multimodal")   # take --attention-impl


@dataclass(frozen=True)
class TrainRecipe:
    name: str                       # checkpoint dir suffix, e.g. "rgb_only"
    model: str                      # model-zoo name
    title: str                      # banner text
    modalities: Dict[str, ModalityConfig]
    defaults: TrainConfig
    load_datasets: Callable[[DataConfig, argparse.Namespace],
                            Dict[str, ArrayDataset]]
    leakage_name: str = ""


def build_parser(recipe: TrainRecipe) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=recipe.title)
    cfg_mod.add_common_args(parser)
    parser.add_argument("--model", default=recipe.model,
                        help="model-zoo name override (e.g. tiny_rgb for "
                             "smoke runs)")
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--attention-impl", default="auto",
                        choices=["auto", "xla", "pallas"])
    parser.add_argument("--no-leakage-check", action="store_true")
    parser.add_argument("--skip-test-eval", action="store_true")
    parser.add_argument("--resume", action="store_true",
                        help="resume from this run's best checkpoint "
                             "(model + optimizer state)")
    parser.add_argument("--init-from", type=Path, default=None,
                        help="warm-start the model weights from a "
                             "checkpoint directory (the port's or the JAX "
                             "package's) — fresh optimizer, epoch 1")
    parser.add_argument("--profile-dir", type=Path, default=None,
                        help="write a torch.profiler trace of epoch 2 here")
    parser.add_argument("--log-jsonl", type=Path, default=None,
                        help="append one machine-readable JSON object per "
                             "epoch (losses, accs, F1s, seconds, img/s/"
                             "chip) to this file — structured stream for "
                             "dashboards/run comparison")
    parser.add_argument("--debug-nans", action="store_true",
                        help="anomaly detection: raise at the backward op "
                             "that produced the first NaN")
    return parser


def resolve_device(name: str) -> torch.device:
    """``--device``: the card unless the caller asks for the CPU; a CUDA
    device on a host without one is an error, never a silent CPU run."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {name}: no CUDA device is available on this host; "
            "pass --device cpu to train on the CPU")
    return device


def _write_run_info(ckpt_dir: Path, recipe: TrainRecipe, args, train_cfg,
                    argv, device: torch.device) -> None:
    """Reproducibility manifest next to the checkpoint: the exact command,
    resolved config, library and device."""
    info = {
        "model": args.model,
        "recipe": recipe.name,
        "argv": list(sys.argv[1:] if argv is None else argv),
        "config": {k: (str(v) if isinstance(v, Path) else v)
                   for k, v in dataclasses.asdict(train_cfg).items()},
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": "gpu" if device.type == "cuda" else device.type,
        "device_count": 1,                # the port trains on one device
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "python": sys.version.split()[0],
    }
    (Path(ckpt_dir) / "run_info.json").write_text(
        json.dumps(info, indent=2, default=str))


def run_training(recipe: TrainRecipe,
                 argv: Optional[list] = None) -> Dict[str, float]:
    parser = build_parser(recipe)
    args = parser.parse_args(argv)
    train_cfg = cfg_mod.train_config_from_args(args, recipe.defaults)
    data_cfg = cfg_mod.data_config_from_args(args)
    device = resolve_device(args.device)

    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    ckpt_dir = Path(data_cfg.checkpoint_root) / f"checkpoints_{recipe.name}"
    ckpt_dir.mkdir(parents=True, exist_ok=True)

    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "host")
    print(f"Device: {device} ({name})")
    print(native.describe())
    print(f"Data Directory: {data_cfg.data_dir}")
    print(f"Checkpoint Directory: {ckpt_dir}\n")

    print("Loading datasets...")
    datasets = recipe.load_datasets(
        dataclasses.replace(data_cfg, image_size=args.image_size), args)
    for split in ("train", "val", "test"):
        ds = datasets[split]
        counts = ds.class_counts
        print(f"  {split.upper()}: {len(ds)} samples "
              f"({counts[0]} healthy, {counts[1]} ulcer)")

    if not args.no_leakage_check:
        for modality in datasets["train"].modalities:
            check_split_leakage(
                {split: datasets[split].paths.get(modality, [])
                 for split in ("train", "val", "test")},
                name=f"{recipe.leakage_name or recipe.name}/{modality}")

    labels = datasets["train"].labels
    class_weights = class_weights_from_labels(labels)
    counts = np.bincount(labels, minlength=2)
    print(f"\nTraining class counts: healthy={counts[0]}, ulcer={counts[1]}")
    print(f"Using class weights for loss: {class_weights.tolist()}")

    if (train_cfg.lr_schedule != "constant" or train_cfg.warmup_epochs
            ) and train_cfg.steps_per_epoch == 0:
        # schedules need a step horizon: ceil over the batch size
        spe = -(-len(datasets["train"]) // train_cfg.batch_size)
        train_cfg = dataclasses.replace(train_cfg, steps_per_epoch=spe)

    print("\nBuilding model...")
    model_kwargs = ({"attention_impl": args.attention_impl}
                    if args.model in VIT_MODELS else {})
    trainer = Trainer(args.model, train_cfg, recipe.modalities,
                      class_weights=class_weights, device=device,
                      image_size=args.image_size, **model_kwargs)
    if not args.resume and args.init_from is None:
        zoo.init_model(trainer.module, torch.Generator(
            device=device).manual_seed(train_cfg.seed))
    print(f"Model: {args.model} "
          f"(compute dtype {train_cfg.compute_dtype}, device {device})")

    print("\n" + "=" * 70)
    print(recipe.title.upper())
    print("=" * 70)
    history, best_val_f1 = trainer.fit(
        datasets["train"], datasets["val"], checkpoint_dir=ckpt_dir,
        profile_dir=args.profile_dir,
        resume_from=ckpt_dir if args.resume else None,
        init_from=args.init_from, metrics_jsonl=args.log_jsonl)

    print("\n" + "=" * 70)
    print(f"TRAINING COMPLETE - Best Val F1: {best_val_f1:.4f}")
    print("=" * 70)

    _write_run_info(ckpt_dir, recipe, args, train_cfg, argv, device)

    # Drift baseline: per-channel intensity histograms + moments of the
    # TRAIN split's raw uint8 images (eval/drift.py)
    drift_mod.save_baseline(
        ckpt_dir / drift_mod.BASELINE_FILENAME,
        drift_mod.baseline_from_arrays(datasets["train"].arrays,
                                       paths=datasets["train"].paths))

    results = {"best_val_f1": best_val_f1}
    if not args.skip_test_eval:
        print("\nEvaluating on test set...")
        # EMA runs validate and checkpoint the averaged weights: test the
        # same ones (the final epoch's EMA)
        with trainer.ema_weights():
            test_m, arrays = trainer.run_eval_epoch(datasets["test"])
        test_acc = metrics_mod.compute_all_metrics(
            arrays["y_true"], arrays["y_pred"])["accuracy"]
        print("\n" + "=" * 70)
        print(f"TEST RESULTS ({recipe.name.upper()})")
        print("=" * 70)
        print(f"Test Loss: {test_m.loss:.4f}")
        print(f"Test Acc:  {test_m.accuracy:.4f}")
        print(f"Test F1:   {test_m.f1:.4f}")
        print("=" * 70)

        save_pt({
            "test_preds": arrays["y_pred"],
            "test_labels": arrays["y_true"],
            "test_probs": arrays["y_probs"],
            "test_acc": test_m.accuracy,
            "test_f1": test_m.f1,
            "test_loss": test_m.loss,
        }, ckpt_dir / "test_results.pt")
        results.update(test_acc=test_acc, test_f1=test_m.f1,
                       test_loss=test_m.loss)
        print("\nTraining complete!")
        best = ckpt_dir / "best_model.pt"
        if best.exists():
            print(f"Best model saved to: {best}")
        else:
            # reference save contract: best-by-val-F1, epoch >=
            # save_best_after_epoch, STRICT improvement over 0.0 — a run
            # whose val F1 never rose above zero writes nothing
            print("WARNING: no best_model checkpoint was written — val F1 "
                  f"never improved after epoch "
                  f"{train_cfg.save_best_after_epoch} (train longer, or "
                  "lower --save-best-after)")
            last = ckpt_dir / f"{ckpt_mod.LAST_BASENAME}.pt"
            if last.exists():
                print(f"Last model saved to: {last}")
        print(f"Test results saved to: {ckpt_dir / 'test_results.pt'}")
    return results
