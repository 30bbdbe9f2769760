"""Semi-supervised self-training entry point (counterpart of
``dfu_multimodal_tpu/cli/self_train.py``).

For deployments with few labelled images and a directory of unlabelled
ones: train, pseudo-label the pool at a confidence threshold, retrain on
labelled + adopted images (``train/self_train.py``).  Composes with SSL
pretraining::

    python -m dfu_multimodal_tpu_torch.cli.pretrain --modality rgb \\
        --data-dir data --out pre_rgb
    python -m dfu_multimodal_tpu_torch.cli.self_train --modality rgb \\
        --data-dir data --unlabeled-dir pool_images/ --init-from pre_rgb \\
        --rounds 3 --threshold 0.9

The labelled set is ``data/<modality>/train`` (however small); val picks
the best round; test is only evaluated.  Writes
``checkpoints_<model>_selftrain/`` with ``round_*/`` of every round,
``best_model.pt`` + meta (the winning round's) and
``self_train_report.json`` (per-round adoption counts).  Runs on
``--device`` (default ``cuda``; ``cpu`` asks for the host).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from dfu_multimodal_tpu_torch.cli._train_common import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Semi-supervised self-training over an unlabeled pool")
    p.add_argument("--data-dir", type=Path, required=True,
                   help="root with <modality>/{train,val,test} labeled "
                        "splits (train may be tiny)")
    p.add_argument("--unlabeled-dir", type=Path, required=True,
                   help="flat directory of unlabeled images (the pool)")
    p.add_argument("--modality", choices=["rgb", "thermal"], default="rgb")
    p.add_argument("--model", default=None,
                   help="model-zoo name (default: the modality's "
                        "reference model — rgb_only / thermal_only)")
    p.add_argument("--checkpoint-root", type=Path, default=Path("logs"))
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--threshold", type=float, default=0.9,
                   help="adopt a pool image when max-class prob >= this")
    p.add_argument("--max-per-class", type=int, default=None,
                   help="per-round cap on adopted pseudo-labels per class")
    p.add_argument("--no-balance", action="store_true",
                   help="skip class-balancing the adopted set (default "
                        "adopts the min of the two classes' counts)")
    p.add_argument("--epochs", type=int, default=10,
                   help="training epochs per round")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--compute-dtype", choices=["bfloat16", "float32"],
                   default="bfloat16")
    p.add_argument("--lr-schedule", choices=["constant", "cosine"],
                   default="cosine",
                   help="cosine by default: every round is a short "
                        "fine-tune")
    p.add_argument("--init-from", type=Path, default=None,
                   help="warm-start EVERY round from this checkpoint "
                        "(e.g. a pretrain CLI's SSL trunk)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: the card; "
                        "'cpu' asks for the host)")
    return p


def main(argv=None) -> dict:
    """Returns the report (``self_train_report.json``'s contents, with the
    test metrics when the test split exists)."""
    from dfu_multimodal_tpu_torch import config as cfg_mod
    from dfu_multimodal_tpu_torch.data.layout import list_images
    from dfu_multimodal_tpu_torch.data.loader import (ArrayDataset,
                                                      decode_all,
                                                      load_single_modality)
    from dfu_multimodal_tpu_torch.train.self_train import (SelfTrainConfig,
                                                           self_train)

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    model = args.model or {"rgb": "rgb_only",
                           "thermal": "thermal_only"}[args.modality]
    modality = (cfg_mod.rgb_modality() if args.modality == "rgb"
                else cfg_mod.thermal_modality())

    labeled = load_single_modality(args.data_dir / args.modality, "train",
                                   args.image_size, args.modality)
    val_ds = load_single_modality(args.data_dir / args.modality, "val",
                                  args.image_size, args.modality)
    pool_paths = sorted(list_images(args.unlabeled_dir))
    if not pool_paths:
        raise SystemExit(f"no images under {args.unlabeled_dir}")
    pool = ArrayDataset(
        arrays={args.modality: decode_all(pool_paths, args.image_size)},
        labels=np.zeros(len(pool_paths), np.int32),     # ignored
        paths={args.modality: list(pool_paths)})

    print(f"Self-training {model}: {len(labeled)} labeled, "
          f"{len(pool)} unlabeled pool, {args.rounds} rounds @ "
          f"threshold {args.threshold}, on {device}")
    train_cfg = cfg_mod.TrainConfig(
        batch_size=args.batch_size, num_epochs=args.epochs,
        learning_rate=args.lr, weight_decay=args.weight_decay,
        seed=args.seed, compute_dtype=args.compute_dtype,
        lr_schedule=args.lr_schedule, save_best_after_epoch=1)
    st_cfg = SelfTrainConfig(rounds=args.rounds, threshold=args.threshold,
                             max_per_class=args.max_per_class,
                             balance=not args.no_balance)
    ckpt_dir = args.checkpoint_root / f"checkpoints_{model}_selftrain"
    trainer, report = self_train(
        model, st_cfg, train_cfg, {args.modality: modality}, labeled,
        pool, val_ds, ckpt_dir, init_from=args.init_from,
        image_size=args.image_size, device=device)

    out = {"model": model, "threshold": args.threshold, "rounds": report}
    (ckpt_dir / "self_train_report.json").write_text(
        json.dumps(out, indent=2))
    print(f"Report: {ckpt_dir / 'self_train_report.json'}")

    test_dir = args.data_dir / args.modality / "test"
    if test_dir.exists():
        test_ds = load_single_modality(args.data_dir / args.modality,
                                       "test", args.image_size,
                                       args.modality)
        m, _ = trainer.run_eval_epoch(test_ds)
        print(f"Test: acc {m.accuracy:.4f}, F1 {m.f1:.4f}")
        out["test"] = {"accuracy": m.accuracy, "f1": m.f1}
    return out


if __name__ == "__main__":
    main()
