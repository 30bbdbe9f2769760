"""Knowledge-distillation entry point (counterpart of
``dfu_multimodal_tpu/cli/distill.py``): a trained checkpoint into a
smaller student (``train/distill.py``)::

    # same-modality compression: ResNet-50 -> ResNet-18
    python -m dfu_multimodal_tpu_torch.cli.distill \\
        --teacher-checkpoint logs/checkpoints_rgb_only \\
        --student resnet18_rgb --data-dir data

    # cross-modal: a multimodal teacher -> an RGB-only student
    python -m dfu_multimodal_tpu_torch.cli.distill \\
        --teacher-checkpoint logs/checkpoints_multimodal \\
        --student resnet18_rgb --data-dir data

The teacher loads from the port's ``best_model.pt`` or the JAX package's
``best_model.msgpack``.  Writes ``checkpoints_<student>_distilled/``
(``best_model.pt`` + meta and ``test_results.pt``, the train CLIs'
artifact contract), which the eval, predict, serve and export CLIs take
like any checkpoint.  Runs on ``--device`` (default ``cuda``; ``cpu``
asks for the host).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from dfu_multimodal_tpu_torch.cli._train_common import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Distill a trained teacher into a smaller student")
    p.add_argument("--teacher-checkpoint", type=Path, required=True)
    p.add_argument("--teacher-model", default=None,
                   help="zoo name of the teacher (default: read from the "
                        "checkpoint's meta)")
    p.add_argument("--student", default="resnet18_rgb",
                   help="zoo name of the student (resnet18_rgb / "
                        "resnet18_thermal / any zoo model)")
    p.add_argument("--data-dir", type=Path, required=True)
    p.add_argument("--checkpoint-root", type=Path, default=Path("logs"))
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--alpha", type=float, default=0.7,
                   help="weight of the soft-target KL term")
    p.add_argument("--temperature", type=float, default=4.0)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--compute-dtype", choices=["bfloat16", "float32"],
                   default="bfloat16")
    p.add_argument("--lr-schedule", choices=["constant", "cosine"],
                   default="cosine")
    p.add_argument("--qat", action="store_true",
                   help="quantization-aware distillation: the student "
                        "trains through its int8 serving grid (ResNet "
                        "stage convs / ViT encoder kernels snapped with "
                        "straight-through gradients, train/qat.py), so "
                        "the int8 student deployment is ~lossless")
    p.add_argument("--skip-test-eval", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: the card; "
                        "'cpu' asks for the host)")
    return p


def main(argv=None) -> int:
    from dfu_multimodal_tpu_torch import config as cfg_mod
    from dfu_multimodal_tpu_torch.data.loader import (load_paired,
                                                      load_single_modality)
    from dfu_multimodal_tpu_torch.models import zoo
    from dfu_multimodal_tpu_torch.train.distill import (DistillConfig,
                                                        DistillTrainer)
    from dfu_multimodal_tpu_torch.train.engine import (
        Trainer, class_weights_from_labels)
    from dfu_multimodal_tpu_torch.utils import checkpoint as ckpt_mod
    from dfu_multimodal_tpu_torch.utils.artifacts import save_pt

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    teacher_model = args.teacher_model or ckpt_mod.load_meta(
        args.teacher_checkpoint).get("model", "rgb_only")
    tspec, sspec = zoo.get(teacher_model), zoo.get(args.student)
    needed = tuple(dict.fromkeys(sspec.inputs + tspec.inputs))

    modalities = {"rgb": cfg_mod.rgb_modality(),
                  "thermal": cfg_mod.thermal_modality(
                      blur="multimodal" not in teacher_model)}

    # paired when teacher and student together span both modalities
    # (pseudo-pairing, the multimodal trainer's), one modality otherwise
    if set(needed) == {"rgb", "thermal"}:
        load = lambda split: load_paired(args.data_dir, split,
                                         args.image_size,
                                         strategy="pseudo", seed=args.seed)
    else:
        (mod,) = needed
        load = lambda split: load_single_modality(
            args.data_dir / mod, split, args.image_size, mod)
    train_ds, val_ds, test_ds = (load(s) for s in ("train", "val", "test"))

    tcfg = cfg_mod.TrainConfig(compute_dtype=args.compute_dtype)
    t_trainer = Trainer(teacher_model, tcfg, modalities, device=device,
                        image_size=args.image_size)
    t_trainer.load_weights(args.teacher_checkpoint)

    scfg = cfg_mod.TrainConfig(
        batch_size=args.batch_size, num_epochs=args.epochs,
        learning_rate=args.lr, weight_decay=args.weight_decay,
        seed=args.seed, compute_dtype=args.compute_dtype,
        lr_schedule=args.lr_schedule, save_best_after_epoch=1,
        qat=args.qat,
        steps_per_epoch=max(1, -(-len(train_ds) // args.batch_size)))
    dcfg = DistillConfig(alpha=args.alpha, temperature=args.temperature)
    trainer = DistillTrainer(args.student, teacher_model, t_trainer.module,
                             dcfg, scfg, modalities,
                             class_weights=class_weights_from_labels(
                                 train_ds.labels),
                             device=device, image_size=args.image_size)
    zoo.init_model(trainer.module, torch.Generator(
        device=device).manual_seed(args.seed))
    print(f"Distilling {teacher_model} "
          f"({zoo.param_count(t_trainer.module):,} params) -> "
          f"{args.student} ({zoo.param_count(trainer.module):,} params), "
          f"alpha {args.alpha}, T {args.temperature}, on {device}")

    ckpt_dir = (args.checkpoint_root
                / f"checkpoints_{args.student}_distilled")
    trainer.fit(train_ds, val_ds, checkpoint_dir=ckpt_dir)
    if ckpt_mod.best_checkpoint_exists(ckpt_dir):
        trainer.load_weights(ckpt_dir)
    else:
        print("  (no best checkpoint was saved; evaluating final state)")

    if not args.skip_test_eval:
        m, arrays = trainer.run_eval_epoch(test_ds)
        print(f"Student test: acc {m.accuracy:.4f}, F1 {m.f1:.4f}")
        tm, _ = t_trainer.run_eval_epoch(test_ds)
        print(f"Teacher test: acc {tm.accuracy:.4f}, F1 {tm.f1:.4f}")
        save_pt({
            "test_preds": arrays["y_pred"], "test_labels": arrays["y_true"],
            "test_probs": arrays["y_probs"], "test_acc": m.accuracy,
            "test_f1": m.f1, "test_loss": m.loss,
            "teacher_model": teacher_model,
            "teacher_test_f1": tm.f1,
            "alpha": args.alpha, "temperature": args.temperature},
            ckpt_dir / "test_results.pt")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
