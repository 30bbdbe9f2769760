"""Model-soup entry point (the port's counterpart of
``dfu_multimodal_tpu/cli/soup.py``; `dfu soup`).

Average the weights of several same-architecture checkpoints
(train/soup.py) into one deployable checkpoint::

    python -m dfu_multimodal_tpu_torch.cli.soup \\
        --checkpoints logs/run_seed1 logs/run_seed2 logs/run_seed3 \\
        --data-dir data --out logs/checkpoints_rgb_soup [--greedy]

Greedy mode ranks the candidates by their own val F1 and keeps an
ingredient only when the averaged model's val F1 does not drop.  The
output directory follows the standard artifact contract
(``best_model.pt`` + its meta + ``test_results.pt``), so predict, serve,
export_model and extended_metrics consume the soup like any trained
checkpoint.  The ingredients may be the port's checkpoints or the JAX
package's; every val/test evaluation runs on ``--device`` (default
``cuda``; ``cpu`` asks for the host).
"""

from __future__ import annotations

import argparse
from pathlib import Path

from dfu_multimodal_tpu_torch import config as cfg_mod
from dfu_multimodal_tpu_torch.cli._train_common import resolve_device
from dfu_multimodal_tpu_torch.data.loader import (load_paired,
                                                  load_single_modality)
from dfu_multimodal_tpu_torch.models import zoo
from dfu_multimodal_tpu_torch.train.engine import Trainer
from dfu_multimodal_tpu_torch.train.soup import (average_model_states,
                                                 greedy_soup)
from dfu_multimodal_tpu_torch.utils import checkpoint as ckpt_mod
from dfu_multimodal_tpu_torch.utils.artifacts import save_pt


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Average same-architecture checkpoints into one model")
    p.add_argument("--checkpoints", type=Path, nargs="+", required=True,
                   help="two or more checkpoint dirs of the SAME model")
    p.add_argument("--data-dir", type=Path, required=True)
    p.add_argument("--out", type=Path, required=True,
                   help="output checkpoint directory")
    p.add_argument("--model", default=None,
                   help="zoo name (default: read from the first "
                        "checkpoint's meta)")
    p.add_argument("--greedy", action="store_true",
                   help="greedy soup: add ingredients best-first, keep "
                        "only those that don't drop val F1")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--compute-dtype", choices=["bfloat16", "float32"],
                   default="bfloat16")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--skip-test-eval", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda, the card); 'cpu' runs "
                        "on the host")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if len(args.checkpoints) < 2:
        raise SystemExit("--checkpoints needs at least two directories")
    device = resolve_device(args.device)

    metas = [ckpt_mod.load_meta(d) for d in args.checkpoints]
    names = {m.get("model") for m in metas if m.get("model")}
    model_name = args.model or (names.pop() if len(names) == 1 else None)
    if model_name is None:
        raise SystemExit(
            f"checkpoint metas disagree on the model ({sorted(names)}); "
            "pass --model explicitly")
    mismatched = [str(d) for d, m in zip(args.checkpoints, metas)
                  if m.get("model") not in (None, model_name)]
    if mismatched:
        raise SystemExit(f"not {model_name!r} checkpoints: {mismatched}")

    spec = zoo.get(model_name)
    modalities = {"rgb": cfg_mod.rgb_modality(),
                  "thermal": cfg_mod.thermal_modality()}
    if set(spec.inputs) == {"rgb", "thermal"}:
        load = lambda split: load_paired(args.data_dir, split,
                                         args.image_size,
                                         strategy="pseudo", seed=args.seed)
    else:
        (mod,) = spec.inputs
        load = lambda split: load_single_modality(
            args.data_dir / mod, split, args.image_size, mod)
    val_ds, test_ds = load("val"), load("test")

    cfg = cfg_mod.TrainConfig(batch_size=args.batch_size,
                              eval_batch_size=args.batch_size,
                              compute_dtype=args.compute_dtype)
    trainer = Trainer(model_name, cfg, modalities, device=device,
                      image_size=args.image_size)
    target = {k: v.detach().cpu()
              for k, v in trainer.module.state_dict().items()}

    def load_state(d: Path):
        payload, _ = ckpt_mod.load_checkpoint(d, model_name=model_name)
        merged, _, _ = ckpt_mod.load_flexible(
            target, payload["model_state_dict"], verbose=False)
        return merged

    def val_f1(model_state) -> float:
        trainer.module.load_state_dict(model_state)
        m, _ = trainer.run_eval_epoch(val_ds)
        return m.f1

    candidates = [(str(d), load_state(d)) for d in args.checkpoints]
    print(f"Souping {len(candidates)} {model_name} checkpoints "
          f"({'greedy' if args.greedy else 'uniform'})")
    if args.greedy:
        soup_state, ingredients, soup_val = greedy_soup(candidates, val_f1)
    else:
        soup_state = average_model_states([s for _, s in candidates])
        ingredients = [n for n, _ in candidates]
        soup_val = val_f1(soup_state)
    print(f"Soup val F1: {soup_val:.4f} "
          f"({len(ingredients)}/{len(candidates)} ingredients)")

    ckpt_mod.save_checkpoint(
        args.out, epoch=0, model_state=soup_state, opt_state={},
        val_f1=soup_val, history={},
        extra_meta={"model": model_name,
                    "soup": {"recipe": "greedy" if args.greedy
                             else "uniform",
                             "ingredients": ingredients}})
    print(f"Soup checkpoint -> {args.out}")

    if not args.skip_test_eval:
        trainer.module.load_state_dict(soup_state)
        m, arrays = trainer.run_eval_epoch(test_ds)
        print(f"Soup test: acc {m.accuracy:.4f}, F1 {m.f1:.4f}")
        save_pt({"test_preds": arrays["y_pred"],
                 "test_labels": arrays["y_true"],
                 "test_probs": arrays["y_probs"],
                 "test_acc": m.accuracy, "test_f1": m.f1,
                 "test_loss": m.loss,
                 "soup_ingredients": ingredients},
                args.out / "test_results.pt")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
