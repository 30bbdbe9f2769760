"""Paired checkpoint comparison entry point (the port's counterpart of
``dfu_multimodal_tpu/cli/compare.py``; `dfu compare`).

Score two checkpoints on the SAME test rows and decide whether the
difference is real (eval/compare.py): McNemar exact test on the
discordant decisions, paired-bootstrap CIs on every metric delta, and
the decision-flip table::

    python -m dfu_multimodal_tpu_torch.cli.compare \\
        --checkpoint-a logs/checkpoints_rgb_only \\
        --checkpoint-b logs/checkpoints_multimodal --data-dir data

The models may be different families (rgb-only vs multimodal, teacher vs
distilled student, ingredient vs soup): the dataset is built over the
UNION of their input modalities — pseudo-paired when either needs both
(same strategy/seed as the multimodal trainer, reference
notebooks/train_multimodal_fusion.py pairing) — so both models always
score the identical row list.  Each checkpoint's persisted
``deployment.json`` (temperature scaling + operating-point threshold,
eval/deployment.py) is applied by default — the same auto-apply contract
as ``predict``/``serve`` — so the comparison is between the models AS
DEPLOYED, not raw argmax; ``--ignore-deployment`` opts out (both sides
then use the reference's argmax rule).  Both models run their eval step
on ``--device`` (default ``cuda``; ``cpu`` asks for the host).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from dfu_multimodal_tpu_torch import config as cfg_mod
from dfu_multimodal_tpu_torch.cli._train_common import resolve_device
from dfu_multimodal_tpu_torch.data.loader import (load_paired,
                                                  load_single_modality)
from dfu_multimodal_tpu_torch.eval.calibration import apply_temperature
from dfu_multimodal_tpu_torch.eval.compare import (compare_models,
                                                   format_report)
from dfu_multimodal_tpu_torch.eval.deployment import resolve_deployment
from dfu_multimodal_tpu_torch.eval.threshold import apply_threshold
from dfu_multimodal_tpu_torch.models import zoo
from dfu_multimodal_tpu_torch.train.engine import Trainer
from dfu_multimodal_tpu_torch.utils import checkpoint as ckpt_mod


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="paired statistical comparison of two checkpoints "
                    "(McNemar exact + paired-bootstrap metric deltas)")
    p.add_argument("--checkpoint-a", type=Path, required=True,
                   help="baseline checkpoint directory")
    p.add_argument("--checkpoint-b", type=Path, required=True,
                   help="candidate checkpoint directory")
    p.add_argument("--model-a", default=None,
                   help="zoo name for A (default: checkpoint meta)")
    p.add_argument("--model-b", default=None,
                   help="zoo name for B (default: checkpoint meta)")
    p.add_argument("--data-dir", type=Path, required=True)
    p.add_argument("--split", default="test", choices=["val", "test"])
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--compute-dtype", choices=["bfloat16", "float32"],
                   default="bfloat16")
    p.add_argument("--bootstrap", type=int, default=2000,
                   help="paired-bootstrap replicates (default 2000)")
    p.add_argument("--alpha", type=float, default=0.05,
                   help="significance level (default 0.05)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ignore-deployment", action="store_true",
                   help="score both models with raw argmax instead of "
                        "each checkpoint's persisted deployment.json "
                        "threshold/temperature")
    p.add_argument("--out", type=Path, default=None,
                   help="write the JSON report here "
                        "(default: <checkpoint-b>/compare_report.json)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda, the card); 'cpu' runs "
                        "on the host")
    return p


def _evaluate_checkpoint(ckpt_dir: Path, model_arg, dataset, args, device):
    if not ckpt_mod.best_checkpoint_exists(ckpt_dir):
        raise SystemExit(f"No best_model checkpoint under {ckpt_dir}")
    model_name = model_arg or ckpt_mod.load_meta(ckpt_dir).get(
        "model", "rgb_only")
    cfg = cfg_mod.TrainConfig(batch_size=args.batch_size,
                              eval_batch_size=args.batch_size,
                              compute_dtype=args.compute_dtype)
    trainer = Trainer(model_name, cfg,
                      {"rgb": cfg_mod.rgb_modality(),
                       "thermal": cfg_mod.thermal_modality()},
                      device=device, image_size=args.image_size)
    trainer.restore(ckpt_dir)
    _, arrays = trainer.run_eval_epoch(dataset)

    # the predict/serve auto-apply contract (eval/deployment.py): the
    # comparison should be between the models AS DEPLOYED
    deploy_note = "argmax (--ignore-deployment)"
    if not args.ignore_deployment:
        threshold, temperature, note = resolve_deployment(
            ckpt_dir, None, None)
        if temperature is not None:
            arrays["y_probs"] = apply_temperature(arrays["y_probs"],
                                                  temperature)
        if threshold is not None:
            arrays["y_pred"] = apply_threshold(arrays["y_probs"],
                                               threshold)
        deploy_note = note or "argmax (no deployment.json)"
    return model_name, arrays, deploy_note


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    name_a = args.model_a or ckpt_mod.load_meta(args.checkpoint_a).get(
        "model", "rgb_only")
    name_b = args.model_b or ckpt_mod.load_meta(args.checkpoint_b).get(
        "model", "rgb_only")
    needed = set(zoo.get(name_a).inputs) | set(zoo.get(name_b).inputs)
    if needed == {"rgb", "thermal"}:
        # same pairing strategy/seed as the multimodal trainer and the
        # robustness sweep, so the row list is reproducible
        ds = load_paired(args.data_dir, args.split, args.image_size,
                         strategy="pseudo", seed=42)
    else:
        (mod,) = needed
        ds = load_single_modality(args.data_dir / mod, args.split,
                                  args.image_size, mod)
    print(f"Comparing on {len(ds)} {args.split} rows "
          f"(modalities: {sorted(needed)})")

    _, arr_a, dep_a = _evaluate_checkpoint(args.checkpoint_a,
                                           args.model_a, ds, args, device)
    _, arr_b, dep_b = _evaluate_checkpoint(args.checkpoint_b,
                                           args.model_b, ds, args, device)
    assert np.array_equal(arr_a["y_true"], arr_b["y_true"])
    print(f"Decision rule A: {dep_a}")
    print(f"Decision rule B: {dep_b}")

    report = compare_models(
        arr_a["y_true"], arr_a["y_pred"], arr_a["y_probs"],
        arr_b["y_pred"], arr_b["y_probs"],
        n_boot=args.bootstrap, alpha=args.alpha, seed=args.seed)
    report["checkpoint_a"] = str(args.checkpoint_a)
    report["checkpoint_b"] = str(args.checkpoint_b)
    report["model_a"], report["model_b"] = name_a, name_b
    report["split"] = args.split
    report["decision_rule_a"], report["decision_rule_b"] = dep_a, dep_b

    print()
    print(format_report(report, name_a=name_a, name_b=name_b))

    out = args.out or (args.checkpoint_b / "compare_report.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2))
    print(f"\nReport written: {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
