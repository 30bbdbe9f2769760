"""Batch inference: classify a directory of images with a checkpoint (the
port's counterpart of ``dfu_multimodal_tpu/cli/predict.py``).

Point it at any directory (or paired rgb/thermal directories) and get
per-image probabilities and a CSV:

    python -m dfu_multimodal_tpu_torch.cli.predict --checkpoint logs/checkpoints_rgb_only \
        --images <dir> [--thermal-images <dir>] [--output preds.csv] \
        [--explain-dir <dir>]   # Grad-CAM evidence overlay per image

The model runs on ``--device`` (default ``cuda``).  ``--int8`` serves
``thermal_only`` on the int8 blocks; ``--explain-dir`` always
differentiates the full-fidelity restore.  ``--token-merge`` needs
``ops/token_merge.py`` and ``--int8`` of a ResNet trunk
``models/resnet_q8.py``, neither ported yet: both are refused with that
named.
"""

from __future__ import annotations

import argparse
import csv
import json
from pathlib import Path

import numpy as np

from dfu_multimodal_tpu_torch import config as cfg_mod
from dfu_multimodal_tpu_torch.cli._train_common import (VIT_MODELS,
                                                        resolve_device)
from dfu_multimodal_tpu_torch.cli.serve import UNPORTED
from dfu_multimodal_tpu_torch.config import TrainConfig
from dfu_multimodal_tpu_torch.data.layout import list_images
from dfu_multimodal_tpu_torch.data.loader import ArrayDataset, decode_all
from dfu_multimodal_tpu_torch.eval import drift as drift_mod
from dfu_multimodal_tpu_torch.eval import vit_attribution as va
from dfu_multimodal_tpu_torch.eval.calibration import apply_temperature
from dfu_multimodal_tpu_torch.eval.deployment import resolve_deployment
from dfu_multimodal_tpu_torch.eval.threshold import apply_threshold
from dfu_multimodal_tpu_torch.eval.tta import tta_predictions
from dfu_multimodal_tpu_torch.serve.engine import quantize_for_serving
from dfu_multimodal_tpu_torch.serve.explain import (explain_batch,
                                                    normalize_inputs,
                                                    render_overlay)
from dfu_multimodal_tpu_torch.train.engine import Trainer
from dfu_multimodal_tpu_torch.utils import checkpoint as ckpt_mod


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Batch inference")
    parser.add_argument("--checkpoint", type=Path, required=True)
    parser.add_argument("--model", default=None,
                        help="zoo name; default: checkpoint metadata")
    parser.add_argument("--images", type=Path, required=True,
                        help="directory of images (RGB modality for "
                             "multimodal models)")
    parser.add_argument("--thermal-images", type=Path, default=None,
                        help="paired thermal directory (multimodal models; "
                             "paired by sorted filename order)")
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--output", type=Path, default=None,
                        help="write CSV of path,prob_ulcer,prediction")
    parser.add_argument("--compute-dtype", default="bfloat16",
                        choices=["bfloat16", "float32"])
    parser.add_argument("--attention-impl", default="auto",
                        choices=["auto", "xla", "pallas"])
    parser.add_argument("--int8", action="store_true",
                        help="serve thermal_only on the int8 blocks "
                             "(weights quantised at load)")
    parser.add_argument("--threshold", type=float, default=None,
                        help="classify ulcer when P(ulcer) >= this value "
                             "instead of argmax")
    parser.add_argument("--temperature", type=float, default=None,
                        help="temperature-scale the reported probabilities "
                             "(sigmoid(logit(p)/T))")
    parser.add_argument("--tta", type=int, default=0, metavar="N",
                        help="test-time augmentation: average P(ulcer) "
                             "over N augmented views per image (majority-"
                             "vote predictions). 0 = off")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the --tta augmentations")
    parser.add_argument("--explain-dir", type=Path, default=None,
                        help="write a Grad-CAM evidence overlay PNG per "
                             "image (per provided modality) into this "
                             "directory")
    parser.add_argument("--explain-class", default="pred",
                        choices=["pred", "0", "1"],
                        help="class logit the CAM explains: the predicted "
                             "class per image (default) or a fixed class")
    parser.add_argument("--cam-method", default="saliency",
                        choices=["saliency", "rollout", "chefer"],
                        help="ViT-branch attribution for --explain-dir; "
                             "ResNet branches always use true Grad-CAM")
    parser.add_argument("--drift-check", action="store_true",
                        help="score the inputs' intensity distribution "
                             "against the checkpoint's drift_baseline.json "
                             "and print the report")
    parser.add_argument("--ignore-deployment", action="store_true",
                        help="do not auto-load <checkpoint>/"
                             "deployment.json")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda, the card); "
                             "'cpu' runs on the host")
    # refused: its module is not ported yet
    parser.add_argument("--token-merge", default=None, help=argparse.SUPPRESS)
    return parser


def write_explanations(trainer, arrays, paths, provided, out_dir: Path,
                       explain_class: str, batch_size: int,
                       cam_method: str = "saliency") -> int:
    """A Grad-CAM overlay PNG per (image, provided modality), one forward
    and backward a batch and branch: the batch counterpart of the daemon's
    /v1/explain (``serve/explain.py::explain_batch``)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    ci = "pred" if explain_class == "pred" else int(explain_class)
    if (cam_method != "saliency"
            and not va.supports_transformer_attribution(trainer.spec.name)):
        print(f"--cam-method {cam_method}: model {trainer.spec.name!r} "
              f"{va.DOWNGRADE_NOTE}")
        cam_method = "saliency"
    written = 0
    n = len(paths)
    for start in range(0, n, batch_size):
        sl = slice(start, min(start + batch_size, n))
        inputs = normalize_inputs(trainer, {m: arrays[m][sl]
                                            for m in trainer.spec.inputs})
        _, cams = explain_batch(trainer, inputs, provided, ci, cam_method)
        for k, pi in enumerate(range(sl.start, sl.stop)):
            stem = Path(paths[pi]).stem
            for m, (batch_cam, _) in cams.items():
                png = render_overlay(arrays[m][pi], batch_cam[k])
                (out_dir / f"{pi:05d}_{stem}_{m}.png").write_bytes(png)
                written += 1
    return written


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.token_merge:
        raise SystemExit(f"--token-merge needs {UNPORTED['token_merge']}, "
                         "which is not ported yet")
    device = resolve_device(args.device)
    model_name = args.model or ckpt_mod.load_meta(args.checkpoint).get(
        "model", "rgb_only")
    cfg = TrainConfig(batch_size=args.batch_size,
                      eval_batch_size=args.batch_size,
                      compute_dtype=args.compute_dtype)
    modalities = {"rgb": cfg_mod.rgb_modality(),
                  "thermal": cfg_mod.thermal_modality()}
    kwargs = ({"attention_impl": args.attention_impl}
              if model_name in VIT_MODELS else {})
    trainer = Trainer(model_name, cfg, modalities, device=device,
                      image_size=args.image_size, **kwargs)
    trainer.restore(args.checkpoint)

    paths = list_images(args.images)
    if not paths:
        print(f"No images found under {args.images}")
        return {}
    primary = trainer.spec.inputs[0]
    arrays = {primary: decode_all(paths, args.image_size)}
    if len(trainer.spec.inputs) > 1:
        th_paths = (list_images(args.thermal_images) if args.thermal_images
                    else paths)
        n = min(len(paths), len(th_paths))
        paths = paths[:n]
        arrays = {primary: arrays[primary][:n],
                  "thermal": decode_all(th_paths[:n], args.image_size)}

    if args.drift_check:
        baseline = drift_mod.load_baseline(
            args.checkpoint / drift_mod.BASELINE_FILENAME)
        if baseline is None:
            print(f"drift check: no {drift_mod.BASELINE_FILENAME} in "
                  f"{args.checkpoint} (written by training runs of this "
                  "framework) — skipping")
        else:
            mon = drift_mod.DriftMonitor(baseline, min_images=1)
            # score only the modalities the user supplied: without
            # --thermal-images a multimodal model's thermal array repeats
            # the RGB photos, which would read as major drift
            provided = {primary} | ({"thermal"} if args.thermal_images
                                    is not None else set())
            for m, arr in arrays.items():
                if m in provided:
                    mon.update(m, arr)
            rep = mon.report()
            print("DRIFT CHECK vs training-split baseline "
                  f"(verdict: {rep['verdict']}):")
            print(json.dumps(rep["modalities"], indent=2))

    # --explain-dir differentiates this full-fidelity restore, never the
    # int8 rebuild below
    base_trainer = trainer
    if args.int8:
        try:
            trainer = quantize_for_serving(trainer,
                                           image_size=args.image_size)
        except (ValueError, NotImplementedError) as e:
            raise SystemExit(f"--int8: {e}")

    n = len(paths)
    ds = ArrayDataset(arrays=arrays, labels=np.zeros(n, np.int32))
    if args.tta > 0:
        preds, probs = tta_predictions(trainer, ds, num_tta=args.tta,
                                       seed=args.seed)
        print(f"TTA: averaging {args.tta} augmented views per image")
    else:
        _, out = trainer.run_eval_epoch(ds)
        preds, probs = out["y_pred"], out["y_probs"]
    threshold, temperature, note = resolve_deployment(
        args.checkpoint, args.threshold, args.temperature,
        args.ignore_deployment)
    if note:
        print(f"Loaded {note}")
    if temperature is not None:
        probs = apply_temperature(probs, temperature)
        print(f"Calibration: temperature T={temperature}")
    if threshold is not None:
        preds = apply_threshold(probs, threshold)
        print(f"Operating point: P(ulcer) >= {threshold}")
    results = {str(p): (float(prob), int(pred))
               for p, prob, pred in zip(paths, probs, preds)}
    print(f"{'image':50s}  P(ulcer)  prediction")
    for p, (prob, pred) in results.items():
        print(f"{Path(p).name:50s}  {prob:8.4f}  "
              f"{'ulcer' if pred == 1 else 'healthy'}")

    if args.explain_dir is not None:
        provided = [primary] + (
            ["thermal"] if (len(trainer.spec.inputs) > 1
                            and args.thermal_images is not None) else [])
        written = write_explanations(
            base_trainer, arrays, paths, provided, args.explain_dir,
            args.explain_class, args.batch_size, cam_method=args.cam_method)
        print(f"\nWrote {written} evidence overlays to {args.explain_dir}")

    if args.output:
        with open(args.output, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["path", "prob_ulcer", "prediction"])
            for p, (prob, pred) in results.items():
                writer.writerow([p, f"{prob:.6f}",
                                 "ulcer" if pred == 1 else "healthy"])
        print(f"\nWrote {args.output}")
    return results


if __name__ == "__main__":
    main()
