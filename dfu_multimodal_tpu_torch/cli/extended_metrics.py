"""Extended medical-metrics evaluation over all three checkpoints (the
port's counterpart of ``dfu_multimodal_tpu/cli/extended_metrics.py``).

Counterpart of reference notebooks/extended_metrics.py: for each of
{rgb_only, thermal_only, multimodal} load the best checkpoint (the port's
``best_model.pt`` or a JAX ``best_model.msgpack``; flexible,
shape-mismatch-skipping, :40-92), evaluate the test split through the
eval step (on the card: the ViT blocks on K1/K2, the fusion head on K3),
compute the full medical metric set, emit ``results.pt`` +
confusion/ROC/PR PNGs (``eval/plots.py``, drawn by the port) into
``<out>/extended_metrics/<model>/`` (:715-734), and print the cross-model
summary comparison (:848-863).  Runs on ``--device`` (default ``cuda``;
``cpu`` asks for the host).

    python -m dfu_multimodal_tpu_torch.cli.extended_metrics --data-dir <root>
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, Optional

import numpy as np

import torch

from dfu_multimodal_tpu_torch import config as cfg_mod
from dfu_multimodal_tpu_torch.cli._train_common import (VIT_MODELS,
                                                        resolve_device)
from dfu_multimodal_tpu_torch.config import TrainConfig
from dfu_multimodal_tpu_torch.data.loader import (load_paired,
                                                  load_single_modality)
from dfu_multimodal_tpu_torch.eval import metrics as metrics_mod
from dfu_multimodal_tpu_torch.eval import plots
from dfu_multimodal_tpu_torch.train.engine import Trainer
from dfu_multimodal_tpu_torch.utils import checkpoint as ckpt_mod
from dfu_multimodal_tpu_torch.utils.artifacts import save_pt

# (checkpoint dir, display name, output subdir, model zoo name)
MODELS = (
    ("checkpoints_rgb_only", "RGB-Only", "rgb_only", "rgb_only"),
    ("checkpoints_thermal_only", "Thermal-Only", "thermal_only",
     "thermal_only"),
    ("checkpoints_multimodal", "Multimodal", "multimodal", "multimodal"),
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Extended medical metrics evaluation")
    cfg_mod.add_common_args(parser)
    parser.add_argument("--output-dir", type=Path, default=None,
                        help="default: <checkpoint-root>/extended_metrics")
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--attention-impl", default="auto",
                        choices=["auto", "xla", "pallas"])
    parser.add_argument("--models", nargs="*", default=None,
                        help="subset of rgb_only/thermal_only/multimodal")
    parser.add_argument("--model-overrides", nargs="*", default=[],
                        metavar="NAME=ZOO",
                        help="e.g. rgb_only=tiny_rgb for smoke runs")
    parser.add_argument("--operating-point", default=None,
                        metavar="STRATEGY",
                        help="also report metrics at a clinically tuned "
                             "probability threshold selected on the VAL "
                             "split: youden | f1 | sens@<floor> (e.g. "
                             "sens@0.95). Default 0.5/argmax metrics and "
                             "artifacts are unchanged; the tuned point is "
                             "reported alongside and saved under "
                             "'operating_point' in results.pt "
                             "(eval/threshold.py)")
    parser.add_argument("--calibration", action="store_true",
                        help="also report probability-calibration quality "
                             "(ECE / MCE / Brier, eval/calibration.py) and "
                             "write reliability_diagram_<model>.png; "
                             "results.pt gains a 'calibration' entry. "
                             "Default metrics and artifacts are unchanged")
    parser.add_argument("--calibration-bins", type=int, default=15,
                        help="equal-width probability bins for ECE/"
                             "reliability (default 15)")
    parser.add_argument("--bootstrap", type=int, default=0, metavar="N",
                        help="report nonparametric percentile-bootstrap "
                             "95%% CIs over N test-set resamples for the "
                             "headline metrics (eval/bootstrap.py); "
                             "results.pt gains a 'bootstrap' entry. "
                             "0 = off (reference behavior: bare point "
                             "estimates)")
    parser.add_argument("--bootstrap-alpha", type=float, default=0.05,
                        help="CI significance level (default 0.05 -> 95%% "
                             "intervals)")
    parser.add_argument("--temperature-from-val", action="store_true",
                        help="fit a temperature-scaling T on the VAL split "
                             "(Guo et al. 2017; implies --calibration) and "
                             "report test calibration before/after. "
                             "Rankings (and thus AUC/accuracy/F1) are "
                             "unchanged — only probability sharpness moves")
    parser.add_argument("--save-deployment", action="store_true",
                        help="persist the val-tuned operating point and/or "
                             "temperature as <checkpoint>/deployment.json; "
                             "predict and serve apply it automatically "
                             "(eval/deployment.py). With both, the "
                             "threshold is re-selected on temperature-"
                             "scaled val probabilities, matching the "
                             "inference order")
    return parser


def make_eval_trainer(zoo_name: str, args, image_size: int,
                      device: torch.device,
                      cfg: Optional[TrainConfig] = None) -> Trainer:
    """The evaluation trainer of the JAX CLI (batch 8, both modality
    configs); ``--attention-impl`` goes to the ViT models, as the train
    CLIs pass it."""
    cfg = cfg or TrainConfig(batch_size=8, compute_dtype=args.compute_dtype,
                             mesh=cfg_mod.MeshConfig(data=args.mesh_data))
    modalities = {"rgb": cfg_mod.rgb_modality(),
                  "thermal": cfg_mod.thermal_modality()}
    kwargs = ({"attention_impl": args.attention_impl}
              if zoo_name in VIT_MODELS else {})
    return Trainer(zoo_name, cfg, modalities, device=device,
                   image_size=image_size, **kwargs)


def evaluate_model(trainer: Trainer, ckpt_dir: Path, dataset,
                   val_dataset=None) -> Optional[Dict[str, np.ndarray]]:
    """Evaluate the checkpoint on ``dataset``; with ``val_dataset`` also
    returns the validation arrays (for operating-point selection) under
    the ``val_*`` keys."""
    if not ckpt_mod.best_checkpoint_exists(ckpt_dir):
        print(f"  Checkpoint not found: {ckpt_dir}")
        return None
    print(f"Loading: {ckpt_dir}")
    trainer.restore(ckpt_dir)
    _, arrays = trainer.run_eval_epoch(dataset)
    if val_dataset is not None:
        _, val_arrays = trainer.run_eval_epoch(val_dataset)
        arrays = dict(arrays, **{f"val_{k}": v
                                 for k, v in val_arrays.items()})
    return arrays


def _write_evaluation_summary(out_root: Path, datasets, all_results,
                              data_cfg) -> Path:
    """EVALUATION_SUMMARY.txt — the reference's committed artifact format
    (reference logs/EVALUATION_SUMMARY.txt)."""
    import datetime

    bar = "=" * 80
    lines = [bar, "DFU MULTIMODAL MODEL EVALUATION SUMMARY", bar,
             f"Date: {datetime.datetime.now().isoformat(timespec='seconds')}",
             "", "DATASETS USED:"]
    for subdir, label in (("rgb_only", "RGB Test Set"),
                          ("thermal_only", "Thermal Test Set"),
                          ("multimodal", "Multimodal Test Set")):
        ds = datasets.get(subdir)
        if ds is None:        # model not selected: split never loaded
            continue
        healthy, ulcer = ds.class_counts
        lines.append(f"- {label}: {len(ds)} samples "
                     f"({healthy} healthy, {ulcer} ulcer)")
    lines += ["", bar, "EXTENDED METRICS RESULTS (Test Set Performance)",
              bar, ""]
    for name, m in all_results.items():
        lines.append(f"{name.upper()} MODEL:")
        lines.append(f"  F1-Score:        {m['f1']:.4f}")
        lines.append(f"  Accuracy:        {m['accuracy']:.4f}")
        lines.append(f"  Sensitivity:     {m['sensitivity']:.4f}")
        lines.append(f"  Specificity:     {m['specificity']:.4f}")
        auc = m["auc_roc"]
        lines.append(f"  ROC-AUC:         "
                     f"{auc:.4f}" if auc is not None else "  ROC-AUC: N/A")
        lines.append(f"  Confusion Matrix: TN={m['tn']}, FP={m['fp']}, "
                     f"FN={m['fn']}, TP={m['tp']}")
        lines.append("")
    lines.append(bar)
    path = Path(out_root) / "EVALUATION_SUMMARY.txt"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(lines) + "\n")
    return path


def main(argv=None) -> Dict[str, Dict]:
    args = build_parser().parse_args(argv)
    data_cfg = cfg_mod.data_config_from_args(args)
    device = resolve_device(args.device)
    out_root = args.output_dir or (Path(data_cfg.checkpoint_root)
                                   / "extended_metrics")
    overrides = dict(kv.split("=", 1) for kv in args.model_overrides)
    selected = set(args.models) if args.models else None

    print("=" * 70)
    print("EXTENDED MEDICAL METRICS EVALUATION")
    print("=" * 70)
    print(f"Device: {device}")

    print("\nLoading test datasets...")
    size = args.image_size

    # Lazy per-model dataset loading: with --models a subset, the other
    # splits are never decoded (and their directories need not exist) —
    # previously all three test+val sets were fully decoded up front
    # even when evaluating one model.
    _loaders = {
        "rgb_only": lambda split: load_single_modality(
            data_cfg.data_dir / "rgb", split, size, "rgb"),
        "thermal_only": lambda split: load_single_modality(
            data_cfg.data_dir / "thermal", split, size, "thermal"),
        "multimodal": lambda split: load_paired(
            data_cfg.data_dir, split, size, strategy="pseudo",
            seed=args.seed),
    }
    _ds_cache: Dict = {}

    def get_dataset(split, subdir):
        key = (split, subdir)
        if key not in _ds_cache:
            _ds_cache[key] = _loaders[subdir](split)
        return _ds_cache[key]

    if args.save_deployment and not (args.operating_point
                                     or args.temperature_from_val):
        raise SystemExit("--save-deployment needs --operating-point and/or "
                         "--temperature-from-val (nothing to persist)")

    need_val = bool(args.operating_point or args.temperature_from_val)

    all_results: Dict[str, Dict] = {}
    for ckpt_name, display, subdir, zoo_default in MODELS:
        if selected is not None and subdir not in selected:
            continue
        print(f"\n{'=' * 70}\nEVALUATING {display.upper()} MODEL\n{'=' * 70}")
        # model name resolution: explicit override > checkpoint metadata >
        # the canonical default for this slot
        ckpt_dir = Path(data_cfg.checkpoint_root) / ckpt_name
        meta_model = ckpt_mod.load_meta(ckpt_dir).get("model")
        zoo_name = overrides.get(subdir, meta_model or zoo_default)
        trainer = make_eval_trainer(zoo_name, args, size, device)
        arrays = evaluate_model(
            trainer, Path(data_cfg.checkpoint_root) / ckpt_name,
            get_dataset("test", subdir),
            val_dataset=(get_dataset("val", subdir) if need_val
                         else None))
        if arrays is None:
            continue

        metrics = metrics_mod.compute_all_metrics(
            arrays["y_true"], arrays["y_pred"], arrays["y_probs"])
        metrics_mod.print_report(metrics, display)

        op_payload = None
        if args.operating_point:
            from dfu_multimodal_tpu_torch.eval import threshold as thr_mod
            try:
                t, info = thr_mod.pick_threshold(
                    arrays["val_y_true"], arrays["val_y_probs"],
                    args.operating_point)
                op_pred = thr_mod.apply_threshold(arrays["y_probs"], t)
                op_metrics = metrics_mod.compute_all_metrics(
                    arrays["y_true"], op_pred, arrays["y_probs"])
                op_payload = {"info": info, "metrics": op_metrics}
                print(f"\nOPERATING POINT ({info['strategy']}, selected "
                      f"on val): threshold={t:.4f} "
                      f"(val sens={info['selection_sensitivity']:.4f}, "
                      f"spec={info['selection_specificity']:.4f})")
                print(f"  test at tuned point:  "
                      f"acc={op_metrics['accuracy']:.4f} "
                      f"F1={op_metrics['f1']:.4f} "
                      f"sens={op_metrics['sensitivity']:.4f} "
                      f"spec={op_metrics['specificity']:.4f}")
                print(f"  test at default 0.5:  "
                      f"acc={metrics['accuracy']:.4f} "
                      f"F1={metrics['f1']:.4f} "
                      f"sens={metrics['sensitivity']:.4f} "
                      f"spec={metrics['specificity']:.4f}")
            except ValueError as e:
                print(f"\nOPERATING POINT skipped: {e}")

        out_dir = out_root / subdir
        out_dir.mkdir(parents=True, exist_ok=True)

        boot_payload = None
        if args.bootstrap > 0:
            from dfu_multimodal_tpu_torch.eval import bootstrap as boot_mod
            boot_payload = boot_mod.bootstrap_cis(
                arrays["y_true"], arrays["y_pred"], arrays["y_probs"],
                n_boot=args.bootstrap, alpha=args.bootstrap_alpha,
                seed=args.seed)
            print("\n" + boot_mod.format_cis(boot_payload, display))

        cal_payload = None
        if args.calibration or args.temperature_from_val:
            from dfu_multimodal_tpu_torch.eval import calibration as cal_mod
            errors = cal_mod.calibration_errors(
                arrays["y_true"], arrays["y_probs"], args.calibration_bins)
            cal_payload = {"errors": errors}
            temperature = None
            print(f"\nCALIBRATION (test, {args.calibration_bins} bins): "
                  f"ECE={errors['ece']:.4f} MCE={errors['mce']:.4f} "
                  f"Brier={errors['brier']:.4f}")
            if args.temperature_from_val:
                try:
                    temperature, info = cal_mod.fit_temperature(
                        arrays["val_y_true"], arrays["val_y_probs"])
                    scaled = cal_mod.apply_temperature(arrays["y_probs"],
                                                       temperature)
                    errors_after = cal_mod.calibration_errors(
                        arrays["y_true"], scaled, args.calibration_bins)
                    cal_payload.update(temperature=info,
                                       errors_after=errors_after,
                                       y_probs_scaled=scaled)
                    print(f"  temperature T={temperature:.4f} fitted on "
                          f"val (NLL {info['selection_nll_before']:.4f} -> "
                          f"{info['selection_nll_after']:.4f})")
                    print(f"  test after scaling:  "
                          f"ECE={errors_after['ece']:.4f} "
                          f"MCE={errors_after['mce']:.4f} "
                          f"Brier={errors_after['brier']:.4f}")
                except ValueError as e:
                    print(f"  temperature fitting skipped: {e}")
            plots.plot_reliability_diagram(
                arrays["y_true"], arrays["y_probs"], display, out_dir,
                n_bins=args.calibration_bins, temperature=temperature)

        if args.save_deployment:
            from dfu_multimodal_tpu_torch.eval import calibration as cal_mod
            from dfu_multimodal_tpu_torch.eval import deployment as dep_mod
            from dfu_multimodal_tpu_torch.eval import threshold as thr_mod
            t_info = (cal_payload or {}).get("temperature")
            t_dep = t_info["temperature"] if t_info else None
            thr_dep, op_info = None, None
            if args.operating_point:
                try:
                    val_probs = arrays["val_y_probs"]
                    if t_dep is not None:
                        # inference applies T first — select the
                        # threshold on the scaled probabilities
                        val_probs = cal_mod.apply_temperature(val_probs,
                                                              t_dep)
                    thr_dep, op_info = thr_mod.pick_threshold(
                        arrays["val_y_true"], val_probs,
                        args.operating_point)
                except ValueError as e:
                    print(f"deployment threshold skipped: {e}")
            if t_dep is not None or thr_dep is not None:
                src = ("extended_metrics"
                       + (f" --operating-point {args.operating_point}"
                          if args.operating_point else "")
                       + (" --temperature-from-val"
                          if args.temperature_from_val else ""))
                path = dep_mod.save_deployment(
                    ckpt_dir, threshold=thr_dep, temperature=t_dep,
                    operating_point=op_info, temperature_info=t_info,
                    source=src)
                parts = ([f"threshold={thr_dep:.4f}"]
                         if thr_dep is not None else []) + \
                        ([f"temperature={t_dep:.4f}"]
                         if t_dep is not None else [])
                print(f"Deployment config saved to {path} "
                      f"({', '.join(parts)})")

        plots.plot_confusion_matrix(arrays["y_true"], arrays["y_pred"],
                                    display, out_dir)
        roc_ci_band = None
        if args.bootstrap > 0:
            from dfu_multimodal_tpu_torch.eval import bootstrap as boot_mod
            try:
                roc_ci_band = boot_mod.roc_band(
                    arrays["y_true"], arrays["y_probs"],
                    n_boot=min(args.bootstrap, 500),
                    alpha=args.bootstrap_alpha, seed=args.seed)
            except ValueError:
                pass
        plots.plot_roc_curve(arrays["y_true"], arrays["y_probs"], display,
                             out_dir, band=roc_ci_band,
                             band_alpha=args.bootstrap_alpha)
        plots.plot_precision_recall_curve(arrays["y_true"],
                                          arrays["y_probs"], display, out_dir)
        payload = {"y_true": arrays["y_true"], "y_pred": arrays["y_pred"],
                   "y_probs": arrays["y_probs"], "metrics": metrics}
        if op_payload is not None:
            payload["operating_point"] = op_payload
        if cal_payload is not None:
            payload["calibration"] = cal_payload
        if boot_payload is not None:
            payload["bootstrap"] = boot_payload
        save_pt(payload, out_dir / "results.pt")
        print(f"\nResults saved to {subdir}/results.pt")
        all_results[display] = metrics

    _write_evaluation_summary(
        out_root,
        {subdir: ds for (split, subdir), ds in _ds_cache.items()
         if split == "test"},
        all_results, data_cfg)

    print("\n" + "=" * 70)
    print("SUMMARY COMPARISON")
    print("=" * 70)
    if all_results:
        print("\nF1-Scores:")
        for name, m in all_results.items():
            print(f"  {name:20s}: {m['f1']:.4f}")
        print("\nSensitivity (Detect Ulcers):")
        for name, m in all_results.items():
            print(f"  {name:20s}: {m['sensitivity']:.4f}")
        print("\nSpecificity (Identify Healthy):")
        for name, m in all_results.items():
            print(f"  {name:20s}: {m['specificity']:.4f}")
    print("\n" + "=" * 70)
    print(f"METRICS SAVED TO: {out_root}")
    print("=" * 70)
    return all_results


if __name__ == "__main__":
    main()
