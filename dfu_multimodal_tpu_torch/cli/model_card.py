"""Model card generator: one audit-ready markdown document per checkpoint
(the port's counterpart of ``dfu_multimodal_tpu/cli/model_card.py``).

Beyond-reference, opt-in surface.  The reference documents its models as
README prose detached from any specific checkpoint (reference
README.md:84-112); in a clinical setting every deployed artifact needs a
self-contained record of what it is, how it was trained, how it performed,
and what its limits are — the "model card" reporting standard (Mitchell et
al., FAT* 2019).  This CLI assembles one from artifacts the framework
already writes, without re-running anything:

- ``run_info.json``          — exact command, resolved config, versions
- ``best_model.meta.json``   — best epoch, val F1, training history
- ``best_model.pt``          — parameter count + SHA-256 (provenance); a
  JAX ``best_model.msgpack`` is read with ``utils/flax_msgpack.py``
- ``test_results.pt``        — trainer's final test metrics
- ``extended_metrics/<m>/results.pt`` — full medical metric suite, plus
  bootstrap CIs / calibration / operating point when those were run
- ``deployment.json``        — applied threshold / temperature
- ``drift_baseline.json``    — monitoring coverage

The parameter count counts parameters only (BatchNorm running
statistics and ``num_batches_tracked`` are buffers), so it equals the JAX
count of the ``params`` collection for the same weights::

    python -m dfu_multimodal_tpu_torch.cli.model_card \\
        --checkpoint logs/checkpoints_rgb_only \\
        [--metrics-dir logs/extended_metrics/rgb_only] \\
        [--output MODEL_CARD.md]
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import pickle
from datetime import datetime, timezone
from pathlib import Path
from typing import Dict, List, Optional

import torch

from dfu_multimodal_tpu_torch.utils.artifacts import load_pt
from dfu_multimodal_tpu_torch.utils.flax_msgpack import (MsgpackError,
                                                         msgpack_restore)

ARCH = {
    "rgb_only": ("ResNet50 + Dropout(0.5) + Linear(2048→2)",
                 "RGB photographs"),
    "thermal_only": ("ViT-B/16 + Dropout(0.5) + Linear(768→2)",
                     "thermal images"),
    "multimodal": ("ResNet50 ⊕ ViT-B/16 late fusion, MLP 2816→512→256→2",
                   "pseudo-paired RGB + thermal images"),
    "efficientnet_rgb": ("EfficientNet-B0 + Linear(1280→2)",
                         "RGB photographs (legacy lineage)"),
    "efficientnet_thermal": ("EfficientNet-B0 + Linear(1280→2)",
                             "thermal images (legacy lineage)"),
    "legacy_gated_fusion": ("dual EfficientNet-B0, sigmoid-gated fusion",
                            "paired RGB + thermal (legacy lineage)"),
    "legacy_rgb_resnet_fusion": ("ResNet50(→1280) + EfficientNet-B0, "
                                 "gated fusion",
                                 "paired RGB + thermal (legacy lineage)"),
    "tiny_rgb": ("TinyCNN (test model)", "RGB (smoke runs)"),
    "tiny_thermal": ("TinyCNN (test model)", "thermal (smoke runs)"),
}

METRIC_ROWS = (("accuracy", "Accuracy"), ("f1", "F1"),
               ("sensitivity", "Sensitivity (recall)"),
               ("specificity", "Specificity"), ("ppv", "PPV (precision)"),
               ("npv", "NPV"), ("balanced_accuracy", "Balanced accuracy"),
               ("mcc", "MCC"), ("auc_roc", "ROC-AUC"),
               ("auc_pr", "PR-AUC"))


# state-dict entries that are BatchNorm buffers, not parameters
_BN_BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def _leaf_sizes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_leaf_sizes(v) for v in tree.values())
    return int(tree.numel()) if isinstance(tree, torch.Tensor) else 0


def _param_count_and_hash(ckpt: Path) -> (Optional[int], Optional[str]):
    """(parameter count, SHA-256 of the file) of the port's
    ``best_model.pt``, else of a JAX ``best_model.msgpack`` (its
    ``params`` tree); (None, None) with neither, a None count when the
    file does not parse."""
    pt, msgpack = ckpt / "best_model.pt", ckpt / "best_model.msgpack"
    f = pt if pt.exists() else msgpack
    if not f.exists():
        return None, None
    data = f.read_bytes()
    sha = hashlib.sha256(data).hexdigest()
    try:
        if f is pt:
            state = torch.load(io.BytesIO(data), map_location="cpu",
                               weights_only=True)["model_state_dict"]
            count = sum(int(v.numel()) for k, v in state.items()
                        if k.rsplit(".", 1)[-1] not in _BN_BUFFERS)
        else:
            payload = msgpack_restore(data)
            count = _leaf_sizes(payload.get("model_state", {}).get(
                "params", {}))
    except (MsgpackError, KeyError, AttributeError, RuntimeError,
            pickle.UnpicklingError):
        count = None
    return count, sha


def _load_json(path: Path) -> Optional[Dict]:
    return json.loads(path.read_text()) if path.exists() else None


def _fmt(v, digits=4) -> str:
    if v is None:
        return "—"
    try:
        return f"{float(v):.{digits}f}"
    except (TypeError, ValueError):
        return str(v)


def build_card(ckpt: Path, metrics_dir: Optional[Path]) -> str:
    meta = _load_json(ckpt / "best_model.meta.json") or {}
    run_info = _load_json(ckpt / "run_info.json") or {}
    deployment = _load_json(ckpt / "deployment.json")
    drift = _load_json(ckpt / "drift_baseline.json")
    robustness = _load_json(ckpt / "robustness_report.json")
    compare = _load_json(ckpt / "compare_report.json")
    results = None
    if metrics_dir is not None and (metrics_dir / "results.pt").exists():
        results = load_pt(metrics_dir / "results.pt")
    test_results = None
    if (ckpt / "test_results.pt").exists():
        test_results = load_pt(ckpt / "test_results.pt")

    model = meta.get("model") or run_info.get("model") or ckpt.name
    arch, inputs_desc = ARCH.get(model, (model, "images"))
    n_params, sha = _param_count_and_hash(ckpt)
    cfg = run_info.get("config", {})

    L: List[str] = []
    L.append(f"# Model card — `{model}`")
    L.append("")
    L.append(f"*Generated {datetime.now(timezone.utc).date().isoformat()} "
             f"from `{ckpt}` by dfu_multimodal_tpu_torch "
             f"(`cli.model_card`).*")
    L.append("")
    L.append("## Model details")
    L.append("")
    L.append("| | |")
    L.append("|---|---|")
    L.append(f"| Task | Binary diabetic-foot-ulcer screening "
             f"(healthy vs ulcer) |")
    L.append(f"| Architecture | {arch} |")
    L.append(f"| Inputs | {inputs_desc}, 224×224 (uint8 → on-device "
             f"normalize) |")
    if n_params is not None:
        L.append(f"| Parameters | {n_params:,} |")
    if sha is not None:
        L.append(f"| Weights SHA-256 | `{sha[:16]}…` |")
    if meta.get("epoch") is not None:
        L.append(f"| Best epoch | {meta['epoch']} "
                 f"(val F1 {_fmt(meta.get('val_f1'))}) |")
    L.append("")

    if run_info:
        L.append("## Training")
        L.append("")
        argv = " ".join(run_info.get("argv", []))
        recipe = run_info.get("recipe", "")
        subcmd = {"rgb_only": "train-rgb-only",
                  "thermal_only": "train-thermal-only",
                  "multimodal": "train-multimodal-fusion"}.get(
            recipe, "train-legacy" if recipe.startswith("legacy_")
            else recipe or "train")
        L.append(f"Command: `dfu {subcmd} {argv}`")
        L.append("")
        L.append("| Hyperparameter | Value |")
        L.append("|---|---|")
        for key in ("batch_size", "num_epochs", "learning_rate",
                    "weight_decay", "drop_rate", "seed", "compute_dtype",
                    "lr_schedule", "ema_decay", "grad_accum", "qat"):
            if key in cfg:
                L.append(f"| {key} | {cfg[key]} |")
        L.append(f"| backend | {run_info.get('backend', '?')} × "
                 f"{run_info.get('device_count', '?')} "
                 f"(torch {run_info.get('torch_version', '?')}) |")
        L.append("")
        L.append("Class-weighted cross-entropy with weighted resampling; "
                 "SHA-256 cross-split leakage gate enforced at load "
                 "(reference parity: train_rgb_only.py:138-165).")
        L.append("")

    metrics = (results or {}).get("metrics") if results else None
    boot = (results or {}).get("bootstrap") if results else None
    if metrics:
        L.append("## Evaluation (held-out test split)")
        L.append("")
        if boot:
            L.append("| Metric | Value | 95% CI |")
            L.append("|---|---|---|")
        else:
            L.append("| Metric | Value |")
            L.append("|---|---|")
        for key, label in METRIC_ROWS:
            if key not in metrics or metrics[key] is None:
                continue
            if boot and key in boot:
                ci = boot[key]
                L.append(f"| {label} | {_fmt(metrics[key])} | "
                         f"[{_fmt(ci.get('lo'))}, {_fmt(ci.get('hi'))}] |")
            else:
                L.append(f"| {label} | {_fmt(metrics[key])} |")
        L.append("")
        cal = (results or {}).get("calibration")
        if cal:
            err = cal.get("errors", cal)
            # extended_metrics stores the whole fit_temperature info
            # dict under 'temperature' (eval/calibration.py); pull the
            # scalar T out (tolerating an already-scalar legacy value)
            t_info = cal.get("temperature")
            t_val = (t_info.get("temperature")
                     if isinstance(t_info, dict) else t_info)
            L.append(f"Calibration: ECE {_fmt(err.get('ece'))}, "
                     f"MCE {_fmt(err.get('mce'))}, "
                     f"Brier {_fmt(err.get('brier'))}"
                     + (f"; temperature T={_fmt(t_val)} "
                        "fitted on the validation split"
                        if t_val else "") + ".")
            L.append("")
    elif test_results:
        L.append("## Evaluation (trainer's test pass)")
        L.append("")
        L.append("| Metric | Value |")
        L.append("|---|---|")
        for key, label in (("test_acc", "Accuracy"), ("test_f1", "F1"),
                           ("test_loss", "Loss")):
            if key in test_results:
                L.append(f"| {label} | {_fmt(test_results[key])} |")
        L.append("")
        L.append("*Run `dfu extended-metrics --bootstrap 2000 "
                 "--calibration` for the full metric suite with CIs.*")
        L.append("")

    L.append("## Deployment")
    L.append("")
    if deployment:
        thr = deployment.get("threshold")
        temp = deployment.get("temperature")
        parts = []
        if thr is not None:
            parts.append(f"operating point P(ulcer) ≥ {_fmt(thr)}")
        if temp is not None:
            parts.append(f"temperature T={_fmt(temp)}")
        L.append(f"Val-tuned deployment config persisted "
                 f"(`deployment.json`: {', '.join(parts)}); "
                 "`predict`/`serve`/`export-model` apply it "
                 "automatically.")
    else:
        L.append("No persisted deployment config — predictions use "
                 "argmax at 0.5. Tune one with `dfu extended-metrics "
                 "--operating-point … --save-deployment`.")
    if drift:
        mods = ", ".join(sorted(drift.get("modalities", {})))
        L.append(f"Input drift monitoring baseline present ({mods}); "
                 "`serve` scores live traffic (PSI) on `/metrics`.")
    if robustness and robustness.get("results"):
        worst = min(robustness["results"], key=lambda r: r["worst_f1"])
        frag = [r for r in robustness["results"]
                if r["verdict"] == "fragile"]
        L.append(
            f"Corruption robustness swept on {robustness.get('split')} "
            f"(`robustness_report.json`, clean F1 "
            f"{_fmt(robustness.get('clean_f1'))}): "
            f"{len(frag)}/{len(robustness['results'])} axes fragile; "
            f"worst = {worst['corruption']} on "
            f"{'+'.join(worst['modalities'])} "
            f"(F1 {_fmt(worst['worst_f1'])} at max severity).")
    if compare and compare.get("mcnemar"):
        mc = compare["mcnemar"]
        acc = compare.get("deltas", {}).get("accuracy", {})
        L.append(
            f"Paired comparison vs `{compare.get('model_a')}` "
            f"(`compare_report.json`, {compare.get('n')} "
            f"{compare.get('split')} rows): McNemar exact "
            f"p = {_fmt(mc.get('p_value'))} "
            f"({'significant' if mc.get('significant') else 'not significant'}"
            f"); Δaccuracy {_fmt(acc.get('delta'))} "
            f"[{_fmt(acc.get('lo'))}, {_fmt(acc.get('hi'))}].")
    L.append("")

    L.append("## Intended use & limitations")
    L.append("")
    L.append("- Screening aid for diabetic-foot-ulcer triage; NOT a "
             "diagnostic device. A clinician reviews every positive.")
    L.append("- Trained on the public Kaggle DFU datasets (SURVEY.md §0); "
             "performance on other cameras/populations/sites is not "
             "established — monitor drift and re-validate before reuse.")
    if model == "multimodal":
        L.append("- The RGB and thermal inputs are PSEUDO-paired (modulo "
                 "cycling over unpaired pools — reference "
                 "train_multimodal_fusion.py:109-137): the two modalities "
                 "come from different patients, so fusion gains are not "
                 "expected until genuinely paired data exists (the "
                 "reference's own multimodal run collapses to "
                 "always-ulcer, BASELINE.md).")
    L.append("- Test-split sizes at reference scale (~130-280 images) "
             "carry ±2-4 points of sampling noise on accuracy-like "
             "metrics — prefer the bootstrap CIs over point estimates.")
    L.append("")
    return "\n".join(L)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Generate a markdown model card from checkpoint "
                    "artifacts (beyond-reference)")
    parser.add_argument("--checkpoint", type=Path, required=True)
    parser.add_argument("--metrics-dir", type=Path, default=None,
                        help="extended_metrics output dir for this model "
                             "(default: <ckpt-root>/extended_metrics/"
                             "<model> when present)")
    parser.add_argument("--output", type=Path, default=None,
                        help="default: <checkpoint>/MODEL_CARD.md")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    ckpt = args.checkpoint
    if not ckpt.is_dir():
        raise SystemExit(f"checkpoint directory not found: {ckpt}")
    metrics_dir = args.metrics_dir
    if metrics_dir is None:
        # the trainers' layout: logs/checkpoints_<name> ->
        # logs/extended_metrics/<name>
        name = ckpt.name.replace("checkpoints_", "")
        candidate = ckpt.parent / "extended_metrics" / name
        if (candidate / "results.pt").exists():
            metrics_dir = candidate
    card = build_card(ckpt, metrics_dir)
    out = args.output or (ckpt / "MODEL_CARD.md")
    out.write_text(card)
    print(f"Wrote {out} ({len(card.splitlines())} lines"
          + (f"; metrics from {metrics_dir}" if metrics_dir else
             "; no extended-metrics results found") + ")")
    return {"output": str(out)}


if __name__ == "__main__":
    main()
