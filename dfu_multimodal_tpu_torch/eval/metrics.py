"""Metrics (counterpart of ``dfu_multimodal_tpu/eval/metrics.py``).

Device half: masked binary confusion counts on the step's device, one
(4,) vector per step, and the accuracy and F1 read from summed counts on
the host.  Host half, numpy copies of the JAX package's: the confusion
matrix, ROC and PR curves and their AUCs, MCC, Cohen's kappa, the
sklearn-style classification report, ``compute_all_metrics`` (every key
of the reference's MedicalMetricsCalculator) and ``print_report``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


def confusion_counts(preds: torch.Tensor, labels: torch.Tensor,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked binary confusion counts -> [tn, fp, fn, tp] float32."""
    if valid is None:
        valid = torch.ones_like(labels, dtype=torch.float32)
    valid = valid.float()
    p1, l1 = preds.long() == 1, labels.long() == 1
    return torch.stack([(valid * (~p1 & ~l1)).sum(),
                        (valid * (p1 & ~l1)).sum(),
                        (valid * (~p1 & l1)).sum(),
                        (valid * (p1 & l1)).sum()]).float()


def f1_from_counts(counts: Sequence[float]) -> float:
    """Binary F1 from [tn, fp, fn, tp] (sklearn ``average='binary'``)."""
    tn, fp, fn, tp = (float(c) for c in counts)
    denom = 2 * tp + fp + fn
    return 2 * tp / denom if denom > 0 else 0.0


def accuracy_from_counts(counts: Sequence[float]) -> float:
    tn, fp, fn, tp = (float(c) for c in counts)
    total = tn + fp + fn + tp
    return (tn + tp) / total if total > 0 else 0.0

# ------------------------------------------------------------------ host side


def binary_confusion(y_true: np.ndarray, y_pred: np.ndarray) -> np.ndarray:
    """2x2 confusion matrix [[tn, fp], [fn, tp]]."""
    y_true = np.asarray(y_true).astype(np.int64)
    y_pred = np.asarray(y_pred).astype(np.int64)
    tn = int(np.sum((y_true == 0) & (y_pred == 0)))
    fp = int(np.sum((y_true == 0) & (y_pred == 1)))
    fn = int(np.sum((y_true == 1) & (y_pred == 0)))
    tp = int(np.sum((y_true == 1) & (y_pred == 1)))
    return np.array([[tn, fp], [fn, tp]], np.int64)


def roc_curve(y_true: np.ndarray, y_score: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fpr, tpr, thresholds), sklearn-compatible (drops collinear points
    is NOT done; sklearn keeps unique-threshold points — we match that)."""
    y_true = np.asarray(y_true).astype(np.int64)
    y_score = np.asarray(y_score, np.float64)
    order = np.argsort(-y_score, kind="stable")
    y_true = y_true[order]
    y_score = y_score[order]

    distinct = np.where(np.diff(y_score))[0]
    threshold_idxs = np.r_[distinct, y_true.size - 1]

    tps = np.cumsum(y_true)[threshold_idxs].astype(np.float64)
    fps = (1 + threshold_idxs - tps).astype(np.float64)
    thresholds = y_score[threshold_idxs]

    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    thresholds = np.r_[np.inf, thresholds]

    tpr = tps / tps[-1] if tps[-1] > 0 else np.zeros_like(tps)
    fpr = fps / fps[-1] if fps[-1] > 0 else np.zeros_like(fps)
    return fpr, tpr, thresholds


def precision_recall_curve(y_true: np.ndarray, y_score: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(precision, recall, thresholds), sklearn-compatible ordering
    (recall decreasing, final point (p=1, r=0) appended)."""
    y_true = np.asarray(y_true).astype(np.int64)
    y_score = np.asarray(y_score, np.float64)
    order = np.argsort(-y_score, kind="stable")
    y_true = y_true[order]
    y_score = y_score[order]

    distinct = np.where(np.diff(y_score))[0]
    threshold_idxs = np.r_[distinct, y_true.size - 1]

    tps = np.cumsum(y_true)[threshold_idxs].astype(np.float64)
    fps = (1 + threshold_idxs - tps).astype(np.float64)
    thresholds = y_score[threshold_idxs]

    precision = np.divide(tps, tps + fps,
                          out=np.zeros_like(tps), where=(tps + fps) > 0)
    recall = tps / tps[-1] if tps[-1] > 0 else np.ones_like(tps)

    # reverse so recall is decreasing; append the (p=1, r=0) endpoint
    precision = np.r_[precision[::-1], 1.0]
    recall = np.r_[recall[::-1], 0.0]
    return precision, recall, thresholds[::-1]


def trapezoid_auc(x: np.ndarray, y: np.ndarray) -> float:
    """Trapezoidal area matching sklearn.metrics.auc (handles decreasing x)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    dx = np.diff(x)
    if np.all(dx <= 0):
        x, y = x[::-1], y[::-1]
    return float(np.trapezoid(y, x))


def roc_auc_score(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """NaN when ``y_true`` holds a single class: the metric is undefined
    there (sklearn raises), and the curve fallback's all-zero tpr/fpr
    would otherwise report a perfectly-separating model as AUC 0.0."""
    y_true = np.asarray(y_true)
    if y_true.size == 0 or len(np.unique(y_true)) < 2:
        return float("nan")
    fpr, tpr, _ = roc_curve(y_true, y_score)
    return trapezoid_auc(fpr, tpr)


def pr_auc_score(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """The reference's PR-AUC: trapezoid over the PR curve
    (extended_metrics.py:435-436).  NaN when there are no positive
    labels (undefined precision everywhere)."""
    y_true = np.asarray(y_true)
    if y_true.size == 0 or not np.any(y_true == 1):
        return float("nan")
    precision, recall, _ = precision_recall_curve(y_true, y_score)
    return trapezoid_auc(recall, precision)


def matthews_corrcoef(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    cm = binary_confusion(y_true, y_pred).astype(np.float64)
    tn, fp, fn, tp = cm[0, 0], cm[0, 1], cm[1, 0], cm[1, 1]
    denom = np.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
    return float((tp * tn - fp * fn) / denom) if denom > 0 else 0.0


def cohen_kappa_score(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    cm = binary_confusion(y_true, y_pred).astype(np.float64)
    n = cm.sum()
    if n == 0:
        return 0.0
    po = np.trace(cm) / n
    pe = float(cm.sum(0) @ cm.sum(1)) / (n * n)
    return float((po - pe) / (1 - pe)) if pe != 1.0 else 0.0


def _prf(tp: float, fp: float, fn: float) -> Tuple[float, float, float]:
    precision = tp / (tp + fp) if (tp + fp) > 0 else 0.0
    recall = tp / (tp + fn) if (tp + fn) > 0 else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if (precision + recall) > 0 else 0.0)
    return precision, recall, f1


def classification_report(y_true: np.ndarray, y_pred: np.ndarray,
                          target_names=("Healthy", "Ulcer")) -> str:
    """sklearn-style text report (per-class P/R/F1/support + accuracy,
    macro avg, weighted avg rows)."""
    cm = binary_confusion(y_true, y_pred).astype(np.float64)
    rows = []
    supports = cm.sum(axis=1)
    for cls in (0, 1):
        tp = cm[cls, cls]
        fp = cm[1 - cls, cls]
        fn = cm[cls, 1 - cls]
        rows.append(_prf(tp, fp, fn) + (supports[cls],))

    n = cm.sum()
    accuracy = np.trace(cm) / n if n > 0 else 0.0
    macro = tuple(np.mean([r[i] for r in rows]) for i in range(3))
    weighted = tuple(
        float(np.sum([r[i] * r[3] for r in rows]) / n) if n > 0 else 0.0
        for i in range(3))

    width = max(len(t) for t in target_names + ("weighted avg",))
    head = f"{'':>{width}}  precision    recall  f1-score   support\n\n"
    lines = [head]
    for name, (p, r, f1, s) in zip(target_names, rows):
        lines.append(f"{name:>{width}}  {p:9.2f} {r:9.2f} {f1:9.2f} "
                     f"{int(s):9d}\n")
    lines.append("\n")
    lines.append(f"{'accuracy':>{width}}  {'':9s} {'':9s} {accuracy:9.2f} "
                 f"{int(n):9d}\n")
    for name, (p, r, f1) in (("macro avg", macro), ("weighted avg", weighted)):
        lines.append(f"{name:>{width}}  {p:9.2f} {r:9.2f} {f1:9.2f} "
                     f"{int(n):9d}\n")
    return "".join(lines)


def compute_all_metrics(y_true: np.ndarray, y_pred: np.ndarray,
                        y_probs: Optional[np.ndarray] = None) -> Dict:
    """Every metric the reference's MedicalMetricsCalculator emits, same
    keys (extended_metrics.py:385-445)."""
    cm = binary_confusion(y_true, y_pred)
    tn, fp, fn, tp = (float(x) for x in cm.ravel())

    metrics: Dict = {
        "confusion_matrix": cm,
        "tn": int(tn), "fp": int(fp), "fn": int(fn), "tp": int(tp),
    }

    total = tn + fp + fn + tp
    metrics["accuracy"] = (tn + tp) / total if total > 0 else 0.0
    precision, recall, f1 = _prf(tp, fp, fn)
    metrics["precision"] = precision
    metrics["recall"] = recall
    metrics["f1"] = f1
    metrics["classification_report"] = classification_report(y_true, y_pred)

    metrics["sensitivity"] = tp / (tp + fn) if (tp + fn) > 0 else 0
    metrics["specificity"] = tn / (tn + fp) if (tn + fp) > 0 else 0
    metrics["ppv"] = tp / (tp + fp) if (tp + fp) > 0 else 0
    metrics["npv"] = tn / (tn + fn) if (tn + fn) > 0 else 0
    metrics["fpr"] = fp / (fp + tn) if (fp + tn) > 0 else 0
    metrics["fnr"] = fn / (fn + tp) if (fn + tp) > 0 else 0

    if y_probs is not None:
        metrics["auc_roc"] = roc_auc_score(y_true, y_probs)
        metrics["auc_pr"] = pr_auc_score(y_true, y_probs)
    else:
        metrics["auc_roc"] = None
        metrics["auc_pr"] = None

    metrics["mcc"] = matthews_corrcoef(y_true, y_pred)
    metrics["kappa"] = cohen_kappa_score(y_true, y_pred)
    sens, spec = metrics["sensitivity"], metrics["specificity"]
    metrics["balanced_accuracy"] = (sens + spec) / 2
    metrics["f_harmonic"] = (2 * sens * spec / (sens + spec)
                             if (sens + spec) > 0 else 0)
    return metrics


def print_report(metrics: Dict, model_name: str = "Model") -> None:
    """The reference's report format (extended_metrics.py:450-490)."""
    print("\n" + "=" * 70)
    print(f"EXTENDED MEDICAL METRICS: {model_name}")
    print("=" * 70)
    print("\nBASIC CLASSIFICATION METRICS:")
    print(f"  Accuracy:       {metrics['accuracy']:.4f}")
    print(f"  Precision:      {metrics['precision']:.4f}")
    print(f"  Recall:         {metrics['recall']:.4f}")
    print(f"  F1-Score:       {metrics['f1']:.4f}")
    print("\nMEDICAL IMAGING METRICS (CRITICAL):")
    print(f"  Sensitivity:    {metrics['sensitivity']:.4f}  <- Detect ulcers")
    print(f"  Specificity:    {metrics['specificity']:.4f}  <- Identify healthy")
    print(f"  PPV:            {metrics['ppv']:.4f}")
    print(f"  NPV:            {metrics['npv']:.4f}")
    print(f"  Balanced Acc:   {metrics['balanced_accuracy']:.4f}")
    print("\nCONFUSION MATRIX:")
    print(f"  TN: {metrics['tn']:4d}  FP: {metrics['fp']:4d}")
    print(f"  FN: {metrics['fn']:4d}  TP: {metrics['tp']:4d}")
    print("\nCURVE METRICS:")
    if metrics["auc_roc"] is not None:
        print(f"  ROC-AUC:        {metrics['auc_roc']:.4f}")
        print(f"  PR-AUC:         {metrics['auc_pr']:.4f}")
    else:
        print("  ROC-AUC:        N/A (need probabilities)")
        print("  PR-AUC:         N/A (need probabilities)")
    print("\nAGREEMENT METRICS:")
    print(f"  MCC:            {metrics['mcc']:.4f}")
    print(f"  Kappa Score:    {metrics['kappa']:.4f}")
    print("\nERROR RATES:")
    print(f"  FPR:            {metrics['fpr']:.4f}")
    print(f"  FNR:            {metrics['fnr']:.4f}")
    print("\nCLASSIFICATION REPORT:")
    print(metrics["classification_report"])
