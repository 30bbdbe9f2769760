"""Clinical operating-point selection.
(The port's copy of ``dfu_multimodal_tpu/eval/threshold.py``.)

The reference classifies at the implicit argmax-0.5 threshold everywhere
(e.g. ``preds = torch.argmax(output, dim=1)``, reference
notebooks/extended_metrics.py:592-593). Screening deployments usually
don't want that point: a DFU screen is sensitivity-first (a missed ulcer
costs far more than a false referral). This module picks a probability
threshold on a VALIDATION split and applies it at inference — a
beyond-reference, opt-in surface (``extended_metrics --operating-point``,
``predict --threshold``); default behavior everywhere stays 0.5/argmax
for artifact parity.

Strategies (``y_probs`` = P(class 1 = Ulcer)):

- ``youden``    maximize Youden's J = sensitivity + specificity − 1
  (the ROC point farthest above the chance diagonal).
- ``f1``        maximize F1 over the PR curve's candidate thresholds.
- ``sens@0.95`` (any value in (0, 1]) — the HIGHEST threshold whose
  sensitivity still meets the floor: the most specific operating point
  that keeps the mandated recall.

All strategies evaluate only thresholds realized by the data (the
ROC/PR curve points), so picks are deterministic and reproducible.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from dfu_multimodal_tpu_torch.eval.metrics import (
    precision_recall_curve, roc_curve)


def pick_threshold(y_true: np.ndarray, y_probs: np.ndarray,
                   strategy: str = "youden") -> Tuple[float, Dict]:
    """Returns ``(threshold, info)``; ``info`` records the strategy and
    the selection-split sensitivity/specificity at the chosen point."""
    y_true = np.asarray(y_true)
    y_probs = np.asarray(y_probs, np.float64)
    if y_true.min() == y_true.max():
        raise ValueError("operating-point selection needs both classes "
                         "present in the selection split")

    fpr, tpr, thr = roc_curve(y_true, y_probs)
    # drop the synthetic +inf point; candidate thresholds are realized
    fpr, tpr, thr = fpr[1:], tpr[1:], thr[1:]

    if strategy == "youden":
        j = tpr - fpr
        i = int(np.argmax(j))            # first max -> highest threshold
    elif strategy == "f1":
        prec, rec, pthr = precision_recall_curve(y_true, y_probs)
        # curve rows beyond len(pthr) are the synthetic (1, 0) endpoint
        prec, rec = prec[:len(pthr)], rec[:len(pthr)]
        denom = prec + rec
        f1 = np.where(denom > 0, 2 * prec * rec / np.maximum(denom, 1e-12),
                      0.0)
        k = int(np.argmax(f1))
        t = float(pthr[k])
        return _at(y_true, y_probs, t, strategy)
    elif strategy.startswith("sens@"):
        floor = float(strategy[len("sens@"):])
        if not 0.0 < floor <= 1.0:
            raise ValueError(f"sensitivity floor must be in (0, 1]: "
                             f"{strategy!r}")
        ok = np.flatnonzero(tpr >= floor)
        if ok.size == 0:
            raise ValueError(f"no threshold reaches sensitivity {floor} "
                             "on the selection split")
        i = int(ok[0])                   # ROC is sorted by falling thr
    else:
        raise ValueError(f"unknown strategy {strategy!r} "
                         "(youden | f1 | sens@<floor>)")
    return _at(y_true, y_probs, float(thr[i]), strategy)


def _at(y_true: np.ndarray, y_probs: np.ndarray, t: float,
        strategy: str) -> Tuple[float, Dict]:
    pred = (y_probs >= t).astype(np.int64)
    pos, neg = y_true == 1, y_true == 0
    sens = float(pred[pos].mean()) if pos.any() else float("nan")
    spec = float(1.0 - pred[neg].mean()) if neg.any() else float("nan")
    return t, {"strategy": strategy, "threshold": t,
               "selection_sensitivity": sens,
               "selection_specificity": spec}


def apply_threshold(y_probs: np.ndarray, threshold: float) -> np.ndarray:
    """P(Ulcer) >= threshold -> class 1 (the >= convention matches the
    ROC-curve candidate semantics used for selection)."""
    return (np.asarray(y_probs) >= threshold).astype(np.int64)
