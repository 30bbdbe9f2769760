"""Bootstrap confidence intervals for the medical metric suite.
(The port's copy of ``dfu_multimodal_tpu/eval/bootstrap.py``.)

The reference reports every test-set metric as a bare point estimate
(reference notebooks/extended_metrics.py:374-490) — on a 131-image RGB test
split, "accuracy 0.9847" is ±2 points of binomial noise. Clinical reporting
standards (TRIPOD, STARD) expect interval estimates, so this module adds
nonparametric percentile-bootstrap CIs as a beyond-reference, opt-in surface
(``extended_metrics --bootstrap N``): resample the test rows with
replacement, recompute each metric per replicate, take the (α/2, 1−α/2)
percentiles.

Replicates that draw a single class have no defined AUC/sensitivity etc.;
those replicates are simply excluded from that metric's percentile pool and
the count of valid replicates is reported (``n_valid``) — the standard
treatment. Everything is vectorized numpy on host arrays; at reference
scale (≤ 300 rows × 2000 replicates) this is milliseconds, nothing for the
card to do.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from dfu_multimodal_tpu_torch.eval import metrics as M

DEFAULT_KEYS = ("accuracy", "f1", "sensitivity", "specificity", "ppv",
                "npv", "balanced_accuracy", "mcc", "auc_roc", "auc_pr")


def _counts(y_true: np.ndarray, y_pred: np.ndarray):
    tp = float(np.sum((y_true == 1) & (y_pred == 1)))
    tn = float(np.sum((y_true == 0) & (y_pred == 0)))
    fp = float(np.sum((y_true == 0) & (y_pred == 1)))
    fn = float(np.sum((y_true == 1) & (y_pred == 0)))
    return tn, fp, fn, tp


def _metric_from_counts(key: str, tn: float, fp: float, fn: float,
                        tp: float) -> float:
    """Same formulas as metrics.compute_all_metrics (kept in lockstep by
    test_bootstrap.py::test_point_estimates_match_metrics_engine) — except
    that an undefined metric (zero denominator: e.g. a replicate that drew
    no positives has no sensitivity) returns NaN so it is EXCLUDED from
    the percentile pool instead of biasing the interval toward 0."""
    nan = float("nan")
    total = tn + fp + fn + tp
    if key == "accuracy":
        return (tn + tp) / total if total else nan
    if key == "sensitivity":
        return tp / (tp + fn) if (tp + fn) else nan
    if key == "specificity":
        return tn / (tn + fp) if (tn + fp) else nan
    if key == "ppv":
        return tp / (tp + fp) if (tp + fp) else nan
    if key == "npv":
        return tn / (tn + fn) if (tn + fn) else nan
    if key == "f1":
        if (tp + fn) == 0:               # no positives drawn: undefined
            return nan
        prec = tp / (tp + fp) if (tp + fp) else 0.0
        rec = tp / (tp + fn)
        return 2 * prec * rec / (prec + rec) if (prec + rec) else 0.0
    if key == "balanced_accuracy":
        if (tp + fn) == 0 or (tn + fp) == 0:
            return nan
        return (tp / (tp + fn) + tn / (tn + fp)) / 2
    if key == "mcc":
        denom = np.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
        return float((tp * tn - fp * fn) / denom) if denom else nan
    raise KeyError(key)


def _evaluate(key: str, yt: np.ndarray, yp: np.ndarray,
              probs: Optional[np.ndarray]) -> float:
    if key in ("auc_roc", "auc_pr"):
        if probs is None or yt.min() == yt.max():
            return float("nan")          # undefined on this replicate
        fn = M.roc_auc_score if key == "auc_roc" else M.pr_auc_score
        return float(fn(yt, probs))
    return _metric_from_counts(key, *_counts(yt, yp))


def bootstrap_cis(y_true: np.ndarray, y_pred: np.ndarray,
                  y_probs: Optional[np.ndarray] = None, *,
                  n_boot: int = 2000, alpha: float = 0.05, seed: int = 0,
                  keys: Optional[Sequence[str]] = None) -> Dict[str, Dict]:
    """Percentile-bootstrap CIs. Returns
    ``{metric: {estimate, lo, hi, n_valid}}`` plus a ``_meta`` entry
    recording n_boot/alpha/seed. Deterministic for a given seed."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if y_probs is not None:
        y_probs = np.asarray(y_probs)
    if keys is None:
        keys = [k for k in DEFAULT_KEYS
                if y_probs is not None or not k.startswith("auc")]
    n = len(y_true)
    if n == 0:
        raise ValueError("bootstrap needs a non-empty evaluation set")
    rng = np.random.default_rng(seed)

    samples: Dict[str, list] = {k: [] for k in keys}
    for _ in range(int(n_boot)):
        idx = rng.integers(0, n, n)
        yt, yp = y_true[idx], y_pred[idx]
        probs = y_probs[idx] if y_probs is not None else None
        for k in keys:
            samples[k].append(_evaluate(k, yt, yp, probs))

    out: Dict[str, Dict] = {"_meta": {"n_boot": int(n_boot),
                                      "alpha": float(alpha),
                                      "seed": int(seed), "n": int(n)}}
    lo_q, hi_q = 100 * alpha / 2, 100 * (1 - alpha / 2)
    for k in keys:
        vals = np.asarray(samples[k], np.float64)
        valid = vals[~np.isnan(vals)]
        est = _evaluate(k, y_true, y_pred, y_probs)
        if valid.size == 0:
            out[k] = {"estimate": est, "lo": float("nan"),
                      "hi": float("nan"), "n_valid": 0}
            continue
        out[k] = {"estimate": est,
                  "lo": float(np.percentile(valid, lo_q)),
                  "hi": float(np.percentile(valid, hi_q)),
                  "n_valid": int(valid.size)}
    return out


def format_cis(cis: Dict[str, Dict], title: str = "") -> str:
    meta = cis.get("_meta", {})
    pct = 100 * (1 - meta.get("alpha", 0.05))
    lines = [f"BOOTSTRAP {pct:.0f}% CIs"
             + (f" — {title}" if title else "")
             + f" ({meta.get('n_boot', '?')} resamples of"
               f" {meta.get('n', '?')} rows):"]
    for k, v in cis.items():
        if k == "_meta":
            continue
        lines.append(f"  {k:18s} {v['estimate']:.4f}  "
                     f"[{v['lo']:.4f}, {v['hi']:.4f}]"
                     + (f"  ({v['n_valid']} valid)"
                        if v["n_valid"] < meta.get("n_boot", 0) else ""))
    return "\n".join(lines)


def roc_band(y_true: np.ndarray, y_probs: np.ndarray, *,
             n_boot: int = 500, alpha: float = 0.05, seed: int = 0,
             grid: int = 101):
    """Vertical-averaging bootstrap band for the ROC curve: resample rows,
    interpolate each replicate's TPR onto a fixed FPR grid, take the
    (α/2, 1−α/2) percentiles per grid point. Returns
    ``(fpr_grid, tpr_lo, tpr_mean, tpr_hi)``; replicates with a single
    class are skipped."""
    y_true = np.asarray(y_true)
    y_probs = np.asarray(y_probs, np.float64)
    rng = np.random.default_rng(seed)
    fgrid = np.linspace(0.0, 1.0, grid)
    n = len(y_true)
    curves = []
    for _ in range(int(n_boot)):
        idx = rng.integers(0, n, n)
        yt, pr = y_true[idx], y_probs[idx]
        if yt.min() == yt.max():
            continue
        fpr, tpr, _ = M.roc_curve(yt, pr)
        curves.append(np.interp(fgrid, fpr, tpr))
    if not curves:
        raise ValueError("roc_band needs replicates with both classes")
    stack = np.stack(curves)
    lo_q, hi_q = 100 * alpha / 2, 100 * (1 - alpha / 2)
    return (fgrid, np.percentile(stack, lo_q, axis=0), stack.mean(axis=0),
            np.percentile(stack, hi_q, axis=0))
