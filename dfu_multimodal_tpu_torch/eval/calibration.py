"""Probability calibration: measurement and temperature scaling.
(The port's copy of ``dfu_multimodal_tpu/eval/calibration.py``.)

The reference reports discrimination metrics only (ROC/PR/accuracy —
reference notebooks/extended_metrics.py:374-490); it never asks whether the
predicted probabilities MEAN anything. For a clinical screen they must: a
"0.9 ulcer" that is right 60% of the time mis-triages patients. This module
adds the standard calibration toolkit as a beyond-reference, opt-in surface
(``extended_metrics --calibration``, ``predict/serve --temperature``):

- **Brier score** — mean squared error of P(Ulcer) against the outcome;
  proper scoring rule, lower is better.
- **ECE / MCE** — expected / maximum calibration error over equal-width
  probability bins: how far bin-average confidence sits from the bin's
  empirical ulcer rate.
- **Reliability curve** + diagram PNG (confidence vs empirical frequency).
- **Temperature scaling** (Guo et al. 2017): one scalar T > 0 fitted on the
  VALIDATION split by NLL, applied as sigmoid(logit(p)/T). For a binary
  softmax head this is exactly logits/T — dividing the 2-logit vector by T
  shifts the log-odds by 1/T, which is what the logit transform recovers —
  so no model surgery is needed. T does not change the argmax ranking, so
  accuracy/F1/AUC at 0.5 are untouched; only probability sharpness moves.

Everything is plain numpy on already-fetched eval arrays (a few hundred
rows at reference scale) — nothing here belongs on the card.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

_EPS = 1e-7


def brier_score(y_true: np.ndarray, y_probs: np.ndarray) -> float:
    """Mean (P(Ulcer) − y)²; equals sklearn's ``brier_score_loss``."""
    y_true = np.asarray(y_true, np.float64)
    y_probs = np.asarray(y_probs, np.float64)
    return float(np.mean((y_probs - y_true) ** 2))


def reliability_curve(y_true: np.ndarray, y_probs: np.ndarray,
                      n_bins: int = 15
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Equal-width bins over P(Ulcer). Returns ``(mean_prob, frac_pos,
    counts)`` per bin; empty bins carry NaN means and count 0."""
    y_true = np.asarray(y_true, np.float64)
    y_probs = np.asarray(y_probs, np.float64)
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    # right-closed last bin so p=1.0 lands in bin n_bins-1
    idx = np.minimum(np.digitize(y_probs, edges[1:-1]), n_bins - 1)
    mean_prob = np.full(n_bins, np.nan)
    frac_pos = np.full(n_bins, np.nan)
    counts = np.zeros(n_bins, np.int64)
    for b in range(n_bins):
        mask = idx == b
        counts[b] = int(mask.sum())
        if counts[b]:
            mean_prob[b] = y_probs[mask].mean()
            frac_pos[b] = y_true[mask].mean()
    return mean_prob, frac_pos, counts


def calibration_errors(y_true: np.ndarray, y_probs: np.ndarray,
                       n_bins: int = 15) -> Dict[str, float]:
    """ECE = Σ (nᵦ/N)·|conf̄ᵦ − freqᵦ|, MCE = max over non-empty bins,
    plus the Brier score — the standard triple."""
    mean_prob, frac_pos, counts = reliability_curve(y_true, y_probs, n_bins)
    n = max(1, int(counts.sum()))
    nonempty = counts > 0
    gaps = np.abs(mean_prob[nonempty] - frac_pos[nonempty])
    weights = counts[nonempty] / n
    return {
        "ece": float(np.sum(weights * gaps)) if nonempty.any() else 0.0,
        "mce": float(gaps.max()) if nonempty.any() else 0.0,
        "brier": brier_score(y_true, y_probs),
        "n_bins": int(n_bins),
    }


def _logit(p: np.ndarray) -> np.ndarray:
    p = np.clip(np.asarray(p, np.float64), _EPS, 1.0 - _EPS)
    return np.log(p) - np.log1p(-p)


def apply_temperature(y_probs: np.ndarray, temperature: float) -> np.ndarray:
    """sigmoid(logit(p)/T). T=1 is the identity; T>1 softens
    (overconfident models), T<1 sharpens. Monotone in p, so rankings —
    and every threshold-swept metric like ROC-AUC — are unchanged."""
    if temperature <= 0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
    z = _logit(y_probs) / float(temperature)
    return 1.0 / (1.0 + np.exp(-z))


def _nll(y_true: np.ndarray, z: np.ndarray, temp: float) -> float:
    zt = z / temp
    # log(1+e^z) computed stably
    log1pexp = np.logaddexp(0.0, zt)
    return float(np.mean(log1pexp - y_true * zt))


def fit_temperature(y_true: np.ndarray, y_probs: np.ndarray,
                    t_min: float = 0.05, t_max: float = 20.0
                    ) -> Tuple[float, Dict]:
    """Fit the temperature on a selection (validation) split by minimizing
    binary NLL with golden-section search over log T — the objective is
    unimodal in T, and 80 iterations pin T to ~1e-9 relative, fully
    deterministic. Returns ``(T, info)`` with before/after selection-split
    NLL and ECE."""
    y_true = np.asarray(y_true, np.float64)
    z = _logit(y_probs)
    if y_true.min() == y_true.max():
        raise ValueError("temperature fitting needs both classes present "
                         "in the selection split")

    lo, hi = np.log(t_min), np.log(t_max)
    phi = (np.sqrt(5.0) - 1.0) / 2.0
    a, b = lo, hi
    c, d = b - phi * (b - a), a + phi * (b - a)
    fc, fd = _nll(y_true, z, np.exp(c)), _nll(y_true, z, np.exp(d))
    for _ in range(80):
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - phi * (b - a)
            fc = _nll(y_true, z, np.exp(c))
        else:
            a, c, fc = c, d, fd
            d = a + phi * (b - a)
            fd = _nll(y_true, z, np.exp(d))
    t = float(np.exp((a + b) / 2.0))
    info = {
        "temperature": t,
        "selection_nll_before": _nll(y_true, z, 1.0),
        "selection_nll_after": _nll(y_true, z, t),
        "selection_ece_before": calibration_errors(y_true, y_probs)["ece"],
        "selection_ece_after": calibration_errors(
            y_true, apply_temperature(y_probs, t))["ece"],
    }
    return t, info
