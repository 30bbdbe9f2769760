"""Paired statistical comparison of two checkpoints (the port's copy of
``dfu_multimodal_tpu/eval/compare.py``; `dfu compare`).

The reference reports every model as a bare point estimate
(reference notebooks/extended_metrics.py:374-490) and its ablation study
compares those points directly (notebooks/ablation_study.py) — on a
~130-image test split a 1-2 point gap is inside binomial noise, so
"multimodal beats RGB-only" can be an artifact of the draw. This module
answers "is B actually better than A?" with the statistically correct
PAIRED tests, which exploit that both models are scored on the SAME rows:

- **McNemar exact test** on the discordant decisions: under H0 (equal
  accuracy) the n01/n10 discordant rows split Binomial(n01+n10, 1/2);
  the two-sided exact p-value needs no large-sample approximation, which
  matters at reference scale where discordant counts are often < 25.
- **Paired-bootstrap CIs on metric deltas**: each replicate resamples ONE
  index vector and scores BOTH models on it, so between-row variance
  cancels and the interval covers Δmetric = metric(B) − metric(A). A
  delta whose CI excludes 0 is significant at the chosen α.
- **Decision flip table**: both-correct / only-A / only-B / both-wrong
  row counts — the clinically legible summary (which cases would change
  management if the hospital swapped models).

Beyond-reference, opt-in surface; no reference analogue exists. Pure
host-side numpy on the per-row arrays `Trainer.run_eval_epoch` already
produces — milliseconds at reference scale, nothing for the card to do.
"""

from __future__ import annotations

from math import comb
from typing import Dict, Optional, Sequence

import numpy as np

from dfu_multimodal_tpu_torch.eval.bootstrap import DEFAULT_KEYS, _evaluate


def mcnemar_exact(n01: int, n10: int) -> float:
    """Two-sided exact McNemar p-value.

    ``n01`` = rows model A got right and B got wrong; ``n10`` = the
    opposite. Under H0 the min(n01, n10) discordant count is
    Binomial(n, 1/2)-distributed; the two-sided p doubles the lower tail
    (capped at 1). Exact arbitrary-precision arithmetic — no χ²
    approximation, valid at any count."""
    n01, n10 = int(n01), int(n10)
    if n01 < 0 or n10 < 0:
        raise ValueError("discordant counts must be non-negative")
    n = n01 + n10
    if n == 0:
        return 1.0
    k = min(n01, n10)
    tail = sum(comb(n, i) for i in range(k + 1))
    return min(1.0, 2.0 * tail / 2 ** n)


def flip_table(y_true: np.ndarray, pred_a: np.ndarray,
               pred_b: np.ndarray) -> Dict[str, int]:
    """Paired decision outcomes. Keys: ``both_correct``, ``only_a``
    (A right, B wrong), ``only_b``, ``both_wrong``, ``n_flips``
    (rows where the two models disagree, regardless of truth)."""
    y_true = np.asarray(y_true)
    a_ok = np.asarray(pred_a) == y_true
    b_ok = np.asarray(pred_b) == y_true
    return {
        "both_correct": int(np.sum(a_ok & b_ok)),
        "only_a": int(np.sum(a_ok & ~b_ok)),
        "only_b": int(np.sum(~a_ok & b_ok)),
        "both_wrong": int(np.sum(~a_ok & ~b_ok)),
        "n_flips": int(np.sum(np.asarray(pred_a) != np.asarray(pred_b))),
    }


def paired_bootstrap_deltas(
        y_true: np.ndarray,
        pred_a: np.ndarray, probs_a: Optional[np.ndarray],
        pred_b: np.ndarray, probs_b: Optional[np.ndarray], *,
        n_boot: int = 2000, alpha: float = 0.05, seed: int = 0,
        keys: Optional[Sequence[str]] = None) -> Dict[str, Dict]:
    """Percentile-bootstrap CIs on Δmetric = metric(B) − metric(A).

    One index vector per replicate scores BOTH models (the pairing is
    the whole point — independent resamples would double the variance).
    Replicates where either side's metric is undefined (single-class
    draw) are excluded from that metric's pool, mirroring
    :func:`eval.bootstrap.bootstrap_cis`. Returns
    ``{metric: {a, b, delta, lo, hi, n_valid, significant}}`` plus
    ``_meta``; ``significant`` means the (1−α) CI excludes 0."""
    y_true = np.asarray(y_true)
    pred_a, pred_b = np.asarray(pred_a), np.asarray(pred_b)
    pa = None if probs_a is None else np.asarray(probs_a)
    pb = None if probs_b is None else np.asarray(probs_b)
    if keys is None:
        keys = [k for k in DEFAULT_KEYS
                if (pa is not None and pb is not None)
                or not k.startswith("auc")]
    n = len(y_true)
    if n == 0:
        raise ValueError("compare needs a non-empty evaluation set")
    rng = np.random.default_rng(seed)

    samples: Dict[str, list] = {k: [] for k in keys}
    for _ in range(int(n_boot)):
        idx = rng.integers(0, n, n)
        yt = y_true[idx]
        ra, rb = pred_a[idx], pred_b[idx]
        qa = pa[idx] if pa is not None else None
        qb = pb[idx] if pb is not None else None
        for k in keys:
            va = _evaluate(k, yt, ra, qa)
            vb = _evaluate(k, yt, rb, qb)
            samples[k].append(vb - va)

    out: Dict[str, Dict] = {"_meta": {"n_boot": int(n_boot),
                                      "alpha": float(alpha),
                                      "seed": int(seed), "n": int(n)}}
    lo_q, hi_q = 100 * alpha / 2, 100 * (1 - alpha / 2)
    for k in keys:
        vals = np.asarray(samples[k], np.float64)
        valid = vals[~np.isnan(vals)]
        ea = _evaluate(k, y_true, pred_a, pa)
        eb = _evaluate(k, y_true, pred_b, pb)
        row = {"a": ea, "b": eb, "delta": eb - ea}
        if valid.size == 0:
            row.update(lo=float("nan"), hi=float("nan"), n_valid=0,
                       significant=False)
        else:
            lo = float(np.percentile(valid, lo_q))
            hi = float(np.percentile(valid, hi_q))
            row.update(lo=lo, hi=hi, n_valid=int(valid.size),
                       significant=bool(lo > 0.0 or hi < 0.0))
        out[k] = row
    return out


def compare_models(y_true: np.ndarray,
                   pred_a: np.ndarray, probs_a: Optional[np.ndarray],
                   pred_b: np.ndarray, probs_b: Optional[np.ndarray], *,
                   n_boot: int = 2000, alpha: float = 0.05,
                   seed: int = 0,
                   keys: Optional[Sequence[str]] = None) -> Dict:
    """Full paired comparison report (JSON-serializable dict)."""
    flips = flip_table(y_true, pred_a, pred_b)
    deltas = paired_bootstrap_deltas(
        y_true, pred_a, probs_a, pred_b, probs_b,
        n_boot=n_boot, alpha=alpha, seed=seed, keys=keys)
    p = mcnemar_exact(flips["only_a"], flips["only_b"])
    return {
        "n": int(len(np.asarray(y_true))),
        "flip_table": flips,
        "mcnemar": {"n01_only_a": flips["only_a"],
                    "n10_only_b": flips["only_b"],
                    "p_value": p,
                    "significant": bool(p < alpha)},
        "deltas": deltas,
    }


def format_report(report: Dict, name_a: str = "A",
                  name_b: str = "B") -> str:
    """Human-readable rendering of :func:`compare_models` output."""
    f = report["flip_table"]
    mc = report["mcnemar"]
    meta = report["deltas"].get("_meta", {})
    pct = 100 * (1 - meta.get("alpha", 0.05))
    lines = [
        f"PAIRED COMPARISON — B ({name_b}) vs A ({name_a}), "
        f"{report['n']} rows",
        "",
        "Decision flips:",
        f"  both correct        {f['both_correct']:5d}",
        f"  only A correct      {f['only_a']:5d}",
        f"  only B correct      {f['only_b']:5d}",
        f"  both wrong          {f['both_wrong']:5d}",
        f"  predictions differ  {f['n_flips']:5d}",
        "",
        f"McNemar exact (two-sided): p = {mc['p_value']:.4f}"
        + ("  ** accuracy difference significant **"
           if mc["significant"] else "  (not significant)"),
        "",
        f"Metric deltas (B − A), {pct:.0f}% paired-bootstrap"
        f" CIs ({meta.get('n_boot', '?')} resamples):",
    ]
    for k, v in report["deltas"].items():
        if k == "_meta":
            continue
        if v["n_valid"] == 0 or np.isnan(v["delta"]):
            lines.append(f"  {k:18s} undefined on this split")
            continue
        mark = "  *" if v["significant"] else ""
        lines.append(
            f"  {k:18s} {v['a']:.4f} -> {v['b']:.4f}  "
            f"Δ {v['delta']:+.4f}  [{v['lo']:+.4f}, {v['hi']:+.4f}]"
            + (f"  ({v['n_valid']} valid)"
               if v["n_valid"] < meta.get("n_boot", 0) else "") + mark)
    lines.append("")
    lines.append("  * = CI excludes 0")
    return "\n".join(lines)
