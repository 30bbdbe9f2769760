"""Metric reductions (counterpart of the device half of
``dfu_multimodal_tpu/eval/metrics.py``): masked binary confusion counts
on the step's device, one (4,) vector per step, and the accuracy and F1
read from summed counts on the host.  The host-side medical metrics
(ROC/PR-AUC, MCC, ...) are not ported yet."""

from __future__ import annotations

from typing import Optional, Sequence

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
