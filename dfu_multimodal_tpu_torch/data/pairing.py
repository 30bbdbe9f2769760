"""Pairing logic as pure index-space functions (the port's copy of
``dfu_multimodal_tpu/data/pairing.py``; the same seeds give the same
pairs).

1. ``aligned_pairs`` — index-aligned truncate-to-min pairing per class,
   with a black-placeholder fallback when one modality is empty
   (reference scripts/dataloader.py:38-75, DFUPairedDataset).
2. ``pseudo_pairs`` — modulo-cycling to max length per class: pair i uses
   rgb[i % len(rgb)] and thermal[i % len(thermal)], then a seeded shuffle
   (reference notebooks/train_multimodal_fusion.py:109-140).
3. ``random_pairs`` — label-matched random pairing, min-count per class
   (the reference's early-files strategy).
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class Pair:
    """Indices into per-class path lists; ``None`` = missing modality
    (black placeholder image at load time)."""

    rgb: Optional[int]
    thermal: Optional[int]
    label: int


def aligned_pairs(rgb_counts: Sequence[int],
                  thermal_counts: Sequence[int]) -> List[Pair]:
    """Truncate-to-min pairing per class.

    ``rgb_counts[c]`` / ``thermal_counts[c]`` are the number of images of
    class ``c`` in each modality. Output indices are positions within the
    sorted per-class listings.
    """
    pairs: List[Pair] = []
    for label, (n_rgb, n_th) in enumerate(zip(rgb_counts, thermal_counts)):
        if n_rgb == 0 and n_th == 0:
            continue
        if n_rgb == 0:
            pairs.extend(Pair(None, i, label) for i in range(n_th))
        elif n_th == 0:
            pairs.extend(Pair(i, None, label) for i in range(n_rgb))
        else:
            n = min(n_rgb, n_th)
            pairs.extend(Pair(i, i, label) for i in range(n))
    return pairs


def pseudo_pairs(rgb_counts: Sequence[int], thermal_counts: Sequence[int],
                 seed: Optional[int] = None) -> List[Pair]:
    """Modulo-cycling pairing to max length per class, then shuffle.

    A class contributes pairs only when BOTH modalities have images of it
    (train_multimodal_fusion.py:114-137).
    """
    pairs: List[Pair] = []
    for label, (n_rgb, n_th) in enumerate(zip(rgb_counts, thermal_counts)):
        if n_rgb == 0 or n_th == 0:
            continue
        n = max(n_rgb, n_th)
        pairs.extend(Pair(i % n_rgb, i % n_th, label) for i in range(n))
    rng = random.Random(seed)
    rng.shuffle(pairs)
    return pairs


def random_pairs(rgb_counts: Sequence[int], thermal_counts: Sequence[int],
                 seed: Optional[int] = None) -> List[Pair]:
    """Label-matched *random* pairing, min-count per class — the legacy
    early-files strategy (reference notebooks/early files/
    train_rgb_resnet_fusion.py:114-200): per class take
    min(len(rgb), len(thermal)) labels, each pair drawing random samples of
    that class from both modalities; then shuffle the label sequence."""
    rng = random.Random(seed)
    pairs: List[Pair] = []
    for label, (n_rgb, n_th) in enumerate(zip(rgb_counts, thermal_counts)):
        n = min(n_rgb, n_th)
        for _ in range(n):
            pairs.append(Pair(rng.randrange(n_rgb), rng.randrange(n_th),
                              label))
    rng.shuffle(pairs)
    return pairs


def pair_class_counts(pairs: Sequence[Pair]) -> Tuple[int, int]:
    healthy = sum(1 for p in pairs if p.label == 0)
    return healthy, len(pairs) - healthy
