"""Synthetic dataset generation for tests and the card's smoke run (the
port's copy of ``dfu_multimodal_tpu/data/synthetic.py``).

The real datasets (Kaggle DFU RGB + thermography) are not in the
repository; this module writes a small learnable stand-in with the
on-disk layout the framework and the reference's scripts expect:

    root/{rgb,thermal}/{train,val,test}/{healthy,ulcer}/NNNNNN.jpg

``make_image`` is the JAX package's, bit for bit (the same numpy draws);
``make_synthetic_dataset`` writes the same tree and file names through
the port's JPEG encoder (``native.encode_jpeg``) at quality 90: on the
libjpeg route the files are PIL's ``save(quality=90)``, byte for byte.
Classes are separable by construction: "ulcer" images carry a reddish
blob (RGB) or a hot spot (thermal) on a smooth texture.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from dfu_multimodal_tpu_torch import native
from dfu_multimodal_tpu_torch.data.layout import SPLITS


def _base_texture(rng: np.random.Generator, size: int,
                  base: Tuple[int, int, int]) -> np.ndarray:
    img = np.ones((size, size, 3), np.float32) * np.asarray(base, np.float32)
    # ceil-divide so the upsampled field always covers the full image
    # (any size works, not just multiples of 8)
    blocks = -(-size // 8)
    noise = rng.normal(0, 12, (blocks, blocks, 3)).astype(np.float32)
    noise = np.kron(noise, np.ones((8, 8, 1), np.float32))  # smooth blotches
    return img + noise[:size, :size]


def _add_blob(rng: np.random.Generator, img: np.ndarray,
              color: Tuple[int, int, int]) -> np.ndarray:
    size = img.shape[0]
    cy, cx = rng.uniform(0.3, 0.7, 2) * size
    radius = rng.uniform(0.10, 0.22) * size
    yy, xx = np.mgrid[0:size, 0:size]
    d2 = (yy - cy) ** 2 + (xx - cx) ** 2
    mask = np.exp(-d2 / (2 * radius ** 2))[..., None]
    return img * (1 - mask) + np.asarray(color, np.float32) * mask


def make_image(rng: np.random.Generator, modality: str, label: int,
               size: int = 224, difficulty: str = "easy") -> np.ndarray:
    """``difficulty='easy'`` (default, used by tests/benchmarks): strongly
    separable classes.  ``'hard'``: both classes carry 1-2 distractor
    blobs and the ulcer signal is a subtler color shift — built for the
    SSL-pretraining rehearsal, where a trivially-separable task would let
    a from-scratch baseline saturate and mask any initialization effect."""
    if modality == "rgb":
        img = _base_texture(rng, size, (196, 160, 130))     # skin tone
        if difficulty == "hard":
            for _ in range(rng.integers(1, 3)):
                img = _add_blob(rng, img, tuple(
                    rng.uniform((150, 100, 80), (200, 150, 120))))
            if label == 1:
                img = _add_blob(rng, img, (168, 95, 85))    # subtle redness
        elif label == 1:
            img = _add_blob(rng, img, (150, 40, 35))        # dark red ulcer
    else:
        heat = _base_texture(rng, size, (90, 60, 120))      # cool palette
        if difficulty == "hard":
            for _ in range(rng.integers(1, 3)):
                heat = _add_blob(rng, heat, tuple(
                    rng.uniform((120, 90, 90), (180, 140, 110))))
            if label == 1:
                heat = _add_blob(rng, heat, (200, 160, 95))  # warm-ish spot
        elif label == 1:
            heat = _add_blob(rng, heat, (250, 200, 60))     # hot spot
        img = heat
    return np.clip(img, 0, 255).astype(np.uint8)


def make_synthetic_dataset(
        root: Path, images_per_class: int = 8, size: int = 224,
        seed: int = 0,
        split_fractions: Tuple[float, float] = (0.6, 0.2),
        counts: Dict[str, Dict[str, Tuple[int, int]]] = None,
        difficulty: str = "easy") -> Path:
    """Write a synthetic dataset tree under ``root``.

    ``counts`` optionally gives exact (healthy, ulcer) counts per
    modality/split: ``counts['rgb']['train'] = (10, 12)``; otherwise
    ``images_per_class`` images per class are split 60/20/20.
    """
    root = Path(root)
    rng = np.random.default_rng(seed)
    for modality in ("rgb", "thermal"):
        for split_idx, split in enumerate(SPLITS):
            for cls_idx, cls in enumerate(("healthy", "ulcer")):
                if counts is not None:
                    n = counts[modality][split][cls_idx]
                else:
                    train_n = max(1, int(images_per_class * split_fractions[0]))
                    val_n = max(1, int(images_per_class * split_fractions[1]))
                    test_n = max(1, images_per_class - train_n - val_n)
                    n = (train_n, val_n, test_n)[split_idx]
                out_dir = root / modality / split / cls
                out_dir.mkdir(parents=True, exist_ok=True)
                for i in range(n):
                    img = make_image(rng, modality, cls_idx, size,
                                     difficulty=difficulty)
                    native.encode_jpeg(img, out_dir / f"{i:06d}.jpg",
                                       quality=90)
    return root
