"""Dataset image-size analyzer (the port's copy of
``dfu_multimodal_tpu/tools/analyze.py``).

Counterpart of reference scripts/analyze_image_sizes.py (SURVEY.md §2 #7):
per-directory statistics over dimensions, aspect ratios, file sizes and
color modes, plus a standardization recommendation (:13-177).

Sizes, modes and formats come from the file headers
(``data/loader.py::image_info``, PIL's ``size`` / ``mode`` / ``format``
for JPEG and PNG).  A file it cannot read is skipped, as the JAX loop
skips what PIL cannot open; so a BMP, GIF, TIFF or WebP, which PIL opens
and the JAX package counts, is skipped here.
"""

from __future__ import annotations

from collections import Counter
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from dfu_multimodal_tpu_torch.data.layout import IMAGE_EXTS
from dfu_multimodal_tpu_torch.data.loader import DecodeError, image_info


def analyze_image_sizes(root: Path, max_images: Optional[int] = None,
                        verbose: bool = True) -> Dict:
    """Returns a stats dict; prints a report when verbose."""
    widths, heights, aspects, file_sizes = [], [], [], []
    modes: Counter = Counter()
    formats: Counter = Counter()
    n = 0
    for p in sorted(Path(root).rglob("*")):
        if p.suffix.lower() not in IMAGE_EXTS or not p.is_file():
            continue
        try:
            w, h, mode, fmt = image_info(p)
        except (OSError, DecodeError):
            continue
        widths.append(w)
        heights.append(h)
        aspects.append(w / h)
        modes[mode] += 1
        formats[fmt] += 1
        file_sizes.append(p.stat().st_size)
        n += 1
        if max_images and n >= max_images:
            break

    if n == 0:
        if verbose:
            print(f"No images found under {root}")
        return {"count": 0}

    w = np.asarray(widths)
    h = np.asarray(heights)
    a = np.asarray(aspects)
    fs = np.asarray(file_sizes)

    stats = {
        "count": n,
        "width": {"min": int(w.min()), "max": int(w.max()),
                  "mean": float(w.mean()), "median": float(np.median(w))},
        "height": {"min": int(h.min()), "max": int(h.max()),
                   "mean": float(h.mean()), "median": float(np.median(h))},
        "aspect_ratio": {"min": float(a.min()), "max": float(a.max()),
                         "mean": float(a.mean())},
        "file_size_kb": {"min": float(fs.min() / 1024),
                         "max": float(fs.max() / 1024),
                         "mean": float(fs.mean() / 1024)},
        "modes": dict(modes),
        "formats": dict(formats),
        "uniform_size": bool(w.min() == w.max() and h.min() == h.max()),
    }

    # Recommendation mirrors the reference's guidance: already-uniform 224²
    # needs nothing; mixed sizes with near-square aspects -> direct resize;
    # wide aspect spread -> resize-longest-edge + pad (the standardizer).
    if stats["uniform_size"] and w[0] == 224 and h[0] == 224:
        rec = "none: dataset already standardized at 224x224"
    elif a.max() / max(a.min(), 1e-9) < 1.34:
        rec = "resize directly to 224x224 (aspect ratios near-uniform)"
    else:
        rec = ("resize longest edge to 224 and pad to square "
               "(aspect ratios vary widely) — use tools/standardize")
    stats["recommendation"] = rec

    if verbose:
        print("=" * 70)
        print(f"IMAGE SIZE ANALYSIS: {root}")
        print("=" * 70)
        print(f"Images analyzed: {n}")
        print(f"Width:  min {stats['width']['min']}, max "
              f"{stats['width']['max']}, mean {stats['width']['mean']:.1f}")
        print(f"Height: min {stats['height']['min']}, max "
              f"{stats['height']['max']}, mean {stats['height']['mean']:.1f}")
        print(f"Aspect: min {stats['aspect_ratio']['min']:.3f}, max "
              f"{stats['aspect_ratio']['max']:.3f}")
        print(f"File size: mean {stats['file_size_kb']['mean']:.1f} KB")
        print(f"Color modes: {stats['modes']}")
        print(f"Formats: {stats['formats']}")
        print(f"\nRecommendation: {rec}")
    return stats
