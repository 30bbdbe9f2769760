"""Image standardization: aspect-preserving resize + pad to a square (the
port's copy of ``dfu_multimodal_tpu/tools/standardize.py``).

Counterpart of reference scripts/standardize_images.py (SURVEY.md §2 #6):
resize so the longest edge equals ``target`` with PIL bilinear, paste
centered on a black square canvas, save; then a verification pass asserting
every output is exactly ``target x target`` (:13-100, :102-156).

The port reads the size from the file's header
(``data/loader.py::image_info``), decodes and resizes with its own decoder
(the PIL-exact BILINEAR resampler at the non-square target), and writes by
the destination's suffix: a JPEG through ``native.encode_jpeg`` at quality
95 (PIL's ``save(quality=95)`` on the libjpeg route), a PNG through
``data/png.py::write_png``.  A file it cannot decode counts as an error.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from dfu_multimodal_tpu_torch import native
from dfu_multimodal_tpu_torch.data.layout import IMAGE_EXTS
from dfu_multimodal_tpu_torch.data.loader import (DecodeError, image_info,
                                                  load_image)
from dfu_multimodal_tpu_torch.data.png import write_png


def standardize_image(src: Path, dst: Path, target: int = 224,
                      fill=(0, 0, 0)) -> Tuple[int, int]:
    """Standardize one image; returns the original (width, height)."""
    ow, oh, _, _ = image_info(src)
    scale = target / max(ow, oh)
    nw, nh = max(1, round(ow * scale)), max(1, round(oh * scale))
    canvas = np.empty((target, target, 3), np.uint8)
    canvas[:] = np.asarray(fill, np.uint8)
    x0, y0 = (target - nw) // 2, (target - nh) // 2
    canvas[y0:y0 + nh, x0:x0 + nw] = load_image(src, (nw, nh))
    suffix = Path(dst).suffix.lower()
    if suffix not in (".jpg", ".jpeg", ".png"):
        raise DecodeError(f"{dst}: the port writes JPEG and PNG only, not "
                          f"{suffix}")
    dst.parent.mkdir(parents=True, exist_ok=True)
    if suffix == ".png":
        write_png(dst, canvas)
    else:
        native.encode_jpeg(canvas, dst, quality=95)
    return ow, oh


def standardize_tree(src_root: Path, dst_root: Path, target: int = 224,
                     verbose: bool = True) -> Dict[str, int]:
    """Standardize every image under ``src_root`` preserving the relative
    directory layout. Returns {'processed': n, 'errors': n}."""
    src_root, dst_root = Path(src_root), Path(dst_root)
    processed = errors = 0
    for src in sorted(src_root.rglob("*")):
        if src.suffix.lower() not in IMAGE_EXTS or not src.is_file():
            continue
        dst = dst_root / src.relative_to(src_root)
        try:
            standardize_image(src, dst, target)
            processed += 1
        except (OSError, DecodeError) as e:
            errors += 1
            if verbose:
                print(f"  error: {src}: {e}")
    if verbose:
        print(f"Standardized {processed} images -> {dst_root} "
              f"({errors} errors)")
    return {"processed": processed, "errors": errors}


def verify_standardization(root: Path, target: int = 224,
                           verbose: bool = True) -> Dict[str, int]:
    """Post-condition check: every image is exactly target x target
    (reference :102-156)."""
    ok = bad = 0
    offenders = []
    for p in sorted(Path(root).rglob("*")):
        if p.suffix.lower() not in IMAGE_EXTS or not p.is_file():
            continue
        w, h, _, _ = image_info(p)
        if (w, h) == (target, target):
            ok += 1
        else:
            bad += 1
            offenders.append((str(p), (w, h)))
    if verbose:
        print(f"Verification: {ok} OK, {bad} wrong-size")
        for path, size in offenders[:10]:
            print(f"  {path}: {size}")
    return {"ok": ok, "bad": bad}
