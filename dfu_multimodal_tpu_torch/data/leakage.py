"""SHA256 cross-split leakage gate (the port's copy of
``dfu_multimodal_tpu/data/leakage.py``).

Training aborts if any exact image (by content hash) appears in more than
one split — the reference's hard training gate (reference
notebooks/train_rgb_only.py:138-168, train_multimodal_fusion.py:240-265).
Hashing uses ``hashlib``, which gives the digests of the JAX package's
threaded native hasher; that hasher is a speed path and is not ported.
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set


class LeakageError(RuntimeError):
    """Raised when exact-image duplicates exist across splits."""


def compute_sha256(path: Path, block_size: int = 65536) -> Optional[str]:
    try:
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for block in iter(lambda: f.read(block_size), b""):
                h.update(block)
        return h.hexdigest()
    except OSError:
        return None


def hash_files(paths: Iterable[Optional[Path]],
               strict: bool = False) -> Set[str]:
    """Content hashes of all existing files.  ``strict=True`` raises on
    any unreadable file instead of silently dropping it — the leakage
    GATE must use this (a duplicate that cannot be read at gate time
    would otherwise escape detection, which is the gate's single job)."""
    real = [Path(p) for p in paths if p is not None]
    hashes = [compute_sha256(p) for p in real]
    if strict:
        bad = [str(p) for p, h in zip(real, hashes) if not h]
        if bad:
            raise LeakageError(
                f"{len(bad)} file(s) could not be read while hashing for "
                f"the leakage gate (first: {bad[0]}); refusing to skip "
                "them — an unreadable duplicate would escape the check")
    return {h for h in hashes if h}


def check_split_leakage(split_paths: Dict[str, Sequence[Optional[Path]]],
                        name: str = "", verbose: bool = True) -> None:
    """Raise :class:`LeakageError` on any cross-split hash overlap.

    ``split_paths`` maps split name -> file paths. Overlap counts are
    reported pairwise like the reference gate (train_rgb_only.py:147-165).
    """
    if verbose:
        tag = f" ({name})" if name else ""
        print(f"\nChecking for exact-image leakage across splits "
              f"(SHA256){tag} ...")
    hashes = {split: hash_files(paths, strict=True)
              for split, paths in split_paths.items()}
    splits = list(hashes)
    overlaps: List[str] = []
    total = 0
    for i, a in enumerate(splits):
        for b in splits[i + 1:]:
            n = len(hashes[a] & hashes[b])
            total += n
            overlaps.append(f"{a}/{b}: {n}")
    if verbose:
        print("  Overlaps - " + ", ".join(overlaps))
    if total > 0:
        raise LeakageError(
            "Image leakage detected across splits - aborting training")
    if verbose:
        print("  OK: no exact-image leakage detected (by SHA256).")
