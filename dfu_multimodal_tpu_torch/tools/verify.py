"""Raw-dataset structure verifier (the port's copy of
``dfu_multimodal_tpu/tools/verify.py``).

Counterpart of reference scripts/verify_structure.py (SURVEY.md §2 #2):
walk the expected raw layouts (RGB Kaggle patches, thermal ThermoDataBase)
and the organized output, print a tree with image counts, and report which
expected directories are present (:16-167).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

from dfu_multimodal_tpu_torch.data.layout import IMAGE_EXTS

EXPECTED_RGB = (
    "Patches/Normal|Patches/Healthy",
    "Patches/Abnormal|Patches/Ulcer",
    "TestSet",
)
EXPECTED_THERMAL = (
    "ThermoDataBase/train/Control Group",
    "ThermoDataBase/train/DM Group",
    "ThermoDataBase/val/Control Group",
    "ThermoDataBase/val/DM Group",
)
EXPECTED_ORGANIZED = tuple(
    f"{m}/{s}/{c}" for m in ("rgb", "thermal")
    for s in ("train", "val", "test") for c in ("healthy", "ulcer"))


def count_images(directory: Path) -> int:
    if not directory.exists():
        return 0
    return sum(1 for p in directory.rglob("*")
               if p.suffix.lower() in IMAGE_EXTS and p.is_file())


def explore_directory(root: Path, max_depth: int = 3,
                      verbose: bool = True) -> List[Tuple[str, int]]:
    """Print a shallow tree of ``root`` with per-directory image counts."""
    rows: List[Tuple[str, int]] = []
    root = Path(root)
    if not root.exists():
        if verbose:
            print(f"  MISSING: {root}")
        return rows

    def walk(d: Path, depth: int):
        n = count_images(d)
        rows.append((str(d.relative_to(root.parent)), n))
        if verbose:
            print(f"  {'  ' * depth}{d.name}/  ({n} images)")
        if depth < max_depth:
            for sub in sorted(p for p in d.iterdir() if p.is_dir()):
                walk(sub, depth + 1)

    walk(root, 0)
    return rows


def check_expected(root: Path, expected, verbose: bool = True
                   ) -> Dict[str, bool]:
    """For each expected entry ('a|b' = alternatives), is it present?"""
    results: Dict[str, bool] = {}
    for entry in expected:
        present = any((Path(root) / alt).exists()
                      for alt in entry.split("|"))
        results[entry] = present
        if verbose:
            print(f"  [{'OK ' if present else 'MISS'}] {entry}")
    return results


def verify_structure(rgb_source: Path = None, thermal_source: Path = None,
                     organized: Path = None, verbose: bool = True) -> Dict:
    """Full verification across all configured roots."""
    out: Dict = {}
    if rgb_source is not None:
        if verbose:
            print(f"\nRGB raw dataset: {rgb_source}")
        explore_directory(Path(rgb_source), verbose=verbose)
        out["rgb"] = check_expected(rgb_source, EXPECTED_RGB, verbose)
    if thermal_source is not None:
        if verbose:
            print(f"\nThermal raw dataset: {thermal_source}")
        explore_directory(Path(thermal_source), verbose=verbose)
        out["thermal"] = check_expected(thermal_source, EXPECTED_THERMAL,
                                        verbose)
    if organized is not None:
        if verbose:
            print(f"\nOrganized dataset: {organized}")
        out["organized"] = check_expected(organized, EXPECTED_ORGANIZED,
                                          verbose)
    return out
