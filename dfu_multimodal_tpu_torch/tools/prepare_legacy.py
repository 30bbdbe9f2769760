"""Legacy dataset preparation pipeline (pre-organizer generation; the
port's copy of ``dfu_multimodal_tpu/tools/prepare_legacy.py``).

Counterpart of reference scripts/prepare_datasets.py (SURVEY.md §2 #3):
a plain random 70/15/15 split with NO dedup (superseded by the organizer's
by-hash split, kept for parity):

- RGB from ``<rgb_src>/Patches/{Normal->healthy, Abnormal->ulcer}``,
  split 70/15/15 per class;
- thermal from ``<thermal_src>/ThermoDataBase/{train,val}``
  (Control Group -> healthy, DM Group -> ulcer): the raw val becomes our
  val, and the raw train is carved 85/15 into train/test (the raw dataset
  has no test split — the reference's documented workaround);
- writes ``dataset_info.txt`` with per-split per-modality counts in the
  reference's format (:223-249).
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import Dict, List, Tuple

from dfu_multimodal_tpu_torch.data.layout import IMAGE_EXTS
from dfu_multimodal_tpu_torch.tools.splits import (carve_test_from_train,
                                                   random_split_70_15_15)


def _images(directory: Path) -> List[Path]:
    if not directory.exists():
        return []
    return sorted(p for p in directory.rglob("*.*")
                  if p.suffix.lower() in IMAGE_EXTS)


def _copy_all(items: List[Path], dst: Path) -> int:
    dst.mkdir(parents=True, exist_ok=True)
    for p in items:
        shutil.copy2(p, dst / p.name)
    return len(items)


def prepare_rgb(rgb_source: Path, out_dir: Path,
                seed: int = 42) -> Dict[str, Dict[str, int]]:
    patches = Path(rgb_source) / "Patches"
    counts: Dict[str, Dict[str, int]] = {}
    for src_name, cls in (("Normal", "healthy"), ("Abnormal", "ulcer")):
        train, val, test = random_split_70_15_15(
            _images(patches / src_name), seed)
        for split, items in (("train", train), ("val", val), ("test", test)):
            n = _copy_all(items, Path(out_dir) / split / cls)
            counts.setdefault(split, {})[cls] = n
    return counts


def prepare_thermal(thermal_source: Path, out_dir: Path,
                    seed: int = 42) -> Dict[str, Dict[str, int]]:
    base = Path(thermal_source) / "ThermoDataBase"
    counts: Dict[str, Dict[str, int]] = {}
    for src_name, cls in (("Control Group", "healthy"), ("DM Group", "ulcer")):
        train_pool = _images(base / "train" / src_name)
        val_items = _images(base / "val" / src_name)
        train_items, test_items = carve_test_from_train(train_pool, 0.15,
                                                        seed)
        for split, items in (("train", train_items), ("val", val_items),
                             ("test", test_items)):
            n = _copy_all(items, Path(out_dir) / split / cls)
            counts.setdefault(split, {})[cls] = n
    return counts


def write_dataset_info(output_dir: Path, rgb_counts, thermal_counts) -> Path:
    lines = ["DFU Multimodal Dataset Information", "=" * 50, ""]
    for split in ("train", "val", "test"):
        lines.append(f"{split.upper()} Split:")
        for name, counts in (("RGB", rgb_counts), ("Thermal",
                                                   thermal_counts)):
            healthy = counts.get(split, {}).get("healthy", 0)
            ulcer = counts.get(split, {}).get("ulcer", 0)
            lines.append(f"  {name} Dataset:")
            lines.append(f"    Healthy: {healthy}")
            lines.append(f"    Ulcer:   {ulcer}")
            lines.append(f"    Total:   {healthy + ulcer}")
            lines.append("")
    path = Path(output_dir) / "dataset_info.txt"
    path.write_text("\n".join(lines))
    return path


def prepare_datasets(rgb_source: Path, thermal_source: Path,
                     output_dir: Path, seed: int = 42,
                     verbose: bool = True) -> Dict:
    output_dir = Path(output_dir)
    rgb_counts = prepare_rgb(rgb_source, output_dir / "rgb", seed)
    thermal_counts = prepare_thermal(thermal_source, output_dir / "thermal",
                                     seed)
    info = write_dataset_info(output_dir, rgb_counts, thermal_counts)
    if verbose:
        print(f"Legacy preparation complete; metadata at {info}")
    return {"rgb": rgb_counts, "thermal": thermal_counts}
