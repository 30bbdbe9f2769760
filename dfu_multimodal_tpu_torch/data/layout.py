"""On-disk dataset layout scanning (the port's copy of
``dfu_multimodal_tpu/data/layout.py``).

Canonical layout (the reference's organize_clean_dataset.py:23-35):

    data_dir/{rgb,thermal}/{train,val,test}/{healthy,ulcer}/*.jpg|png|...

A recursive listing filtered by image extension, healthy=0 / ulcer=1,
files sorted for determinism (reference notebooks/train_rgb_only.py:55-97,
scripts/dataloader.py:38-44).  The port decodes JPEG and PNG; a listed
file of another format raises when it is decoded (``data/loader.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Tuple

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff"}
CLASSES: Tuple[Tuple[str, int], ...] = (("healthy", 0), ("ulcer", 1))
SPLITS = ("train", "val", "test")


def list_images(directory: Path) -> List[Path]:
    """Sorted recursive listing of image files under ``directory``."""
    if not directory.exists():
        return []
    return sorted(p for p in directory.rglob("*")
                  if p.suffix.lower() in IMAGE_EXTS)


@dataclass
class SplitIndex:
    """All image paths + labels for one modality/split."""

    paths: List[Path] = field(default_factory=list)
    labels: List[int] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.paths)

    @property
    def class_counts(self) -> Tuple[int, int]:
        return (self.labels.count(0), self.labels.count(1))

    def by_class(self) -> Dict[int, List[Path]]:
        out: Dict[int, List[Path]] = {0: [], 1: []}
        for p, l in zip(self.paths, self.labels):
            out[l].append(p)
        return out


def scan_split(modality_dir: Path, split: str) -> SplitIndex:
    """Scan ``modality_dir/split/{healthy,ulcer}``."""
    index = SplitIndex()
    split_dir = Path(modality_dir) / split
    for cls, label in CLASSES:
        for p in list_images(split_dir / cls):
            index.paths.append(p)
            index.labels.append(label)
    return index


def scan_modality(modality_dir: Path) -> Dict[str, SplitIndex]:
    return {split: scan_split(modality_dir, split) for split in SPLITS}


def dataset_statistics(data_dir: Path) -> Dict[str, Dict[str, Tuple[int, int]]]:
    """(healthy, ulcer) counts per split per modality — the
    ``print_dataset_statistics`` contract (scripts/dataloader.py:292-315)."""
    stats: Dict[str, Dict[str, Tuple[int, int]]] = {}
    for split in SPLITS:
        stats[split] = {}
        for modality in ("rgb", "thermal"):
            idx = scan_split(Path(data_dir) / modality, split)
            stats[split][modality] = idx.class_counts
    return stats


def print_dataset_statistics(data_dir: Path) -> None:
    print("\n" + "=" * 70)
    print("DATASET STATISTICS")
    print("=" * 70)
    stats = dataset_statistics(data_dir)
    for split, mods in stats.items():
        print(f"\n{split.upper()} SET:")
        for modality, (healthy, ulcer) in mods.items():
            total = healthy + ulcer
            if total:
                print(f"  {modality.upper():8s}: {healthy:4d} healthy "
                      f"({100 * healthy / total:5.1f}%), {ulcer:4d} ulcer "
                      f"({100 * ulcer / total:5.1f}%), Total: {total:4d}")
            else:
                print(f"  {modality.upper():8s}: No images found")
    print("\n" + "=" * 70)
