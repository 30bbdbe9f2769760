"""Clean dataset organizer — dedup, by-hash split, anonymous naming (the
port's copy of ``dfu_multimodal_tpu/tools/organize.py``).

Behavioral counterpart of reference scripts/organize_clean_dataset.py (the
canonical L0 pipeline, SURVEY.md §2 #4):

- RGB candidates: ``<rgb_src>/Patches/{Normal|Healthy}`` -> healthy (first
  existing dir wins), ``Patches/{Abnormal|Ulcer}`` -> ulcer, plus everything
  under ``<rgb_src>/TestSet`` -> ulcer (:164-187);
- thermal candidates: ``<thermal_src>/ThermoDataBase/{train,val}/
  {Control Group -> healthy, DM Group -> ulcer}`` (:290-307);
- SHA-256 every candidate (``hashlib``, ``data/leakage.py``);
- one class per unique hash, ulcer wins on conflict (:205-212);
- 70/15/15 split over UNIQUE HASHES per class (train_test_split 0.3 then
  0.5/0.5, random_state=42, as ``tools/splits.py::train_test_split``
  states it) so exact duplicates can never leak across splits
  (:217-227);
- copy the first original per hash as ``NNNNNN.jpg`` (zero-padded global
  counter per modality) into ``out/{modality}/{split}/{class}/`` (:234-254);
- write ``{rgb,thermal}_dedupe_report.json``, ``dataset_manifest.json``
  and ``dataset_summary.txt`` (:257-266, 389-411, 413-491).
"""

from __future__ import annotations

import json
import shutil
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

from dfu_multimodal_tpu_torch.data.layout import SPLITS
from dfu_multimodal_tpu_torch.data.leakage import compute_sha256
from dfu_multimodal_tpu_torch.tools.splits import train_test_split

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff"}
RANDOM_SEED = 42


def _image_files(directory: Path) -> List[Path]:
    return sorted(p for p in directory.rglob("*.*")
                  if p.suffix.lower() in IMAGE_EXTS)


def collect_rgb_candidates(rgb_source: Path) -> List[Tuple[Path, str]]:
    patches = Path(rgb_source) / "Patches"
    candidates: List[Tuple[Path, str]] = []
    if not patches.exists():
        return candidates
    for names, cls in ((("Normal", "Healthy"), "healthy"),
                       (("Abnormal", "Ulcer"), "ulcer")):
        for name in names:
            d = patches / name
            if d.exists():
                candidates.extend((p, cls) for p in _image_files(d))
                break
    test_dir = Path(rgb_source) / "TestSet"
    if test_dir.exists():
        candidates.extend((p, "ulcer") for p in _image_files(test_dir))
    return candidates


def collect_thermal_candidates(thermal_source: Path) -> List[Tuple[Path, str]]:
    base = Path(thermal_source) / "ThermoDataBase"
    candidates: List[Tuple[Path, str]] = []
    if not base.exists():
        return candidates
    for split_dir in ("train", "val"):
        root = base / split_dir
        if not root.exists():
            continue
        for sub, cls in (("Control Group", "healthy"), ("DM Group", "ulcer")):
            d = root / sub
            if d.exists():
                candidates.extend((p, cls) for p in _image_files(d))
    return candidates


def hash_candidates(candidates: Sequence[Tuple[Path, str]]
                    ) -> Dict[str, List[Dict]]:
    """hash -> [{'path', 'class'}, ...]; IO-failed files are dropped."""
    hashes = [compute_sha256(p) or "" for p, _ in candidates]

    hash_map: Dict[str, List[Dict]] = defaultdict(list)
    for (p, cls), h in zip(candidates, hashes):
        if h:
            hash_map[h].append({"path": str(Path(p).resolve()),
                                "class": cls})
    return dict(hash_map)


def assign_classes(hash_map: Dict[str, List[Dict]]
                   ) -> Tuple[List[str], List[str]]:
    """(healthy_hashes, ulcer_hashes), deterministic order, ulcer wins."""
    healthy, ulcer = [], []
    for h, items in sorted(hash_map.items()):
        if any(it["class"] == "ulcer" for it in items):
            ulcer.append(h)
        else:
            healthy.append(h)
    return healthy, ulcer


def split_70_15_15(items: List[str],
                   seed: int = RANDOM_SEED) -> Tuple[List, List, List]:
    """70/15/15 via the reference's two-stage train_test_split with
    random_state=seed (``tools/splits.py::train_test_split``: scikit-learn's
    shuffle, reproduced with numpy)."""
    if len(items) < 3:
        return list(items), [], []
    train, temp = train_test_split(items, 0.3, seed)
    val, test = train_test_split(temp, 0.5, seed)
    return train, val, test


@dataclass
class ModalityResult:
    healthy: int = 0
    ulcer: int = 0
    errors: int = 0
    manifest: Dict[str, Dict] = field(default_factory=dict)
    dedupe_report: Dict = field(default_factory=dict)
    split_counts: Dict[str, Dict[str, int]] = field(default_factory=dict)


def organize_modality(candidates: Sequence[Tuple[Path, str]], out_dir: Path,
                      seed: int = RANDOM_SEED,
                      verbose: bool = True) -> ModalityResult:
    """Dedup + split + copy one modality; returns stats & manifest."""
    result = ModalityResult()
    if not candidates:
        result.errors = 1
        return result

    hash_map = hash_candidates(candidates)
    healthy_hashes, ulcer_hashes = assign_classes(hash_map)
    if verbose:
        print(f"  Candidates: {len(candidates)}, unique hashes: "
              f"{len(hash_map)} (healthy {len(healthy_hashes)}, "
              f"ulcer {len(ulcer_hashes)})")

    splits = {
        "healthy": split_70_15_15(healthy_hashes, seed),
        "ulcer": split_70_15_15(ulcer_hashes, seed),
    }

    counter = 1
    for cls in ("healthy", "ulcer"):
        result.split_counts[cls] = {}
        for split_name, hash_list in zip(SPLITS, splits[cls]):
            dst_dir = Path(out_dir) / split_name / cls
            dst_dir.mkdir(parents=True, exist_ok=True)
            result.split_counts[cls][split_name] = len(hash_list)
            for h in hash_list:
                originals = [it["path"] for it in hash_map[h]]
                anon = f"{counter:06d}.jpg"
                try:
                    shutil.copy2(originals[0], dst_dir / anon)
                    result.manifest[anon] = {
                        "originals": originals, "split": split_name,
                        "class": cls, "hash": h}
                except OSError:
                    result.errors += 1
                counter += 1

    result.healthy = len(healthy_hashes)
    result.ulcer = len(ulcer_hashes)
    result.dedupe_report = {
        "total_candidate_files": len(candidates),
        "unique_hashes": len(hash_map),
        "duplicates_removed": sum(max(0, len(v) - 1)
                                  for v in hash_map.values()),
    }
    return result


def write_manifest(output_dir: Path, rgb: ModalityResult,
                   thermal: ModalityResult) -> Path:
    manifest = {
        "created": str(Path(output_dir) / "dataset_manifest.json"),
        "description":
            "Maps anonymous numeric filenames to original sources (list)",
        "rgb": rgb.manifest,
        "thermal": thermal.manifest,
        "notes": [
            "Filenames follow pattern: 000001.jpg (numeric-only, "
            "zero-padded 6 digits)",
            "One anonymous file corresponds to one unique image hash "
            "(SHA256)",
            "Original file paths are provided as a list under 'originals' "
            "for each anonymous file",
            "Splits created by unique-image hashing to avoid leakage "
            "across train/val/test",
        ],
    }
    path = Path(output_dir) / "dataset_manifest.json"
    path.write_text(json.dumps(manifest, indent=2))
    return path


def write_summary(output_dir: Path, rgb: ModalityResult,
                  thermal: ModalityResult) -> Path:
    lines = ["=" * 70, "DATASET SUMMARY", "=" * 70, ""]
    for name, res in (("RGB", rgb), ("THERMAL", thermal)):
        lines.append(f"{name} dataset:")
        lines.append(f"  Unique images: {res.healthy + res.ulcer} "
                     f"(healthy {res.healthy}, ulcer {res.ulcer})")
        lines.append(f"  Duplicates removed: "
                     f"{res.dedupe_report.get('duplicates_removed', 0)}")
        for cls, counts in res.split_counts.items():
            per = ", ".join(f"{s}: {n}" for s, n in counts.items())
            lines.append(f"  {cls}: {per}")
        lines.append(f"  Copy errors: {res.errors}")
        lines.append("")
    lines.append("Splits: 70/15/15 by unique SHA256 hash (leakage-safe)")
    path = Path(output_dir) / "dataset_summary.txt"
    path.write_text("\n".join(lines) + "\n")
    return path


def organize_clean_dataset(rgb_source: Path, thermal_source: Path,
                           output_dir: Path, seed: int = RANDOM_SEED,
                           fresh: bool = True,
                           verbose: bool = True) -> Dict[str, ModalityResult]:
    """Full pipeline (reference main(), :493-537)."""
    output_dir = Path(output_dir)
    if fresh and output_dir.exists():
        if verbose:
            print(f"Removing existing output directory: {output_dir}")
        shutil.rmtree(output_dir, ignore_errors=True)
    output_dir.mkdir(parents=True, exist_ok=True)

    if verbose:
        print("\nPROCESSING RGB DATASET (DEDUPED & NUMERIC NAMES)")
    rgb = organize_modality(collect_rgb_candidates(rgb_source),
                            output_dir / "rgb", seed, verbose)
    (output_dir / "rgb_dedupe_report.json").write_text(
        json.dumps(rgb.dedupe_report, indent=2))

    if verbose:
        print("\nPROCESSING THERMAL DATASET")
    thermal = organize_modality(collect_thermal_candidates(thermal_source),
                                output_dir / "thermal", seed, verbose)
    (output_dir / "thermal_dedupe_report.json").write_text(
        json.dumps(thermal.dedupe_report, indent=2))

    write_manifest(output_dir, rgb, thermal)
    write_summary(output_dir, rgb, thermal)
    if verbose:
        print(f"\nDATASET ORGANIZATION COMPLETE: {output_dir}")
    return {"rgb": rgb, "thermal": thermal}
