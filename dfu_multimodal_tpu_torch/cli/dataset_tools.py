"""Grab-bag dataset tooling CLI: verify / analyze / standardize /
patient-split / prepare (legacy split) / prepare-raw / stats (the port's
counterpart of ``dfu_multimodal_tpu/cli/dataset_tools.py``).

Counterparts of reference scripts/verify_structure.py,
analyze_image_sizes.py, standardize_images.py, patient_level_split.py,
prepare_datasets.py and the dataloader's ``print_dataset_statistics``
(scripts/dataloader.py:292-315).  Sizes and modes come from the file
headers and ``standardize`` decodes and writes with the port's own
decoder and writers (``tools/standardize.py``).

    python -m dfu_multimodal_tpu_torch.cli.dataset_tools verify --rgb-source ...
    python -m dfu_multimodal_tpu_torch.cli.dataset_tools analyze --root ...
    python -m dfu_multimodal_tpu_torch.cli.dataset_tools standardize --src ... --dst ...
    python -m dfu_multimodal_tpu_torch.cli.dataset_tools patient-split --src ... --out ...
    python -m dfu_multimodal_tpu_torch.cli.dataset_tools stats --data-dir ...
"""

from __future__ import annotations

import argparse
from pathlib import Path

from dfu_multimodal_tpu_torch.data.layout import (
    CLASSES, list_images, print_dataset_statistics)
from dfu_multimodal_tpu_torch.tools import analyze as analyze_mod
from dfu_multimodal_tpu_torch.tools import splits as splits_mod
from dfu_multimodal_tpu_torch.tools import standardize as std_mod
from dfu_multimodal_tpu_torch.tools import verify as verify_mod


def main(argv=None):
    parser = argparse.ArgumentParser(description="Dataset tooling")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("verify", help="verify raw/organized dataset layout")
    p.add_argument("--rgb-source", type=Path)
    p.add_argument("--thermal-source", type=Path)
    p.add_argument("--organized", type=Path)

    p = sub.add_parser("analyze", help="image size/aspect/mode statistics")
    p.add_argument("--root", type=Path, required=True)
    p.add_argument("--max-images", type=int, default=None)

    p = sub.add_parser("standardize",
                       help="resize-longest-edge + pad to square")
    p.add_argument("--src", type=Path, required=True)
    p.add_argument("--dst", type=Path, required=True)
    p.add_argument("--target", type=int, default=224)
    p.add_argument("--verify", action="store_true")

    p = sub.add_parser("patient-split",
                       help="pseudo-patient grouped 70/15/15 split")
    p.add_argument("--src", type=Path, required=True,
                   help="class-dir root: <src>/{healthy,ulcer}/*")
    p.add_argument("--out", type=Path, required=True)
    p.add_argument("--group-size", type=int, default=5)
    p.add_argument("--seed", type=int, default=42)

    p = sub.add_parser("prepare",
                       help="legacy random 70/15/15 split (per class dir)")
    p.add_argument("--src", type=Path, required=True)
    p.add_argument("--out", type=Path, required=True)
    p.add_argument("--seed", type=int, default=42)

    p = sub.add_parser("prepare-raw",
                       help="legacy raw-source pipeline: random split + "
                            "thermal test carved from train + dataset_info")
    p.add_argument("--rgb-source", type=Path, required=True)
    p.add_argument("--thermal-source", type=Path, required=True)
    p.add_argument("--out", type=Path, required=True)
    p.add_argument("--seed", type=int, default=42)

    p = sub.add_parser("stats", help="organized dataset statistics")
    p.add_argument("--data-dir", type=Path, required=True)

    args = parser.parse_args(argv)

    if args.command == "verify":
        return verify_mod.verify_structure(
            args.rgb_source, args.thermal_source, args.organized)
    if args.command == "analyze":
        return analyze_mod.analyze_image_sizes(args.root, args.max_images)
    if args.command == "standardize":
        result = std_mod.standardize_tree(args.src, args.dst, args.target)
        if args.verify:
            result.update(std_mod.verify_standardization(args.dst,
                                                         args.target))
        return result
    if args.command in ("patient-split", "prepare"):
        items = []
        for cls, _ in CLASSES:
            items.extend((p, cls) for p in list_images(args.src / cls))
        if args.command == "patient-split":
            groups = splits_mod.group_items(items, args.group_size)
            train, val, test = splits_mod.patient_level_split(
                groups, seed=args.seed)
        else:
            train, val, test = splits_mod.random_split_70_15_15(
                items, seed=args.seed)
        split_items = {"train": train, "val": val, "test": test}
        counts = splits_mod.materialize_split(split_items, args.out)
        leaks = splits_mod.leakage_check_groups(split_items,
                                               getattr(args, "group_size", 5))
        print(f"Split counts: {counts}")
        if args.command == "patient-split":
            print(f"Cross-split pseudo-patient groups: {leaks} "
                  f"({'OK' if leaks == 0 else 'LEAKAGE'})")
        return counts
    if args.command == "prepare-raw":
        from dfu_multimodal_tpu_torch.tools.prepare_legacy import (
            prepare_datasets)
        return prepare_datasets(args.rgb_source, args.thermal_source,
                                args.out, seed=args.seed)
    if args.command == "stats":
        print_dataset_statistics(args.data_dir)
        return None


if __name__ == "__main__":
    main()
