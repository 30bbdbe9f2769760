"""Kaggle dataset downloader (counterpart of the JAX package's
``cli/download_datasets.py``; the reference's
``scripts/download_datasets.sh``): fetch the two source datasets with the
``kaggle`` CLI when it is on ``PATH``, otherwise print the setup steps.

    python -m dfu_multimodal_tpu_torch.cli.download_datasets --out .
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
from pathlib import Path

DATASETS = (
    ("laithjj/diabetic-foot-ulcer-dfu", "DFU_RGB"),
    ("vuppalaadithyasairam/thermography-images-of-diabetic-foot",
     "DFU_Thermal"),
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Download DFU datasets")
    parser.add_argument("--out", type=Path, default=Path("."))
    args = parser.parse_args(argv)

    if shutil.which("kaggle") is None:
        print("kaggle CLI not found. Install it (pip install kaggle) and "
              "place API credentials in ~/.kaggle/kaggle.json, then re-run.")
        print("Datasets to fetch:")
        for slug, dest in DATASETS:
            print(f"  {slug} -> {args.out / dest}")
        return 1

    failures = 0
    for slug, dest in DATASETS:
        target = args.out / dest
        print(f"Downloading {slug} -> {target}")
        result = subprocess.run(
            ["kaggle", "datasets", "download", "-d", slug,
             "-p", str(target), "--unzip"])
        if result.returncode != 0:
            print(f"  failed to download {slug} — check the slug, "
                  f"credentials and network")
            failures += 1
    print("Downloads attempted. Verify DFU_RGB/ and DFU_Thermal/.")
    return failures


if __name__ == "__main__":
    raise SystemExit(main())
