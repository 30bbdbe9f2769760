"""Clean dataset organizer CLI (the port's counterpart of
``dfu_multimodal_tpu/cli/organize_clean_dataset.py`` and of reference
scripts/organize_clean_dataset.py).  It only hashes and copies files, so
it needs no device.

    python -m dfu_multimodal_tpu_torch.cli.organize_clean_dataset \
        --rgb-source <DFU_RGB> --thermal-source <DFU_Thermal> --output <data>
"""

from __future__ import annotations

import argparse
from pathlib import Path

from dfu_multimodal_tpu_torch.tools.organize import (
    RANDOM_SEED, organize_clean_dataset)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Organize raw DFU datasets: dedup, split, anonymize")
    parser.add_argument("--rgb-source", type=Path, required=True)
    parser.add_argument("--thermal-source", type=Path, required=True)
    parser.add_argument("--output", type=Path, required=True)
    parser.add_argument("--seed", type=int, default=RANDOM_SEED)
    parser.add_argument("--keep-existing", action="store_true",
                        help="do not wipe the output directory first")
    args = parser.parse_args(argv)

    print("=" * 70)
    print("CLEAN DATASET ORGANIZATION FOR MULTIMODAL DFU PROJECT")
    print("=" * 70)
    return organize_clean_dataset(
        args.rgb_source, args.thermal_source, args.output, seed=args.seed,
        fresh=not args.keep_existing)


if __name__ == "__main__":
    main()
