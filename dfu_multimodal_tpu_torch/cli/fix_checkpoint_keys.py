"""Offline checkpoint key migration (counterpart of
``dfu_multimodal_tpu/cli/fix_checkpoint_keys.py`` and of the reference's
notebooks/fix_checkpoint_keys.py:15-56): rewrite ``backbone.*`` keys to
``resnet.*`` / ``vit.*`` inside a torch ``best_model.pt``, in place
(``--dry-run`` only counts).  ``cli/convert_checkpoint.py`` strips such
prefixes itself; this tool is for reference checkpoints used with the
reference's own eval scripts.  No device: it only renames keys.

    python -m dfu_multimodal_tpu_torch.cli.fix_checkpoint_keys <ckpt.pt> --to resnet
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch


def fix_checkpoint_keys(path: Path, target_prefix: str = "resnet",
                        dry_run: bool = False) -> int:
    """Rename ``backbone.*`` -> ``<target_prefix>.*`` in the checkpoint's
    ``model_state_dict``; returns the number of keys renamed.  The file is
    rewritten only when something was renamed and not ``dry_run``.  The
    reference's checkpoints are whole pickles (history, numpy scalars),
    hence ``weights_only=False``: run it on files you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state = ckpt.get("model_state_dict")
    if state is None:
        print("No 'model_state_dict' in checkpoint; nothing to do.")
        return 0
    renamed = {}
    n = 0
    for key, value in state.items():
        if key.startswith("backbone."):
            renamed[f"{target_prefix}." + key[len("backbone."):]] = value
            n += 1
        else:
            renamed[key] = value
    print(f"Renamed {n} keys (backbone.* -> {target_prefix}.*)")
    if n and not dry_run:
        ckpt["model_state_dict"] = renamed
        torch.save(ckpt, path)
        print(f"Updated in place: {path}")
    return n


def main(argv=None):
    parser = argparse.ArgumentParser(description="Fix checkpoint key names")
    parser.add_argument("checkpoint", type=Path)
    parser.add_argument("--to", default="resnet", choices=["resnet", "vit"])
    parser.add_argument("--dry-run", action="store_true")
    args = parser.parse_args(argv)
    fix_checkpoint_keys(args.checkpoint, args.to, args.dry_run)
    return 0


if __name__ == "__main__":
    main()
