"""Time the ViT kernels of two checkouts on one card, in turns.

    python -m dfu_multimodal_tpu_torch.tools.ab_kernels PARENT_DIR

Runs ``chip_smoke.py``'s forward and backward kernel phases (3 and 3b:
K1-K5 against their plain versions, CUDA events) from PARENT_DIR, from
this checkout twice, then from PARENT_DIR again — parent, change,
change, parent — each in a process of its own, which builds its
checkout's kernels into that checkout's ``build/``.  Prints the card's
name and power limit, then each kernel line prefixed by its turn.  Two
versions are compared only within one run: two runs may land on two
cards.  Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
PHASES = ("import torch, chip_smoke as cs; dev = torch.device('cuda', 0); "
          "cs.phase_kernels(dev); cs.phase_backward_kernels(dev)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path,
                    help="root of the other checkout (e.g. a git archive "
                         "of the parent commit)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    parent = args.parent.resolve()
    for turn, (tag, tree) in enumerate((("parent", parent), ("change", ROOT),
                                        ("change", ROOT), ("parent", parent)),
                                       start=1):
        proc = subprocess.run([sys.executable, "-c", PHASES], cwd=tree,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        for line in proc.stdout.splitlines():
            if line.startswith("[kernel]"):
                print(f"[turn {turn} {tag}] {line}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
