"""Device availability check (counterpart of the JAX package's
``cli/check_tpu.py``; the reference's ``scripts/check_gpu.py``): torch and
CUDA versions, each card with its name and power limit, this process's
rank and world size, and a tiny product on the device.

    python -m dfu_multimodal_tpu_torch.cli.check_gpu [--device cpu]
    torchrun --nproc-per-node 2 -m dfu_multimodal_tpu_torch.cli.check_gpu

Without a CUDA device it says so and exits 1, unless ``--device cpu``
asks for the host.
"""

from __future__ import annotations

import argparse
import subprocess

import torch


def power_limits() -> list:
    """``nvidia-smi``'s name and power limit of each card (empty when the
    tool is missing)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [line.strip() for line in out.splitlines() if line.strip()]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="device check")
    p.add_argument("--device", default="cuda",
                   help="cuda (default, the card) or cpu (the host)")
    args = p.parse_args(argv)
    print(f"torch version: {torch.__version__}")
    print(f"CUDA version: {torch.version.cuda}")
    if torch.device(args.device).type == "cuda" and (
            not torch.cuda.is_available()):
        print("No CUDA device is available (pass --device cpu to check "
              "the host).")
        return 1
    from dfu_multimodal_tpu_torch.parallel import mesh as mesh_mod

    device = mesh_mod.init_from_env(args.device)
    if device.type == "cuda":
        limits = power_limits()
        print(f"Devices ({torch.cuda.device_count()}):")
        for i in range(torch.cuda.device_count()):
            limit = limits[i] if i < len(limits) else "power limit unknown"
            print(f"  cuda:{i} {torch.cuda.get_device_name(i)} ({limit})")
    else:
        print("Device: cpu")
    rank, world = mesh_mod.world()
    print(f"Process {rank} of {world} (device {device})")
    x = torch.ones(128, 128, device=device)
    total = float((x @ x).sum())
    print(f"Compute smoke: OK (sum={total:.1f})")
    if world > 1:                      # every rank reached its product
        mesh_mod.barrier()
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
