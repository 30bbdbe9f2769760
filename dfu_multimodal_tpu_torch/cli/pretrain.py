"""Self-supervised trunk pretraining entry point (counterpart of
``dfu_multimodal_tpu/cli/pretrain.py``).

Where the reference's torchvision / timm pretrained weights cannot be
downloaded, this manufactures an initialisation from the unlabelled
training images (SimCLR for either trunk, MAE for the ViT —
``train/ssl.py``) as a checkpoint every train CLI takes via
``--init-from``::

    python -m dfu_multimodal_tpu_torch.cli.pretrain --modality thermal \\
        --method simclr --data-dir data --out logs/pretrain_thermal
    python -m dfu_multimodal_tpu_torch.cli.train_thermal_only --data-dir data \\
        --init-from logs/pretrain_thermal --lr-schedule cosine

Only the train split is used (with ``--include-val`` the val split's
images too; test never).  Labels are ignored.  It runs on ``--device``
(default ``cuda``; ``cpu`` asks for the host).  The JAX flags, with
``--mesh-data`` beyond one device refused (the port trains on one).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np

from dfu_multimodal_tpu_torch import config as cfg_mod
from dfu_multimodal_tpu_torch.cli._train_common import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Self-supervised trunk pretraining (SimCLR / MAE)")
    p.add_argument("--data-dir", type=Path, required=True,
                   help="root containing rgb/ and thermal/ split dirs")
    p.add_argument("--out", type=Path, required=True,
                   help="checkpoint directory to write (then pass as "
                        "--init-from to any train CLI)")
    p.add_argument("--modality", choices=["rgb", "thermal"], default="rgb")
    p.add_argument("--method", choices=["simclr", "mae"], default="simclr")
    p.add_argument("--trunk", choices=["resnet", "vit", "tiny"],
                   default=None,
                   help="trunk family (default: the modality's reference "
                        "trunk — resnet for rgb, vit for thermal; 'tiny' "
                        "is a seconds-scale smoke trunk)")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--warmup-epochs", type=float, default=5.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--compute-dtype", choices=["bfloat16", "float32"],
                   default="bfloat16")
    p.add_argument("--temperature", type=float, default=0.2,
                   help="SimCLR NT-Xent temperature")
    p.add_argument("--simclr-no-color-jitter", action="store_true",
                   help="drop color jitter from the SimCLR views so the "
                        "features stay color-SENSITIVE — recommended when "
                        "the class signal is chromatic (e.g. ulcer "
                        "redness)")
    p.add_argument("--mask-ratio", type=float, default=0.75,
                   help="MAE masked-patch fraction")
    p.add_argument("--save-every", type=int, default=0,
                   help="also checkpoint every N epochs (0 = end only)")
    p.add_argument("--resume", action="store_true",
                   help="continue from the checkpoint already in --out")
    p.add_argument("--include-val", action="store_true",
                   help="also pretrain on the val split's images "
                        "(labels unused; test is never touched)")
    p.add_argument("--cache-dir", type=Path, default=None,
                   help="persistent decode cache directory")
    p.add_argument("--mesh-data", type=int, default=-1,
                   help="DP axis size (-1 or 1: this one device; the port "
                        "refuses more)")
    p.add_argument("--block-impl", default="auto",
                   help="ViT block impl (auto/flax/fused): 'auto' is the "
                        "fused kernels (SimCLR); MAE refuses fused impls")
    p.add_argument("--attention-impl", default="auto",
                   help="attention impl (auto/xla/pallas)")
    # small-ViT overrides (tests / small-image experiments)
    p.add_argument("--vit-patch", type=int, default=16)
    p.add_argument("--vit-hidden", type=int, default=768)
    p.add_argument("--vit-depth", type=int, default=12)
    p.add_argument("--vit-heads", type=int, default=12)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: the card; "
                        "'cpu' asks for the host)")
    return p


def main(argv=None) -> int:
    from dfu_multimodal_tpu_torch.data.loader import (ArrayDataset,
                                                      load_single_modality)
    from dfu_multimodal_tpu_torch.train.ssl import PretrainConfig, SSLTrainer

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    trunk = args.trunk or {"rgb": "resnet", "thermal": "vit"}[args.modality]
    cfg = PretrainConfig(
        method=args.method, batch_size=args.batch_size,
        num_epochs=args.epochs, learning_rate=args.lr,
        weight_decay=args.weight_decay, warmup_epochs=args.warmup_epochs,
        seed=args.seed, compute_dtype=args.compute_dtype,
        temperature=args.temperature, mask_ratio=args.mask_ratio,
        simclr_color_jitter=not args.simclr_no_color_jitter,
        save_every=args.save_every,
        vit_patch=args.vit_patch, vit_hidden=args.vit_hidden,
        vit_depth=args.vit_depth, vit_heads=args.vit_heads,
        mesh=cfg_mod.MeshConfig(data=args.mesh_data))

    modality = (cfg_mod.rgb_modality() if args.modality == "rgb"
                else cfg_mod.thermal_modality())
    splits = ("train", "val") if args.include_val else ("train",)
    parts = [load_single_modality(args.data_dir / args.modality, s,
                                  args.image_size, args.modality,
                                  cache_dir=args.cache_dir)
             for s in splits]
    dataset = parts[0] if len(parts) == 1 else ArrayDataset(
        arrays={args.modality: np.concatenate(
            [p.arrays[args.modality] for p in parts])},
        labels=np.concatenate([p.labels for p in parts]),
        paths={args.modality: sum((p.paths[args.modality] for p in parts),
                                  [])})

    print(f"Pretraining {trunk} trunk with {cfg.method} on "
          f"{len(dataset)} unlabeled {args.modality} images "
          f"({'+'.join(splits)} split{'s' if len(splits) > 1 else ''}) "
          f"on {device}")
    trainer = SSLTrainer(trunk, cfg, modality, image_size=args.image_size,
                         block_impl=args.block_impl,
                         attention_impl=args.attention_impl, device=device)
    trainer.fit(dataset, args.out, resume=args.resume)

    # reproducibility manifest, as the trainers' run_info.json
    info = {"argv": list(sys.argv[1:] if argv is None else argv),
            "trunk": trunk, "dataset_size": len(dataset),
            "device": str(device),
            "config": dataclasses.asdict(
                dataclasses.replace(cfg, mesh=None))}
    (Path(args.out) / "run_info.json").write_text(
        json.dumps(info, indent=2, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
