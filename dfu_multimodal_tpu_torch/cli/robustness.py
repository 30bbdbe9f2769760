"""Corruption-robustness sweep entry point (the port's counterpart of
``dfu_multimodal_tpu/cli/robustness.py``; `dfu robustness`).

Measure test F1 under parametric input corruptions (sensor noise,
defocus blur, exposure drift, contrast loss) at 5 severity levels, per
input modality (eval/robustness.py)::

    python -m dfu_multimodal_tpu_torch.cli.robustness \\
        --checkpoint logs/checkpoints_multimodal --data-dir data

Writes ``<checkpoint>/robustness_report.json`` and prints the
F1-vs-severity table with the reference's TTA verdict thresholds
(robust / moderate / fragile at 0.05 / 0.15 F1 drop).  Runs on
``--device`` (default ``cuda``; ``cpu`` asks for the host);
``--resnet-block-impl fused`` puts a ResNet-50 trunk's blocks on the fused
bottleneck kernel, as for serve and predict.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from dfu_multimodal_tpu_torch import config as cfg_mod
from dfu_multimodal_tpu_torch.cli._train_common import resolve_device
from dfu_multimodal_tpu_torch.cli.serve import (FUSED_TRUNK_MODELS,
                                                add_resnet_block_impl)
from dfu_multimodal_tpu_torch.data.loader import (load_paired,
                                                  load_single_modality)
from dfu_multimodal_tpu_torch.eval.robustness import CORRUPTIONS, sweep
from dfu_multimodal_tpu_torch.models import zoo
from dfu_multimodal_tpu_torch.serve.engine import RGB_IMPL_ARG
from dfu_multimodal_tpu_torch.train.engine import Trainer
from dfu_multimodal_tpu_torch.utils import checkpoint as ckpt_mod


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="F1 under parametric corruptions x severity levels")
    p.add_argument("--checkpoint", type=Path, required=True)
    p.add_argument("--model", default=None,
                   help="zoo name (default: checkpoint meta)")
    p.add_argument("--data-dir", type=Path, required=True)
    p.add_argument("--split", default="test", choices=["val", "test"])
    p.add_argument("--corruptions", nargs="+", default=list(CORRUPTIONS),
                   choices=list(CORRUPTIONS))
    p.add_argument("--severities", type=int, nargs="+",
                   default=[1, 2, 3, 4, 5])
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--compute-dtype", choices=["bfloat16", "float32"],
                   default="bfloat16")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--all-modalities-together", action="store_true",
                   help="for multimodal models, ALSO corrupt every input "
                        "at once (default sweeps each input separately)")
    add_resnet_block_impl(p)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda, the card); 'cpu' runs "
                        "on the host")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    bad = [s for s in args.severities if not 1 <= s <= 5]
    if bad:
        raise SystemExit(f"severities must be 1..5, got {bad}")
    device = resolve_device(args.device)
    model_name = args.model or ckpt_mod.load_meta(args.checkpoint).get(
        "model", "rgb_only")
    spec = zoo.get(model_name)

    modalities = {"rgb": cfg_mod.rgb_modality(),
                  "thermal": cfg_mod.thermal_modality()}
    if set(spec.inputs) == {"rgb", "thermal"}:
        ds = load_paired(args.data_dir, args.split, args.image_size,
                         strategy="pseudo", seed=42)
    else:
        (mod,) = spec.inputs
        ds = load_single_modality(args.data_dir / mod, args.split,
                                  args.image_size, mod)

    cfg = cfg_mod.TrainConfig(batch_size=args.batch_size,
                              eval_batch_size=args.batch_size,
                              compute_dtype=args.compute_dtype)
    kwargs = ({RGB_IMPL_ARG[model_name]: args.resnet_block_impl}
              if args.resnet_block_impl != "auto"
              and model_name in FUSED_TRUNK_MODELS else {})
    trainer = Trainer(model_name, cfg, modalities, device=device,
                      image_size=args.image_size, **kwargs)
    trainer.restore(args.checkpoint)

    subsets = [(m,) for m in spec.inputs]
    if args.all_modalities_together and len(spec.inputs) > 1:
        subsets.append(tuple(spec.inputs))

    print(f"Robustness sweep: {model_name} on {args.split} "
          f"({len(ds)} samples), severities {args.severities}")
    report = sweep(trainer, ds, args.corruptions, args.severities,
                   subsets, seed=args.seed)
    report["split"] = args.split
    out = args.checkpoint / "robustness_report.json"
    out.write_text(json.dumps(report, indent=2))
    print(f"report -> {out}")
    fragile = [r for r in report["results"] if r["verdict"] == "fragile"]
    if fragile:
        worst = min(fragile, key=lambda r: r["worst_f1"])
        print(f"WARNING: {len(fragile)} fragile corruption axes — worst: "
              f"{worst['corruption']} on {'+'.join(worst['modalities'])} "
              f"(F1 {worst['worst_f1']:.3f} vs clean "
              f"{report['clean_f1']:.3f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
