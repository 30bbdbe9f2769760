"""Freeze a trained checkpoint into a serving bundle (the port's
counterpart of ``dfu_multimodal_tpu/cli/export_model.py``).

The bundle holds one ``torch.export`` program per serving batch bucket
plus the weights once (``serve/export.py``), so the serving daemon
replays it with no model source and no model construction at start-up:

    python -m dfu_multimodal_tpu_torch.cli.export_model \
        --checkpoint logs/checkpoints_multimodal --out export/multimodal \
        [--int8 --calib-images <dir>] [--token-merge 4:128
        [--tome-prop-attn]] [--resnet-block-impl fused] [--max-batch 64]
        [--verify]

    # then, on the serving host (same device type)
    python -m dfu_multimodal_tpu_torch.cli.serve --exported export/multimodal

The checkpoint is restored as the serve CLI restores it
(``cli/serve.py::restore_trainer``: a port ``.pt`` or a JAX ``.msgpack``
checkpoint, int8 and token merging applied as asked) on ``--device``
(default ``cuda``, the card; ``cpu`` exports on the host).  The bundle is
for ``--platforms`` (default: that device's type) and loads on no other.
``--verify`` reloads the written bundle and checks it against the live
checkpoint forward row for row on its smallest bucket: predictions
equal, probabilities within 1e-5 (1e-2 with ``--int8``).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    from dfu_multimodal_tpu_torch.cli.serve import add_resnet_block_impl

    parser = argparse.ArgumentParser(
        description="Export a checkpoint to a torch.export serving bundle")
    parser.add_argument("--checkpoint", type=Path, required=True)
    parser.add_argument("--out", type=Path, required=True,
                        help="bundle output directory")
    parser.add_argument("--model", default=None,
                        help="zoo name; default: checkpoint metadata")
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--max-batch", type=int, default=64,
                        help="top of the power-of-two bucket ladder")
    parser.add_argument("--buckets", default=None,
                        help="comma-separated explicit bucket list "
                             "(overrides --max-batch ladder)")
    parser.add_argument("--platforms", default=None,
                        help="comma-separated device types the bundle is "
                             "for ('cuda', 'cpu' or 'cuda,cpu'); default: "
                             "--device's")
    parser.add_argument("--compute-dtype", default="bfloat16",
                        choices=["bfloat16", "float32"])
    parser.add_argument("--attention-impl", default="auto",
                        choices=["auto", "xla", "pallas"])
    add_resnet_block_impl(parser)
    parser.add_argument("--int8", action="store_true",
                        help="freeze the int8 serving path (the int8 ViT "
                             "blocks, the calibrated int8 ResNet trunk)")
    parser.add_argument("--calib-images", type=Path, default=None,
                        help="REQUIRED with --int8 for models with a "
                             "ResNet trunk (static activation-scale "
                             "calibration)")
    parser.add_argument("--token-merge", default=None, metavar="L:K",
                        help="freeze the token-merged ViT serving path "
                             "(L full-token blocks, merge to K tokens; "
                             "see serve --token-merge; composes with "
                             "--int8)")
    parser.add_argument("--tome-prop-attn", action="store_true",
                        help="with --token-merge: freeze ToMe's "
                             "proportional attention (log-size key bias)")
    parser.add_argument("--verify", action="store_true",
                        help="reload the bundle and check prob/pred "
                             "parity against the live checkpoint forward")
    parser.add_argument("--device", default="cuda",
                        help="torch device to restore and trace on "
                             "(default cuda, the card); 'cpu' exports on "
                             "the host")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    from dfu_multimodal_tpu_torch import config as cfg_mod
    from dfu_multimodal_tpu_torch.cli._train_common import resolve_device
    from dfu_multimodal_tpu_torch.cli.serve import restore_trainer
    from dfu_multimodal_tpu_torch.config import TrainConfig
    from dfu_multimodal_tpu_torch.eval.deployment import (DEPLOYMENT_NAME,
                                                          load_deployment)
    from dfu_multimodal_tpu_torch.eval.drift import BASELINE_FILENAME
    from dfu_multimodal_tpu_torch.serve.export import (export_bundle,
                                                       load_bundle)

    device = resolve_device(args.device)
    cfg = TrainConfig(batch_size=args.max_batch,
                      eval_batch_size=args.max_batch,
                      compute_dtype=args.compute_dtype)
    modalities = {"rgb": cfg_mod.rgb_modality(),
                  "thermal": cfg_mod.thermal_modality()}
    name, trainer, _ = restore_trainer(args.checkpoint, args.model, args,
                                       cfg, modalities, device)
    buckets = ([int(b) for b in args.buckets.split(",")]
               if args.buckets else None)
    platforms = args.platforms.split(",") if args.platforms else None

    meta = export_bundle(
        trainer, args.out, image_size=args.image_size,
        max_batch=args.max_batch, buckets=buckets, platforms=platforms,
        extra_meta={"int8": bool(args.int8),
                    "token_merge": args.token_merge,
                    "tome_prop_attn": bool(args.tome_prop_attn),
                    "checkpoint": str(args.checkpoint)})
    for bucket, seconds in meta["export_seconds"].items():
        print(f"exported bucket {bucket} in {seconds:.2f} s")
    # the checkpoint's val-tuned deployment config (threshold /
    # temperature, extended_metrics --save-deployment) and its drift
    # baseline go into the bundle: serve --exported loads them from there
    dep = load_deployment(args.checkpoint)
    if dep:
        (args.out / DEPLOYMENT_NAME).write_text(
            (Path(args.checkpoint) / DEPLOYMENT_NAME).read_text())
        print(f"deployment config copied into bundle "
              f"(threshold={dep.get('threshold')}, "
              f"temperature={dep.get('temperature')})")
    drift_src = Path(args.checkpoint) / BASELINE_FILENAME
    if drift_src.exists():
        (args.out / BASELINE_FILENAME).write_text(drift_src.read_text())
        print("drift baseline copied into bundle")

    total = sum(p.stat().st_size for p in args.out.iterdir())
    print(f"exported {name} -> {args.out}  buckets={meta['buckets']}  "
          f"platforms={meta['platforms']}  ({total / 1e6:.1f} MB)")

    if args.verify:
        servable = load_bundle(args.out, device)
        b = servable.buckets[0]
        s = args.image_size
        rng = np.random.default_rng(0)
        batch = {m: rng.integers(0, 255, (b, s, s, 3)).astype(np.uint8)
                 for m in trainer.spec.inputs}
        batch["label"] = np.zeros(b, np.int64)
        batch["valid"] = np.ones(b, np.float32)
        live = trainer.eval_step(batch)
        frozen = servable.eval_step(batch)
        dp = float(np.max(np.abs(
            live["probs"].double().cpu().numpy()
            - frozen["probs"].double().cpu().numpy())))
        same = bool(np.array_equal(live["preds"].cpu().numpy(),
                                   frozen["preds"].cpu().numpy()))
        # the JAX package's budgets: predictions equal on every path;
        # probabilities within 1e-5, or 1e-2 on the int8 path
        tol = 1e-2 if args.int8 else 1e-5
        print(f"verify: max |prob delta| {dp:.2e} (tol {tol:.0e}), "
              f"preds equal: {same}")
        if not same or dp > tol:
            raise SystemExit("bundle verification FAILED")
    return meta


if __name__ == "__main__":
    main()
