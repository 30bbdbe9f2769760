"""Grad-CAM visualization over all three checkpoints (the port's
counterpart of ``dfu_multimodal_tpu/cli/grad_cam_visualization.py``).

Counterpart of reference notebooks/grad_cam_visualization.py: for each
model pick 5 healthy + 5 ulcer test samples (:688-691), draw the 1x3
(original | heatmap | overlay) figure per sample — 2x3 for multimodal
with an RGB and a thermal row (:599-632) — and save it as
``<out>/grad_cam_visualizations/<model>/{healthy,ulcer}_NN.png``.  The
model runs in fp32 with batch 1 in its config, on ``--device`` (default
``cuda``; ``cpu`` asks for the host); the selected samples CAM in one
forward and backward a tap.

The figures are drawn on ``eval/plots.py``'s numpy canvas at the JAX
figures' nominal sizes (figsize x 150 dpi: 2250 x 750, multimodal 2700 x
1500) with its titles and method labels; matplotlib's pictures are not
reproduced (no matplotlib on any host of the port).

    python -m dfu_multimodal_tpu_torch.cli.grad_cam_visualization --data-dir <root>
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from dfu_multimodal_tpu_torch import config as cfg_mod
from dfu_multimodal_tpu_torch.cli._train_common import (VIT_MODELS,
                                                        resolve_device)
from dfu_multimodal_tpu_torch.config import TrainConfig
from dfu_multimodal_tpu_torch.data.loader import (ArrayDataset, load_paired,
                                                  load_single_modality)
from dfu_multimodal_tpu_torch.eval import gradcam
from dfu_multimodal_tpu_torch.eval import vit_attribution as va
from dfu_multimodal_tpu_torch.eval.plots import BLACK, Canvas
from dfu_multimodal_tpu_torch.serve.explain import (BRANCH_TAPS,
                                                    normalize_inputs)
from dfu_multimodal_tpu_torch.train.engine import Trainer
from dfu_multimodal_tpu_torch.utils import checkpoint as ckpt_mod

MODELS = (
    ("checkpoints_rgb_only", "rgb_only", "rgb_only", "RGB-Only"),
    ("checkpoints_thermal_only", "thermal_only", "thermal_only",
     "Thermal-Only"),
    ("checkpoints_multimodal", "multimodal", "multimodal", "Multimodal"),
)
DPI = 150
SINGLE_SIZE = (15 * DPI, 5 * DPI)
MULTI_SIZE = (18 * DPI, 10 * DPI)


def _primary_tap(spec) -> str:
    """The primary input's branch tap from the one registry
    (``serve/explain.py::BRANCH_TAPS``); ``stage4`` for unlisted models,
    the reference default."""
    taps = BRANCH_TAPS.get(spec.name)
    if taps:
        return taps.get(spec.inputs[0], "stage4")
    return "stage4"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Grad-CAM visualization")
    cfg_mod.add_common_args(parser)
    parser.add_argument("--output-dir", type=Path, default=None)
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--attention-impl", default="auto",
                        choices=["auto", "xla", "pallas"])
    parser.add_argument("--num-per-class", type=int, default=5)
    parser.add_argument("--cam-class", default="0",
                        help="'0' (reference quirk: class-0 logit), '1', "
                             "or 'pred'")
    parser.add_argument("--cam-method", default="saliency",
                        choices=["saliency", "rollout", "chefer"],
                        help="ViT-branch attribution: 'saliency' (default, "
                             "reference-parity input gradients), 'rollout' "
                             "(attention rollout), or 'chefer' (relevance "
                             "propagation) — eval/vit_attribution.py; "
                             "ResNet branches always use true Grad-CAM")
    parser.add_argument("--multimodal-cam", default="fused",
                        choices=["fused", "strict"],
                        help="multimodal branch CAM semantics: 'fused' "
                             "(default, d fused-logit/d branch) or 'strict' "
                             "(reference parity: each trunk CAMed in "
                             "isolation against its own first feature unit, "
                             "grad_cam_visualization.py:575-580)")
    parser.add_argument("--models", nargs="*", default=None)
    parser.add_argument("--model-overrides", nargs="*", default=[],
                        metavar="NAME=ZOO")
    return parser


def _select_samples(labels: np.ndarray, per_class: int) -> List[int]:
    """First ``per_class`` indices of each class in dataset order (the
    reference walks the loader in order, :715-726)."""
    chosen, counts = [], {0: 0, 1: 0}
    for i, lbl in enumerate(labels):
        lbl = int(lbl)
        if counts[lbl] < per_class:
            chosen.append(i)
            counts[lbl] += 1
        if all(c >= per_class for c in counts.values()):
            break
    return chosen


def _method_label(method) -> str:
    """Figure label of an attribution method: the reference titles
    everything (its ViT saliency fallback too) "Grad-CAM"; the transformer
    methods are named for what they are."""
    return {"rollout": "Attention Rollout",
            "chefer": "Chefer Relevance"}.get(method, "Grad-CAM")


def _panel(cv: Canvas, img: np.ndarray, cx: float, top: int, side: int,
           titles: List[str]) -> None:
    """``img`` scaled (nearest) into a ``side``-pixel square centred at
    column ``cx`` below ``top``, its title lines above it."""
    h, w = img.shape[:2]
    rows = np.minimum(np.arange(side) * h // side, h - 1)
    cols = np.minimum(np.arange(side) * w // side, w - 1)
    x0 = int(round(cx - side / 2))
    cv.px[top:top + side, x0:x0 + side] = img[rows][:, cols]
    y = top - 16
    for line in reversed(titles):
        _, th = cv.text(line, cx, y, 4, va="bottom")
        y -= th + 10


def _suptitle(cv: Canvas, lines: List[str]) -> int:
    """Bold centred title lines from the top; returns the row below."""
    y = 24
    for line in lines:
        _, th = cv.text(line, cv.px.shape[1] / 2, y, 5, BLACK, va="top",
                        bold=True)
        y += th + 14
    return y


def figure_single(img_u8, cam_out, modality_title: str,
                  model_title: str) -> Canvas:
    """1 x 3: the original, the heatmap and the overlay with the
    prediction (``_figure_single`` of the JAX CLI)."""
    overlay, heatmap = gradcam.overlay_cam(img_u8, cam_out["cam"])
    label = _method_label(cam_out.get("method"))
    pred_txt = "Ulcer" if cam_out["pred"] == 1 else "Healthy"
    cv = Canvas(SINGLE_SIZE)
    top = _suptitle(cv, [f"{model_title} Model {label}"]) + 90
    side = min(SINGLE_SIZE[0] // 3 - 60, SINGLE_SIZE[1] - top - 20)
    col = SINGLE_SIZE[0] / 3
    for k, (img, titles) in enumerate((
            (img_u8, [f"Original {modality_title} Image"]),
            (heatmap, [f"{label} Heatmap"]),
            (overlay, ["Overlay", f"Pred: {pred_txt} "
                                  f"({cam_out['confidence']:.3f})"]))):
        _panel(cv, img, col * (k + 0.5), top, side, titles)
    return cv


def figure_multimodal(rgb_u8, thermal_u8, rgb_cam, thermal_cam, pred: int,
                      confidence: float, rgb_method=None,
                      thermal_method=None) -> Canvas:
    """2 x 3: an RGB and a thermal row of image, heatmap and overlay
    (``_figure_multimodal`` of the JAX CLI)."""
    labels = (_method_label(rgb_method), _method_label(thermal_method))
    pred_txt = "Ulcer" if pred == 1 else "Healthy"
    head = ("Grad-CAM" if labels[0] == labels[1] == "Grad-CAM"
            else f"{labels[0]} (RGB) / {labels[1]} (Thermal)")
    cv = Canvas(MULTI_SIZE)
    top = _suptitle(cv, [f"Multimodal Fusion {head}",
                         f"Prediction: {pred_txt} "
                         f"(Confidence: {confidence:.3f})"]) + 60
    row_h = (MULTI_SIZE[1] - top) // 2
    side = min(MULTI_SIZE[0] // 3 - 80, row_h - 60)
    col = MULTI_SIZE[0] / 3
    for row, (img, cam, name) in enumerate(
            ((rgb_u8, rgb_cam, "RGB"), (thermal_u8, thermal_cam,
                                        "Thermal"))):
        overlay, heat = gradcam.overlay_cam(img, cam)
        y = top + row * row_h
        for k, (panel, title) in enumerate((
                (img, f"{name} Image"), (heat, f"{name} {labels[row]}"),
                (overlay, f"{name} Overlay"))):
            _panel(cv, panel, col * (k + 0.5), y, side, [title])
    return cv


def _vit_branch_cam(trainer, inputs, cam_class, input_index: int,
                    method: str):
    """ViT-branch attribution (rollout / Chefer) through
    ``eval/vit_attribution.py`` for the models with a ViT trunk."""
    return va.compute_vit_cam_batch(
        trainer.module, inputs, va.VIT_TRUNK_SCOPES[trainer.spec.name],
        method, class_index=cam_class, input_index=input_index)


def multimodal_cams(trainer, inputs, cam_class, mm_cam: str = "fused",
                    cam_method: str = "saliency"):
    """(rgb outs, thermal outs) of a multimodal batch.  ``strict``: each
    trunk CAMed alone with score = its feature 0 (the reference wraps
    ``model.resnet`` / ``model.vit`` and backprops ``output[0, 0]``,
    :385-387, :575-580), the prediction and confidence from the fused
    model (:567-572)."""
    module = trainer.module
    if mm_cam == "strict":
        rgb_outs = gradcam.compute_cam_batch(
            gradcam.branch_module(module, "rgb_branch"), (inputs[0],),
            "stage4", class_index=0)
        th_outs = gradcam.compute_cam_batch(
            gradcam.branch_module(module, "thermal_branch"), (inputs[1],),
            "blocks", class_index=0)
        with gradcam.frozen(module), torch.no_grad():
            probs = torch.softmax(module(*inputs).float(), dim=-1)
        probs = probs.cpu().numpy()
        for k in range(probs.shape[0]):
            pred = int(probs[k].argmax())
            for outs in (rgb_outs, th_outs):
                outs[k]["pred"] = pred
                outs[k]["confidence"] = float(probs[k][pred])
        return rgb_outs, th_outs
    rgb_outs = gradcam.compute_cam_batch(module, inputs, "stage4", cam_class,
                                         input_index=0)
    if cam_method != "saliency":
        th_outs = _vit_branch_cam(trainer, inputs, cam_class, 1, cam_method)
    else:
        th_outs = gradcam.compute_cam_batch(module, inputs, "blocks",
                                            cam_class, input_index=1)
    return rgb_outs, th_outs


def visualize_model(trainer: Trainer, dataset: ArrayDataset, out_dir: Path,
                    display: str, cam_class, per_class: int,
                    mm_cam: str = "fused",
                    cam_method: str = "saliency") -> int:
    spec = trainer.spec
    out_dir.mkdir(parents=True, exist_ok=True)
    selected = _select_samples(dataset.labels, per_class)
    if not selected:
        return 0
    sel = np.asarray(selected)
    raw = {m: dataset.arrays[m][sel] for m in spec.inputs}
    inputs = normalize_inputs(trainer, raw)
    multimodal = spec.name == "multimodal"
    if multimodal:
        rgb_outs, th_outs = multimodal_cams(trainer, inputs, cam_class,
                                            mm_cam, cam_method)
    elif cam_method != "saliency" and spec.name == "thermal_only":
        cam_outs = _vit_branch_cam(trainer, inputs, cam_class, 0, cam_method)
    else:
        cam_outs = gradcam.compute_cam_batch(trainer.module, inputs,
                                             _primary_tap(spec), cam_class,
                                             input_index=0)
    counts = {0: 0, 1: 0}
    for k, idx in enumerate(selected):
        label = int(dataset.labels[idx])
        if multimodal:
            fig = figure_multimodal(
                raw["rgb"][k], raw["thermal"][k], rgb_outs[k]["cam"],
                th_outs[k]["cam"], rgb_outs[k]["pred"],
                rgb_outs[k]["confidence"],
                rgb_method=rgb_outs[k].get("method"),
                thermal_method=th_outs[k].get("method"))
        else:
            fig = figure_single(raw[spec.inputs[0]][k], cam_outs[k],
                                spec.inputs[0].upper(), display)
        cls_name = "healthy" if label == 0 else "ulcer"
        path = fig.save(out_dir / f"{cls_name}_{counts[label]:02d}.png")
        counts[label] += 1
        print(f"  Saved {path.name}")
    return len(selected)


def main(argv=None) -> Dict[str, int]:
    args = build_parser().parse_args(argv)
    data_cfg = cfg_mod.data_config_from_args(args)
    device = resolve_device(args.device)
    out_root = args.output_dir or (Path(data_cfg.checkpoint_root)
                                   / "grad_cam_visualizations")
    overrides = dict(kv.split("=", 1) for kv in args.model_overrides)
    selected = set(args.models) if args.models else None
    cam_class = args.cam_class if args.cam_class == "pred" else int(
        args.cam_class)
    if args.multimodal_cam == "strict" and args.cam_method != "saliency":
        raise SystemExit(
            "--multimodal-cam strict reproduces the reference's "
            "isolated-trunk saliency semantics and cannot combine with "
            f"--cam-method {args.cam_method}")
    size = args.image_size

    print("=" * 70)
    print("GRAD-CAM VISUALIZATION")
    print("=" * 70)
    print(f"Will visualize {args.num_per_class} healthy + "
          f"{args.num_per_class} ulcer samples per model\n")

    # lazy per-model loading: with --models a subset, the other splits
    # are never decoded (and need not exist on disk)
    loaders = {
        "rgb_only": lambda: load_single_modality(
            data_cfg.data_dir / "rgb", "test", size, "rgb"),
        "thermal_only": lambda: load_single_modality(
            data_cfg.data_dir / "thermal", "test", size, "thermal"),
        "multimodal": lambda: load_paired(data_cfg.data_dir, "test", size,
                                          strategy="pseudo",
                                          seed=args.seed),
    }

    results: Dict[str, int] = {}
    for ckpt_name, subdir, zoo_default, display in MODELS:
        if selected is not None and subdir not in selected:
            continue
        ckpt_dir = Path(data_cfg.checkpoint_root) / ckpt_name
        print(f"\nVISUALIZING {display.upper()} MODEL")
        if not ckpt_mod.best_checkpoint_exists(ckpt_dir):
            print(f"  Checkpoint not found: {ckpt_dir}")
            continue
        zoo_name = overrides.get(
            subdir, ckpt_mod.load_meta(ckpt_dir).get("model") or zoo_default)
        if (args.cam_method != "saliency"
                and not va.supports_transformer_attribution(zoo_name)):
            print(f"  --cam-method {args.cam_method} {va.DOWNGRADE_NOTE}")
        kwargs = ({"attention_impl": args.attention_impl}
                  if zoo_name in VIT_MODELS else {})
        trainer = Trainer(zoo_name, TrainConfig(batch_size=1,
                                                compute_dtype="float32"),
                          {"rgb": cfg_mod.rgb_modality(),
                           "thermal": cfg_mod.thermal_modality()},
                          device=device, image_size=size, **kwargs)
        print(f"Loading: {ckpt_dir}")
        trainer.restore(ckpt_dir)
        n = visualize_model(trainer, loaders[subdir](), out_root / subdir,
                            display, cam_class, args.num_per_class,
                            mm_cam=args.multimodal_cam,
                            cam_method=args.cam_method)
        print(f"Saved {n} {display} visualizations to {out_root / subdir}")
        results[subdir] = n
    return results


if __name__ == "__main__":
    main()
