"""Convert a reference torch checkpoint into the port's checkpoint
(counterpart of ``dfu_multimodal_tpu/cli/convert_checkpoint.py``).

Takes a ``best_model.pt`` written by the reference trainers (a
``torch.save`` dict with ``model_state_dict``, reference
notebooks/train_rgb_only.py:310-316, ``backbone.*`` prefix quirk
included) and writes the port's ``best_model.pt`` and meta, which every
eval CLI of the port loads.  The key map is the JAX package's
``tools/convert_torch.py`` (``convert_resnet50``, ``convert_vit_b16``,
``convert_state_dict``), applied straight onto the port's keys, which
are torchvision's and timm's: the reference prefixes (``backbone.``,
``resnet.``, ``vit.``, ``module.``, ``rgb_branch.``, ``thermal_branch.``)
are stripped and the port's trunk prefix put back; the reference heads
(``fc.1`` / ``fc`` of the ResNet, ``head.1`` / ``head`` of the ViT, a
Sequential(Dropout, Linear)) map to ``head``; the fusion head's
``fusion.{0,3,6}`` keep their keys.  A head key of another shape (a
1000-class head) keeps the fresh initialisation, which is drawn on
``--device`` (default ``cuda``) from seed 0, and is listed.  Any other
key left at its fresh initialisation (a wrong ``--model``, a file with
prefixes the map does not know) is an error, and nothing is written::

    python -m dfu_multimodal_tpu_torch.cli.convert_checkpoint \\
        --model rgb_only --torch-checkpoint best_model.pt --output <dir>
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, Mapping, Sequence

import torch

PREFIXES = ("backbone.", "resnet.", "vit.", "module.", "rgb_branch.",
            "thermal_branch.")
RESNET_KEYS = ("conv1", "bn1", "layer")
VIT_KEYS = ("cls_token", "pos_embed", "patch_embed", "blocks", "norm.")
UNIMODAL = {"rgb_only": ("resnet.", RESNET_KEYS, ("fc.1", "fc")),
            "thermal_only": ("vit.", VIT_KEYS, ("head.1", "head"))}
# the port's keys of each model's classifier head, which may stay fresh
HEAD_KEYS = {"rgb_only": ("head.",), "thermal_only": ("head.",),
             "multimodal": ("fusion.",)}


def strip_prefix(key: str) -> str:
    """Every leading reference prefix removed, repeatedly."""
    changed = True
    while changed:
        changed = False
        for p in PREFIXES:
            if key.startswith(p):
                key, changed = key[len(p):], True
    return key


def _trunk(state_dict: Mapping[str, torch.Tensor], prefix: str,
           keys: Sequence[str]) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in state_dict.items():
        s = strip_prefix(k)
        if s.startswith(keys):
            out[prefix + s] = v.reshape(1, 1, -1) if s == "cls_token" else v
    return out


def reference_state_dict(model_name: str,
                         state_dict: Mapping[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """The reference model's torch state_dict -> the port model's keys
    (``rgb_only``, ``thermal_only``, ``multimodal``)."""
    if model_name in UNIMODAL:
        prefix, keys, heads = UNIMODAL[model_name]
        out = _trunk(state_dict, prefix, keys)
        stripped = {strip_prefix(k): v for k, v in state_dict.items()}
        for base in heads:
            if f"{base}.weight" in stripped:
                out["head.weight"] = stripped[f"{base}.weight"]
                if f"{base}.bias" in stripped:
                    out["head.bias"] = stripped[f"{base}.bias"]
                break
        return out
    if model_name != "multimodal":
        raise ValueError(f"no converter for model {model_name!r}")
    rgb = {k: v for k, v in state_dict.items()
           if strip_prefix(k).startswith(RESNET_KEYS)
           or k.startswith(("rgb_branch.", "resnet."))}
    vit = {k: v for k, v in state_dict.items()
           if k.startswith(("thermal_branch.", "vit."))
           or strip_prefix(k).startswith(VIT_KEYS)}
    out = _trunk(rgb, "rgb_branch.", RESNET_KEYS)
    out.update(_trunk(vit, "thermal_branch.", VIT_KEYS))
    out.update({k: v for k, v in state_dict.items()
                if k.startswith("fusion.")})
    return out


def main(argv=None):
    from dfu_multimodal_tpu_torch.cli._train_common import resolve_device
    from dfu_multimodal_tpu_torch.models import zoo
    from dfu_multimodal_tpu_torch.utils import checkpoint as ckpt_mod

    parser = argparse.ArgumentParser(
        description="Convert torch checkpoint -> framework checkpoint")
    parser.add_argument("--model", required=True,
                        choices=["rgb_only", "thermal_only", "multimodal"])
    parser.add_argument("--torch-checkpoint", type=Path, required=True)
    parser.add_argument("--output", type=Path, required=True,
                        help="checkpoint directory to write")
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--device", default="cuda",
                        help="device of the fresh initialisation (default: "
                             "the card; 'cpu' asks for the host)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    module, _ = zoo.build(args.model, image_size=args.image_size)
    module.to(device)
    zoo.init_model(module, torch.Generator(device=device).manual_seed(0))
    # the reference's files are whole pickles (history, numpy scalars)
    ckpt = torch.load(args.torch_checkpoint, map_location="cpu",
                      weights_only=False)
    state = ckpt.get("model_state_dict", ckpt)
    target = module.state_dict()
    merged, loaded, skipped = ckpt_mod.load_flexible(
        target, reference_state_dict(args.model, state), verbose=False)
    fresh = [k for k in target if merged[k] is target[k]
             and not k.endswith("num_batches_tracked")]
    heads = [k for k in fresh if k.startswith(HEAD_KEYS[args.model])]
    trunk = [k for k in fresh if k not in heads]
    if trunk:
        raise SystemExit(
            f"{args.torch_checkpoint}: {len(trunk)} {args.model} arrays "
            f"have no counterpart in the file and would stay random: "
            f"{trunk[:8]}{' ...' if len(trunk) > 8 else ''}")
    print(f"Converted {loaded} arrays; {skipped} skipped"
          + (f"; the head left at its fresh initialisation: {heads}"
             if heads else ""))
    history = {k: [float(x) for x in v]
               for k, v in dict(ckpt.get("history", {})).items()}
    ckpt_mod.save_checkpoint(
        args.output, epoch=int(ckpt.get("epoch", 0)), model_state=merged,
        opt_state={}, val_f1=float(ckpt.get("val_f1", 0.0)),
        history=history,
        extra_meta={"model": args.model,
                    "converted_from": str(args.torch_checkpoint)})
    print(f"Wrote {args.output}/best_model.pt")
    return 0


if __name__ == "__main__":
    main()
