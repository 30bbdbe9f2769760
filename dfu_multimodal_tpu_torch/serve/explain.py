"""Serving-time Grad-CAM: per-request visual explanations (counterpart of
``dfu_multimodal_tpu/serve/explain.py``).

A clinician reviewing a prediction asks why, and gets the evidence
heatmap for the exact image they submitted.

- The explainer is built from the full-fidelity trainer, never the int8
  serving rebuild: ``cli/serve.py --explain`` captures it before
  quantisation.
- Explanations run one at a time on the engine's batcher thread (the
  thread that owns the device, ``serve/engine.py``), batch 1, between
  predict batches, in the trainer's compute dtype.
- Tapped trunks (ResNet ``stage4``, the tiny models' ``features``) get
  true Grad-CAM through ``eval/gradcam.py``; the ViT's non-4-D
  ``blocks`` tap and untapped models fall back to input saliency, the
  offline CLI's semantics; ``cam_method`` ``rollout`` / ``chefer`` takes
  the ViT branch to ``eval/vit_attribution.py``.
- Each explanation freezes the parameters for its backward
  (``eval/gradcam.py::frozen``): no weight gradient is computed and no
  ``.grad`` is left behind.
"""

from __future__ import annotations

import io
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from dfu_multimodal_tpu_torch.data.png import write_png
from dfu_multimodal_tpu_torch.data.transforms import eval_normalize
from dfu_multimodal_tpu_torch.eval import gradcam
from dfu_multimodal_tpu_torch.eval.vit_attribution import (
    VIT_TRUNK_SCOPES, compute_vit_cam_batch)

# Per-model {modality: tap name}: the one registry of the offline CLI
# (cli/grad_cam_visualization.py), the daemon and the predict CLI, so
# online and offline explanations of a checkpoint cannot diverge.  Models
# not listed explain every modality by input saliency.  (The JAX dict,
# entries of models the port has not ported included.)
BRANCH_TAPS: Dict[str, Dict[str, str]] = {
    "rgb_only": {"rgb": "stage4"},
    "resnet18_rgb": {"rgb": "stage4"},
    "resnet18_thermal": {"thermal": "stage4"},
    "thermal_only": {"thermal": "blocks"},
    "multimodal": {"rgb": "stage4", "thermal": "blocks"},
    "efficientnet_rgb": {"rgb": "features"},
    "efficientnet_thermal": {"thermal": "features"},
    "tiny_rgb": {"rgb": "features"},
    "tiny_thermal": {"thermal": "features"},
}

CAM_METHODS = ("saliency", "rollout", "chefer")


def normalize_inputs(trainer, arrays: Dict[str, np.ndarray],
                     ) -> Tuple[torch.Tensor, ...]:
    """{modality: (B, S, S, 3) uint8} -> the model's inputs, normalised
    to fp32 on the trainer's device (the model casts them to its compute
    dtype, as the JAX explainer's ``eval_normalize(..., jnp.float32)``)."""
    return tuple(
        eval_normalize(torch.as_tensor(np.ascontiguousarray(arrays[m]))
                       .to(trainer.device), trainer.modalities[m],
                       torch.float32)
        for m in trainer.spec.inputs)


def explain_batch(trainer, inputs: Sequence[torch.Tensor],
                  provided: Sequence[str], class_index: Any,
                  cam_method: str = "saliency") -> Tuple[np.ndarray, Dict]:
    """CAMs of a normalised batch for the ``provided`` modalities: (probs
    (B, K), {modality: ((B, h, w) CAMs in [0, 1], method)}).  The rule
    the daemon and ``cli/predict.py --explain-dir`` share."""
    module, name = trainer.module, trainer.spec.name
    model_inputs = tuple(trainer.spec.inputs)
    taps = BRANCH_TAPS.get(name)
    cams: Dict[str, Tuple[np.ndarray, str]] = {}
    probs: Optional[np.ndarray] = None
    if taps is None:
        probs, sal = gradcam.saliency_batch(module, inputs, class_index)
        for i, m in enumerate(model_inputs):
            if m in provided:
                peak = sal[i].max(axis=(1, 2), keepdims=True)
                cams[m] = ((sal[i] / np.maximum(peak, 1e-12)).astype(
                    np.float32), "saliency")
        return probs, cams
    for m in provided:
        index = model_inputs.index(m)
        if cam_method != "saliency" and taps[m] == "blocks":
            outs = compute_vit_cam_batch(module, inputs, VIT_TRUNK_SCOPES[name],
                                         cam_method, class_index=class_index,
                                         input_index=index)
            method = cam_method
        else:
            outs = gradcam.compute_cam_batch(module, inputs, taps[m],
                                             class_index=class_index,
                                             input_index=index)
            method = "saliency" if outs[0]["used_saliency"] else "gradcam"
        cams[m] = (np.stack([o["cam"] for o in outs]), method)
        probs = np.stack([o["probs"] for o in outs]).astype(np.float32)
    return probs, cams


class Explainer:
    """Grad-CAM / saliency explanations for one served model, built once
    at daemon start-up from the full-fidelity trainer; :meth:`explain_one`
    runs on the engine's batcher thread.  ``class_index``: ``"pred"``
    (explain the decision returned) or a fixed class (``0`` is the
    offline CLI's reference quirk).  ``cam_method``: the ViT branch's
    attribution, ``"saliency"`` (the reference's), ``"rollout"`` or
    ``"chefer"``; ResNet branches always get Grad-CAM."""

    def __init__(self, trainer, class_index: Any = "pred",
                 cam_method: str = "saliency"):
        self.trainer = trainer
        self.model_name: str = trainer.spec.name
        self.inputs: Tuple[str, ...] = tuple(trainer.spec.inputs)
        if class_index != "pred":
            class_index = int(class_index)
        self.class_index = class_index
        if cam_method not in CAM_METHODS:
            raise ValueError(f"unknown cam_method {cam_method!r}")
        if (cam_method != "saliency"
                and self.model_name not in VIT_TRUNK_SCOPES):
            raise ValueError(
                f"--cam-method {cam_method} needs a ViT branch; model "
                f"{self.model_name!r} has none (use saliency)")
        self.cam_method = cam_method
        self.taps = BRANCH_TAPS.get(self.model_name)
        # every CAM this explainer can produce ignores the class (rollout
        # on a model whose only tapped branch is the ViT): the engine then
        # skips the borderline re-explain, whose map would be identical
        self.class_agnostic = (cam_method == "rollout"
                               and self.taps is not None
                               and all(t == "blocks"
                                       for t in self.taps.values()))

    def explain_one(self, sample_u8: Dict[str, np.ndarray],
                    class_override: Optional[int] = None) -> Dict:
        """One request -> {"probs": (K,) float32, "class_explained": int,
        "cams": {modality: {"cam": (h, w) float32 in [0, 1], "method":
        "gradcam" | "saliency" | "rollout" | "chefer"}}}.

        ``class_override`` explains that class instead (the engine's
        re-explain of a borderline request whose tuned decision differs
        from the argmax).  CAMs only for the modalities the request
        provided: a black fill-in is padding, not evidence."""
        class_key = (self.class_index if class_override is None
                     else int(class_override))
        shape = next(iter(sample_u8.values())).shape
        arrays = {m: (sample_u8[m] if m in sample_u8
                      else np.zeros(shape, np.uint8))[None]
                  for m in self.inputs}
        provided = [m for m in self.inputs if m in sample_u8]
        probs, cams = explain_batch(
            self.trainer, normalize_inputs(self.trainer, arrays), provided,
            class_key, self.cam_method)
        probs = probs[0].astype(np.float32)
        explained = (int(np.argmax(probs)) if class_key == "pred"
                     else int(class_key))
        return {"probs": probs, "class_explained": explained,
                "cams": {m: {"cam": c[0], "method": method}
                         for m, (c, method) in cams.items()}}

    def warmup(self, image_size: int,
               classes: Tuple[int, ...] = ()) -> None:
        """Run an explanation before traffic (the first call builds the
        kernels and the backward's library handles on this thread).
        ``classes`` also runs the fixed-class overrides the engine's
        borderline re-explain may ask for."""
        zero = {m: np.zeros((image_size, image_size, 3), np.uint8)
                for m in self.inputs}
        self.explain_one(zero)
        for c in classes:
            if c != self.class_index:
                self.explain_one(zero, class_override=int(c))


def encode_png(arr_u8: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes (the port's writer; no file)."""
    buf = io.BytesIO()
    write_png(buf, arr_u8)
    return buf.getvalue()


def render_overlay(image_u8: np.ndarray, cam: np.ndarray,
                   alpha: float = 0.5) -> bytes:
    """The JET-coloured CAM blended onto the submitted image (the offline
    CLI's overlay, ``eval/gradcam.py::overlay_cam``), as PNG bytes.  Runs
    on the HTTP request thread, never the batcher."""
    overlay, _ = gradcam.overlay_cam(np.ascontiguousarray(image_u8), cam,
                                     alpha=alpha)
    return encode_png(overlay)
