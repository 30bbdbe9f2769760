"""Grad-CAM through the models' tap points (counterpart of
``dfu_multimodal_tpu/eval/gradcam.py``).

One forward and one backward for a whole batch: the model records its
tap activations in the ``taps`` record (``models/common.py``), the score
is the sum over samples of each one's class logit, and
``torch.autograd.grad`` gives d score / d tap and d score / d input
together.  Samples are independent, so each gradient slice is that
sample's own.

- CAM = ReLU(Σ_c w_c · A_c) with w the spatial mean of the gradient,
  divided by its max (reference grad_cam_visualization.py:415-428);
- ``class_index=0`` backprops the class-0 logit whatever the prediction
  (the reference's quirk, :385-387); ``"pred"`` takes each sample's
  argmax;
- a tap that is not 4-D (the ViT's ``blocks``) falls back to input
  saliency |∂score/∂x| averaged over channels (:401-413);
- the overlay is the JET colormap blended at alpha 0.5 (:432-462).

Explanations run with the model's parameters frozen (:func:`frozen`):
autograd then computes no weight gradient (the fused blocks' chain rules
skip their weight products, ``ops/vit_block.py``), no parameter gets a
``.grad``, and the flags are restored afterwards, so the trainer trains
on unchanged.  The forward runs outside inference mode: the eval step's
``torch.inference_mode`` tensors cannot enter a graph.

The overlay helpers are numpy statements of the three OpenCV calls the
JAX package makes (``cv2.resize`` INTER_LINEAR on float32,
``cv2.applyColorMap(COLORMAP_JET)`` then BGR->RGB, ``cv2.addWeighted``);
the port imports no OpenCV.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn


@contextlib.contextmanager
def frozen(module: nn.Module) -> Iterator[nn.Module]:
    """Within the context every parameter of ``module`` has
    ``requires_grad`` False and the module is in eval mode; both are
    restored on exit."""
    params = list(module.parameters())
    flags = [p.requires_grad for p in params]
    training = module.training
    for p in params:
        p.requires_grad_(False)
    module.eval()
    try:
        yield module
    finally:
        for p, flag in zip(params, flags):
            p.requires_grad_(flag)
        module.train(training)


def branch_module(module: nn.Module, branch: str) -> nn.Module:
    """The named branch trunk, for CAMing it in isolation (JAX's
    ``branch_variables``: the reference wraps ``model.resnet`` /
    ``model.vit`` directly, grad_cam_visualization.py:575-580).  In the
    port the submodule carries its own weights."""
    try:
        return getattr(module, branch)
    except AttributeError:
        raise ValueError(f"{type(module).__name__} has no branch "
                         f"{branch!r}") from None


def _class_score(logits: torch.Tensor, class_index: Any) -> torch.Tensor:
    """Σ over samples of each one's class logit (``"pred"``: its argmax,
    taken without gradient)."""
    if class_index == "pred":
        idx = logits.detach().argmax(dim=-1)
    else:
        idx = torch.full((logits.shape[0],), int(class_index),
                         dtype=torch.long, device=logits.device)
    return logits.gather(1, idx[:, None]).sum()


def _leaves(inputs: Sequence[torch.Tensor], input_index: int
            ) -> List[torch.Tensor]:
    """Fresh graph leaves of the inputs (a copy: an input made under
    inference mode cannot enter a graph), the one at ``input_index``
    requiring its gradient."""
    return [x.detach().clone().requires_grad_(i == input_index)
            for i, x in enumerate(inputs)]


def cam_grads(module: nn.Module, inputs: Sequence[torch.Tensor],
              tap_name: str, class_index: Any = 0, input_index: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """One forward and backward for the whole batch: (probs, activation,
    d score / d tap, d score / d inputs[input_index]), detached.  Raises
    ``ValueError`` naming the model's taps when ``tap_name`` is not one."""
    with frozen(module), torch.enable_grad():
        xs = _leaves(inputs, input_index)
        taps: Dict[str, torch.Tensor] = {}
        logits = module(*xs, taps=taps).float()
        if tap_name not in taps:
            raise ValueError(f"unknown tap {tap_name!r}: this model sows "
                             f"{sorted(taps)}")
        act = taps[tap_name]
        tap_grad, input_grad = torch.autograd.grad(
            _class_score(logits, class_index), [act, xs[input_index]])
    probs = torch.softmax(logits.detach(), dim=-1)
    return probs, act.detach(), tap_grad, input_grad


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def compute_cam_batch(module: nn.Module, inputs: Sequence[torch.Tensor],
                      tap_name: str, class_index: Any = 0,
                      input_index: int = 0) -> List[Dict]:
    """Grad-CAM for a batch (``inputs``: the model's normalised NHWC
    inputs).  Returns per-sample dicts with 'cam' in [0, 1], 'probs',
    'pred', 'confidence', 'used_saliency'."""
    ci = class_index if class_index == "pred" else int(class_index)
    probs, act, tap_grad, input_grad = cam_grads(module, inputs, tap_name,
                                                 ci, input_index)
    probs, act, tap_grad = _numpy(probs), _numpy(act), _numpy(tap_grad)
    used_saliency = act.ndim != 4
    if used_saliency:
        cams = np.abs(_numpy(input_grad)).mean(axis=-1)       # (B, H, W)
    else:
        weights = tap_grad.mean(axis=(1, 2))                  # (B, C)
        cams = np.maximum(np.einsum("bc,bhwc->bhw", weights, act), 0.0)
    out = []
    for i in range(probs.shape[0]):
        cam = cams[i]
        if cam.max() > 0:
            cam = cam / cam.max()
        pred = int(probs[i].argmax())
        out.append({"cam": cam.astype(np.float32), "probs": probs[i],
                    "pred": pred, "confidence": float(probs[i][pred]),
                    "used_saliency": used_saliency})
    return out


def compute_cam(module: nn.Module, inputs: Sequence[torch.Tensor],
                tap_name: str, class_index: Any = 0,
                input_index: int = 0) -> Dict:
    """Grad-CAM for one sample (batch size 1)."""
    return compute_cam_batch(module, inputs, tap_name, class_index,
                             input_index)[0]


def saliency_batch(module: nn.Module, inputs: Sequence[torch.Tensor],
                   class_index: Any) -> Tuple[np.ndarray, List[np.ndarray]]:
    """(probs (B, K), [|d score / d x| averaged over channels, (B, H, W),
    one per input]) — the explanation of a model with no usable tap (JAX
    ``serve/explain.py::saliency_grads_fn``)."""
    with frozen(module), torch.enable_grad():
        xs = [x.detach().clone().requires_grad_(True) for x in inputs]
        logits = module(*xs).float()
        grads = torch.autograd.grad(_class_score(logits, class_index), xs)
    probs = _numpy(torch.softmax(logits.detach(), dim=-1))
    return probs, [np.abs(_numpy(g)).mean(axis=-1) for g in grads]


# ------------------------------------------------------------ overlay


def _jet_table() -> np.ndarray:
    """OpenCV's ``COLORMAP_JET`` as a (256, 3) RGB uint8 table: ramps of
    4 levels a step between flat runs (the blue ramp down ends on 1)."""
    i = np.arange(256)
    table = np.zeros((256, 3), np.int64)
    # (channel, first, end, value(i)) — every entry not listed is 0
    for ch, lo, hi, f in (
            (0, 96, 160, lambda k: 2 + 4 * (k - 96)),
            (0, 160, 224, lambda k: 255),
            (0, 224, 256, lambda k: 252 - 4 * (k - 224)),
            (1, 33, 96, lambda k: 4 * (k - 32)),
            (1, 96, 160, lambda k: 255),
            (1, 160, 223, lambda k: 252 - 4 * (k - 160)),
            (2, 0, 32, lambda k: 128 + 4 * k),
            (2, 32, 96, lambda k: 255),
            (2, 96, 159, lambda k: 254 - 4 * (k - 96)),
            (2, 159, 160, lambda k: 1)):
        table[lo:hi, ch] = f(i[lo:hi])
    return table.astype(np.uint8)


JET_RGB = _jet_table()


def _linear_taps(n_in: int, n_out: int):
    """OpenCV's INTER_LINEAR source taps along one axis: half-pixel
    centres, the fraction in float32, clamped to the edge pixels."""
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    edge = (s < 0) | (s >= n_in - 1)
    f[edge] = 0.0
    s = np.clip(s, 0, n_in - 1)
    return s, np.minimum(s + 1, n_in - 1), np.float32(1.0) - f, f


def resize_linear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(img, (width, height))`` of a 2-D float32 array
    (INTER_LINEAR): rows first, then columns, in float32."""
    img = np.asarray(img, np.float32)
    ys, ys1, b0, b1 = _linear_taps(img.shape[0], height)
    xs, xs1, a0, a1 = _linear_taps(img.shape[1], width)
    rows = img[:, xs] * a0 + img[:, xs1] * a1
    return rows[ys] * b0[:, None] + rows[ys1] * b1[:, None]


def add_weighted(a: np.ndarray, alpha: float, b: np.ndarray, beta: float,
                 gamma: float = 0.0) -> np.ndarray:
    """``cv2.addWeighted`` on uint8 images: fma(a, α, fma(b, β, γ)) in
    float32 (each fma rounded once), rounded half to even, saturated."""
    al, be, ga = (np.float64(np.float32(v)) for v in (alpha, beta, gamma))
    inner = (b.astype(np.float64) * be + ga).astype(np.float32)
    out = (a.astype(np.float64) * al + inner).astype(np.float32)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def overlay_cam(image_u8: np.ndarray, cam: np.ndarray,
                alpha: float = 0.5) -> Tuple[np.ndarray, np.ndarray]:
    """(overlay, heatmap): the JET-coloured CAM resized to the image and
    blended onto it, the JAX package's cv2 pipeline."""
    h, w = image_u8.shape[:2]
    cam_u8 = (np.clip(resize_linear(cam, w, h), 0, 1) * 255).astype(np.uint8)
    heatmap = JET_RGB[cam_u8]
    return add_weighted(image_u8, 1 - alpha, heatmap, alpha), heatmap
