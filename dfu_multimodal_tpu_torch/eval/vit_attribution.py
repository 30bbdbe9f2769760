"""Transformer attribution for the ViT thermal branch: attention rollout
and Chefer relevance (counterpart of
``dfu_multimodal_tpu/eval/vit_attribution.py``).

- **attention rollout** (Abnar & Zuidema 2020): head-averaged attention,
  mixed with the residual identity and row-normalised, multiplied through
  the depth; the CLS row of the product scores each patch.
  Class-agnostic.
- **Chefer relevance** (Chefer et al. 2021, the self-attention rule): per
  block R += mean_heads(ReLU(dlogit_c/dA ⊙ A)) @ R from R = I;
  class-specific through the attention gradients.

The fused blocks never hold the (T, T) attention matrix, so the trunk
runs here again as a plain fp32 forward (:func:`trunk_tokens`, PyTorch
ops: JAX computes it with XLA, outside any Pallas kernel) that keeps each
block's attention probabilities.  dA comes from ``torch.autograd.grad``
with respect to those probability tensors: they feed only their block's
A·V product, so this is the JAX ``eps`` trick's gradient (a zero added
to A) without the zeros.

Class specificity through a fusion model: the outer model (head, or the
fusion MLP with the rgb branch) gives d logit_c / d tokens at the trunk's
``blocks`` tap (``eval/gradcam.py::cam_grads``), and the trunk's score is
<tokens, that gradient>: by the chain rule its dA is d logit_c / dA
through the whole model.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from dfu_multimodal_tpu_torch.eval import gradcam

VIT_TRUNK_SCOPES = {
    # model name -> attribute of the ViT trunk whose attention we unroll
    "thermal_only": "vit",
    "multimodal": "thermal_branch",
}


def supports_transformer_attribution(model_name: str) -> bool:
    """True when ``--cam-method rollout/chefer`` applies to this model (it
    has a ViT trunk).  The one capability rule every surface uses: the
    Explainer raises on other models, the CLIs downgrade with a notice."""
    return model_name in VIT_TRUNK_SCOPES


DOWNGRADE_NOTE = ("applies to ViT branches only; this model's branches "
                  "keep their default methods (true Grad-CAM for tapped "
                  "trunks, input saliency otherwise)")

LN_EPS = 1e-6


def trunk_params(trunk: nn.Module) -> Dict:
    """The ViT trunk's weights as detached fp32 tensors for
    :func:`trunk_tokens` (JAX's ``stacked_trunk_params``; the port keeps
    one entry a block rather than a stacked tree): ``patch`` ((p·p·3,
    hidden) kernel, bias, p), ``cls``, ``pos``, ``blocks`` and
    ``num_heads``.  The int8 blocks hold no fp32 weights: attribution runs
    on the full-fidelity trunk, never on a serving rebuild."""
    def f32(t):
        return t.detach().float()

    blocks = []
    for blk in trunk.blocks:
        if not isinstance(getattr(blk.attn, "qkv", None), nn.Linear):
            raise ValueError(
                f"{type(blk).__name__} holds no fp32 weights; run "
                "attribution on the full-fidelity trunk, not the int8 "
                "serving rebuild")
        blocks.append({name: (f32(lin.weight).t(), f32(lin.bias))
                       for name, lin in (("qkv", blk.attn.qkv),
                                         ("proj", blk.attn.proj),
                                         ("fc1", blk.mlp.fc1),
                                         ("fc2", blk.mlp.fc2))}
                      | {"norm1": (f32(blk.norm1.weight),
                                   f32(blk.norm1.bias)),
                         "norm2": (f32(blk.norm2.weight),
                                   f32(blk.norm2.bias))})
    conv = trunk.patch_embed.proj
    hidden, cin, p, _ = conv.weight.shape
    first = trunk.blocks[0]
    heads = getattr(first, "num_heads", None) or first.attn.num_heads
    return {"patch": (f32(conv.weight).permute(2, 3, 1, 0).reshape(
                p * p * cin, hidden), f32(conv.bias), p),
            "cls": f32(trunk.cls_token), "pos": f32(trunk.pos_embed),
            "blocks": blocks, "num_heads": int(heads)}


def _layernorm(x: torch.Tensor, scale_bias) -> torch.Tensor:
    scale, bias = scale_bias
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + LN_EPS) * scale + bias


def _dense(x: torch.Tensor, wb) -> torch.Tensor:
    return x @ wb[0] + wb[1]


def trunk_tokens(params: Dict, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """fp32 trunk forward to the ``blocks`` tap (before the final norm),
    mirroring the flax ``ViT`` / ``EncoderBlock`` with plain attention.
    x (B, S, S, 3) normalised NHWC.  Returns (tokens (B, T, C), the
    attention probabilities of each block, (B, H, T, T))."""
    kernel, bias, p = params["patch"]
    heads = params["num_heads"]
    b, h, w, c = x.shape
    gh, gw = h // p, w // p
    x = x.float().reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, gh * gw, p * p * c) @ kernel + bias
    x = torch.cat([params["cls"].expand(b, 1, -1), x], dim=1) + params["pos"]
    attn = []
    for blk in params["blocks"]:
        n, ch = x.shape[1], x.shape[2]
        hd = ch // heads
        qkv = _dense(_layernorm(x, blk["norm1"]), blk["qkv"])
        q, k, v = qkv.reshape(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
        probs = torch.softmax((q * hd ** -0.5) @ k.transpose(-1, -2), dim=-1)
        out = (probs @ v).transpose(1, 2).reshape(b, n, ch)
        x = x + _dense(out, blk["proj"])
        y = torch.nn.functional.gelu(_dense(_layernorm(x, blk["norm2"]),
                                            blk["fc1"]))
        x = x + _dense(y, blk["fc2"])
        attn.append(probs)
    return x, attn


def _grid(cam_flat: torch.Tensor) -> torch.Tensor:
    g = int(round((cam_flat.shape[1]) ** 0.5))
    return cam_flat.reshape(cam_flat.shape[0], g, g)


def attention_rollout(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """(B, S, S, 3) normalised input -> (B, g, g) rollout CAM (raw).
    Â = norm(0.5·mean_h(A) + 0.5·I), R = Â_L ··· Â_1, CAM = R[CLS,
    patches]."""
    with torch.no_grad():
        _, attn = trunk_tokens(params, x)
        t = attn[0].shape[-1]
        eye = torch.eye(t, device=x.device)
        r = eye.expand(x.shape[0], t, t)
        for a in attn:
            a = 0.5 * a.mean(dim=1) + 0.5 * eye
            r = (a / a.sum(dim=-1, keepdim=True)) @ r
    return _grid(r[:, 0, 1:])


def chefer_relevance(params: Dict, x: torch.Tensor,
                     tap_grad: torch.Tensor) -> torch.Tensor:
    """(B, S, S, 3) input and d logit_c / d tokens at the ``blocks`` tap ->
    (B, g, g) Chefer relevance CAM (raw).  Per block, with A the attention
    probabilities and G = d logit_c / dA: R += mean_h(ReLU(G ⊙ A)) @ R
    from R = I."""
    with torch.enable_grad():
        # the input a leaf, so each block's probabilities are in the graph
        leaf = x.detach().float().clone().requires_grad_(True)
        tokens, attn = trunk_tokens(params, leaf)
        score = (tokens * tap_grad.detach().float()).sum()
        grads = torch.autograd.grad(score, attn)
    t = attn[0].shape[-1]
    r = torch.eye(t, device=x.device).expand(x.shape[0], t, t)
    for g, a in zip(grads, attn):
        r = r + torch.relu(g * a.detach()).mean(dim=1) @ r
    return _grid(r[:, 0, 1:])


def _normalize_batch(cams: np.ndarray) -> np.ndarray:
    out = []
    for cam in np.asarray(cams, np.float32):
        cam = np.maximum(cam, 0.0)
        if cam.max() > 0:
            cam = cam / cam.max()
        out.append(cam)
    return np.stack(out)


def compute_vit_cam_batch(module: nn.Module, inputs: Sequence[torch.Tensor],
                          trunk_scope: str, method: str,
                          class_index="pred", input_index: int = 0,
                          num_heads: Optional[int] = None) -> List[Dict]:
    """ViT attribution through the whole model, one batch.  The return
    contract of ``eval/gradcam.py::compute_cam_batch``: per-sample dicts
    with 'cam' in [0, 1] on the (g, g) patch grid, 'probs', 'pred',
    'confidence', 'used_saliency' = False, and 'method'."""
    params = trunk_params(getattr(module, trunk_scope))
    if num_heads is not None:
        params["num_heads"] = int(num_heads)
    x = inputs[input_index]
    if method == "rollout":
        # class-agnostic: the plain forward's probabilities are all the
        # outer model gives
        with gradcam.frozen(module), torch.no_grad():
            logits = module(*inputs).float()
        probs = torch.softmax(logits, dim=-1)
        cams = attention_rollout(params, x)
    elif method == "chefer":
        ci = class_index if class_index == "pred" else int(class_index)
        probs, _, tap_grad, _ = gradcam.cam_grads(module, inputs, "blocks",
                                                  ci, input_index)
        cams = chefer_relevance(params, x, tap_grad)
    else:
        raise ValueError(f"unknown ViT attribution method {method!r} "
                         "(expected 'rollout' or 'chefer')")
    cams = _normalize_batch(cams.detach().cpu().numpy())
    probs = probs.float().cpu().numpy()
    out = []
    for i in range(probs.shape[0]):
        pred = int(probs[i].argmax())
        out.append({"cam": cams[i].astype(np.float32), "probs": probs[i],
                    "pred": pred, "confidence": float(probs[i][pred]),
                    "used_saliency": False, "method": method})
    return out
