"""Device-side image transforms (counterpart of
``dfu_multimodal_tpu/data/transforms.py``).

- ``eval_normalize``: uint8 NHWC -> (x/255 - mean)/std in the compute dtype;
- ``augment_and_normalize``: the train transform.  Per sample, colour
  jitter (RGB), ONE geometric transform (h/v flip, rotation, random
  affine) composed into a single inverse 3x3 matrix and applied as one
  bilinear resample about the centre with zero fill, a Gaussian blur
  (thermal), then normalisation.

The batch is processed at once (JAX ``vmap``s one image); every random
draw comes from an explicit ``torch.Generator`` on the batch's device and
is handed to the op that uses it (``affine_warp`` takes the inverse
matrices, ``color_jitter`` the factors, ``gaussian_blur`` the sigmas), so
the tests inject the same draws into both packages: JAX PRNG streams
cannot be reproduced in torch.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from dfu_multimodal_tpu_torch.config import AugmentConfig, ModalityConfig


def normalize(images: torch.Tensor, mean: Sequence[float],
              std: Sequence[float],
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8/float [0, 255] NHWC -> (x/255 - mean)/std NHWC in ``dtype``,
    computed in fp32 on the images' device."""
    x = images.float() / 255.0
    m = torch.tensor(mean, dtype=torch.float32, device=images.device)
    s = torch.tensor(std, dtype=torch.float32, device=images.device)
    return ((x - m) / s).to(dtype)


def eval_normalize(images: torch.Tensor, modality: ModalityConfig,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Eval-time transform: normalize only (resize happened at load)."""
    return normalize(images, modality.mean, modality.std, dtype)


# ------------------------------------------------------------ geometry


def _uniform(gen: torch.Generator, n: int, lo: float, hi: float
             ) -> torch.Tensor:
    u = torch.rand(n, generator=gen, device=gen.device)
    return lo + (hi - lo) * u


def _bernoulli(gen: torch.Generator, n: int, p: float) -> torch.Tensor:
    return torch.rand(n, generator=gen, device=gen.device) < p


def _mat(rows) -> torch.Tensor:
    """(B,)-tensor entries -> (B, 3, 3)."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def sample_inverse_affine(gen: torch.Generator, cfg: AugmentConfig,
                          height: int, width: int,
                          batch: int) -> torch.Tensor:
    """Draw one random geometric transform per sample; return the INVERSE
    (B, 3, 3) fp32 matrices mapping centred output pixel coordinates to
    input coordinates (forward: flip -> rotate -> affine)."""
    deg = math.pi / 180.0
    hflip = _bernoulli(gen, batch, cfg.horizontal_flip_prob)
    vflip = _bernoulli(gen, batch, cfg.vertical_flip_prob)
    theta1 = _uniform(gen, batch, -cfg.rotation_degrees,
                      cfg.rotation_degrees) * deg
    apply = _bernoulli(gen, batch, cfg.aug_prob) & bool(cfg.affine)
    zero = torch.zeros(batch, device=gen.device)
    one = torch.ones(batch, device=gen.device)
    theta2 = torch.where(apply, _uniform(gen, batch, -cfg.affine_degrees,
                                         cfg.affine_degrees) * deg, zero)
    tx = torch.where(apply, _uniform(gen, batch, -cfg.affine_translate,
                                     cfg.affine_translate) * width, zero)
    ty = torch.where(apply, _uniform(gen, batch, -cfg.affine_translate,
                                     cfg.affine_translate) * height, zero)
    lo, hi = cfg.affine_scale
    scale = torch.where(apply, _uniform(gen, batch, lo, hi), one)

    def rot(t):
        c, s = torch.cos(t), torch.sin(t)
        return _mat([[c, -s, zero], [s, c, zero], [zero, zero, one]])

    inv_flip = _mat([[torch.where(hflip, -one, one), zero, zero],
                     [zero, torch.where(vflip, -one, one), zero],
                     [zero, zero, one]])
    inv_scale = _mat([[1.0 / scale, zero, zero], [zero, 1.0 / scale, zero],
                      [zero, zero, one]])
    inv_translate = _mat([[one, zero, -tx], [zero, one, -ty],
                          [zero, zero, one]])
    return inv_flip @ rot(-theta1) @ (inv_scale @ rot(-theta2)
                                      @ inv_translate)


def affine_warp(images: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """Bilinear warp of (B, H, W, C) float images about their centres by
    the inverse matrices ``inv`` (B, 3, 3).  A corner tap outside the
    image contributes 0 (torchvision's default fill), exactly as the JAX
    gather warp's per-corner validity masks do."""
    b, h, w, c = images.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    dt = images.dtype
    dev = images.device
    yy = (torch.arange(h, device=dev, dtype=torch.float32) - cy)[:, None]
    xx = (torch.arange(w, device=dev, dtype=torch.float32) - cx)[None, :]
    m = inv.float()[:, :2, :, None, None]                 # (B, 2, 3, 1, 1)
    src_x = m[:, 0, 0] * xx + m[:, 0, 1] * yy + m[:, 0, 2] + cx  # (B, H, W)
    src_y = m[:, 1, 0] * xx + m[:, 1, 1] * yy + m[:, 1, 2] + cy
    x0, y0 = torch.floor(src_x), torch.floor(src_y)
    wx = (src_x - x0)[..., None].to(dt)
    wy = (src_y - y0)[..., None].to(dt)
    flat = images.reshape(b, h * w, c)

    def corner(dy: int, dx: int) -> torch.Tensor:
        yi, xi = y0 + dy, x0 + dx
        valid = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
        px = torch.gather(flat, 1, idx.reshape(b, h * w, 1).expand(-1, -1, c))
        return px.reshape(b, h, w, c) * valid[..., None].to(dt)

    top = corner(0, 0) * (1 - wx) + corner(0, 1) * wx
    bot = corner(1, 0) * (1 - wx) + corner(1, 1) * wx
    return top * (1 - wy) + bot * wy


# ---------------------------------------------------------- photometric


def color_jitter(images: torch.Tensor, brightness: torch.Tensor,
                 contrast: torch.Tensor,
                 saturation: torch.Tensor) -> torch.Tensor:
    """Brightness/contrast/saturation jitter of [0, 255] float NHWC images
    by per-sample factors (B,) (1.0 = unchanged).  Saturation blends
    against the grayscale of the post-contrast image, as torchvision."""
    def luma(im):
        return (0.299 * im[..., 0] + 0.587 * im[..., 1]
                + 0.114 * im[..., 2])

    def per(f):
        return f.to(images.dtype)[:, None, None, None]

    x = images * per(brightness)
    mean = luma(x).mean(dim=(1, 2))[:, None, None, None]
    x = mean * (1 - per(contrast)) + x * per(contrast)
    x = luma(x)[..., None] * (1 - per(saturation)) + x * per(saturation)
    return torch.clamp(x, 0.0, 255.0)


def gaussian_blur(images: torch.Tensor, sigma: torch.Tensor,
                  apply: torch.Tensor) -> torch.Tensor:
    """3-tap separable Gaussian blur with per-sample ``sigma`` (B,), edge
    padding, over H then W; rows with ``apply`` (B,) False pass through."""
    t = torch.exp(-0.5 / (sigma.float() * sigma.float()))
    kern = torch.stack([t, torch.ones_like(t), t], dim=-1)
    kern = (kern / kern.sum(-1, keepdim=True)).to(images.dtype)
    k0, k1, k2 = (kern[:, i, None, None, None] for i in range(3))
    p = torch.cat([images[:, :1], images, images[:, -1:]], dim=1)
    x = p[:, :-2] * k0 + p[:, 1:-1] * k1 + p[:, 2:] * k2
    p = torch.cat([x[:, :, :1], x, x[:, :, -1:]], dim=2)
    x = p[:, :, :-2] * k0 + p[:, :, 1:-1] * k1 + p[:, :, 2:] * k2
    return torch.where(apply[:, None, None, None], x, images)


# -------------------------------------------------------------- pipeline


def augment_batch(images: torch.Tensor, cfg: AugmentConfig,
                  gen: torch.Generator,
                  work_dtype: torch.dtype = torch.float32,
                  fill: Optional[Sequence[float]] = None,
                  rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Augment (B, H, W, C) uint8 images -> [0, 255] ``work_dtype`` (the
    batch counterpart of the JAX ``_augment_one``).  ``fill``: per-channel
    constant for out-of-coverage pixels; the resample is linear and maps
    constants to constants, so ``warp(x - fill) + fill`` fills with
    ``fill`` at no extra pass.  ``rows = (lo, n)``: ``images`` are rows
    ``lo:lo + B`` of an n-row batch; every draw is made for all n rows
    and these rows' are kept, so a data-parallel rank's views are the
    ones a single device makes of the whole batch."""
    b, h, w, _ = images.shape
    lo, n = rows if rows is not None else (0, b)
    mine = slice(lo, lo + b)
    x = images.to(work_dtype)
    if cfg.color_jitter:
        apply = _bernoulli(gen, n, cfg.aug_prob)
        one = torch.ones(n, device=gen.device)
        factors = [torch.where(apply, _uniform(gen, n, 1 - f, 1 + f),
                               one)[mine]
                   for f in (cfg.brightness, cfg.contrast, cfg.saturation)]
        x = color_jitter(x, *factors)
    inv = sample_inverse_affine(gen, cfg, h, w, n)[mine]
    if fill is not None:
        f = torch.tensor(fill, dtype=x.dtype, device=x.device)
        x = affine_warp(x - f, inv) + f
    else:
        x = affine_warp(x, inv)
    if cfg.gaussian_blur:
        apply = _bernoulli(gen, n, cfg.aug_prob)[mine]
        x = gaussian_blur(x, _uniform(gen, n, *cfg.blur_sigma)[mine], apply)
    return x


def augment_and_normalize(images: torch.Tensor, modality: ModalityConfig,
                          dtype: torch.dtype, gen: torch.Generator,
                          rows: Optional[Tuple[int, int]] = None
                          ) -> torch.Tensor:
    """Train-time transform: per-sample random augment + normalize.
    ``images``: uint8 (B, H, W, C) on ``gen``'s device -> normalized
    (B, H, W, C) ``dtype``.  The warp works in bf16 when ``dtype`` is
    bf16 (as the JAX package), else fp32.  ``rows``: a data-parallel
    rank's place in the global batch (:func:`augment_batch`; the JAX
    ``augment_and_normalize_spmd``)."""
    work = torch.bfloat16 if dtype == torch.bfloat16 else torch.float32
    fill = (tuple(255.0 * m for m in modality.mean)
            if modality.augment.fill_with_mean else None)
    x = augment_batch(images, modality.augment, gen, work, fill, rows)
    return normalize(x, modality.mean, modality.std, dtype)
