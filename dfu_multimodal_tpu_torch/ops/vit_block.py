"""ViT encoder-block forward: hand-written Hopper kernels + plain versions.

Counterpart of ``dfu_multimodal_tpu/ops/vit_block.py`` (the fused Pallas
``attn_block`` / ``mlp_block``):

  ``attn_block``:  x + proj(attention(qkv(LN1(x))))
  ``mlp_block``:   x + fc2(gelu(fc1(LN2(x))))

Dispatch is by device only.  A CPU tensor takes the plain PyTorch version
(:func:`attn_block_ref`, :func:`mlp_block_ref`); a CUDA tensor launches the
kernels of ``csrc/vit_block.cu`` (LayerNorm, tiled GEMM with a bias / GELU
/ residual epilogue, attention core) or raises.  Arguments keep the JAX
order and layouts: x (B, N, C) in the compute dtype, weights (in, out) in
the compute dtype, LayerNorm params and biases fp32.

Forward only: the backward and the ToMe key ``bias`` are not ported yet
(``bias`` raises ``NotImplementedError``).  GELU is exact erf on both
paths, where the Pallas kernel uses a logistic approximation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dfu_multimodal_tpu_torch.ops import _build

LN_EPS = 1e-6
_EPI_BIAS, _EPI_BIAS_GELU, _EPI_BIAS_RESID = 0, 1, 2
_HEAD_DIMS = (16, 32, 64, 128)          # head dims the attention core takes

_I, _P, _F = _build.I, _build.P, _build.F
_SIGNATURES = {
    "dfu_layernorm": [_I, _I, _P, _P, _P, _P, _I, _I, _F, _P],
    "dfu_gemm": [_I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "dfu_attention": [_I, _I, _P, _P, _I, _I, _I, _I, _F, _P],
}


def _lib():
    return _build.load("vit_block", _SIGNATURES)


# ------------------------------------------------------- plain versions


def _layernorm_f32(x, scale, bias, eps=LN_EPS):
    """LayerNorm over the last axis in fp32 (the TPU kernel's numerics)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * scale.float() + bias.float()


def _mm_f32(a, b):
    """a @ b with compute-dtype operands and an fp32 result (JAX's
    ``preferred_element_type=float32``): bf16 products are exact in fp32."""
    return torch.matmul(a.float(), b.float())


def attn_block_ref(x, g1, b1, wqkv, bqkv, wproj, bproj, num_heads: int,
                   bias=None):
    """Plain version of :func:`attn_block` (mirrors the JAX
    ``_attn_block_ref``: softmax normalised before P·V)."""
    if bias is not None:
        raise NotImplementedError("the ToMe key bias is not ported yet")
    b, n, c = x.shape
    d = c // num_heads
    y = _layernorm_f32(x, g1, b1).to(x.dtype)
    qkv = (_mm_f32(y, wqkv) + bqkv.float()).to(x.dtype)
    qkv = qkv.reshape(b, n, 3, num_heads, d)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    logits = _mm_f32(q.float() * d ** -0.5, k.transpose(-1, -2))
    p = torch.softmax(logits, dim=-1)
    attn = _mm_f32(p.to(x.dtype), v)
    attn = attn.transpose(1, 2).reshape(b, n, c).to(x.dtype)
    o = (_mm_f32(attn, wproj) + bproj.float()).to(x.dtype)
    return x + o


def mlp_block_ref(x, g2, b2, w1, b1, w2, b2b):
    """Plain version of :func:`mlp_block`, exact-erf GELU."""
    y = _layernorm_f32(x, g2, b2).to(x.dtype)
    h = F.gelu(_mm_f32(y, w1) + b1.float()).to(x.dtype)
    o = (_mm_f32(h, w2) + b2b.float()).to(x.dtype)
    return x + o


# --------------------------------------------------------------- kernels


def attn_block(x: torch.Tensor, g1: torch.Tensor, b1: torch.Tensor,
               wqkv: torch.Tensor, bqkv: torch.Tensor,
               wproj: torch.Tensor, bproj: torch.Tensor,
               num_heads: int, bias=None) -> torch.Tensor:
    """x + proj(attention(qkv(LN1(x)))).  x (B, N, C); wqkv (C, 3C) and
    wproj (C, C) in x's dtype; g1, b1, bqkv, bproj fp32."""
    if bias is not None:
        raise NotImplementedError("the ToMe key bias is not ported yet")
    if x.device.type == "cpu":
        return attn_block_ref(x, g1, b1, wqkv, bqkv, wproj, bproj, num_heads)
    _build.check_cuda_operands(
        "attn_block", x, {"x": x, "wqkv": wqkv, "wproj": wproj},
        {"g1": g1, "b1": b1, "bqkv": bqkv, "bproj": bproj})
    bsz, n, c = x.shape
    d = c // num_heads
    if (d * num_heads != c or d not in _HEAD_DIMS
            or wqkv.shape != (c, 3 * c) or wproj.shape != (c, c)
            or g1.shape != (c,) or b1.shape != (c,)
            or bqkv.shape != (3 * c,) or bproj.shape != (c,)):
        raise ValueError(
            f"attn_block: x {tuple(x.shape)} with {num_heads} heads, wqkv "
            f"{tuple(wqkv.shape)}, wproj {tuple(wproj.shape)}: want "
            f"C = heads * D with D in {_HEAD_DIMS} and (C, 3C), (C, C) "
            f"weights")
    lib, dev, rows = _lib(), x.device.index, bsz * n
    dt, stream = _build.DTYPE_CODES[x.dtype], _build.stream_of(x)
    y = torch.empty_like(x)
    qkv = torch.empty((bsz, n, 3 * c), dtype=x.dtype, device=x.device)
    attn = torch.empty_like(x)
    out = torch.empty_like(x)
    _build.check(lib, lib.dfu_layernorm(
        dev, dt, x.data_ptr(), g1.data_ptr(), b1.data_ptr(), y.data_ptr(),
        rows, c, LN_EPS, stream), "attn_block LayerNorm")
    _build.check(lib, lib.dfu_gemm(
        dev, dt, _EPI_BIAS, y.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
        None, qkv.data_ptr(), rows, 3 * c, c, stream), "attn_block qkv")
    _build.check(lib, lib.dfu_attention(
        dev, dt, qkv.data_ptr(), attn.data_ptr(), bsz, n, num_heads, d,
        d ** -0.5, stream), "attn_block attention")
    _build.check(lib, lib.dfu_gemm(
        dev, dt, _EPI_BIAS_RESID, attn.data_ptr(), wproj.data_ptr(),
        bproj.data_ptr(), x.data_ptr(), out.data_ptr(), rows, c, c, stream),
        "attn_block proj")
    attn_block.launches += 1
    return out


def mlp_block(x: torch.Tensor, g2: torch.Tensor, b2: torch.Tensor,
              w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2b: torch.Tensor) -> torch.Tensor:
    """x + fc2(gelu(fc1(LN2(x)))).  x (B, N, C); w1 (C, H) and w2 (H, C)
    in x's dtype; g2, b2, b1, b2b fp32."""
    if x.device.type == "cpu":
        return mlp_block_ref(x, g2, b2, w1, b1, w2, b2b)
    _build.check_cuda_operands(
        "mlp_block", x, {"x": x, "w1": w1, "w2": w2},
        {"g2": g2, "b2": b2, "b1": b1, "b2b": b2b})
    bsz, n, c = x.shape
    hidden = w1.shape[-1]
    if (w1.shape != (c, hidden) or w2.shape != (hidden, c)
            or g2.shape != (c,) or b2.shape != (c,)
            or b1.shape != (hidden,) or b2b.shape != (c,)):
        raise ValueError(
            f"mlp_block: x {tuple(x.shape)}, w1 {tuple(w1.shape)}, w2 "
            f"{tuple(w2.shape)}: want (C, H) and (H, C) weights")
    lib, dev, rows = _lib(), x.device.index, bsz * n
    dt, stream = _build.DTYPE_CODES[x.dtype], _build.stream_of(x)
    y = torch.empty_like(x)
    h = torch.empty((bsz, n, hidden), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    _build.check(lib, lib.dfu_layernorm(
        dev, dt, x.data_ptr(), g2.data_ptr(), b2.data_ptr(), y.data_ptr(),
        rows, c, LN_EPS, stream), "mlp_block LayerNorm")
    _build.check(lib, lib.dfu_gemm(
        dev, dt, _EPI_BIAS_GELU, y.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        None, h.data_ptr(), rows, hidden, c, stream), "mlp_block fc1")
    _build.check(lib, lib.dfu_gemm(
        dev, dt, _EPI_BIAS_RESID, h.data_ptr(), w2.data_ptr(),
        b2b.data_ptr(), x.data_ptr(), out.data_ptr(), rows, c, hidden,
        stream), "mlp_block fc2")
    mlp_block.launches += 1
    return out


# launch counts: one per call that ran the kernels (CPU calls do not count)
attn_block.launches = 0
mlp_block.launches = 0
