"""ViT encoder blocks: hand-written Hopper kernels, plain versions, and the
rematerialising backward.

Counterpart of ``dfu_multimodal_tpu/ops/vit_block.py``:

  ``attn_block``:  x + proj(attention(qkv(LN1(x))))     (K1, forward)
  ``mlp_block``:   x + fc2(gelu(fc1(LN2(x))))           (K2, forward)
  ``mlp_block_bwd``: LN2/fc1 recompute, dGELU, dx with the LN backward,
                   emits y, h, dhpre, dg2, db2           (K4)

and the two hand chain rules the custom VJPs run: :func:`attn_block_bwd`
(LN1 and qkv recompute, the K5 attention fwd+bwd of ``ops.attention``,
the projection and qkv products, LN backward in fp32) and
:func:`mlp_block_grads` (K4 plus the big-K weight-gradient products).
:class:`AttnBlock` and :class:`MlpBlock` are the ``torch.autograd.
Function``s: forward = K1 / K2, saving only the block inputs (remat, as
the JAX custom VJPs), backward = the chain rules.

In bf16 the products of K1, K2 and K4 and the attention chain rule's data
products run on the TMA + wgmma GEMM of csrc/gemm_sm90.cuh (the weight
gradients stay ``torch.matmul``s), and K1's attention step on
the tensor-core forward of csrc/attention_fwd_mma.cuh with the Pallas
kernel's deferred softmax division; fp32, the parity dtype, runs the SIMT
GEMM of csrc/gemm_tile.cuh and the attention core of
csrc/attention_core.cuh.

:func:`attn_block_bwd_fused` is K10 (``_attn_block_bwd_kernel``, the
JAX package's alternative one-kernel VJP ``_attn_block_bwd_fused``): the
whole attention-block backward, dx and all six parameter gradients, from
one C entry of ``csrc/attn_block_bwd.cu`` that runs only the port's own
kernels, the weight gradients included (in bf16 every product on the TMA
+ wgmma GEMM of csrc/gemm_sm90.cuh, the weight gradients in its WGRAD
mode; fp32 on csrc/gemm_tile.cuh's SIMT tile).  :class:`AttnBlockFusedBwd` puts
it behind autograd (forward K1, backward K10).  No model selects it, as
no model of the JAX package does; its entry point is the op.  Attention
at any token count: a head too long for one block's shared memory runs
the tiled attention kernels of ``csrc/attention_kernels.cuh``.

Dispatch is by device only.  A CPU tensor takes the plain versions
(``*_ref``); a CUDA tensor launches the kernels of ``csrc/vit_block.cu``
and ``csrc/attention.cu`` or raises.  Arguments keep the JAX order and
layouts: x (B, N, C) in the compute dtype, weights (in, out) in the
compute dtype, LayerNorm params and biases fp32.  The chain rules'
weight-gradient products dw = aᵀ·b are fp32-result ``torch.matmul``s
outside the kernels (as the JAX package leaves them to XLA), rounded to
the weight's dtype; K10 computes them in its own kernels, as the TPU
kernel does.

GELU is exact erf on both paths (the Pallas kernels use a logistic
approximation only because Mosaic cannot lower erf), so the backward uses
the exact dGELU Φ(x) + x·φ(x).  ``attn_block``'s optional ``bias`` is
ToMe's per-key score bias (proportional attention: log token sizes,
``ops/token_merge.py``), a (B, N) fp32 operand of the same kernels; the
biased block is inference-only, as in JAX, where the biased call bypasses
the custom VJP (:class:`AttnBlock` raises if a gradient is asked through
it).  Plain versions accumulate in fp32, or in fp64 for fp64 inputs
(``torch.autograd.gradcheck``).
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from dfu_multimodal_tpu_torch.ops import _build
from dfu_multimodal_tpu_torch.ops.attention import (
    _HEAD_DIMS as _ATTN_HEAD_DIMS, _attend_two_pass, _check_aligned,
    _merge_heads, _unpack, acc_dtype as _acc, qkv_attention_fwdbwd,
    qkv_attention_fwdbwd_ref)

LN_EPS = 1e-6
# epilogues of csrc/vit_block.cu::dfu_gemm
(_EPI_BIAS, _EPI_BIAS_GELU, _EPI_BIAS_RESID, _EPI_BIAS_GELU_AUX, _EPI_DGELU,
 _EPI_NONE, _EPI_F32) = range(7)
_HEAD_DIMS = (16, 32, 64, 128)          # head dims the attention core takes

_I, _P, _F = _build.I, _build.P, _build.F
_K10_SIGNATURES = {
    "dfu_attn_block_bwd_scratch": [_I, _I, _I, _I, _I, _P],
    "dfu_attn_block_bwd_fused": [_I, _I] + [_P] * 15 + [_I, _I, _I, _I, _F,
                                                       _F, _P],
}
_SIGNATURES = {
    "dfu_layernorm": [_I, _I, _P, _P, _P, _P, _I, _I, _F, _P],
    "dfu_layernorm_bwd": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                          _I, _F, _P],
    "dfu_gemm": [_I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "dfu_gemm_sm90": [_I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "dfu_gemm_sm90_width": [_I, _I, _I, _I, _I, _P],
    "dfu_attention": [_I, _I, _P, _P, _I, _I, _I, _I, _F, _P, _P],
    "dfu_mlp_block_bwd_gemms": [_I] + [_P] * 8 + [_I, _I, _I, _P],
    "dfu_tensor_map_encode_ns": [_P, _I, _I, _I, _P],
}
_LNB_ROWS = 64      # rows per LN-backward column partial (csrc LNB_ROWS)
# the bf16 products (csrc/gemm_sm90.cuh): 64-deep k steps; TMA wants
# 16-byte-aligned bases and row strides
_SM90_BK, _TMA_ALIGN = 64, 16


def _lib():
    return _build.load("vit_block", _SIGNATURES)


# ------------------------------------------------------- plain versions


def _ln_stats(x, eps=LN_EPS):
    """(xhat, rstd) of a LayerNorm over the last axis, in fp32."""
    xf = x.to(_acc(x))
    xc = xf - xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    return xc * rstd, rstd


def _layernorm_f32(x, scale, bias, eps=LN_EPS):
    """LayerNorm over the last axis in fp32 (the TPU kernel's numerics)."""
    xhat, _ = _ln_stats(x, eps)
    return xhat * scale.to(xhat.dtype) + bias.to(xhat.dtype)


def _mm_f32(a, b):
    """a @ b with compute-dtype operands and an fp32 result (JAX's
    ``preferred_element_type=float32``): bf16 products are exact in fp32."""
    acc = _acc(a)
    return torch.matmul(a.to(acc), b.to(acc))


def _gelu_grad(h):
    """d/dx of exact-erf GELU: Φ(x) + x·φ(x)."""
    cdf = 0.5 * (1.0 + torch.erf(h * 0.5 ** 0.5))
    pdf = torch.exp(-0.5 * h * h) / math.sqrt(2.0 * math.pi)
    return cdf + h * pdf


def _ln_bwd_ref(x, resid, dy, gamma):
    """LayerNorm backward in fp32 with the block's residual gradient:
    dx = resid + rstd·(dxhat − mean(dxhat) − xhat·mean(dxhat·xhat)),
    dgamma = Σ dy·xhat, dbeta = Σ dy over rows.  x, resid in the compute
    dtype; dy fp32 (…, C)."""
    xhat, rstd = _ln_stats(x)
    dxhat = dy * gamma.to(dy.dtype)
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx = (resid.to(dy.dtype) + rstd * (dxhat - m1 - xhat * m2)).to(x.dtype)
    c = x.shape[-1]
    return (dx, (dy * xhat).reshape(-1, c).sum(0),
            dy.reshape(-1, c).sum(0))


def attn_block_ref(x, g1, b1, wqkv, bqkv, wproj, bproj, num_heads: int,
                   bias=None):
    """Plain version of :func:`attn_block` (mirrors the JAX
    ``_attn_block_ref``: softmax normalised before P·V; ``bias`` (B, N)
    added to the scaled scores of each key)."""
    b, n, c = x.shape
    d = c // num_heads
    y = _layernorm_f32(x, g1, b1).to(x.dtype)
    qkv = (_mm_f32(y, wqkv) + bqkv.to(_acc(x))).to(x.dtype)
    qkv = qkv.reshape(b, n, 3, num_heads, d)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    logits = _mm_f32(q.to(_acc(x)) * d ** -0.5, k.transpose(-1, -2))
    if bias is not None:
        logits = logits + bias.to(logits.dtype)[:, None, None, :]
    p = torch.softmax(logits, dim=-1)
    attn = _mm_f32(p.to(x.dtype), v)
    attn = attn.transpose(1, 2).reshape(b, n, c).to(x.dtype)
    o = (_mm_f32(attn, wproj) + bproj.to(_acc(x))).to(x.dtype)
    return x + o


def _attn_block_tiled_ref(x, g1, b1, wqkv, bqkv, wproj, bproj,
                          num_heads: int, bias=None):
    """The bf16 K1 kernels' algorithm in plain PyTorch, for the tests (the
    kernels run only on the card): :func:`attn_block_ref`'s LayerNorm and
    products around the tile walk of the attention step,
    ``attention._attend_two_pass(defer=True)`` (csrc/attention_fwd_mma.cuh
    with DEFER: 64-key tiles, pass 1 the row max, pass 2 e = exp(S − max),
    its uncast fp32 sum and bf16(e)·V, then O / sum), which is the Pallas
    kernel's deferred division (``_attention_head``); ``bias`` as
    :func:`attn_block`'s."""
    y = _layernorm_f32(x, g1, b1).to(x.dtype)
    qkv = (_mm_f32(y, wqkv) + bqkv.to(_acc(x))).to(x.dtype)
    attn = _merge_heads(_attend_two_pass(*_unpack(qkv, num_heads),
                                         defer=True, bias=bias), x.dtype)
    o = (_mm_f32(attn, wproj) + bproj.to(_acc(x))).to(x.dtype)
    return x + o


def mlp_block_ref(x, g2, b2, w1, b1, w2, b2b):
    """Plain version of :func:`mlp_block`, exact-erf GELU."""
    y = _layernorm_f32(x, g2, b2).to(x.dtype)
    h = F.gelu(_mm_f32(y, w1) + b1.to(_acc(x))).to(x.dtype)
    o = (_mm_f32(h, w2) + b2b.to(_acc(x))).to(x.dtype)
    return x + o


def mlp_block_bwd_ref(x, g, g2, b2, w1, b1, w2):
    """Plain version of :func:`mlp_block_bwd`: the Pallas kernel's
    numerics with exact-erf GELU.  Returns dx, y, h, dhpre in x's dtype
    ((R, C) rows for y, (R, H) for h and dhpre; dx keeps x's shape) and
    dg2, db2 (C,) in fp32."""
    c, hidden = w1.shape
    x2, g2d = x.reshape(-1, c), g.reshape(-1, c)
    y = _layernorm_f32(x2, g2, b2).to(x.dtype)
    hpre = _mm_f32(y, w1) + b1.to(_acc(x))
    h = F.gelu(hpre).to(x.dtype)
    dh = _mm_f32(g2d, w2.t())
    dhpre = (dh * _gelu_grad(hpre)).to(x.dtype)
    dy = _mm_f32(dhpre, w1.t())
    dx, dg2, db2 = _ln_bwd_ref(x2, g2d, dy, g2)
    return dx.reshape(x.shape), y, h, dhpre, dg2, db2


def _mlp_bwd_dual_ref(y, g, w1, b1, w2):
    """The bf16 K4 dual product's algorithm as a plain tile walk (the
    kernel itself runs only on the card): both accumulators, y·w1 and
    g·w2ᵀ, summed in fp32 over 64-deep k steps (csrc/gemm_sm90.cuh's BK),
    then the epilogue in registers: hpre = acc1 + b1, h = gelu(hpre),
    dhpre = acc2·gelu'(hpre), both in y's dtype.  y, g (R, C)."""
    acc = _acc(y)
    acc1 = torch.zeros(y.shape[0], w1.shape[1], dtype=acc,
                       device=y.device)
    acc2 = torch.zeros_like(acc1)
    for k0 in range(0, y.shape[1], _SM90_BK):
        k = slice(k0, k0 + _SM90_BK)
        acc1 += y[:, k].to(acc) @ w1[k].to(acc)
        acc2 += g[:, k].to(acc) @ w2[:, k].t().to(acc)
    hpre = acc1 + b1.to(acc)
    return (F.gelu(hpre).to(y.dtype),
            (acc2 * _gelu_grad(hpre)).to(y.dtype))


# --------------------------------------------------------------- kernels


def _launch_layernorm(lib, x, g, b, y, rows, c, what):
    _build.check(lib, lib.dfu_layernorm(
        x.device.index, _build.DTYPE_CODES[x.dtype], x.data_ptr(),
        g.data_ptr(), b.data_ptr(), y.data_ptr(), rows, c, LN_EPS,
        _build.stream_of(x)), what)


def _launch_gemm(lib, epi, trans_b, a, b, bias, aux, out, m, n, k, what):
    """out (m, n) = epilogue(a (m, k) @ B) with B = b (k, n), or b (n, k)
    transposed when ``trans_b``."""
    _build.check(lib, lib.dfu_gemm(
        a.device.index, _build.DTYPE_CODES[a.dtype], epi, int(trans_b),
        a.data_ptr(), b.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if aux is None else aux.data_ptr(), out.data_ptr(), m, n, k,
        _build.stream_of(a)), what)


def _launch_layernorm_bwd(lib, x, resid, dy, gamma, rows, c, what):
    """-> (dx in x's dtype, dgamma, dbeta fp32): the warp-per-row dx pass,
    then per-block column partials reduced in a fixed order (no atomics,
    so the sums are deterministic)."""
    nblk = -(-rows // _LNB_ROWS)
    dx = torch.empty_like(x)
    stats = torch.empty((2, rows), dtype=torch.float32, device=x.device)
    partial = torch.empty((2, nblk, c), dtype=torch.float32, device=x.device)
    dgamma = torch.empty(c, dtype=torch.float32, device=x.device)
    dbeta = torch.empty_like(dgamma)
    _build.check(lib, lib.dfu_layernorm_bwd(
        x.device.index, _build.DTYPE_CODES[x.dtype], x.data_ptr(),
        resid.data_ptr(), dy.data_ptr(), gamma.data_ptr(), dx.data_ptr(),
        stats.data_ptr(), partial.data_ptr(), dgamma.data_ptr(),
        dbeta.data_ptr(), rows, c, LN_EPS, _build.stream_of(x)), what)
    return dx, dgamma, dbeta


def _check_tma_operands(name, c, hidden, **operands):
    """The bf16 products load their operands by TMA (and K1/K2 read the
    residual x in 16-byte chunks), which needs 16-byte-aligned bases and
    row strides: raise ValueError unless C and ``hidden`` (the wider
    product's width: 3C, or the MLP's hidden) are multiples of 8 and every
    operand's base is 16-byte aligned (no fallback to another kernel)."""
    if c % 8 or hidden % 8:
        raise ValueError(f"{name}: C = {c} and hidden = {hidden} must be "
                         "multiples of 8 in bf16 (16-byte TMA rows)")
    for arg, t in operands.items():
        if t.data_ptr() % _TMA_ALIGN:
            raise ValueError(f"{name}: {arg} at address {t.data_ptr():#x} "
                             f"is not {_TMA_ALIGN}-byte aligned")


def attn_block(x: torch.Tensor, g1: torch.Tensor, b1: torch.Tensor,
               wqkv: torch.Tensor, bqkv: torch.Tensor,
               wproj: torch.Tensor, bproj: torch.Tensor,
               num_heads: int, bias=None) -> torch.Tensor:
    """x + proj(attention(qkv(LN1(x)))).  x (B, N, C); wqkv (C, 3C) and
    wproj (C, C) in x's dtype; g1, b1, bqkv, bproj fp32.  On the card,
    bf16 runs LN1, qkv and proj on the TMA + wgmma GEMM, and attention on
    the tensor cores with the deferred division (its tile walk:
    :func:`_attn_block_tiled_ref`); it needs C a multiple of 8 and
    16-byte-aligned x, wqkv, wproj (ValueError otherwise).  ``bias``:
    ToMe's per-key score bias (B, N), cast to fp32 as JAX casts it, added
    to the scaled scores inside the same attention kernel (a call with
    one also counts in ``attn_block.bias_launches``).  Inference only.
    The call is the op ``dfu::attn_block``: its CPU implementation is
    :func:`attn_block_ref`, its CUDA one the kernels."""
    _build.check_device("attn_block", x)
    return _ATTN_BLOCK_OP(x, g1, b1, wqkv, bqkv, wproj, bproj, num_heads,
                          bias)


def _attn_block_cuda(x, g1, b1, wqkv, bqkv, wproj, bproj, num_heads, bias):
    """``dfu::attn_block`` on the card: LN1, qkv, attention, proj."""
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
    if x.dtype == torch.bfloat16:
        _check_tma_operands("attn_block", c, 3 * c, x=x, wqkv=wqkv,
                            wproj=wproj)
    bias = _key_bias("attn_block", x, bias)
    lib, rows = _lib(), bsz * n
    y = torch.empty_like(x)
    qkv = torch.empty((bsz, n, 3 * c), dtype=x.dtype, device=x.device)
    attn = torch.empty_like(x)
    out = torch.empty_like(x)
    _launch_layernorm(lib, x, g1, b1, y, rows, c, "attn_block LayerNorm")
    _launch_gemm(lib, _EPI_BIAS, False, y, wqkv, bqkv, None, qkv, rows,
                 3 * c, c, "attn_block qkv")
    _build.check(lib, lib.dfu_attention(
        x.device.index, _build.DTYPE_CODES[x.dtype], qkv.data_ptr(),
        attn.data_ptr(), bsz, n, num_heads, d, d ** -0.5,
        None if bias is None else bias.data_ptr(),
        _build.stream_of(x)), "attn_block attention")
    _launch_gemm(lib, _EPI_BIAS_RESID, False, attn, wproj, bproj, x, out,
                 rows, c, c, "attn_block proj")
    attn_block.launches += 1
    attn_block.bias_launches += bias is not None
    return out


def _key_bias(name, x, bias):
    """ToMe's key bias as the attention kernels take it: (B, N) fp32,
    contiguous, on x's device (JAX casts it to fp32 likewise); None stays
    None.  Raises ValueError for another shape or device."""
    if bias is None:
        return None
    if bias.shape != x.shape[:2] or bias.device != x.device:
        raise ValueError(f"{name}: bias {tuple(bias.shape)} on {bias.device}"
                         f", want {tuple(x.shape[:2])} on {x.device}")
    return bias.to(torch.float32).contiguous()


def _check_mlp(name, x, g2, b2, w1, b1, w2, extra=None):
    compute = {"x": x, "w1": w1, "w2": w2, **(extra or {})}
    _build.check_cuda_operands(name, x, compute,
                               {"g2": g2, "b2": b2, "b1": b1})
    c = x.shape[-1]
    hidden = w1.shape[-1]
    if (w1.shape != (c, hidden) or w2.shape != (hidden, c)
            or g2.shape != (c,) or b2.shape != (c,)
            or b1.shape != (hidden,)):
        raise ValueError(
            f"{name}: x {tuple(x.shape)}, w1 {tuple(w1.shape)}, w2 "
            f"{tuple(w2.shape)}: want (C, H) and (H, C) weights")
    return x.numel() // c, c, hidden


def mlp_block(x: torch.Tensor, g2: torch.Tensor, b2: torch.Tensor,
              w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2b: torch.Tensor) -> torch.Tensor:
    """x + fc2(gelu(fc1(LN2(x)))).  x (B, N, C); w1 (C, H) and w2 (H, C)
    in x's dtype; g2, b2, b1, b2b fp32.  On the card, bf16 runs fc1 and fc2
    on the TMA + wgmma GEMM; it needs C and H multiples of 8 and
    16-byte-aligned x, w1, w2 (ValueError otherwise).  The call is the op
    ``dfu::mlp_block`` (CPU: :func:`mlp_block_ref`; CUDA: the kernels)."""
    _build.check_device("mlp_block", x)
    return _MLP_BLOCK_OP(x, g2, b2, w1, b1, w2, b2b)


def _mlp_block_cuda(x, g2, b2, w1, b1, w2, b2b):
    """``dfu::mlp_block`` on the card: LN2, fc1 + GELU, fc2 + residual."""
    rows, c, hidden = _check_mlp("mlp_block", x, g2, b2, w1, b1, w2)
    _build.check_cuda_operands("mlp_block", x, {}, {"b2b": b2b})
    if b2b.shape != (c,):
        raise ValueError(f"mlp_block: b2b {tuple(b2b.shape)}, want ({c},)")
    if x.dtype == torch.bfloat16:
        _check_tma_operands("mlp_block", c, hidden, x=x, w1=w1, w2=w2)
    lib = _lib()
    y = torch.empty_like(x)
    h = torch.empty((rows, hidden), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    _launch_layernorm(lib, x, g2, b2, y, rows, c, "mlp_block LayerNorm")
    _launch_gemm(lib, _EPI_BIAS_GELU, False, y, w1, b1, None, h, rows,
                 hidden, c, "mlp_block fc1")
    _launch_gemm(lib, _EPI_BIAS_RESID, False, h, w2, b2b, x, out, rows, c,
                 hidden, "mlp_block fc2")
    mlp_block.launches += 1
    return out


def mlp_block_bwd(x: torch.Tensor, g: torch.Tensor, g2: torch.Tensor,
                  b2: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  w2: torch.Tensor):
    """Backward of :func:`mlp_block` from its inputs and the output
    gradient g (x's shape and dtype): returns dx (x's shape), the
    recomputed y = LN2(x) (R, C), h = gelu(fc1) (R, H), dhpre (R, H) in
    x's dtype — the operands of the weight-gradient products — and dg2,
    db2 (C,) fp32.  R = B·N rows, unpadded.  On the card, bf16 runs the
    LayerNorm, the dual product (h and dhpre from one TMA + wgmma launch,
    the fp32 pre-activation kept in registers), dy = dhpre·w1ᵀ on the
    same GEMM and the LN backward; it needs C and hidden multiples of 8
    and 16-byte-aligned g, w1, w2 (ValueError otherwise).  fp32 runs the
    SIMT chain of csrc/gemm_tile.cuh."""
    if x.device.type == "cpu":
        return mlp_block_bwd_ref(x, g, g2, b2, w1, b1, w2)
    rows, c, hidden = _check_mlp("mlp_block_bwd", x, g2, b2, w1, b1, w2,
                                 {"g": g})
    if g.shape != x.shape:
        raise ValueError(f"mlp_block_bwd: g {tuple(g.shape)} != x "
                         f"{tuple(x.shape)}")
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        _check_tma_operands("mlp_block_bwd", c, hidden, g=g, w1=w1, w2=w2)
    lib, dev = _lib(), x.device
    y = torch.empty((rows, c), dtype=x.dtype, device=dev)
    h = torch.empty((rows, hidden), dtype=x.dtype, device=dev)
    dhpre = torch.empty_like(h)
    dy = torch.empty((rows, c), dtype=torch.float32, device=dev)
    _launch_layernorm(lib, x, g2, b2, y, rows, c, "mlp_block_bwd LayerNorm")
    if bf16:        # the dual product, then dy, on the TMA + wgmma GEMM
        _build.check(lib, lib.dfu_mlp_block_bwd_gemms(
            dev.index, y.data_ptr(), g.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), h.data_ptr(), dhpre.data_ptr(),
            dy.data_ptr(), rows, c, hidden, _build.stream_of(x)),
            "mlp_block_bwd products")
    else:           # fp32: the SIMT chain through the fp32 pre-activation
        hpre = torch.empty((rows, hidden), dtype=torch.float32, device=dev)
        _launch_gemm(lib, _EPI_BIAS_GELU_AUX, False, y, w1, b1, hpre, h,
                     rows, hidden, c, "mlp_block_bwd fc1")
        _launch_gemm(lib, _EPI_DGELU, True, g, w2, None, hpre, dhpre, rows,
                     hidden, c, "mlp_block_bwd dh")
        _launch_gemm(lib, _EPI_F32, True, dhpre, w1, None, None, dy, rows,
                     c, hidden, "mlp_block_bwd dy")
    dx, dg2, db2 = _launch_layernorm_bwd(lib, x, g, dy, g2, rows, c,
                                         "mlp_block_bwd LayerNorm bwd")
    mlp_block_bwd.launches += 1
    return dx, y, h, dhpre, dg2, db2


def _like_x(x, *args):
    """The blocks' fake implementation: an output shaped as x."""
    return torch.empty_like(x)


_ATTN_BLOCK_OP = _build.define_op(
    "attn_block",
    "(Tensor x, Tensor g1, Tensor b1, Tensor wqkv, Tensor bqkv, "
    "Tensor wproj, Tensor bproj, int num_heads, Tensor? bias) -> Tensor",
    cpu=lambda *a: attn_block_ref(*a), cuda=_attn_block_cuda, fake=_like_x)
_MLP_BLOCK_OP = _build.define_op(
    "mlp_block",
    "(Tensor x, Tensor g2, Tensor b2, Tensor w1, Tensor b1, Tensor w2, "
    "Tensor b2b) -> Tensor",
    cpu=lambda *a: mlp_block_ref(*a), cuda=_mlp_block_cuda, fake=_like_x)

# launch counts: one per call that ran the kernels (CPU calls do not count)
attn_block.launches = 0
attn_block.bias_launches = 0        # those of them with ToMe's key bias
mlp_block.launches = 0
mlp_block_bwd.launches = 0


# ---------------------------------------------------------- chain rules


def _wgrad(a, b, dtype):
    """aᵀ·b over all rows with an fp32 result, rounded to ``dtype`` (the
    weight's): a big-K product left to torch, as JAX leaves it to XLA."""
    return _mm_f32(a.reshape(-1, a.shape[-1]).t(),
                   b.reshape(-1, b.shape[-1])).to(dtype)


def _colsum(t):
    """Σ over rows in fp32 (fp64 for fp64 inputs)."""
    return t.reshape(-1, t.shape[-1]).to(_acc(t)).sum(0)


def _lazy(thunks, needs):
    """Each thunk's value where ``needs`` asks for it, else None (and the
    thunk, a weight-gradient product or column sum, never runs)."""
    return tuple(f() if need else None for f, need in zip(thunks, needs))


def mlp_block_grads(x, g, g2, b2, w1, b1, w2, b2b_dtype, needs=(True,) * 7):
    """Hand chain rule of the JAX ``_mlp_block_bwd``: K4, then
    dw1 = yᵀ·dhpre, db1 = Σ dhpre, dw2 = hᵀ·g, db2b = Σ g.  Returns the
    gradients of (x, g2, b2, w1, b1, w2, b2b), each in its input's dtype
    (weights in the compute dtype; the fp32 masters receive them through
    the cast, as in JAX); an entry whose ``needs`` is false is None and
    its product is not computed."""
    dx, y, h, dhpre, dg2, db2 = mlp_block_bwd(x, g, g2, b2, w1, b1, w2)
    return _lazy((lambda: dx, lambda: dg2.to(g2.dtype),
                  lambda: db2.to(b2.dtype),
                  lambda: _wgrad(y, dhpre, w1.dtype),
                  lambda: _colsum(dhpre).to(b1.dtype),
                  lambda: _wgrad(h, g, w2.dtype),
                  lambda: _colsum(g).to(b2b_dtype)), needs)


def _attn_grads(dx, dg1, db1, y, dqkv, attn, g, wqkv, wproj, needs):
    return _lazy((lambda: dx, lambda: dg1, lambda: db1,
                  lambda: _wgrad(y, dqkv, wqkv.dtype),
                  lambda: _colsum(dqkv),
                  lambda: _wgrad(attn, g, wproj.dtype),
                  lambda: _colsum(g)), needs)


def attn_block_bwd_ref(x, g, g1, b1, wqkv, bqkv, wproj, num_heads,
                       needs=(True,) * 7, prescale=False):
    """Plain version of :func:`attn_block_bwd` (the JAX
    ``_attn_block_bwd`` in torch, with the plain K5 on every device).
    ``prescale``: q scaled in the compute dtype for every head dim, as
    K10 does (:func:`attn_block_bwd_fused_ref`)."""
    y = _layernorm_f32(x, g1, b1).to(x.dtype)
    qkv = (_mm_f32(y, wqkv) + bqkv.to(_acc(x))).to(x.dtype)
    dattn = _mm_f32(g, wproj.t()).to(x.dtype)
    attn, dqkv = qkv_attention_fwdbwd_ref(qkv, dattn, num_heads, prescale)
    dy = _mm_f32(dqkv, wqkv.t())
    dx, dg1, db1 = _ln_bwd_ref(x, g, dy, g1)
    return _attn_grads(dx, dg1, db1, y, dqkv, attn, g, wqkv, wproj, needs)


def attn_block_bwd(x: torch.Tensor, g: torch.Tensor, g1: torch.Tensor,
                   b1: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor,
                   wproj: torch.Tensor, num_heads: int, needs=(True,) * 7):
    """Hand chain rule of the JAX ``_attn_block_bwd`` (remat from the
    block inputs): recompute LN1 and qkv, dattn = g·wprojᵀ, K5 (attention
    re-forward + backward, softmax once per head), dwproj = attnᵀ·g,
    dy = dqkv·wqkvᵀ, dwqkv = yᵀ·dqkv, dbqkv, then the LN backward in
    fp32 with the residual g.  Returns the gradients of (x, g1, b1, wqkv,
    bqkv, wproj, bproj): dx in x's dtype, weights in their dtype, the
    rest fp32; an entry whose ``needs`` is false is None and its product
    is not computed.  On a CUDA tensor the LayerNorm, the three data
    products (bf16: on the TMA + wgmma GEMM, which needs C a multiple of 8
    and 16-byte-aligned g, wqkv, wproj) and the LN backward run on the
    port's kernels."""
    if x.device.type == "cpu":
        return attn_block_bwd_ref(x, g, g1, b1, wqkv, bqkv, wproj, num_heads,
                                  needs)
    _build.check_cuda_operands(
        "attn_block_bwd", x, {"x": x, "g": g, "wqkv": wqkv, "wproj": wproj},
        {"g1": g1, "b1": b1, "bqkv": bqkv})
    bsz, n, c = x.shape
    if (g.shape != x.shape or wqkv.shape != (c, 3 * c)
            or wproj.shape != (c, c) or bqkv.shape != (3 * c,)
            or g1.shape != (c,) or b1.shape != (c,)):
        raise ValueError(
            f"attn_block_bwd: x {tuple(x.shape)}, g {tuple(g.shape)}, wqkv "
            f"{tuple(wqkv.shape)}, wproj {tuple(wproj.shape)}")
    if x.dtype == torch.bfloat16:
        _check_tma_operands("attn_block_bwd", c, 3 * c, g=g, wqkv=wqkv,
                            wproj=wproj)
    lib, rows, dev = _lib(), bsz * n, x.device
    y = torch.empty_like(x)
    qkv = torch.empty((bsz, n, 3 * c), dtype=x.dtype, device=dev)
    dattn = torch.empty_like(x)
    dy = torch.empty((bsz, n, c), dtype=torch.float32, device=dev)
    _launch_layernorm(lib, x, g1, b1, y, rows, c, "attn_block_bwd LayerNorm")
    _launch_gemm(lib, _EPI_BIAS, False, y, wqkv, bqkv, None, qkv, rows,
                 3 * c, c, "attn_block_bwd qkv")
    _launch_gemm(lib, _EPI_NONE, True, g, wproj, None, None, dattn, rows, c,
                 c, "attn_block_bwd dattn")
    attn, dqkv = qkv_attention_fwdbwd(qkv, dattn, num_heads)
    _launch_gemm(lib, _EPI_F32, True, dqkv, wqkv, None, None, dy, rows, c,
                 3 * c, "attn_block_bwd dy")
    dx, dg1, db1 = _launch_layernorm_bwd(lib, x, g, dy, g1, rows, c,
                                         "attn_block_bwd LayerNorm bwd")
    return _attn_grads(dx, dg1, db1, y, dqkv, attn, g, wqkv, wproj, needs)


class AttnBlock(torch.autograd.Function):
    """Trainable :func:`attn_block` (the JAX custom VJP): forward K1,
    saving only the block inputs; backward :func:`attn_block_bwd`.
    ``apply(x, g1, b1, wqkv, bqkv, wproj, bproj, num_heads[, bias])``: with
    ToMe's key bias the block is inference-only (JAX's biased call has no
    VJP), and a gradient asked through it raises RuntimeError."""

    @staticmethod
    def forward(ctx, x, g1, b1, wqkv, bqkv, wproj, bproj, num_heads,
                bias=None):
        ctx.num_heads = num_heads
        ctx.biased = bias is not None
        ctx.save_for_backward(x, g1, b1, wqkv, bqkv, wproj)
        return attn_block(x, g1, b1, wqkv, bqkv, wproj, bproj, num_heads,
                          bias)

    @staticmethod
    def backward(ctx, g):
        if not any(ctx.needs_input_grad):
            return (None,) * 9
        if ctx.biased:
            raise RuntimeError(
                "attn_block with ToMe's key bias is inference-only: it "
                "has no backward (token merging serves, it does not "
                "train)")
        x, g1, b1, wqkv, bqkv, wproj = ctx.saved_tensors
        grads = attn_block_bwd(x, g.contiguous(), g1, b1, wqkv, bqkv, wproj,
                               ctx.num_heads, ctx.needs_input_grad[:7])
        return grads + (None, None)


class MlpBlock(torch.autograd.Function):
    """Trainable :func:`mlp_block` (the JAX custom VJP): forward K2,
    saving only the block inputs; backward :func:`mlp_block_grads` (K4).
    ``apply(x, g2, b2, w1, b1, w2, b2b)``."""

    @staticmethod
    def forward(ctx, x, g2, b2, w1, b1, w2, b2b):
        ctx.b2b_dtype = b2b.dtype
        ctx.save_for_backward(x, g2, b2, w1, b1, w2)
        return mlp_block(x, g2, b2, w1, b1, w2, b2b)

    @staticmethod
    def backward(ctx, g):
        if not any(ctx.needs_input_grad):
            return (None,) * 7
        x, g2, b2, w1, b1, w2 = ctx.saved_tensors
        return mlp_block_grads(x, g.contiguous(), g2, b2, w1, b1, w2,
                               ctx.b2b_dtype, ctx.needs_input_grad)


# ------------------------------------------------------------------ K10


def _k10_lib():
    return _build.load("attn_block_bwd", _K10_SIGNATURES)


def attn_block_bwd_fused_ref(x, g, g1, b1, wqkv, bqkv, wproj, bproj,
                             num_heads):
    """Plain version of :func:`attn_block_bwd_fused`: K10's numerics
    (``_attn_block_bwd_kernel``), which are the chain rule's but for q
    scaled in the compute dtype for every head dim; each gradient rounded
    to its input's dtype."""
    grads = attn_block_bwd_ref(x, g, g1, b1, wqkv, bqkv, wproj, num_heads,
                               prescale=True)
    return tuple(t.to(p.dtype) for t, p in
                 zip(grads, (x, g1, b1, wqkv, bqkv, wproj, bproj)))


def attn_block_bwd_fused(x: torch.Tensor, g: torch.Tensor,
                         g1: torch.Tensor, b1: torch.Tensor,
                         wqkv: torch.Tensor, bqkv: torch.Tensor,
                         wproj: torch.Tensor, bproj: torch.Tensor,
                         num_heads: int):
    """K10: the whole backward of :func:`attn_block` from its inputs and
    the output gradient g (x's shape and dtype).  Returns the gradients of
    (x, g1, b1, wqkv, bqkv, wproj, bproj), the order of the JAX VJP: dx in
    x's dtype, the others computed in fp32 (summed over the batch in a
    fixed order, no atomics) and rounded to their parameter's dtype
    (bproj is read for its dtype only).  On a CUDA tensor one C entry runs
    the port's kernels alone, nothing of torch between the inputs and the
    fp32 results."""
    if x.device.type == "cpu":
        return attn_block_bwd_fused_ref(x, g, g1, b1, wqkv, bqkv, wproj,
                                        bproj, num_heads)
    _build.check_cuda_operands(
        "attn_block_bwd_fused", x,
        {"x": x, "g": g, "wqkv": wqkv, "wproj": wproj},
        {"g1": g1, "b1": b1, "bqkv": bqkv})
    bsz, n, c = x.shape
    d = c // num_heads
    if (d * num_heads != c or d not in _ATTN_HEAD_DIMS or g.shape != x.shape
            or wqkv.shape != (c, 3 * c) or wproj.shape != (c, c)
            or g1.shape != (c,) or b1.shape != (c,)
            or bqkv.shape != (3 * c,) or bproj.shape != (c,)):
        raise ValueError(
            f"attn_block_bwd_fused: x {tuple(x.shape)}, g {tuple(g.shape)} "
            f"with {num_heads} heads, wqkv {tuple(wqkv.shape)}, wproj "
            f"{tuple(wproj.shape)}: want C = heads * D with D in "
            f"{_ATTN_HEAD_DIMS} and (C, 3C), (C, C) weights")
    # bf16 operands 16-byte aligned, as the TMA products and every bf16
    # attention entry take them (C = heads * D is a multiple of 8)
    _check_aligned("attn_block_bwd_fused", x=x, g=g, wqkv=wqkv,
                   wproj=wproj)
    lib, dev = _k10_lib(), x.device
    code = _build.DTYPE_CODES[x.dtype]
    nbytes = ctypes.c_longlong()
    _build.check(lib, lib.dfu_attn_block_bwd_scratch(
        code, bsz, n, c, num_heads, ctypes.addressof(nbytes)),
        "attn_block_bwd_fused scratch")
    scratch = torch.empty(nbytes.value, dtype=torch.uint8, device=dev)
    dx = torch.empty_like(x)
    dwqkv, dbqkv, dwproj, dbproj, dg1, db1 = (
        torch.empty(shape, dtype=torch.float32, device=dev)
        for shape in ((c, 3 * c), (3 * c,), (c, c), (c,), (c,), (c,)))
    _build.check(lib, lib.dfu_attn_block_bwd_fused(
        dev.index, code, *(t.data_ptr() for t in (
            x, g, g1, b1, wqkv, bqkv, wproj, dx, dwqkv, dbqkv, dwproj,
            dbproj, dg1, db1, scratch)), bsz, n, c, num_heads, d ** -0.5,
        LN_EPS, _build.stream_of(x)), "attn_block_bwd_fused")
    attn_block_bwd_fused.launches += 1
    return (dx, dg1.to(g1.dtype), db1.to(b1.dtype), dwqkv.to(wqkv.dtype),
            dbqkv.to(bqkv.dtype), dwproj.to(wproj.dtype),
            dbproj.to(bproj.dtype))


attn_block_bwd_fused.launches = 0


class AttnBlockFusedBwd(torch.autograd.Function):
    """Trainable :func:`attn_block` with K10 as its backward (the JAX
    tests' ``fused_bwd_block``): forward K1, saving only the block
    inputs; backward :func:`attn_block_bwd_fused`.
    ``apply(x, g1, b1, wqkv, bqkv, wproj, bproj, num_heads)``."""

    @staticmethod
    def forward(ctx, x, g1, b1, wqkv, bqkv, wproj, bproj, num_heads):
        ctx.num_heads = num_heads
        ctx.save_for_backward(x, g1, b1, wqkv, bqkv, wproj, bproj)
        return attn_block(x, g1, b1, wqkv, bqkv, wproj, bproj, num_heads)

    @staticmethod
    def backward(ctx, g):
        x, g1, b1, wqkv, bqkv, wproj, bproj = ctx.saved_tensors
        grads = attn_block_bwd_fused(x, g.contiguous(), g1, b1, wqkv, bqkv,
                                     wproj, bproj, ctx.num_heads)
        return grads + (None,)
