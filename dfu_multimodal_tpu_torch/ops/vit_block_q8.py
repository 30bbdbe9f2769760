"""Int8 ViT encoder blocks for serving: hand-written Hopper kernels and
their plain versions.

Counterpart of ``dfu_multimodal_tpu/ops/vit_block_q8.py``:

  ``attn_block_q8``:  x + proj(attention(qkv(LN1(x))))   (K7, dynamic)
  ``mlp_block_q8``:   x + fc2(gelu(fc1(LN2(x))))         (K7, dynamic)
  ``attn_block_q8s`` / ``mlp_block_q8s``: the same with calibrated static
                      activation scales                  (K8)

Scheme (static weights, dynamic or calibrated activations):

- weights are quantised ONCE at load time per output channel
  (:func:`quantize_weight`): w_q8[k, m] = round(w[k, m] / s[m]),
  s[m] = max(absmax(w[:, m]) / 127, 1e-12); int8 (in, out), contiguous;
- dynamic: every activation that feeds a product (the fp32 LayerNorm
  output, the fp32 attention output, each 768-wide chunk of the fp32 GELU
  output) is quantised per row, a[r] = max(absmax / 127, 1e-12), as
  round(y·(1/a[r])) (:func:`row_quant`); the int32 product is dequantised
  as (acc·a[r])·s[m] + bias;
- static: a calibrated per-tensor scale, ``inv_scales`` (2,) fp32 =
  [1/s_in, 1/s_mid]; the act scales are folded into the weight scales
  (``s_eff``) at conversion time (``models/vit.py``), so the product is
  dequantised as acc·s_eff[m] + bias;
- the MLP's hidden is processed in ``hidden_chunks`` chunks whose fc2
  products are dequantised each with its own row scale and summed in fp32
  in chunk order; attention itself stays in the compute dtype / fp32.

Rounding is half to even, clipped to [-127, 127].  GELU is exact erf (the
Pallas kernels' logistic form exists only because Mosaic cannot lower
erf).  Serving only: no backward.

Dispatch is by device only: each block is an op ``dfu::<name>``, whose
CPU implementation is its plain version (``*_ref``) and whose CUDA one
launches the kernels of ``csrc/vit_block_q8.cu`` or raises.  Arguments
keep the JAX order and layouts: x (B, N, C) in the
compute dtype, weights int8 (in, out), scales, biases and LayerNorm params
fp32.  The card's int8 products (wgmma) read both operands K-major, so
they read each weight's (out, in) copy: the keyword ``kmajor`` passes the
two copies (``w.t().contiguous()``, which the model keeps once per weight
version, ``models/vit.py::QDense``); without it each call makes them.  The
plain versions compute each int8 product exactly in floating
point: in fp32 on the CPU when every partial sum stays below 2²⁴
(K·127² < 2²⁴, so K <= 1040: C and the 768 chunks of ViT-B/16), in fp64
otherwise and on the card (where a TF32 setting could otherwise round an
fp32 product).  The attention blocks' optional ``bias`` is ToMe's
per-key score bias (B, N) (proportional attention), added to the scaled
scores inside the same attention kernel, as ``ops.vit_block.attn_block``
takes it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from dfu_multimodal_tpu_torch.ops import _build
from dfu_multimodal_tpu_torch.ops.attention import _is_pow2
from dfu_multimodal_tpu_torch.ops.vit_block import (LN_EPS, _HEAD_DIMS,
                                                   _key_bias,
                                                   _layernorm_f32, _like_x)

Q_MAX = 127.0
# the int8 GEMM's k32 step: C and the hidden chunk width are multiples
_TILE = 32
# epilogues of the int8 products (csrc/gemm_sm90.cuh::QEpilogue)
QEPI_OUT, QEPI_RESID, QEPI_GELU_F32, QEPI_GELU_Q8 = range(4)

_I, _P, _F = _build.I, _build.P, _build.F
_SIGNATURES = {
    "dfu_q8_ln_quant": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _F, _P],
    "dfu_q8_quant_rows": [_I, _P, _P, _P, _P, _I, _I, _I, _P],
    "dfu_q8_gemm": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                    _I, _I, _P],
    "dfu_q8_gemm_width": [_I, _I, _I, _I, _I, _I, _P],
    "dfu_q8_attention": [_I, _I, _P, _P, _I, _I, _I, _I, _F, _P, _P],
}


def _lib():
    return _build.load("vit_block_q8", _SIGNATURES)


# ------------------------------------------------------- plain versions


def over_qmax(t: torch.Tensor) -> torch.Tensor:
    """t / 127, a true division on every device: CUDA divides by a Python
    scalar through its reciprocal, which can differ from t / 127 in the
    last bit (and then from the JAX package and the kernels)."""
    return t / t.new_tensor(Q_MAX)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8: w (K, M) -> (int8 (K, M), fp32
    (M,)).  Run once at model load, outside the serving step."""
    w = w.float()
    s = over_qmax(w.abs().amax(0)).clamp_min(1e-12)
    q = torch.round(w / s).clamp(-Q_MAX, Q_MAX).to(torch.int8)
    return q.contiguous(), s


def row_quant(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 of fp32 y (..., K): (int8 y_q, fp32 (..., 1)
    a), quantised by the reciprocal multiply y·(1/a) as the TPU kernel."""
    a = over_qmax(y.abs().amax(-1, keepdim=True)).clamp_min(1e-12)
    return torch.round(y * (1.0 / a)).clamp(-Q_MAX, Q_MAX).to(torch.int8), a


def static_quant(y: torch.Tensor, inv_scale: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 with a precomputed reciprocal scale (a scalar)."""
    return torch.round(y * inv_scale).clamp(-Q_MAX, Q_MAX).to(torch.int8)


def _int_mm(a_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The int32 product a_q @ w_q of two int8 tensors, exact, as fp32 (the
    TPU kernel's ``acc.astype(float32)``)."""
    exact32 = a_q.device.type == "cpu" and a_q.shape[-1] * 127 * 127 < 2 ** 24
    acc = torch.float32 if exact32 else torch.float64
    return torch.matmul(a_q.to(acc), w_q.to(acc)).float()


def gemm_q8_ref(epi: int, a_q: torch.Tensor, w_q8: torch.Tensor,
                row_scale: Optional[torch.Tensor], col_scale: torch.Tensor,
                bias: torch.Tensor, resid: Optional[torch.Tensor] = None,
                inv: Optional[torch.Tensor] = None,
                group: Optional[int] = None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of one int8 product of the blocks (the kernels' GEMM,
    ``csrc/gemm_sm90.cuh``'s int8 modes): a_q (m, k) int8 times w_q8
    (k, n) int8 over K groups of ``group`` (all of k when None), each
    group's exact int32 sum rounded to fp32 and flushed as facc +
    (acc·row_scale[:, g])·col_scale (row_scale (m, k / group) fp32, None
    for static scales), then v = facc + bias and the epilogue ``epi``:
    QEPI_OUT dtype(v), QEPI_RESID dtype(resid + dtype(v)), QEPI_GELU_F32
    gelu(v) in fp32, QEPI_GELU_Q8 int8(gelu(v)·inv[0])."""
    k = a_q.shape[1]
    group = k if group is None else group
    facc = torch.zeros((a_q.shape[0], w_q8.shape[1]), dtype=torch.float32,
                       device=a_q.device)
    for g in range(k // group):
        sl = slice(g * group, (g + 1) * group)
        v = _int_mm(a_q[:, sl], w_q8[sl])
        if row_scale is not None:
            v = v * row_scale[:, g:g + 1]
        facc = facc + v * col_scale
    v = facc + bias
    if epi == QEPI_OUT:
        return v.to(dtype)
    if epi == QEPI_RESID:
        return (resid.float() + v.to(dtype).float()).to(dtype)
    if epi == QEPI_GELU_F32:
        return F.gelu(v)
    return static_quant(F.gelu(v), inv[0])


def _attention_f32(qkv: torch.Tensor, num_heads: int,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, N, 3C) packed qkv in the compute dtype -> (B, N, C) fp32: the
    TPU kernel's ``_attention_head`` per head (q pre-scaled in the compute
    dtype when d**-0.5 is a power of two, fp32 scores plus the (B, N) key
    ``bias`` and fp32 softmax statistics, the un-normalised exp matrix
    rounded to the compute dtype for e·V, the division by the fp32 row
    sum after it)."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads
    scale = d ** -0.5
    q, k, v = qkv.reshape(b, n, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    kt = k.float().transpose(-1, -2)
    if _is_pow2(scale):
        s = torch.matmul((q * scale).float(), kt)
    else:
        s = torch.matmul(q.float(), kt) * scale
    if bias is not None:
        s = s + bias.float()[:, None, None, :]
    e = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.matmul(e.to(qkv.dtype).float(), v.float())
    o = o / e.sum(-1, keepdim=True)
    return o.transpose(1, 2).reshape(b, n, c)


def _attn_ref(x, g1, b1, wqkv_q8, sqkv, bqkv, wproj_q8, sproj, bproj,
              num_heads, inv_scales, bias=None):
    b, n, c = x.shape
    y = _layernorm_f32(x.reshape(-1, c), g1, b1)
    if inv_scales is None:
        y_q, a = row_quant(y)
        qkv = _int_mm(y_q, wqkv_q8) * a * sqkv + bqkv
    else:
        qkv = _int_mm(static_quant(y, inv_scales[0]), wqkv_q8) * sqkv + bqkv
    attn = _attention_f32(qkv.to(x.dtype).reshape(b, n, 3 * c), num_heads,
                          bias)
    attn = attn.reshape(-1, c)
    if inv_scales is None:
        attn_q, a2 = row_quant(attn)
        o = _int_mm(attn_q, wproj_q8) * a2 * sproj + bproj
    else:
        o = _int_mm(static_quant(attn, inv_scales[1]), wproj_q8) * sproj \
            + bproj
    return x + o.to(x.dtype).reshape(b, n, c)


def _mlp_ref(x, g2, b2, w1_q8, s1, b1, w2_q8, s2, b2b, hidden_chunks,
             inv_scales):
    c = x.shape[-1]
    hidden = w1_q8.shape[-1]
    chunk = hidden // hidden_chunks
    y = _layernorm_f32(x.reshape(-1, c), g2, b2)
    if inv_scales is None:
        y_q, a = row_quant(y)
    else:
        y_q = static_quant(y, inv_scales[0])
    acc = torch.zeros(y.shape, dtype=torch.float32, device=x.device)
    for i in range(hidden_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        h = _int_mm(y_q, w1_q8[:, sl])
        if inv_scales is None:
            h_q, ah = row_quant(F.gelu(h * a * s1[sl] + b1[sl]))
            acc = acc + _int_mm(h_q, w2_q8[sl]) * ah * s2
        else:
            h_q = static_quant(F.gelu(h * s1[sl] + b1[sl]), inv_scales[1])
            acc = acc + _int_mm(h_q, w2_q8[sl]) * s2
    o = acc + b2b
    return x + o.to(x.dtype).reshape(x.shape)


def attn_block_q8_ref(x, g1, b1, wqkv_q8, sqkv, bqkv, wproj_q8, sproj,
                      bproj, num_heads: int, bias=None):
    """Plain version of :func:`attn_block_q8` (the TPU kernel's numerics)."""
    return _attn_ref(x, g1, b1, wqkv_q8, sqkv, bqkv, wproj_q8, sproj, bproj,
                     num_heads, None, bias)


def mlp_block_q8_ref(x, g2, b2, w1_q8, s1, b1, w2_q8, s2, b2b,
                     hidden_chunks: int = 4):
    """Plain version of :func:`mlp_block_q8`, exact-erf GELU."""
    return _mlp_ref(x, g2, b2, w1_q8, s1, b1, w2_q8, s2, b2b, hidden_chunks,
                    None)


def attn_block_q8s_ref(x, g1, b1, wqkv_q8, sqkv_eff, bqkv, wproj_q8,
                       sproj_eff, bproj, inv_scales, num_heads: int,
                       bias=None):
    """Plain version of :func:`attn_block_q8s`."""
    return _attn_ref(x, g1, b1, wqkv_q8, sqkv_eff, bqkv, wproj_q8, sproj_eff,
                     bproj, num_heads, inv_scales, bias)


def mlp_block_q8s_ref(x, g2, b2, w1_q8, s1_eff, b1, w2_q8, s2_eff, b2b,
                      inv_scales, hidden_chunks: int = 4):
    """Plain version of :func:`mlp_block_q8s`, exact-erf GELU."""
    return _mlp_ref(x, g2, b2, w1_q8, s1_eff, b1, w2_q8, s2_eff, b2b,
                    hidden_chunks, inv_scales)


# --------------------------------------------------------------- kernels


def _ptr(t: Optional[torch.Tensor], index: int = 0) -> Optional[int]:
    return None if t is None else t.data_ptr() + index * t.element_size()


def _check_shapes(name, int8, vectors, shapes):
    """int8 weights 16-byte aligned (the GEMM's TMA loads read the K-major
    copies) and every operand of the shape the block needs."""
    for arg, t in int8.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")
    bad = {arg: tuple(t.shape) for arg, t in {**int8, **vectors}.items()
           if tuple(t.shape) != shapes[arg]}
    if bad:
        raise ValueError(f"{name}: operand shapes {bad}, want "
                         f"{ {arg: shapes[arg] for arg in bad} }")


def _ln_quant(lib, x, g, b, rows, c, inv, what):
    """int8 y_q (rows, c) of LN(x) and, dynamic (``inv`` None), the row
    scales a (rows, 1)."""
    q = torch.empty((rows, c), dtype=torch.int8, device=x.device)
    a = (torch.empty((rows, 1), dtype=torch.float32, device=x.device)
         if inv is None else None)
    _build.check(lib, lib.dfu_q8_ln_quant(
        x.device.index, _build.DTYPE_CODES[x.dtype], x.data_ptr(),
        g.data_ptr(), b.data_ptr(), q.data_ptr(), _ptr(a), inv, rows, c,
        LN_EPS, _build.stream_of(x)), what)
    return q, a


def _quant_rows(lib, y, groups, inv, what):
    """int8 of fp32 y (rows, groups·width) and, dynamic (``inv`` None), the
    scales a (rows, groups) of each row's groups."""
    rows = y.shape[0]
    q = torch.empty(y.shape, dtype=torch.int8, device=y.device)
    a = (torch.empty((rows, groups), dtype=torch.float32, device=y.device)
         if inv is None else None)
    _build.check(lib, lib.dfu_q8_quant_rows(
        y.device.index, y.data_ptr(), q.data_ptr(), _ptr(a), inv, rows,
        y.shape[1] // groups, groups, _build.stream_of(y)), what)
    return q, a


def _gemm(lib, dtype, epi, a_q, w_t, row_scale, col_scale, bias, resid,
          inv, out, group, what, bn=0):
    """out = epilogue(a_q @ w_tᵀ dequantised per K group of ``group``); w_t
    the weight's K-major (out, in) copy, ``bn`` the tile width (0: the
    launcher's pick)."""
    m, k = a_q.shape
    _build.check(lib, lib.dfu_q8_gemm(
        a_q.device.index, _build.DTYPE_CODES[dtype], epi, a_q.data_ptr(),
        w_t.data_ptr(), _ptr(row_scale), col_scale.data_ptr(),
        bias.data_ptr(), _ptr(resid), inv, out.data_ptr(), m, w_t.shape[0],
        k, group, bn, _build.stream_of(a_q)), what)


def _kmajor(kmajor, w_in, w_out):
    """The two weights' K-major (out, in) copies: ``kmajor`` as given, or
    made now from the (in, out) weights."""
    if kmajor is not None:
        return tuple(kmajor)
    return w_in.t().contiguous(), w_out.t().contiguous()


def _attn_cuda(name, x, g1, b1, wqkv, sqkv, bqkv, wproj, sproj, bproj,
               num_heads, inv_scales, kmajor, bias):
    vectors = {"g1": g1, "b1": b1, "sqkv": sqkv, "bqkv": bqkv,
               "sproj": sproj, "bproj": bproj}
    if inv_scales is not None:
        vectors["inv_scales"] = inv_scales
    int8 = {"wqkv_q8": wqkv, "wproj_q8": wproj}
    _build.check_cuda_operands(name, x, {"x": x}, vectors, int8)
    wqkv_t, wproj_t = _kmajor(kmajor, wqkv, wproj)
    int8.update(wqkv_t=wqkv_t, wproj_t=wproj_t)
    _build.check_cuda_operands(name, x, {}, {}, int8)
    bsz, n, c = x.shape
    d = c // num_heads
    if d * num_heads != c or d not in _HEAD_DIMS or c % _TILE:
        raise ValueError(f"{name}: x {tuple(x.shape)} with {num_heads} "
                         f"heads: want C = heads * D, D in {_HEAD_DIMS}, "
                         f"C a multiple of {_TILE}")
    _check_shapes(name, int8, vectors, {
        "wqkv_q8": (c, 3 * c), "wproj_q8": (c, c), "wqkv_t": (3 * c, c),
        "wproj_t": (c, c), "g1": (c,), "b1": (c,), "sqkv": (3 * c,),
        "bqkv": (3 * c,), "sproj": (c,), "bproj": (c,), "inv_scales": (2,)})
    bias = _key_bias(name, x, bias)
    lib, rows, dev = _lib(), bsz * n, x.device
    y_q, a = _ln_quant(lib, x, g1, b1, rows, c, _ptr(inv_scales, 0),
                       f"{name} LayerNorm")
    qkv = torch.empty((bsz, n, 3 * c), dtype=x.dtype, device=dev)
    _gemm(lib, x.dtype, QEPI_OUT, y_q, wqkv_t, a, sqkv, bqkv, None, None,
          qkv, c, f"{name} qkv")
    attn = torch.empty((rows, c), dtype=torch.float32, device=dev)
    _build.check(lib, lib.dfu_q8_attention(
        dev.index, _build.DTYPE_CODES[x.dtype], qkv.data_ptr(),
        attn.data_ptr(), bsz, n, num_heads, d, d ** -0.5,
        None if bias is None else bias.data_ptr(),
        _build.stream_of(x)), f"{name} attention")
    attn_q, a2 = _quant_rows(lib, attn, 1, _ptr(inv_scales, 1),
                             f"{name} quantise attention")
    out = torch.empty_like(x)
    _gemm(lib, x.dtype, QEPI_RESID, attn_q, wproj_t, a2, sproj, bproj, x,
          None, out, c, f"{name} proj")
    return out


def _mlp_cuda(name, x, g2, b2, w1, s1, b1, w2, s2, b2b, hidden_chunks,
              inv_scales, kmajor):
    vectors = {"g2": g2, "b2": b2, "s1": s1, "b1": b1, "s2": s2, "b2b": b2b}
    if inv_scales is not None:
        vectors["inv_scales"] = inv_scales
    int8 = {"w1_q8": w1, "w2_q8": w2}
    _build.check_cuda_operands(name, x, {"x": x}, vectors, int8)
    w1_t, w2_t = _kmajor(kmajor, w1, w2)
    int8.update(w1_t=w1_t, w2_t=w2_t)
    _build.check_cuda_operands(name, x, {}, {}, int8)
    c = x.shape[-1]
    hidden = w1.shape[-1]
    chunk = hidden // hidden_chunks
    if c % _TILE or chunk * hidden_chunks != hidden or chunk % _TILE:
        raise ValueError(f"{name}: C = {c} and {hidden_chunks} hidden "
                         f"chunks of {hidden}: want C and the chunk width "
                         f"multiples of {_TILE}")
    _check_shapes(name, int8, vectors, {
        "w1_q8": (c, hidden), "w2_q8": (hidden, c), "w1_t": (hidden, c),
        "w2_t": (c, hidden), "g2": (c,), "b2": (c,), "s1": (hidden,),
        "b1": (hidden,), "s2": (c,), "b2b": (c,), "inv_scales": (2,)})
    lib, rows, dev = _lib(), x.numel() // c, x.device
    y_q, a = _ln_quant(lib, x, g2, b2, rows, c, _ptr(inv_scales, 0),
                       f"{name} LayerNorm")
    if inv_scales is None:
        h = torch.empty((rows, hidden), dtype=torch.float32, device=dev)
        _gemm(lib, x.dtype, QEPI_GELU_F32, y_q, w1_t, a, s1, b1, None, None,
              h, c, f"{name} fc1")
        h_q, ah = _quant_rows(lib, h, hidden_chunks, None,
                              f"{name} quantise hidden")
    else:
        h_q, ah = torch.empty((rows, hidden), dtype=torch.int8,
                              device=dev), None
        _gemm(lib, x.dtype, QEPI_GELU_Q8, y_q, w1_t, None, s1, b1, None,
              _ptr(inv_scales, 1), h_q, c, f"{name} fc1")
    out = torch.empty_like(x)
    _gemm(lib, x.dtype, QEPI_RESID, h_q, w2_t, ah, s2, b2b, x, None, out,
          chunk, f"{name} fc2")
    return out


# the two weights' K-major (out, in) int8 copies, or None
Kmajor = Optional[Tuple[torch.Tensor, torch.Tensor]]


def attn_block_q8(x: torch.Tensor, g1: torch.Tensor, b1: torch.Tensor,
                  wqkv_q8: torch.Tensor, sqkv: torch.Tensor,
                  bqkv: torch.Tensor, wproj_q8: torch.Tensor,
                  sproj: torch.Tensor, bproj: torch.Tensor,
                  num_heads: int, bias=None, *,
                  kmajor: Kmajor = None) -> torch.Tensor:
    """Serving-only int8 variant of ``ops.vit_block.attn_block``, dynamic
    per-row activation scales.  x (B, N, C); wqkv_q8 (C, 3C) and wproj_q8
    (C, C) int8 from :func:`quantize_weight`; their scales, the biases and
    g1, b1 fp32.  ``kmajor``: (wqkv_q8ᵀ, wproj_q8ᵀ) contiguous, read by the
    card's products (made per call when None; ignored on the CPU).
    ``bias``: ToMe's (B, N) key bias, as ``ops.vit_block.attn_block``'s (a
    call with one also counts in ``attn_block_q8.bias_launches``)."""
    _build.check_device("attn_block_q8", x)
    return _ATTN_Q8_OP(x, g1, b1, wqkv_q8, sqkv, bqkv, wproj_q8, sproj,
                       bproj, num_heads, bias, *_pair(kmajor))


def mlp_block_q8(x: torch.Tensor, g2: torch.Tensor, b2: torch.Tensor,
                 w1_q8: torch.Tensor, s1: torch.Tensor, b1: torch.Tensor,
                 w2_q8: torch.Tensor, s2: torch.Tensor, b2b: torch.Tensor,
                 hidden_chunks: int = 4, *,
                 kmajor: Kmajor = None) -> torch.Tensor:
    """Serving-only int8 variant of ``ops.vit_block.mlp_block``, dynamic
    per-row activation scales (each hidden chunk its own).  w1_q8 (C, H),
    w2_q8 (H, C) int8; scales, biases, g2, b2 fp32.  ``kmajor``: (w1_q8ᵀ,
    w2_q8ᵀ) contiguous, as :func:`attn_block_q8`'s."""
    _build.check_device("mlp_block_q8", x)
    return _MLP_Q8_OP(x, g2, b2, w1_q8, s1, b1, w2_q8, s2, b2b,
                      hidden_chunks, *_pair(kmajor))


def attn_block_q8s(x: torch.Tensor, g1: torch.Tensor, b1: torch.Tensor,
                   wqkv_q8: torch.Tensor, sqkv_eff: torch.Tensor,
                   bqkv: torch.Tensor, wproj_q8: torch.Tensor,
                   sproj_eff: torch.Tensor, bproj: torch.Tensor,
                   inv_scales: torch.Tensor, num_heads: int,
                   bias=None, *, kmajor: Kmajor = None) -> torch.Tensor:
    """Static-scale int8 attention block.  ``sqkv_eff`` / ``sproj_eff`` are
    the per-channel weight scales pre-multiplied by the calibrated input
    act scales; ``inv_scales`` (2,) fp32 = [1/s_ln1_out, 1/s_attn_out];
    ``kmajor`` and ``bias`` as :func:`attn_block_q8`'s."""
    _build.check_device("attn_block_q8s", x)
    return _ATTN_Q8S_OP(x, g1, b1, wqkv_q8, sqkv_eff, bqkv, wproj_q8,
                        sproj_eff, bproj, inv_scales, num_heads, bias,
                        *_pair(kmajor))


def mlp_block_q8s(x: torch.Tensor, g2: torch.Tensor, b2: torch.Tensor,
                  w1_q8: torch.Tensor, s1_eff: torch.Tensor,
                  b1: torch.Tensor, w2_q8: torch.Tensor,
                  s2_eff: torch.Tensor, b2b: torch.Tensor,
                  inv_scales: torch.Tensor,
                  hidden_chunks: int = 4, *,
                  kmajor: Kmajor = None) -> torch.Tensor:
    """Static-scale int8 MLP block; ``inv_scales`` (2,) fp32 =
    [1/s_ln2_out, 1/s_gelu_out]; ``kmajor`` as :func:`mlp_block_q8`'s."""
    _build.check_device("mlp_block_q8s", x)
    return _MLP_Q8S_OP(x, g2, b2, w1_q8, s1_eff, b1, w2_q8, s2_eff, b2b,
                       inv_scales, hidden_chunks, *_pair(kmajor))


def _pair(kmajor: Kmajor) -> Tuple[Optional[torch.Tensor], ...]:
    return (None, None) if kmajor is None else tuple(kmajor)


def _kept(a, b):
    return None if a is None else (a, b)


# the four blocks as ops ``dfu::<name>``: CPU the plain version, CUDA the
# kernels; the K-major weight copies are the last two (optional) operands
def _attn_q8_cuda(*args):
    *args, bias, wa_t, wb_t = args
    out = _attn_cuda("attn_block_q8", *args, None, _kept(wa_t, wb_t), bias)
    attn_block_q8.launches += 1
    attn_block_q8.bias_launches += bias is not None
    return out


def _mlp_q8_cuda(*args):
    *args, wa_t, wb_t = args
    out = _mlp_cuda("mlp_block_q8", *args, None, _kept(wa_t, wb_t))
    mlp_block_q8.launches += 1
    return out


def _attn_q8s_cuda(*args):
    *args, inv_scales, num_heads, bias, wa_t, wb_t = args
    out = _attn_cuda("attn_block_q8s", *args, num_heads, inv_scales,
                     _kept(wa_t, wb_t), bias)
    attn_block_q8s.launches += 1
    attn_block_q8s.bias_launches += bias is not None
    return out


def _mlp_q8s_cuda(*args):
    *args, inv_scales, hidden_chunks, wa_t, wb_t = args
    out = _mlp_cuda("mlp_block_q8s", *args, hidden_chunks, inv_scales,
                    _kept(wa_t, wb_t))
    mlp_block_q8s.launches += 1
    return out


_Q8_ATTN = ("Tensor x, Tensor g1, Tensor b1, Tensor wqkv_q8, Tensor sqkv, "
            "Tensor bqkv, Tensor wproj_q8, Tensor sproj, Tensor bproj, ")
_Q8_MLP = ("Tensor x, Tensor g2, Tensor b2, Tensor w1_q8, Tensor s1, "
           "Tensor b1, Tensor w2_q8, Tensor s2, Tensor b2b, ")
_Q8_KMAJOR = "Tensor? wa_t, Tensor? wb_t) -> Tensor"
_ATTN_Q8_OP = _build.define_op(
    "attn_block_q8", f"({_Q8_ATTN}int num_heads, Tensor? bias, {_Q8_KMAJOR}",
    cpu=lambda *a: attn_block_q8_ref(*a[:-2]), cuda=_attn_q8_cuda,
    fake=_like_x)
_MLP_Q8_OP = _build.define_op(
    "mlp_block_q8", f"({_Q8_MLP}int hidden_chunks, {_Q8_KMAJOR}",
    cpu=lambda *a: mlp_block_q8_ref(*a[:-2]), cuda=_mlp_q8_cuda,
    fake=_like_x)
_ATTN_Q8S_OP = _build.define_op(
    "attn_block_q8s",
    f"({_Q8_ATTN}Tensor inv_scales, int num_heads, Tensor? bias, "
    f"{_Q8_KMAJOR}",
    cpu=lambda *a: attn_block_q8s_ref(*a[:-2]), cuda=_attn_q8s_cuda,
    fake=_like_x)
_MLP_Q8S_OP = _build.define_op(
    "mlp_block_q8s",
    f"({_Q8_MLP}Tensor inv_scales, int hidden_chunks, {_Q8_KMAJOR}",
    cpu=lambda *a: mlp_block_q8s_ref(*a[:-2]), cuda=_mlp_q8s_cuda,
    fake=_like_x)

# launch counts: one per call that ran the kernels (CPU calls do not count)
attn_block_q8.launches = 0
attn_block_q8.bias_launches = 0     # those of them with ToMe's key bias
mlp_block_q8.launches = 0
attn_block_q8s.launches = 0
attn_block_q8s.bias_launches = 0
mlp_block_q8s.launches = 0
