"""Int8 convolution for the int8 ResNet trunk: a hand-written Hopper
kernel and its plain version.

Replaces no TPU kernel: ``dfu_multimodal_tpu/models/resnet_q8.py::_QConv``
(:59) is an XLA convolution on int8 operands with int32 sums, and PyTorch
has no int8 convolution on CUDA.  It computes, for x NHWC in the compute
dtype T::

    xq = clip(round_half_even(x_f32 / act_scale), -127, 127)     (int8)
    acc = conv(xq, kernel_q8)          (int32; stride s, padding kh // 2)
    y = T(float(acc) * s' + bias),  s' = f32(act_scale * scale)

with s' made once per weight version (JAX's ``act_scale * ws``), then
optionally y = T(shortcut + y), and optionally ReLU (which commutes with
the rounding to T).  Round half to even; the quantisation is a true
division (no reciprocal multiply), as JAX's ``x / scale``.

The conv is an im2col GEMM: A (B·Ho·Wo, kh·kw·Cin) int8 in column order
(dy, dx, cin), zeros at the padding, times the kernel's (Cout, kh·kw·Cin)
K-major copy, which the model keeps once per weight version
(``models/resnet_q8.py::QConv``).  A 1x1 stride-1 conv of an int8 input
(the block input quantised once for conv1 and the projection) takes that
input as A.

Dispatch is by device only, through the ops ``dfu::conv_q8`` and
``dfu::quantize_act_q8``: a CPU tensor takes the plain versions
(:func:`im2col_q8_ref`, ``ops/vit_block_q8.py::gemm_q8_ref``'s exact
integer sums); a CUDA tensor launches ``csrc/conv_q8.cu`` (the gather,
then ``gemm_sm90.cuh``'s int8 GEMM) or raises.  Serving only: no
backward.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dfu_multimodal_tpu_torch.ops import _build
from dfu_multimodal_tpu_torch.ops.vit_block_q8 import (Q_MAX, QEPI_OUT,
                                                       QEPI_RESID,
                                                       gemm_q8_ref)

# the ReLU variants of the int8 GEMM's epilogues (csrc/gemm_sm90.cuh::
# QEpilogue)
QEPI_OUT_RELU, QEPI_RESID_RELU = 4, 5
# the gather's dtype code of an int8 (pre-quantised) input
_DT_I8 = 2
# the GEMM's k32 step and the gather's 8-channel unit
_K_STEP, _C_UNIT = 32, 8

_I, _P = _build.I, _build.P
_SIGNATURES = {
    "dfu_conv_q8_im2col": [_I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                           _I, _I, _I, _P],
    "dfu_conv_q8_gemm": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                         _P],
}


def _lib():
    return _build.load("conv_q8", _SIGNATURES)


def out_hw(h: int, w: int, k: int, stride: int) -> Tuple[int, int]:
    """Output size of a k x k conv at ``stride`` with padding k // 2."""
    pad = k // 2
    return (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1


# ------------------------------------------------------- plain versions


def quantize_act(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Symmetric per-tensor int8 with a static scale: clip(round(x_f32 /
    scale), -127, 127) (JAX ``resnet_q8.py::quantize_act``, a true
    division)."""
    return torch.round(x.float() / scale).clamp(-Q_MAX, Q_MAX).to(torch.int8)


def im2col_q8_ref(x: torch.Tensor, act_scale: Optional[torch.Tensor],
                  k: int, stride: int) -> torch.Tensor:
    """Plain version of the gather: x (B, H, W, C) NHWC, in the compute
    dtype (quantised by ``act_scale``) or int8 (taken as it is) -> A
    (B·Ho·Wo, k·k·C) int8, columns in (dy, dx, c) order, zeros where a tap
    lies outside the image."""
    xq = x if x.dtype == torch.int8 else quantize_act(x, act_scale)
    b, h, w, c = xq.shape
    ho, wo = out_hw(h, w, k, stride)
    pad = k // 2
    xp = torch.nn.functional.pad(xq, (0, 0, pad, pad, pad, pad))
    taps = [xp[:, dy:dy + stride * (ho - 1) + 1:stride,
               dx:dx + stride * (wo - 1) + 1:stride]
            for dy in range(k) for dx in range(k)]
    return torch.stack(taps, dim=3).reshape(b * ho * wo, k * k * c)


def conv_q8_ref(x: torch.Tensor, kernel_kmajor: torch.Tensor,
                col_scale: torch.Tensor, bias: torch.Tensor,
                act_scale: Optional[torch.Tensor], k: int, stride: int = 1,
                relu: bool = False, resid: Optional[torch.Tensor] = None,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain version of :func:`conv_q8`: the gather, the exact int32 sums
    (``gemm_q8_ref``: fp32 on the CPU where every partial sum stays below
    2²⁴, else fp64), float(acc)·col_scale + bias, the shortcut and ReLU.
    Returns (B, Ho, Wo, Cout) in ``dtype`` (:func:`_out_dtype`)."""
    dtype = _out_dtype(x, resid, dtype)
    b, h, w, _ = x.shape
    ho, wo = out_hw(h, w, k, stride)
    a = im2col_q8_ref(x, act_scale, k, stride)
    cout = kernel_kmajor.shape[0]
    r = None if resid is None else resid.reshape(-1, cout)
    y = gemm_q8_ref(QEPI_OUT if resid is None else QEPI_RESID, a,
                    kernel_kmajor.t(), None, col_scale, bias, resid=r,
                    dtype=dtype)
    if relu:
        y = y.clamp_min(0)
    return y.reshape(b, ho, wo, cout)


def _out_dtype(x: torch.Tensor, resid: Optional[torch.Tensor],
               dtype: Optional[torch.dtype]) -> torch.dtype:
    """The output dtype: ``dtype`` if given, else x's, else (an int8 x)
    the shortcut's."""
    if dtype is not None:
        return dtype
    if x.dtype != torch.int8:
        return x.dtype
    if resid is None:
        raise ValueError("conv_q8 of an int8 x needs dtype or resid")
    return resid.dtype


# --------------------------------------------------------------- kernel


def _check(name: str, x, kernel_kmajor, col_scale, bias, act_scale, k,
           resid, dtype) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name}: compute dtype must be float32 or "
                        f"bfloat16, got {dtype}")
    if x.dtype not in (dtype, torch.int8):
        raise TypeError(f"{name}: x must be {dtype} or int8, got {x.dtype}")
    operands = {"x": (x, x.dtype), "kernel_kmajor": (kernel_kmajor,
                                                     torch.int8),
                "col_scale": (col_scale, torch.float32),
                "bias": (bias, torch.float32)}
    if act_scale is not None:
        operands["act_scale"] = (act_scale, torch.float32)
    if resid is not None:
        operands["resid"] = (resid, dtype)
    for arg, (t, want) in operands.items():
        if t.device != x.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, x on "
                             f"{x.device}")
        if t.dtype != want:
            raise TypeError(f"{name}: {arg} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.dim() and t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")
    cin, cout = x.shape[-1], kernel_kmajor.shape[0]
    depth = k * k * cin
    if (x.dim() != 4 or cin % _C_UNIT or depth % _K_STEP or cout % 8
            or tuple(kernel_kmajor.shape) != (cout, depth)
            or tuple(col_scale.shape) != (cout,)
            or tuple(bias.shape) != (cout,)):
        raise ValueError(
            f"{name}: x {tuple(x.shape)}, kernel_kmajor "
            f"{tuple(kernel_kmajor.shape)}, k = {k}: want NHWC x, Cin a "
            f"multiple of {_C_UNIT}, k·k·Cin of {_K_STEP}, Cout of 8 and "
            "a (Cout, k·k·Cin) kernel with (Cout,) scales and bias")
    if x.dtype != torch.int8 and act_scale is None:
        raise ValueError(f"{name}: a {x.dtype} x needs its act_scale")


def conv_q8(x: torch.Tensor, kernel_kmajor: torch.Tensor,
            col_scale: torch.Tensor, bias: torch.Tensor,
            act_scale: Optional[torch.Tensor], k: int, stride: int = 1,
            relu: bool = False, resid: Optional[torch.Tensor] = None,
            dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One int8 convolution with static scales.  x (B, H, W, Cin) NHWC
    contiguous, in the compute dtype (quantised here by ``act_scale``, a
    0-dim fp32 tensor) or int8 (quantised already); ``kernel_kmajor``
    (Cout, k·k·Cin) int8 in (dy, dx, cin) column order; ``col_scale`` =
    act_scale·scale and ``bias`` (Cout,) fp32; ``resid`` (B, Ho, Wo,
    Cout) in the compute dtype, added to the rounded output; ``relu``
    last.  Padding k // 2.  Returns (B, Ho, Wo, Cout) in ``dtype`` (x's,
    or the shortcut's for an int8 x, unless given).  The call is the op
    ``dfu::conv_q8`` (CPU: :func:`conv_q8_ref`; CUDA: the kernels)."""
    dtype = _out_dtype(x, resid, dtype)
    _build.check_device("conv_q8", x)
    return _CONV_Q8_OP(x, kernel_kmajor, col_scale, bias, act_scale, k,
                       stride, relu, resid, dtype)


def _conv_q8_cuda(x, kernel_kmajor, col_scale, bias, act_scale, k, stride,
                  relu, resid, dtype):
    """``dfu::conv_q8`` on the card: the gather (but for an int8 1x1
    stride-1 x), then the int8 GEMM."""
    _check("conv_q8", x, kernel_kmajor, col_scale, bias, act_scale, k,
           resid, dtype)
    b, h, w, cin = x.shape
    ho, wo = out_hw(h, w, k, stride)
    m, cout, depth = b * ho * wo, kernel_kmajor.shape[0], k * k * cin
    if resid is not None and tuple(resid.shape) != (b, ho, wo, cout):
        raise ValueError(f"conv_q8: resid {tuple(resid.shape)}, want "
                         f"{(b, ho, wo, cout)}")
    lib, stream = _lib(), _build.stream_of(x)
    if x.dtype == torch.int8 and k == 1 and stride == 1:
        a = x
    else:
        a = torch.empty((m, depth), dtype=torch.int8, device=x.device)
        code = (_DT_I8 if x.dtype == torch.int8
                else _build.DTYPE_CODES[x.dtype])
        _build.check(lib, lib.dfu_conv_q8_im2col(
            x.device.index, code, x.data_ptr(),
            None if act_scale is None else act_scale.data_ptr(),
            a.data_ptr(), b, h, w, cin, ho, wo, k, k, stride, k // 2,
            stream), "conv_q8 im2col")
    out = torch.empty((b, ho, wo, cout), dtype=dtype, device=x.device)
    epi = ((QEPI_RESID_RELU if relu else QEPI_RESID) if resid is not None
           else (QEPI_OUT_RELU if relu else QEPI_OUT))
    _build.check(lib, lib.dfu_conv_q8_gemm(
        x.device.index, _build.DTYPE_CODES[dtype], epi, a.data_ptr(),
        kernel_kmajor.data_ptr(), col_scale.data_ptr(), bias.data_ptr(),
        None if resid is None else resid.data_ptr(), out.data_ptr(), m,
        cout, depth, stream), "conv_q8 gemm")
    conv_q8.launches += 1
    return out


def quantize_act_q8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 of x (B, H, W, C) in the compute dtype by the static ``scale``
    (:func:`quantize_act`): on the card the gather's kernel as a 1x1
    stride-1 gather, whose A is x's int8 (B, H, W, C).  The call is the
    op ``dfu::quantize_act_q8`` (CPU: :func:`quantize_act`)."""
    _build.check_device("quantize_act_q8", x)
    return _QUANTIZE_ACT_Q8_OP(x, scale)


def _quantize_act_q8_cuda(x: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """``dfu::quantize_act_q8`` on the card: the gather's kernel."""
    if x.dtype not in _build.DTYPE_CODES or not x.is_contiguous() \
            or x.dim() != 4 or x.shape[-1] % _C_UNIT or x.data_ptr() % 16:
        raise ValueError(f"quantize_act_q8: want a contiguous, 16-byte "
                         f"aligned NHWC fp32/bf16 x with C a multiple of "
                         f"{_C_UNIT}, got {tuple(x.shape)} {x.dtype}")
    if scale.device != x.device or scale.dtype != torch.float32:
        raise TypeError("quantize_act_q8: scale must be fp32 on x's device")
    b, h, w, c = x.shape
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    lib = _lib()
    _build.check(lib, lib.dfu_conv_q8_im2col(
        x.device.index, _build.DTYPE_CODES[x.dtype], x.data_ptr(),
        scale.data_ptr(), q.data_ptr(), b, h, w, c, h, w, 1, 1, 1, 0,
        _build.stream_of(x)), "quantize_act_q8")
    quantize_act_q8.launches += 1
    return q


def _conv_q8_fake(x, kernel_kmajor, col_scale, bias, act_scale, k, stride,
                  relu, resid, dtype):
    b, h, w, _ = x.shape
    return x.new_empty((b, *out_hw(h, w, k, stride), kernel_kmajor.shape[0]),
                       dtype=dtype)


_CONV_Q8_OP = _build.define_op(
    "conv_q8",
    "(Tensor x, Tensor kernel_kmajor, Tensor col_scale, Tensor bias, "
    "Tensor? act_scale, int k, int stride, bool relu, Tensor? resid, "
    "ScalarType dtype) -> Tensor",
    cpu=lambda *a: conv_q8_ref(*a), cuda=_conv_q8_cuda, fake=_conv_q8_fake)
_QUANTIZE_ACT_Q8_OP = _build.define_op(
    "quantize_act_q8", "(Tensor x, Tensor scale) -> Tensor",
    cpu=lambda *a: quantize_act(*a), cuda=_quantize_act_q8_cuda,
    fake=lambda x, scale: torch.empty_like(x, dtype=torch.int8))

# launch counts: one per call that ran the kernels (CPU calls do not count)
conv_q8.launches = 0
quantize_act_q8.launches = 0
