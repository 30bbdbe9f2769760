"""Fusion-head MLP forward: a hand-written Hopper kernel + its plain version.

Counterpart of ``dfu_multimodal_tpu/ops/fused_mlp.py``:
relu(relu(x@w1+b1)@w2+b2)@w3+b3 in one launch (``csrc/fused_mlp.cu``),
the eval forward of the multimodal late-fusion head.  A CPU tensor takes
:func:`fused_mlp_ref`; a CUDA tensor launches the kernel or raises.
Weights are (in, out) in x's dtype, biases fp32; the result is fp32.  A
weight may be row-major (the JAX layout) or the transposed view of an
(out, in) row-major matrix (``nn.Linear.weight.t()``): the kernel reads
either in place.

:class:`FusedMlp` is the differentiable form (the JAX custom VJP):
forward the kernel, backward autograd through :func:`fused_mlp_ref` on
the saved inputs.  JAX has no backward kernel for the head, so neither
has the port.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch import nn

from dfu_multimodal_tpu_torch.ops import _build
from dfu_multimodal_tpu_torch.ops.attention import acc_dtype
from dfu_multimodal_tpu_torch.ops.resnet_block import remat_grads

_I, _P = _build.I, _build.P
_SIGNATURES = {
    "dfu_fused_mlp": [_I, _I, _P] + [_P, _I, _I, _P] * 3 + [_P, _P]
    + [_I] * 5 + [_P],
    "dfu_fused_mlp_scratch": [_I] * 6 + [ctypes.POINTER(ctypes.c_longlong)],
}


def _layer(a, w, b):
    acc = acc_dtype(a)
    return torch.matmul(a.to(acc), w.to(acc)) + b.to(acc)


def fused_mlp_ref(x, w1, b1, w2, b2, w3, b3):
    """Plain version with the kernel's numerics (mirrors the JAX
    ``_fused_mlp_ref``): fp32 accumulation (fp64 for fp64 inputs, for
    ``torch.autograd.gradcheck``)."""
    h = torch.relu(_layer(x, w1, b1)).to(x.dtype)
    h = torch.relu(_layer(h, w2, b2)).to(x.dtype)
    return _layer(h, w3, b3)


def _layout(name: str, w: torch.Tensor, x: torch.Tensor) -> Tuple[int, int]:
    """(kmajor, ld) of a (k, n) weight the kernel reads in place: row-major
    (0, its row stride) or the transposed view of an (n, k) row-major
    matrix (1, its column stride); raises on any other layout, device or
    dtype."""
    if w.device != x.device:
        raise ValueError(f"fused_mlp: {name} is on {w.device}, x on "
                         f"{x.device}")
    if w.dtype != x.dtype:
        raise TypeError(f"fused_mlp: {name} must be {x.dtype}, got "
                        f"{w.dtype}")
    if w.dim() == 2 and w.is_contiguous():
        return 0, w.shape[1]
    if w.dim() == 2 and w.t().is_contiguous():
        return 1, w.shape[0]
    raise ValueError(f"fused_mlp: {name} {tuple(w.shape)} with strides "
                     f"{w.stride()} is neither row-major nor the transposed "
                     f"view of a row-major (out, in) matrix")


def fused_mlp(x: torch.Tensor,
              w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor,
              w3: torch.Tensor, b3: torch.Tensor) -> torch.Tensor:
    """x (B, D0) -> (B, D3) float32 through the three layers.  Each weight
    (in, out), row-major or ``nn.Linear.weight.t()``."""
    if x.device.type == "cpu":
        return fused_mlp_ref(x, w1, b1, w2, b2, w3, b3)
    _build.check_cuda_operands("fused_mlp", x, {"x": x},
                               {"b1": b1, "b2": b2, "b3": b3})
    layouts = [_layout(name, w, x) for name, w in
               (("w1", w1), ("w2", w2), ("w3", w3))]
    batch, d0 = x.shape
    d1, d2, d3 = w1.shape[1], w2.shape[1], w3.shape[1]
    if (w1.shape != (d0, d1) or w2.shape != (d1, d2) or w3.shape != (d2, d3)
            or b1.shape != (d1,) or b2.shape != (d2,) or b3.shape != (d3,)):
        raise ValueError(
            f"fused_mlp: x {tuple(x.shape)}, w1 {tuple(w1.shape)}, w2 "
            f"{tuple(w2.shape)}, w3 {tuple(w3.shape)} do not chain")
    out = torch.empty((batch, d3), dtype=torch.float32, device=x.device)
    lib = _build.load("fused_mlp", _SIGNATURES)
    dtype = _build.DTYPE_CODES[x.dtype]
    nbytes = ctypes.c_longlong()
    _build.check(lib, lib.dfu_fused_mlp_scratch(
        x.device.index, batch, d0, d1, d2, d3, ctypes.byref(nbytes)),
        "fused_mlp")
    scratch = torch.empty(nbytes.value, dtype=torch.uint8, device=x.device)
    weights = []
    for w, (kmajor, ld), b in zip((w1, w2, w3), layouts, (b1, b2, b3)):
        weights += [w.data_ptr(), kmajor, ld, b.data_ptr()]
    _build.check(lib, lib.dfu_fused_mlp(
        x.device.index, dtype, x.data_ptr(), *weights, out.data_ptr(),
        scratch.data_ptr(), batch, d0, d1, d2, d3, _build.stream_of(x)),
        "fused_mlp")
    fused_mlp.launches += 1
    return out


# launch count: one per call that ran the kernel (CPU calls do not count)
fused_mlp.launches = 0


class FusedMlp(torch.autograd.Function):
    """Differentiable :func:`fused_mlp` (the JAX ``_fused_mlp_fwd`` /
    ``_fused_mlp_bwd``): forward the kernel, saving only its inputs;
    backward rematerialises through :func:`fused_mlp_ref` under autograd.
    ``apply(x, w1, b1, w2, b2, w3, b3)``."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, w3, b3):
        ctx.save_for_backward(x, w1, b1, w2, b2, w3, b3)
        return fused_mlp(x, w1, b1, w2, b2, w3, b3)

    @staticmethod
    def backward(ctx, g):
        return remat_grads(fused_mlp_ref, ctx, g)


def fusion_mlp_params(fusion: nn.Module) -> Tuple[torch.Tensor, ...]:
    """(w1, b1, w2, b2, w3, b3) of a ``models.fusion.FusionMLP``: each
    weight the (in, out) transposed view of its ``nn.Linear`` weight (no
    copy; :func:`fused_mlp` reads that layout in place)."""
    fc1, fc2, fc3 = fusion.fc1, fusion.fc2, fusion.fc3
    return (fc1.weight.t(), fc1.bias, fc2.weight.t(), fc2.bias,
            fc3.weight.t(), fc3.bias)
