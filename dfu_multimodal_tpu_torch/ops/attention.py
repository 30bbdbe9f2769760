"""Packed-qkv attention forward + backward in one kernel: hand-written
Hopper kernel + plain version.

Counterpart of ``dfu_multimodal_tpu/ops/attention.py::
qkv_attention_fwdbwd`` (the Pallas ``_qkv_attention_fwdbwd_kernel``),
which the attention-block backward calls: from the packed qkv (B, N, 3C)
and the attention output's gradient do (B, N, C) it computes each head's
softmax ONCE and emits both the re-forward output attn (B, N, C) (the
projection weight gradient needs it) and dqkv (B, N, 3C), packed
[dq | dk | dv] by column as qkv is.

Dispatch is by device only: a CPU tensor takes
:func:`qkv_attention_fwdbwd_ref`, a CUDA tensor launches
``csrc/attention.cu`` or raises.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from dfu_multimodal_tpu_torch.ops import _build

_HEAD_DIMS = (16, 32, 64)          # head dims the kernel takes

_I, _P, _F = _build.I, _build.P, _build.F
_SIGNATURES = {
    "dfu_qkv_attention_fwdbwd": [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _F, _I, _P],
}


def _lib():
    return _build.load("attention", _SIGNATURES)


def _is_pow2(x: float) -> bool:
    return math.frexp(x)[0] == 0.5


def acc_dtype(t: torch.Tensor) -> torch.dtype:
    """Accumulation dtype of the plain versions: fp32, or fp64 for fp64
    inputs (``torch.autograd.gradcheck``)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def qkv_attention_fwdbwd_ref(qkv: torch.Tensor, do: torch.Tensor,
                             num_heads: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version, the Pallas kernel's numerics: compute-dtype score
    operands with fp32 accumulation (q pre-scaled by d**-0.5 in the
    compute dtype when that is a power of two, else the scores scaled
    after the product), fp32 softmax statistics with P normalised BEFORE
    P·V, P cast to the compute dtype for o = P·V and dv = Pᵀ·do,
    ds = P∘(dp − rowsum(dp∘P)) cast to the compute dtype,
    dq = ds·k·scale, dk = dsᵀ·q·scale."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads
    dt, acc = qkv.dtype, acc_dtype(qkv)
    scale = d ** -0.5
    heads = qkv.reshape(b, n, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    q, k, v = heads[0], heads[1], heads[2]                # (B, H, N, D)
    dov = do.reshape(b, n, num_heads, d).transpose(1, 2)
    kt = k.to(acc).transpose(-1, -2)
    if _is_pow2(scale):
        s = torch.matmul((q * scale).to(dt).to(acc), kt)
    else:
        s = torch.matmul(q.to(acc), kt) * scale
    p = torch.softmax(s, dim=-1)
    p_c = p.to(dt).to(acc)
    o = torch.matmul(p_c, v.to(acc))
    dv = torch.matmul(p_c.transpose(-1, -2), dov.to(acc))
    dp = torch.matmul(dov.to(acc), v.to(acc).transpose(-1, -2))
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True))).to(dt).to(acc)
    dq = torch.matmul(ds, k.to(acc)) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.to(acc)) * scale
    attn = o.to(dt).transpose(1, 2).reshape(b, n, c)
    dqkv = torch.stack([dq, dk, dv]).to(dt)               # (3, B, H, N, D)
    dqkv = dqkv.permute(1, 3, 0, 2, 4).reshape(b, n, c3)
    return attn, dqkv


def qkv_attention_fwdbwd(qkv: torch.Tensor, do: torch.Tensor,
                         num_heads: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(qkv (B, N, 3C), do (B, N, C)) -> (attn (B, N, C), dqkv (B, N, 3C))
    in qkv's dtype, softmax computed once per head."""
    if qkv.device.type == "cpu":
        return qkv_attention_fwdbwd_ref(qkv, do, num_heads)
    _build.check_cuda_operands("qkv_attention_fwdbwd", qkv,
                               {"qkv": qkv, "do": do}, {})
    b, n, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads
    if (c3 != 3 * c or d * num_heads != c or d not in _HEAD_DIMS
            or do.shape != (b, n, c)):
        raise ValueError(
            f"qkv_attention_fwdbwd: qkv {tuple(qkv.shape)}, do "
            f"{tuple(do.shape)} with {num_heads} heads: want (B, N, 3C), "
            f"(B, N, C) and C = heads * D with D in {_HEAD_DIMS}")
    lib = _lib()
    attn = torch.empty_like(do)
    dqkv = torch.empty_like(qkv)
    scale = d ** -0.5
    _build.check(lib, lib.dfu_qkv_attention_fwdbwd(
        qkv.device.index, _build.DTYPE_CODES[qkv.dtype], qkv.data_ptr(),
        do.data_ptr(), attn.data_ptr(), dqkv.data_ptr(), b, n, num_heads, d,
        scale, int(_is_pow2(scale)), _build.stream_of(qkv)),
        "qkv_attention_fwdbwd")
    qkv_attention_fwdbwd.launches += 1
    return attn, dqkv


# launch count: one per call that ran the kernel (CPU calls do not count)
qkv_attention_fwdbwd.launches = 0
