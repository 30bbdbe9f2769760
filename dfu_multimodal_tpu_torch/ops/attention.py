"""Softmax attention: hand-written Hopper kernels, plain versions and the
trainable entry points.

Counterpart of ``dfu_multimodal_tpu/ops/attention.py``:

- ``qkv_attention_fwd`` / ``qkv_attention_bwd`` (K6, the Pallas
  ``_qkv_attention_fwd_kernel`` / ``_qkv_attention_bwd_kernel``): the
  packed qkv (B, N, 3C) straight from the qkv Linear -> attn (B, N, C);
  backward (qkv, do) -> dqkv (B, N, 3C), packed [dq | dk | dv] by column
  as qkv is, the softmax recomputed.  :func:`qkv_attention` is the
  trainable ``QkvAttention`` (the JAX custom VJP), which the flax-block
  ViT's ``MultiHeadAttention`` calls with ``attention_impl="pallas"``.
- ``flash_attention_fwd`` / ``flash_attention_bwd`` (K9, ``_attention_fwd_
  kernel`` / ``_attention_bwd_kernel``): the same function over separate
  q, k, v (B, H, N, D); :func:`flash_attention` is the trainable
  ``FlashAttention``.
- ``qkv_attention_fwdbwd`` (K5, ``_qkv_attention_fwdbwd_kernel``), which
  the attention-block backward calls: the softmax computed ONCE for both
  the re-forward output attn (the projection weight gradient needs it) and
  dqkv.

All three run one CUDA source (``csrc/attention.cu``) with one set of
numerics, and so do their plain versions (:func:`_probs`,
:func:`_attend`, :func:`_grads`).  Dispatch is by device only: a CPU
tensor takes the plain version (``*_ref``), a CUDA tensor launches the
kernel or raises.  Every token count runs.  In bf16 every kernel runs on
the tensor cores, one path for every N: the forwards of K6 and K9
(``csrc/attention_fwd_mma.cuh``: two passes over 64-key tiles, the
running max and sum, then P normalised before P·V; :func:`_attend_two_pass`
is its tile walk in plain PyTorch) and the backwards of K5, K6 and K9
(``csrc/attention_bwd_mma.cuh``: a query-side kernel that walks the key
tiles three times and writes dQ (and O) and each row's statistics, then
a key-side kernel that walks the query tiles for dK and dV; no atomics;
:func:`_attend_bwd_tiled` is its tile walk).  They need 16-byte-aligned
operands and raise ``ValueError`` for others.  fp32 runs SIMT kernels: a
head whose K and V fit one block's shared memory takes the whole-head
kernels, a longer one the tiled kernels that stream K and V through
shared memory in key tiles (the forward past N ≈ 420, the backward past
N = 208 at D = 64), with the same results.  A head dim other than 8, 16,
32 or 64 raises ``ValueError``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from dfu_multimodal_tpu_torch.ops import _build

_HEAD_DIMS = (8, 16, 32, 64)       # head dims the kernels are built for

_I, _P, _F = _build.I, _build.P, _build.F
_SIGNATURES = {
    "dfu_qkv_attention_fwd": [_I, _I, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    "dfu_qkv_attention_bwd": [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                              _I, _P],
    "dfu_qkv_attention_fwdbwd": [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                                 _I, _F, _I, _P],
    "dfu_attention_fwd": [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                          _P],
    "dfu_attention_bwd": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                          _I, _I, _F, _I, _P],
}


def _lib():
    return _build.load("attention", _SIGNATURES)


def _is_pow2(x: float) -> bool:
    return math.frexp(x)[0] == 0.5


def acc_dtype(t: torch.Tensor) -> torch.dtype:
    """Accumulation dtype of the plain versions: fp32, or fp64 for fp64
    inputs (``torch.autograd.gradcheck``)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


# ------------------------------------------------------- plain versions
#
# The Pallas kernels' numerics (``_softmax_probs_c`` and the kernels
# around it): compute-dtype score operands with fp32 accumulation (q
# pre-scaled by d**-0.5 in the compute dtype when that is a power of two,
# or always with ``prescale`` — the attention-block backward K10's policy
# — else the scores scaled after the product), fp32 softmax statistics with
# P normalised BEFORE P·V, P cast to the compute dtype for o = P·V and
# dv = Pᵀ·do, ds = P∘(dp − rowsum(dp∘P)) cast to the compute dtype,
# dq = ds·k·scale, dk = dsᵀ·q·scale.  q, k, v, do are (B, H, N, D) in the
# compute dtype; results are in the accumulation dtype.


def _probs(q: torch.Tensor, k: torch.Tensor, prescale: bool = False
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(P, P_c): the softmax probabilities, and P rounded to the compute
    dtype, both in the accumulation dtype."""
    dt, acc = q.dtype, acc_dtype(q)
    scale = q.shape[-1] ** -0.5
    kt = k.to(acc).transpose(-1, -2)
    if prescale or _is_pow2(scale):
        s = torch.matmul((q * scale).to(dt).to(acc), kt)
    else:
        s = torch.matmul(q.to(acc), kt) * scale
    p = torch.softmax(s, dim=-1)
    return p, p.to(dt).to(acc)


def _attend(p_c: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.matmul(p_c, v.to(p_c.dtype))


def _attend_two_pass(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     tile: int = 64, defer: bool = False,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The bf16 forward kernel's algorithm (``csrc/attention_fwd_mma.cuh``)
    in plain PyTorch, for the tests: pass 1 walks the key tiles keeping the
    running row max and the running sum of exp(S − max), rescaled when the
    max grows; pass 2 recomputes each tile's S and adds P·V with P =
    exp(S − max) · (1 / sum) rounded to the compute dtype.  Keys past N
    (the last tile's padding) score −inf.  ``defer``: K1's numerics (the
    kernel's DEFER flag, the Pallas ``_attention_head``): pass 1 keeps the
    row max alone; pass 2 adds e = exp(S − max) into the fp32 sum uncast
    and e rounded to the compute dtype times V into O; O / sum at the end.
    ``bias``: ToMe's (B, N) fp32 key bias, added to each tile's scaled S
    in both passes (the kernel's ``bias`` operand).  q, k, v (B, H, N, D)
    in the compute dtype -> o in the accumulation dtype, as
    :func:`_attend`."""
    dt, acc = q.dtype, acc_dtype(q)
    n, d = q.shape[-2:]
    scale = d ** -0.5
    pow2 = _is_pow2(scale)
    qs = ((q * scale).to(dt) if pow2 else q).to(acc)
    pad = -n % tile
    kp, vp = (torch.nn.functional.pad(t.to(acc), (0, 0, 0, pad))
              for t in (k, v))
    past = torch.arange(n + pad, device=q.device) >= n
    bp = (None if bias is None else torch.nn.functional.pad(
        bias.to(acc), (0, pad))[:, None, None, :])

    def scores(j0: int) -> torch.Tensor:
        s = torch.matmul(qs, kp[..., j0:j0 + tile, :].transpose(-1, -2))
        if not pow2:
            s = s * scale
        if bp is not None:
            s = s + bp[..., j0:j0 + tile]
        return s.masked_fill(past[j0:j0 + tile], -math.inf)

    m = torch.full((*q.shape[:-1], 1), -math.inf, dtype=acc,
                   device=q.device)
    l = torch.zeros_like(m)
    for j0 in range(0, n, tile):
        s = scores(j0)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        if not defer:
            l = l * torch.exp(m - m_new) + torch.exp(s - m_new).sum(
                -1, keepdim=True)
        m = m_new
    o = torch.zeros(q.shape, dtype=acc, device=q.device)
    if defer:
        for j0 in range(0, n, tile):
            e = torch.exp(scores(j0) - m)
            l = l + e.sum(-1, keepdim=True)
            o = o + torch.matmul(e.to(dt).to(acc), vp[..., j0:j0 + tile, :])
        return o / l
    inv = 1.0 / l
    for j0 in range(0, n, tile):
        p_c = (torch.exp(scores(j0) - m) * inv).to(dt).to(acc)
        o = o + torch.matmul(p_c, vp[..., j0:j0 + tile, :])
    return o


def _attend_bwd_tiled(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, prescale: bool = False,
                      tile: int = 64) -> Tuple[torch.Tensor, ...]:
    """The bf16 backward kernels' algorithm (``csrc/attention_bwd_mma.cuh``)
    in plain PyTorch, for the tests.  Query side, three passes over the key
    tiles: (a) the running row max and the running sum of exp(S − max),
    rescaled when the max grows; (b) P = exp(S − max) · (1 / sum) in fp32,
    δ += rowsum(dP∘P) and o += P_c·V; (c) dS = P∘(dP − δ) rounded to the
    compute dtype and dq += dS·K.  Key side: walks the query tiles in order
    with the rows' max, 1 / sum and δ (zero past N, as the kernel's stats
    tile is zero-filled there), masks P and dS of the query rows past N to
    0, and adds dv += P_cᵀ·dO and dk += dSᵀ·Q.  Keys past N score −inf on
    the query side.  ``prescale``: q scaled in the compute dtype for every
    head dim (K10).  q, k, v, do (B, H, N, D) in the compute dtype ->
    (o, dq, dk, dv) in the accumulation dtype, as :func:`_grads`."""
    dt, acc = q.dtype, acc_dtype(q)
    n, d = q.shape[-2:]
    scale = d ** -0.5
    pre = prescale or _is_pow2(scale)
    pad = -n % tile
    qp, qsp, kp, vp, dop = (
        torch.nn.functional.pad(t.to(acc), (0, 0, 0, pad))
        for t in (q, (q * scale).to(dt) if pre else q, k, v, do))
    past = torch.arange(n + pad, device=q.device) >= n

    def scores(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        s = torch.matmul(a, b.transpose(-1, -2))
        return s if pre else s * scale

    def key_tile(j0: int):
        """(S masked past N, dP, K tile, V tile) of every query row
        against keys j0 .. j0 + tile - 1."""
        kt, vt = kp[..., j0:j0 + tile, :], vp[..., j0:j0 + tile, :]
        s = scores(qsp, kt).masked_fill(past[j0:j0 + tile], -math.inf)
        return s, torch.matmul(dop, vt.transpose(-1, -2)), kt, vt

    m = torch.full((*qp.shape[:-1], 1), -math.inf, dtype=acc,
                   device=q.device)
    l = torch.zeros_like(m)
    for j0 in range(0, n, tile):                     # (a)
        s = key_tile(j0)[0]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new).sum(
            -1, keepdim=True)
        m = m_new
    inv = 1.0 / l
    delta = torch.zeros_like(m)
    o = torch.zeros(qp.shape, dtype=acc, device=q.device)
    dq = torch.zeros_like(o)
    for j0 in range(0, n, tile):                     # (b)
        s, dp, _, vt = key_tile(j0)
        p = torch.exp(s - m) * inv
        delta = delta + (dp * p).sum(-1, keepdim=True)
        o = o + torch.matmul(p.to(dt).to(acc), vt)
    for j0 in range(0, n, tile):                     # (c)
        s, dp, kt, _ = key_tile(j0)
        p = torch.exp(s - m) * inv
        ds = (p * (dp - delta)).to(dt).to(acc)
        dq = dq + torch.matmul(ds, kt)

    # key side: the stats as the query side stores them (rows < N)
    m, inv, delta = (t.masked_fill(past[:, None], 0.0).transpose(-1, -2)
                     for t in (m, inv, delta))
    dk, dv = torch.zeros_like(o), torch.zeros_like(o)
    for i0 in range(0, n + pad, tile):
        rows = slice(i0, i0 + tile)
        st = scores(kp, qsp[..., rows, :])            # Sᵀ (keys, queries)
        pt = torch.exp(st - m[..., rows]) * inv[..., rows]
        dpt = torch.matmul(vp, dop[..., rows, :].transpose(-1, -2))
        dst = pt * (dpt - delta[..., rows])
        pt, dst = (t.masked_fill(past[rows], 0.0) for t in (pt, dst))
        dv = dv + torch.matmul(pt.to(dt).to(acc), dop[..., rows, :])
        dk = dk + torch.matmul(dst.to(dt).to(acc), qp[..., rows, :])
    return tuple(t[..., :n, :] for t in (o, dq * scale, dk * scale, dv))


def _grads(p, p_c, q, k, v, do):
    acc = p.dtype
    scale = q.shape[-1] ** -0.5
    dv = torch.matmul(p_c.transpose(-1, -2), do.to(acc))
    dp = torch.matmul(do.to(acc), v.to(acc).transpose(-1, -2))
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True))).to(q.dtype).to(acc)
    dq = torch.matmul(ds, k.to(acc)) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.to(acc)) * scale
    return dq, dk, dv


def _unpack(qkv: torch.Tensor, num_heads: int):
    """(B, N, 3C) -> q, k, v views (B, H, N, D)."""
    b, n, c3 = qkv.shape
    heads = qkv.reshape(b, n, 3, num_heads, c3 // (3 * num_heads))
    return heads.permute(2, 0, 3, 1, 4).unbind(0)


def _merge_heads(o: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, H, N, D) -> (B, N, H·D) in ``dtype``."""
    b, h, n, d = o.shape
    return o.to(dtype).transpose(1, 2).reshape(b, n, h * d)


def _pack_grads(dq, dk, dv, dtype: torch.dtype) -> torch.Tensor:
    """(B, H, N, D) x 3 -> (B, N, 3·H·D) packed [dq | dk | dv]."""
    b, h, n, d = dq.shape
    dqkv = torch.stack([dq, dk, dv]).to(dtype)            # (3, B, H, N, D)
    return dqkv.permute(1, 3, 0, 2, 4).reshape(b, n, 3 * h * d)


def _heads_of(do: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, n, c = do.shape
    return do.reshape(b, n, num_heads, c // num_heads).transpose(1, 2)


def qkv_attention_ref(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain version of K6's forward: qkv (B, N, 3C) -> attn (B, N, C)."""
    q, k, v = _unpack(qkv, num_heads)
    return _merge_heads(_attend(_probs(q, k)[1], v), qkv.dtype)


def qkv_attention_bwd_ref(qkv: torch.Tensor, do: torch.Tensor,
                          num_heads: int) -> torch.Tensor:
    """Plain version of K6's backward: (qkv, do (B, N, C)) -> dqkv."""
    q, k, v = _unpack(qkv, num_heads)
    p, p_c = _probs(q, k)
    return _pack_grads(*_grads(p, p_c, q, k, v, _heads_of(do, num_heads)),
                       qkv.dtype)


def qkv_attention_fwdbwd_ref(qkv: torch.Tensor, do: torch.Tensor,
                             num_heads: int, prescale: bool = False
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K5: (qkv, do) -> (attn, dqkv), the softmax once.
    ``prescale``: q scaled in the compute dtype for every head dim (K10)."""
    q, k, v = _unpack(qkv, num_heads)
    p, p_c = _probs(q, k, prescale)
    grads = _grads(p, p_c, q, k, v, _heads_of(do, num_heads))
    return (_merge_heads(_attend(p_c, v), qkv.dtype),
            _pack_grads(*grads, qkv.dtype))


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Plain version of K9's forward: q, k, v (B, H, N, D) -> o."""
    return _attend(_probs(q, k)[1], v).to(q.dtype)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, do: torch.Tensor
                            ) -> Tuple[torch.Tensor, ...]:
    """Plain version of K9's backward: (q, k, v, do) -> (dq, dk, dv)."""
    p, p_c = _probs(q, k)
    return tuple(g.to(q.dtype) for g in _grads(p, p_c, q, k, v, do))


# -------------------------------------------------------------- wrappers


def _check_head(name: str, d: int) -> None:
    if d not in _HEAD_DIMS:
        raise ValueError(f"{name}: no kernel for head dim {d} (head dims "
                         f"{_HEAD_DIMS})")


def _row_stats_scratch(b: int, heads: int, n: int,
                      device: torch.device) -> torch.Tensor:
    """fp32 scratch of a backward kernel: each query row's softmax
    statistics and δ = rowsum(dP∘P), which the query side passes to the
    key side (the bf16 kernels: max, 1 / sum and δ; the fp32 tiled
    kernels: max, sum and δ; unused by the fp32 whole-head kernel)."""
    return torch.empty((3, b * heads * n), dtype=torch.float32,
                       device=device)


def _check_aligned(name: str, **operands: torch.Tensor) -> None:
    """The bf16 kernels copy 16-byte row chunks (cp.async): their
    operands' base addresses must be 16-byte aligned (their strides are,
    for every head dim the kernels take)."""
    for arg, t in operands.items():
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} at address {t.data_ptr():#x} "
                             "is not 16-byte aligned")


def _packed_dims(name: str, qkv: torch.Tensor, num_heads: int,
                 do: Optional[torch.Tensor] = None) -> Tuple[int, int, int]:
    b, n, c3 = qkv.shape
    c = c3 // 3
    if c3 != 3 * c or c % num_heads or (do is not None
                                        and do.shape != (b, n, c)):
        raise ValueError(
            f"{name}: qkv {tuple(qkv.shape)}"
            + ("" if do is None else f", do {tuple(do.shape)}")
            + f" with {num_heads} heads: want (B, N, 3C), (B, N, C) and "
            "C a multiple of the head count")
    return b, n, c // num_heads


def _scale_args(d: int) -> Tuple[float, int]:
    scale = d ** -0.5
    return scale, int(_is_pow2(scale))


def qkv_attention_fwd(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """K6 forward: qkv (B, N, 3C) -> attn (B, N, C) in qkv's dtype.  The
    call is the op ``dfu::qkv_attention_fwd`` (CPU:
    :func:`qkv_attention_ref`; CUDA: the kernel)."""
    _build.check_device("qkv_attention_fwd", qkv)
    return _QKV_ATTENTION_FWD_OP(qkv, num_heads)


def _qkv_attention_fwd_cuda(qkv: torch.Tensor,
                            num_heads: int) -> torch.Tensor:
    """``dfu::qkv_attention_fwd`` on the card."""
    _build.check_cuda_operands("qkv_attention_fwd", qkv, {"qkv": qkv}, {})
    b, n, d = _packed_dims("qkv_attention_fwd", qkv, num_heads)
    _check_head("qkv_attention_fwd", d)
    _check_aligned("qkv_attention_fwd", qkv=qkv)
    lib = _lib()
    attn = qkv.new_empty((b, n, num_heads * d))
    _build.check(lib, lib.dfu_qkv_attention_fwd(
        qkv.device.index, _build.DTYPE_CODES[qkv.dtype], qkv.data_ptr(),
        attn.data_ptr(), b, n, num_heads, d, *_scale_args(d),
        _build.stream_of(qkv)), "qkv_attention_fwd")
    qkv_attention_fwd.launches += 1
    return attn


_QKV_ATTENTION_FWD_OP = _build.define_op(
    "qkv_attention_fwd", "(Tensor qkv, int num_heads) -> Tensor",
    cpu=lambda *a: qkv_attention_ref(*a), cuda=_qkv_attention_fwd_cuda,
    fake=lambda qkv, num_heads: qkv.new_empty(
        (*qkv.shape[:-1], qkv.shape[-1] // 3)))


def qkv_attention_bwd(qkv: torch.Tensor, do: torch.Tensor,
                      num_heads: int) -> torch.Tensor:
    """K6 backward: (qkv (B, N, 3C), do (B, N, C)) -> dqkv (B, N, 3C)."""
    if qkv.device.type == "cpu":
        return qkv_attention_bwd_ref(qkv, do, num_heads)
    _build.check_cuda_operands("qkv_attention_bwd", qkv,
                               {"qkv": qkv, "do": do}, {})
    b, n, d = _packed_dims("qkv_attention_bwd", qkv, num_heads, do)
    _check_head("qkv_attention_bwd", d)
    _check_aligned("qkv_attention_bwd", qkv=qkv, do=do)
    lib = _lib()
    dqkv = torch.empty_like(qkv)
    stats = _row_stats_scratch(b, num_heads, n, qkv.device)
    _build.check(lib, lib.dfu_qkv_attention_bwd(
        qkv.device.index, _build.DTYPE_CODES[qkv.dtype], qkv.data_ptr(),
        do.data_ptr(), dqkv.data_ptr(), stats.data_ptr(), b, n, num_heads, d,
        *_scale_args(d),
        _build.stream_of(qkv)), "qkv_attention_bwd")
    qkv_attention_bwd.launches += 1
    return dqkv


def qkv_attention_fwdbwd(qkv: torch.Tensor, do: torch.Tensor,
                         num_heads: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5: (qkv (B, N, 3C), do (B, N, C)) -> (attn (B, N, C), dqkv
    (B, N, 3C)) in qkv's dtype, softmax computed once per head."""
    if qkv.device.type == "cpu":
        return qkv_attention_fwdbwd_ref(qkv, do, num_heads)
    _build.check_cuda_operands("qkv_attention_fwdbwd", qkv,
                               {"qkv": qkv, "do": do}, {})
    b, n, d = _packed_dims("qkv_attention_fwdbwd", qkv, num_heads, do)
    _check_head("qkv_attention_fwdbwd", d)
    _check_aligned("qkv_attention_fwdbwd", qkv=qkv, do=do)
    lib = _lib()
    attn = torch.empty_like(do)
    dqkv = torch.empty_like(qkv)
    stats = _row_stats_scratch(b, num_heads, n, qkv.device)
    _build.check(lib, lib.dfu_qkv_attention_fwdbwd(
        qkv.device.index, _build.DTYPE_CODES[qkv.dtype], qkv.data_ptr(),
        do.data_ptr(), attn.data_ptr(), dqkv.data_ptr(), stats.data_ptr(), b,
        n, num_heads, d, *_scale_args(d), _build.stream_of(qkv)),
        "qkv_attention_fwdbwd")
    qkv_attention_fwdbwd.launches += 1
    return attn, dqkv


def _bhnd_dims(name: str, q: torch.Tensor, *others: torch.Tensor):
    if q.dim() != 4 or any(t.shape != q.shape for t in others):
        raise ValueError(f"{name}: want q, k, v (and do) of one shape "
                         f"(B, H, N, D), got "
                         f"{[tuple(t.shape) for t in (q, *others)]}")
    return q.shape


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """K9 forward: q, k, v (B, H, N, D) -> o (B, H, N, D) in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v)
    _build.check_cuda_operands("flash_attention_fwd", q,
                               {"q": q, "k": k, "v": v}, {})
    b, h, n, d = _bhnd_dims("flash_attention_fwd", q, k, v)
    _check_head("flash_attention_fwd", d)
    _check_aligned("flash_attention_fwd", q=q, k=k, v=v)
    lib = _lib()
    o = torch.empty_like(q)
    _build.check(lib, lib.dfu_attention_fwd(
        q.device.index, _build.DTYPE_CODES[q.dtype], q.data_ptr(),
        k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, n, d,
        *_scale_args(d), _build.stream_of(q)), "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return o


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """K9 backward: (q, k, v, do), all (B, H, N, D) -> (dq, dk, dv)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, do)
    _build.check_cuda_operands("flash_attention_bwd", q,
                               {"q": q, "k": k, "v": v, "do": do}, {})
    b, h, n, d = _bhnd_dims("flash_attention_bwd", q, k, v, do)
    _check_head("flash_attention_bwd", d)
    _check_aligned("flash_attention_bwd", q=q, k=k, v=v, do=do)
    lib = _lib()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    stats = _row_stats_scratch(b, h, n, q.device)
    _build.check(lib, lib.dfu_attention_bwd(
        q.device.index, _build.DTYPE_CODES[q.dtype], q.data_ptr(),
        k.data_ptr(), v.data_ptr(), do.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), stats.data_ptr(), b, h, n, d,
        *_scale_args(d),
        _build.stream_of(q)), "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


# launch counts: one per call that ran the kernel (CPU calls do not count)
qkv_attention_fwd.launches = 0
qkv_attention_bwd.launches = 0
qkv_attention_fwdbwd.launches = 0
flash_attention_fwd.launches = 0
flash_attention_bwd.launches = 0


# -------------------------------------------------------------- autograd


class QkvAttention(torch.autograd.Function):
    """Trainable packed-qkv attention (the JAX ``_qkv_attention`` custom
    VJP): forward K6, backward K6's own kernel; saves only qkv."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
        ctx.save_for_backward(qkv)
        ctx.num_heads = num_heads
        return qkv_attention_fwd(qkv, num_heads)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (qkv,) = ctx.saved_tensors
        return qkv_attention_bwd(qkv, g.contiguous(), ctx.num_heads), None


class FlashAttention(torch.autograd.Function):
    """Trainable (B, H, N, D) attention (the JAX ``_flash_attention``
    custom VJP): forward and backward K9; saves only q, k, v."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(q, k, v)
        return flash_attention_fwd(q, k, v)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return flash_attention_bwd(*ctx.saved_tensors, g.contiguous())


def qkv_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Packed-qkv attention (B, N, 3C) -> (B, N, C), trainable."""
    return QkvAttention.apply(qkv, num_heads)


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Softmax attention over q, k, v (B, H, N, D) -> (B, H, N, D),
    trainable."""
    return FlashAttention.apply(q, k, v)
