"""Fused stride-1 ResNet bottleneck and whole-stage chain: hand-written
Hopper kernels, plain versions, and the rematerialising backwards.

Counterpart of ``dfu_multimodal_tpu/ops/resnet_block.py::
fused_bottleneck`` (the Pallas ``_bottleneck_kernel`` and
``_bottleneck_proj_kernel``, K11) and ``::fused_stage`` (the Pallas
``_stage_kernel``, K12: a stage's identity bottlenecks in one launch).
With BatchNorm folded into the convolutions by the caller
(``models/resnet.py::Bottleneck.folded_weights``):

    out = relu(sc + T(conv3(relu(conv3x3(relu(conv1 x + b1)) + b2)) + b3))

with sc = x (identity, Cin == Cout) or T(x @ wd + bd) (projection).
Arguments keep the JAX layouts: x (B, H, W, Cin) NHWC in the compute
dtype; w1 (Cin, Cmid), w2 (9·Cmid, Cmid) row-stacked 3x3 taps ((dy, dx)
row-major, i.e. HWIO reshaped), w3 (Cmid, Cout), wd (Cin, Cout) in the
compute dtype; biases fp32.

Dispatch is by device only: a CPU tensor takes the plain version
(:func:`bottleneck_ref`, :func:`stage_ref`), a CUDA tensor launches
``csrc/resnet_block.cu`` or raises.  In bf16 :func:`fused_bottleneck`
runs its products on ``csrc/gemm_sm90.cuh``'s TMA + wgmma GEMM (the 3x3
as its implicit-GEMM mode), and :func:`fused_stage` walks the same tiles
in one cooperative launch; both take channel counts that are multiples
of 8 and 16-byte-aligned operands.  fp32 runs ``csrc/gemm_tile.cuh``'s
SIMT tiles.  :class:`FusedBottleneck` and
:class:`FusedStage` are the ``torch.autograd.Function``s: forward the
kernel, backward autograd through the plain version from the saved
inputs (remat, as the JAX custom VJPs; there is no backward kernel).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from dfu_multimodal_tpu_torch.ops import _build
from dfu_multimodal_tpu_torch.ops.attention import acc_dtype as _acc
from dfu_multimodal_tpu_torch.ops.vit_block import _mm_f32

_I, _P = _build.I, _build.P
_SIGNATURES = {
    "dfu_bottleneck": [_I, _I] + [_P] * 13 + [_I] * 6 + [_P],
    "dfu_resnet_stage": [_I, _I, _P, _P, _P, _I] + [_P] * 4 + [_I] * 4
    + [_P],
    "dfu_stage_max_blocks": [],
    "dfu_stage_tile": [_I, _I, _I, _P, _P],
}


def _lib():
    return _build.load("resnet_block", _SIGNATURES)


def bottleneck_ref(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor, w3: torch.Tensor,
                   b3: torch.Tensor, wd: Optional[torch.Tensor] = None,
                   bd: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`fused_bottleneck` (mirrors the JAX
    ``_bottleneck_ref``): fp32 accumulation, y1 and y2 rounded to the
    compute dtype after bias and ReLU, y3 rounded after its bias, the
    projection shortcut rounded before the add, and the residual add and
    ReLU in the compute dtype."""
    acc = _acc(x)
    cmid = w1.shape[1]
    y1 = torch.relu(_mm_f32(x, w1) + b1.to(acc)).to(x.dtype)
    w2k = w2.to(acc).reshape(3, 3, cmid, cmid).permute(3, 2, 0, 1)  # OIHW
    y2 = F.conv2d(y1.to(acc).permute(0, 3, 1, 2), w2k, padding=1)
    y2 = torch.relu(y2.permute(0, 2, 3, 1) + b2.to(acc)).to(x.dtype)
    y3 = (_mm_f32(y2, w3) + b3.to(acc)).to(x.dtype)
    sc = x if wd is None else (_mm_f32(x, wd) + bd.to(acc)).to(x.dtype)
    return torch.relu(sc + y3)


def fused_bottleneck(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                     w2: torch.Tensor, b2: torch.Tensor, w3: torch.Tensor,
                     b3: torch.Tensor, wd: Optional[torch.Tensor] = None,
                     bd: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One stride-1 bottleneck with BatchNorm pre-folded.  x (B, H, W, Cin)
    contiguous NHWC; returns (B, H, W, Cout) contiguous in x's dtype.
    ``wd``/``bd`` give the projection shortcut, else Cin == Cout.  bf16
    needs Cin, Cmid and Cout multiples of 8 and 16-byte-aligned x and
    weights (ValueError otherwise).  Counts ``fused_bottleneck.launches``
    (identity) and ``.proj_launches``."""
    if (wd is None) != (bd is None):
        raise ValueError("fused_bottleneck: give both wd and bd, or neither")
    if x.device.type == "cpu":
        return bottleneck_ref(x, w1, b1, w2, b2, w3, b3, wd, bd)
    proj = wd is not None
    compute = {"x": x, "w1": w1, "w2": w2, "w3": w3}
    fp32 = {"b1": b1, "b2": b2, "b3": b3}
    if proj:
        compute["wd"], fp32["bd"] = wd, bd
    _build.check_cuda_operands("fused_bottleneck", x, compute, fp32)
    if x.dim() != 4:
        raise ValueError(f"fused_bottleneck: x {tuple(x.shape)}, want "
                         f"(B, H, W, C)")
    bsz, h, w, cin = x.shape
    cmid, cout = w1.shape[-1], w3.shape[-1]
    want = {"w1": (cin, cmid), "b1": (cmid,), "w2": (9 * cmid, cmid),
            "b2": (cmid,), "w3": (cmid, cout), "b3": (cout,)}
    if proj:
        want.update(wd=(cin, cout), bd=(cout,))
    got = {k: tuple(t.shape) for k, t in {**compute, **fp32}.items()
           if k != "x"}
    if got != want or (not proj and cin != cout):
        raise ValueError(
            f"fused_bottleneck: x {tuple(x.shape)} with {got}; want {want}"
            + ("" if proj else " and Cin == Cout (identity shortcut)"))
    if x.dtype == torch.bfloat16:
        _check_tma("fused_bottleneck", x, compute,
                   {"Cin": cin, "Cmid": cmid, "Cout": cout})
    lib, rows = _lib(), bsz * h * w
    y1 = torch.empty((rows, cmid), dtype=x.dtype, device=x.device)
    y2 = torch.empty_like(y1)
    # the shortcut's scratch, but where bf16 runs conv3 and the projection
    # as one product (Cin == Cmid)
    sc = (torch.empty((rows, cout), dtype=x.dtype, device=x.device)
          if proj and (x.dtype != torch.bfloat16 or cin != cmid) else None)
    out = torch.empty((bsz, h, w, cout), dtype=x.dtype, device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    _build.check(lib, lib.dfu_bottleneck(
        x.device.index, _build.DTYPE_CODES[x.dtype], x.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        w3.data_ptr(), b3.data_ptr(), ptr(wd), ptr(bd), y1.data_ptr(),
        y2.data_ptr(), ptr(sc), out.data_ptr(), rows, h, w, cin, cmid, cout,
        _build.stream_of(x)), "fused_bottleneck")
    if proj:
        fused_bottleneck.proj_launches += 1
    else:
        fused_bottleneck.launches += 1
    return out


def _check_tma(name: str, x: torch.Tensor, operands: dict,
               channels: dict) -> None:
    """Raise ValueError unless the bf16 TMA + wgmma products take these
    operands: every channel count (each a row stride) a multiple of 8
    elements (16 bytes; the 3x3's gather also copies 16-byte chunks of one
    tap) and every base 16-byte aligned."""
    bad = {k: v for k, v in channels.items() if v % 8}
    if bad:
        raise ValueError(
            f"{name}: bf16 takes channel counts that are multiples of 8, got "
            f"{bad} (x {tuple(x.shape)})")
    for key, t in operands.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: bf16 {key} must be 16-byte aligned")


# launch counts: one per call that ran the kernels (CPU calls do not count)
fused_bottleneck.launches = 0
fused_bottleneck.proj_launches = 0


class FusedBottleneck(torch.autograd.Function):
    """Trainable :func:`fused_bottleneck` (the JAX custom VJP): forward
    the kernel, saving only its inputs; backward rematerialises through
    :func:`bottleneck_ref` under autograd (Grad-CAM differentiates the
    serving forward).  ``apply(x, w1, b1, w2, b2, w3, b3, wd, bd)`` with
    ``wd = bd = None`` for the identity shortcut."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, w3, b3, wd, bd):
        ctx.save_for_backward(x, w1, b1, w2, b2, w3, b3, wd, bd)
        return fused_bottleneck(x, w1, b1, w2, b2, w3, b3, wd, bd)

    @staticmethod
    def backward(ctx, g):
        return remat_grads(bottleneck_ref, ctx, g)


def remat_grads(plain, ctx, g) -> tuple:
    """The gradients an autograd Function's backward returns: autograd
    through ``plain`` run again on the saved inputs (None stays None)."""
    needs = ctx.needs_input_grad
    if not any(needs):
        return (None,) * len(needs)
    with torch.enable_grad():
        inputs = [None if t is None else t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, needs)]
        out = plain(*inputs)
        wanted = [t for t, n in zip(inputs, needs) if n]
        grads = iter(torch.autograd.grad(out, wanted, g))
    return tuple(next(grads) if n else None for n in needs)


# ------------------------------------------------------------ the stage

Block = Tuple[torch.Tensor, ...]
_STAGE_NAMES = ("w1", "b1", "w2", "b2", "w3", "b3")


def stage_ref(x: torch.Tensor, blocks: Sequence[Block]) -> torch.Tensor:
    """Plain version of :func:`fused_stage` (mirrors the JAX
    ``_stage_ref``): :func:`bottleneck_ref` of each identity block in
    turn."""
    for w1, b1, w2, b2, w3, b3 in blocks:
        x = bottleneck_ref(x, w1, b1, w2, b2, w3, b3)
    return x


def _check_stage(x: torch.Tensor, blocks: Sequence[Block]) -> list:
    """Raise unless ``blocks`` is a non-empty sequence of identity
    bottlenecks (w1, b1, w2, b2, w3, b3) on x's C = Cin = Cout, each with
    its own Cmid.  Returns the Cmids."""
    if x.dim() != 4:
        raise ValueError(f"fused_stage: x {tuple(x.shape)}, want "
                         f"(B, H, W, C)")
    if not blocks:
        raise ValueError("fused_stage: blocks is empty")
    c, cmids = x.shape[-1], []
    for i, blk in enumerate(blocks):
        if len(blk) != 6:
            raise ValueError(
                f"fused_stage: block {i} has {len(blk)} tensors; the stage "
                f"takes identity blocks only, (w1, b1, w2, b2, w3, b3) "
                f"(a projection shortcut runs on fused_bottleneck)")
        cmid = blk[0].shape[-1]
        want = {"w1": (c, cmid), "b1": (cmid,), "w2": (9 * cmid, cmid),
                "b2": (cmid,), "w3": (cmid, c), "b3": (c,)}
        got = {k: tuple(t.shape) for k, t in zip(_STAGE_NAMES, blk)}
        if got != want:
            raise ValueError(
                f"fused_stage: block {i} of x {tuple(x.shape)} has {got}; "
                f"want {want} (identity: Cin == Cout == C)")
        cmids.append(cmid)
    return cmids


def fused_stage(x: torch.Tensor, blocks: Sequence[Block]) -> torch.Tensor:
    """A stage's stride-1 identity bottlenecks, BatchNorm pre-folded, in
    ONE kernel launch.  x (B, H, W, C) contiguous NHWC; ``blocks`` a
    sequence of (w1, b1, w2, b2, w3, b3) in :func:`fused_bottleneck`'s
    layouts, each with Cin == Cout == C and its own Cmid.  Returns (B, H,
    W, C) contiguous in x's dtype, equal bit for bit to the chain of
    :func:`fused_bottleneck` calls over the same blocks.  bf16 needs C and
    every Cmid multiples of 8 and 16-byte-aligned x and weights
    (ValueError otherwise).  Counts ``fused_stage.launches``."""
    cmids = _check_stage(x, blocks)
    if x.device.type == "cpu":
        return stage_ref(x, blocks)
    for i, blk in enumerate(blocks):
        w1, b1, w2, b2, w3, b3 = blk
        _build.check_cuda_operands(
            f"fused_stage block {i}", x, {"x": x, "w1": w1, "w2": w2,
                                          "w3": w3},
            {"b1": b1, "b2": b2, "b3": b3})
    if x.dtype == torch.bfloat16:
        for i, (w1, _, w2, _, w3, _) in enumerate(blocks):
            _check_tma(f"fused_stage block {i}", x,
                       {"x": x, "w1": w1, "w2": w2, "w3": w3},
                       {"C": x.shape[-1], "Cmid": cmids[i]})
    lib = _lib()
    if len(blocks) > lib.dfu_stage_max_blocks():
        raise ValueError(f"fused_stage: {len(blocks)} blocks; one launch "
                         f"takes at most {lib.dfu_stage_max_blocks()}")
    bsz, h, w, c = x.shape
    rows = bsz * h * w
    y1 = torch.empty((rows, max(cmids)), dtype=x.dtype, device=x.device)
    y2 = torch.empty_like(y1)
    buf = torch.empty_like(x) if len(blocks) > 1 else None
    out = torch.empty_like(x)
    weights = (ctypes.c_void_p * (6 * len(blocks)))(
        *[t.data_ptr() for blk in blocks for t in blk])
    _build.check(lib, lib.dfu_resnet_stage(
        x.device.index, _build.DTYPE_CODES[x.dtype], x.data_ptr(), weights,
        (ctypes.c_int * len(cmids))(*cmids), len(blocks), y1.data_ptr(),
        y2.data_ptr(), None if buf is None else buf.data_ptr(),
        out.data_ptr(), rows, h, w, c, _build.stream_of(x)), "fused_stage")
    fused_stage.launches += 1
    return out


# launch count: one per call that ran the kernel (CPU calls do not count)
fused_stage.launches = 0

# csrc/gemm_sm90.cuh's tile rows and the least-rounds width rule
# (pick_bn, least_rounds: TILE_FIXED, MN96_MAX_K), mirrored for the CPU
# walk of the stage kernel's schedule (tests/test_torch_resnet_stage.py);
# chip_smoke.py holds the mirror against dfu_stage_tile on the card
_BM, _TILE_FIXED, _MN96_MAX_K = 128, 64, 1024


def _pick_bn(m: int, n: int, k: int, sms: int) -> int:
    """gemm_sm90.cuh::pick_bn for an MN-major B: of the widths 192, 128,
    96 (not past k = 1024) and 64, the one whose rounds of 128-row tiles
    over the SMs cost least, a tile of width w costing w + 64; the first
    of equal costs."""
    best, best_cost = 0, None
    for w in (192, 128, 0 if k > _MN96_MAX_K else 96, 64):
        if w:
            tiles = -(-m // _BM) * -(-n // w)
            cost = -(-tiles // sms) * (w + _TILE_FIXED)
            if best_cost is None or cost < best_cost:
                best, best_cost = w, cost
    return best


def _stage_tile(rows: int, cmid: int, sms: int) -> Tuple[int, int]:
    """The bf16 stage kernel's tile (rows, columns) for a stage of
    ``rows`` rows whose widest Cmid is ``cmid`` (resnet_block.cu::
    stage_tile): K11's shape for the stage's 3x3 (n = Cmid, k = 9·Cmid),
    64 x 64 where 128 x 64 tiles leave SMs idle, else 128 rows at
    pick_bn's width."""
    if -(-rows // _BM) * -(-cmid // 64) < sms:
        return 64, 64
    return _BM, _pick_bn(rows, cmid, 9 * cmid, sms)


class FusedStage(torch.autograd.Function):
    """Trainable :func:`fused_stage` (the JAX custom VJP): forward the
    kernel, saving only x and the weights; backward rematerialises
    through :func:`stage_ref` under autograd.  ``apply(x, *flat)`` with
    ``flat`` the blocks' tensors in order, six per block
    (:meth:`flat`)."""

    @staticmethod
    def flat(blocks: Sequence[Block]) -> list:
        return [t for blk in blocks for t in blk]

    @staticmethod
    def forward(ctx, x, *flat):
        ctx.save_for_backward(x, *flat)
        return fused_stage(x, _blocks(flat))

    @staticmethod
    def backward(ctx, g):
        return remat_grads(lambda x, *flat: stage_ref(x, _blocks(flat)),
                            ctx, g)


def _blocks(flat: Sequence[torch.Tensor]) -> list:
    """Six tensors per block, in order (a short last block is refused by
    fused_stage's checks)."""
    return [tuple(flat[i:i + 6]) for i in range(0, len(flat), 6)]
