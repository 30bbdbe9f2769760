"""K10's bf16 weight-gradient products (``csrc/gemm_sm90.cuh``'s WGRAD
mode, launched by ``csrc/attn_block_bwd.cu``) as a plain tile walk on the
CPU, and K10 composed of the walk.

WGRAD computes partial[z] = a[rows of chunk z]ᵀ · b[rows of chunk z] over
WG_ROWS-row chunks of a (rows, m) and b (rows, n), both row-major bf16:
K is the rows, so A (= aᵀ) is read MN-major.  Each 128 x 128 output tile
of a chunk loads, per 64-row stage, two 64-column boxes of a and two of b
by TMA under the 128-byte swizzle; each consumer warpgroup reads its box
of a through wgmma's transposed-A descriptor (start 2048 bytes a k16
step, lbo 8 KB, sbo 1024), and sums 16-deep steps in row order into fp32.
A chunk's k loop stops at its own last stage (64-row stages, WG_ROWS a
multiple of 64), the last chunk's rows past B·N load as TMA's zeros, and
a second pass sums the partials in chunk order.

Tolerances, each with its reason:

- the swizzled box read back by the descriptor against aᵀ: equal element
  for element (a copy);
- the walk against a walk of the WMMA kernel it replaces
  (``wgrad_bf16_wmma``: 32-row k stages of two 16-deep steps, rows past
  the chunk's end zero): equal bit for bit, the same 16-deep products in
  the same order (the extra zero steps add +0);
- the walk against aᵀ·b in fp64: fp32 summation, 1e-5·(1 + max|ref|);
- K10 composed of the walk against the JAX ``_attn_block_bwd_fused`` in
  interpret mode and against ``attn_block_bwd_fused_ref``: the budgets of
  ``tests/test_torch_attn_block_bwd.py`` (2e-4 in fp32, 5e-2 in bf16).
"""

import numpy as np
import pytest
import torch

from dfu_multimodal_tpu_torch.ops import attention as at
from dfu_multimodal_tpu_torch.ops import vit_block as vb
from test_torch_attn_block_bwd import NAMES, _compare, _inputs, _jax_grads

torch.set_num_threads(1)

WG_ROWS, BK, STEP, BOX = 1024, 64, 16, 64     # csrc/gemm_sm90.cuh
WMMA_BK = 32                                  # the WMMA kernel's k stage


def _swizzle(off):
    """TMA's and wgmma's 128-byte swizzle of byte offsets in a 1024-byte
    aligned atom: the 16-byte chunk index XOR the 128-byte row index."""
    return off ^ (((off >> 7) & 7) << 4)


def _tma_box(a, r0, c0):
    """The box of ``a`` (rows, m) at rows r0 .. r0 + 63, columns c0 ..
    c0 + 63 as TMA writes it to shared memory under the 128-byte swizzle:
    4096 bf16 slots (element e at byte 2e), zeros outside ``a``."""
    box = np.zeros((BOX, BOX), a.dtype)
    part = a[r0:r0 + BOX, c0:c0 + BOX]
    box[:part.shape[0], :part.shape[1]] = part
    r, c = np.meshgrid(np.arange(BOX), np.arange(BOX), indexing="ij")
    smem = np.full(BOX * BOX, np.nan, a.dtype)
    smem[_swizzle(r * 128 + 2 * c) // 2] = box
    return smem


def _read_transposed_a(smem, kk, lbo=8192, sbo=1024):
    """The (64 x 16) A operand of k16 step ``kk`` that wgmma reads through
    an MN-major (transposed) 128-byte-swizzled descriptor at byte 2048·kk:
    A[i, j] at (j // 8)·sbo + (j % 8)·128 + (i // 64)·lbo + 2·(i % 64),
    swizzled.  One box holds i < 64, so lbo is not reached."""
    i, j = np.meshgrid(np.arange(BOX), np.arange(STEP), indexing="ij")
    off = (2048 * kk + (j // 8) * sbo + (j % 8) * 128 + (i // 64) * lbo
           + 2 * (i % 64))
    return smem[_swizzle(off) // 2]


@pytest.mark.parametrize("rows,r0", [(64, 0), (3152, 3136), (2128, 2048)])
def test_transposed_a_box_reads_back_a_transposed(rows, r0):
    """Every k16 step of a stage's box, read as the descriptor reads it,
    is aᵀ of its 16 rows (zeros past the last row)."""
    a = np.random.default_rng(rows).integers(1, 1000, (rows, 96)).astype(
        np.float32)
    for c0 in (0, 64):                        # a full box and a ragged one
        smem = _tma_box(a, r0, c0)
        assert not np.isnan(smem).any()
        padded = np.zeros((BOX, BOX), np.float32)
        part = a[r0:r0 + BOX, c0:c0 + BOX]
        padded[:part.shape[0], :part.shape[1]] = part
        for kk in range(BK // STEP):
            np.testing.assert_array_equal(
                _read_transposed_a(smem, kk),
                padded[STEP * kk:STEP * (kk + 1)].T)


def _rows(t, r0, r1, end):
    """Rows r0 .. r1 - 1 of t in fp32, rows at or past ``end`` zero."""
    out = torch.zeros((r1 - r0, t.shape[1]))
    hi = min(r1, end)
    if hi > r0:
        out[:hi - r0] = t[r0:hi].float()
    return out


def _wgrad_walk(a, b):
    """WGRAD's partials and their chunk-order sum: chunk z over rows
    z·WG_ROWS.., its k loop ceil(chunk rows / 64) stages of four 16-deep
    steps in row order (rows past the last row zero); then out = Σ_z
    partial[z] in z order from 0.  a (rows, m), b (rows, n)."""
    rows = a.shape[0]
    parts = []
    for z0 in range(0, rows, WG_ROWS):
        stages = -(-min(WG_ROWS, rows - z0) // BK)
        acc = torch.zeros((a.shape[1], b.shape[1]))
        for k0 in range(z0, z0 + stages * BK, STEP):
            acc += _rows(a, k0, k0 + STEP, rows).t() @ _rows(b, k0, k0 + STEP,
                                                            rows)
        parts.append(acc)
    out = torch.zeros_like(parts[0])
    for p in parts:
        out += p
    return out, parts


def _wmma_walk(a, b):
    """``wgrad_bf16_wmma``'s order, which WGRAD replaced: per chunk, 32-row
    k stages of two 16-deep steps, rows past the chunk's end zero; then the
    same chunk-order sum."""
    rows = a.shape[0]
    out = torch.zeros((a.shape[1], b.shape[1]))
    for z0 in range(0, rows, WG_ROWS):
        z1 = min(rows, z0 + WG_ROWS)
        acc = torch.zeros_like(out)
        for k0 in range(z0, z1, WMMA_BK):
            for kk in range(0, WMMA_BK, STEP):
                acc += (_rows(a, k0 + kk, k0 + kk + STEP, z1).t()
                        @ _rows(b, k0 + kk, k0 + kk + STEP, z1))
        out += acc
    return out


# rows: one partial chunk; ViT-B/16's B = 16 (3152: a last chunk of 80
# rows); three chunks ending on a 64-row stage; m, n: multiples of 8 that
# leave a 128-wide tile's second box partly or wholly outside
@pytest.mark.parametrize("rows,m,n", [(40, 32, 96), (3152, 64, 192),
                                      (2112, 72, 40)])
def test_wgrad_walk_equals_the_wmma_order_and_the_product(rows, m, n):
    rng = np.random.default_rng(rows + m)
    a = torch.from_numpy(rng.standard_normal((rows, m)).astype(
        np.float32)).bfloat16()
    b = torch.from_numpy(rng.standard_normal((rows, n)).astype(
        np.float32)).bfloat16()
    out, parts = _wgrad_walk(a, b)
    assert len(parts) == -(-rows // WG_ROWS)
    assert torch.equal(out, _wmma_walk(a, b))
    ref = a.double().t() @ b.double()
    err = float((out.double() - ref).abs().max())
    print(f"\nwgrad walk rows={rows} ({m}, {n}) vs fp64 aᵀ·b: {err:.3e}")
    assert err <= 1e-5 * (1 + float(ref.abs().max()))


def _k16(a, b):
    """fp32 a (r, k) · b (k, n) in 16-deep k steps in k order (the wgmma
    GEMM's data products)."""
    acc = torch.zeros((a.shape[0], b.shape[1]))
    for k0 in range(0, a.shape[1], STEP):
        acc += a[:, k0:k0 + STEP].float() @ b[k0:k0 + STEP].float()
    return acc


def _k10_walk(x, g, g1, b1, wqkv, bqkv, wproj, bproj, heads):
    """K10 as its bf16 kernels compute it: LN1; qkv = T(y·wqkv + bqkv),
    dattn = T(g·wprojᵀ) in 16-deep k steps; the attention step's plain
    version with K10's q prescale; dwproj = attnᵀ·g and dwqkv = yᵀ·dqkv by
    the WGRAD walk; the bias column sums; dy = dqkv·wqkvᵀ in fp32; the LN
    backward.  Each gradient rounded to its parameter's dtype."""
    bsz, n, c = x.shape
    dt = x.dtype
    y = vb._layernorm_f32(x, g1, b1).to(dt).reshape(-1, c)
    g2 = g.reshape(-1, c)
    qkv = (_k16(y, wqkv) + bqkv).to(dt).reshape(bsz, n, 3 * c)
    dattn = _k16(g2, wproj.t()).to(dt).reshape(bsz, n, c)
    attn, dqkv = at.qkv_attention_fwdbwd_ref(qkv, dattn, heads, True)
    attn, dqkv = attn.reshape(-1, c), dqkv.reshape(-1, 3 * c)
    dy = _k16(dqkv, wqkv.t()).reshape(bsz, n, c)
    dx, dg1, db1 = vb._ln_bwd_ref(x, g, dy, g1)
    grads = (dx, dg1, db1, _wgrad_walk(y, dqkv)[0], dqkv.float().sum(0),
             _wgrad_walk(attn, g2)[0], g2.float().sum(0))
    return tuple(t.to(p.dtype) for t, p in
                 zip(grads, (x, g1, b1, wqkv, bqkv, wproj, bproj)))


# C = 64, 2 heads (D = 32), B = 2: 40 tokens, and ViT-B/16's 197
@pytest.mark.parametrize("n,dtype", [(40, torch.float32),
                                     (40, torch.bfloat16),
                                     (197, torch.bfloat16)])
def test_k10_of_the_walk_matches_pallas_interpret_and_plain(n, dtype):
    import jax.numpy as jnp
    b, c, heads = 2, 64, 2
    args, g = _inputs(b, n, c, seed=30 + n)
    t = [torch.from_numpy(a).to(dtype if name in ("x", "wqkv", "wproj")
                                else torch.float32)
         for name, a in zip(NAMES, args)]
    x, g1, b1, wqkv, bqkv, wproj, bproj = t
    gt = torch.from_numpy(g).to(dtype)
    got = _k10_walk(x, gt, g1, b1, wqkv, bqkv, wproj, bproj, heads)
    tol = 2e-4 if dtype == torch.float32 else 5e-2
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    _compare(got, _jax_grads(args, g, heads, jdt), tol)
    plain = vb.attn_block_bwd_fused_ref(x, gt, g1, b1, wqkv, bqkv, wproj,
                                        bproj, heads)
    for name, o, r in zip(NAMES, got, plain):
        assert o.dtype == r.dtype, name
        np.testing.assert_allclose(o.float().numpy(), r.float().numpy(),
                                   rtol=tol, atol=tol, err_msg=name)
