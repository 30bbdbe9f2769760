"""K11's bf16 products (``csrc/gemm_sm90.cuh`` launched by
``csrc/resnet_block.cu``) as a plain tile walk on the CPU: the 3x3's
implicit-GEMM A operand as the card builds each 128-row, 64-deep stage of
it, and a bottleneck composed of the walk.

Two ways fill a stage, both in the flat (tap, channel) k order:

- Cmid % 64 == 0 (every ResNet-50 stage): the stage lies inside one tap
  (dy, dx); one TMA box loads y1's flat rows m0 + dy·w + dx .. +127,
  channels 64·kb - tap·Cmid .. +63 (rows outside y1 as zeros), and each
  consumer thread zeroes, in its ldmatrix fragments, the rows whose
  neighbour lies outside their own image (:func:`_tma_stage`);
- other Cmid (multiples of 8): the producer warpgroup's thread t (of 128)
  copies with cp.async the 16-byte chunk t % 8 (8 channels of one tap, k =
  64·kb + 8·(t % 8)) of the tile rows t / 8 + 16j, j < 8, or zeros where
  the neighbour lies outside the row's image, past the last row or past
  k = 9·Cmid, into TMA's 128-byte swizzle (:func:`_gather`, read back as
  wgmma's K-major layout by :func:`_read_stage`).

Both keep each row's (row in image, column) packed as row << 16 |
column, and a row past m as 0x7FFF << 16.  Tolerances, each with its
reason:

- the walk's A against an im2col by ``F.unfold`` in the flat (tap,
  channel) order: equal element for element (a copy), every stage slot
  of the gather written by exactly one (thread, row);
- a bottleneck of the walk (each product summed in 16-deep k steps in k
  order, the tensor cores' order, through gemm_tile.cuh's epilogues)
  against the JAX package's Pallas kernel in interpret mode and against
  the port's plain version: the tolerances of
  ``tests/test_torch_resnet_block.py`` (fp32 2e-5, bf16 2e-2·(1+|ref|)).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dfu_multimodal_tpu.ops import resnet_block as jax_rb
from dfu_multimodal_tpu_torch.ops import resnet_block as rb

torch.set_num_threads(1)

BM, BK, STEP = 128, 64, 16       # the tile's rows, a stage's k, wgmma's k
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}

# tests/test_torch_cuda.py's BOTTLENECK_SHAPES (batch, H=W, Cin, Cmid,
# Cout) at batch 1-2: ResNet-50's stage 1 projection, stage 3 and stage 4
# identity blocks, and two small ragged ones (K = 9·8, 9·24)
SHAPES = [(2, 56, 64, 64, 256), (2, 14, 1024, 256, 1024),
          (1, 7, 2048, 512, 2048), (2, 6, 16, 8, 32), (2, 5, 40, 24, 40)]

# the producer's threads: chunk t % 8 of rows t / 8 + 16j
_T = np.arange(128)
_CC, _RB = _T & 7, _T >> 3
_R = _RB[:, None] + 16 * np.arange(8)[None, :]           # (thread, j)
# the element offset of each (thread, j)'s chunk in the swizzled stage
_SLOT = _R * BK + ((_CC[:, None] ^ (_R & 7)) * 8)


def _image_yx(rows, m, h, w):
    return np.where(rows < m, ((rows // w) % h) << 16 | (rows % w),
                    0x7FFF << 16)


def _inside(yx, dy, dx, h, w):
    yy, xx = (yx >> 16) + dy, (yx & 0xFFFF) + dx
    return (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)


def _tma_stage(y, m0, kb, h, w):
    """The stage's (128, 64) A tile by TMA (c % 64 == 0): the box of y's
    rows shifted by the stage's tap, then the consumers' row masks (rows
    g and g + 8 of each warp's fragments, i.e. every row)."""
    m, c = y.shape
    tap = kb * BK // c
    dy, dx, c0 = tap // 3 - 1, tap % 3 - 1, kb * BK - tap * c
    src = m0 + dy * w + dx + np.arange(BM)
    ok = (src >= 0) & (src < m)
    box = np.where(ok[:, None], y[np.where(ok, src, 0), c0:c0 + BK], 0)
    keep = _inside(_image_yx(m0 + np.arange(BM), m, h, w), dy, dx, h, w)
    return np.where(keep[:, None], box, 0)


def _gather(y, m0, kb, h, w):
    """The stage (tile rows m0.., k = 64·kb..) of the 3x3's A as the CONV
    producer writes it: y (m, c) -> the 128·64 elements of shared memory,
    chunks at TMA's 128-byte swizzle."""
    m, c = y.shape
    rows = m0 + _R
    yx = _image_yx(rows, m, h, w)
    k = kb * BK + 8 * _CC
    k_in = k < 9 * c
    tap = np.where(k_in, k // c, 4)
    dy, dx, ch = tap // 3 - 1, tap % 3 - 1, k - tap * c
    ok = k_in[:, None] & _inside(yx, dy[:, None], dx[:, None], h, w)
    # the source is read only where ok (cp.async's zero fill elsewhere)
    src = np.where(ok, rows + (dy * w + dx)[:, None], 0)
    col = np.where(ok, ch[:, None], 0)
    smem = np.full(BM * BK, np.nan, y.dtype)
    for e in range(8):
        smem[_SLOT + e] = np.where(ok, y[src, col + e], 0)
    return smem


def _read_stage(smem):
    """The (128, 64) A tile a K-major 128-byte-swizzled descriptor reads."""
    r, kk = np.meshgrid(np.arange(BM), np.arange(BK), indexing="ij")
    return smem[r * BK + ((kk // 8) ^ (r & 7)) * 8 + kk % 8]


def _walk_a(y, h, w, path=None):
    """The 3x3's whole A, stage by stage, (m tiles·128, k stages·64), by
    ``path`` ("tma" or "gather"; default: the card's for y's Cmid)."""
    m, c = y.shape
    path = path or ("tma" if c % BK == 0 else "gather")
    tiles, stages = -(-m // BM), -(-9 * c // BK)
    a = np.empty((tiles * BM, stages * BK), y.dtype)
    for t in range(tiles):
        for kb in range(stages):
            a[t * BM:(t + 1) * BM, kb * BK:(kb + 1) * BK] = (
                _tma_stage(y, t * BM, kb, h, w) if path == "tma" else
                _read_stage(_gather(y, t * BM, kb, h, w)))
    return a


def _im2col(y, b, h, w):
    """(b·h·w, 9·c): row r, column tap·c + channel, taps (dy, dx)
    row-major, zeros outside each image."""
    c = y.shape[1]
    u = F.unfold(torch.from_numpy(y).reshape(b, h, w, c).permute(0, 3, 1, 2),
                 3, padding=1)                       # (b, c·9, h·w)
    return u.reshape(b, c, 9, h * w).permute(0, 3, 2, 1).reshape(
        b * h * w, 9 * c).numpy()


def test_every_stage_slot_is_written_once():
    assert np.array_equal(np.sort((_SLOT[..., None] + np.arange(8)).ravel()),
                          np.arange(BM * BK))


# the gather takes every Cmid (a multiple of 8), TMA stages Cmid % 64 == 0
@pytest.mark.parametrize("shape,path", [(s, "gather") for s in SHAPES] + [
    (s, "tma") for s in SHAPES if s[3] % BK == 0])
def test_conv_a_equals_im2col(shape, path):
    b, hw, _, cmid, _ = shape
    m = b * hw * hw
    y = np.random.default_rng(cmid).integers(
        1, 1000, (m, cmid)).astype(np.float32)       # no zeros of its own
    a = _walk_a(y, hw, hw, path)
    assert not np.isnan(a).any()
    np.testing.assert_array_equal(a[:m, :9 * cmid], _im2col(y, b, hw, hw))
    assert not a[m:].any() and not a[:, 9 * cmid:].any()


def _k16(a, b):
    """fp32 a (m, k) · b (k, n) summed in 16-deep steps in k order."""
    acc = torch.zeros((a.shape[0], b.shape[1]))
    for k0 in range(0, a.shape[1], STEP):
        acc += a[:, k0:k0 + STEP].float() @ b[k0:k0 + STEP].float()
    return acc


def _walk_bottleneck(x, w1, b1, w2, b2, w3, b3, wd=None, bd=None):
    """fused_bottleneck as the bf16 chain computes it: conv1, the 3x3 on
    the walk's A, [projection], conv3, with gemm_tile.cuh's epilogues
    (EPI_BIAS_RELU, EPI_BIAS, EPI_BIAS_RESID_RELU) in x's dtype."""
    bsz, h, w, cin = x.shape
    m, dt = bsz * h * w, x.dtype
    rows = x.reshape(m, cin)
    y1 = torch.relu(_k16(rows, w1) + b1).to(dt)
    a = torch.from_numpy(_walk_a(y1.float().numpy(), h, w))
    cmid = w1.shape[1]
    y2 = torch.relu(_k16(a[:m, :9 * cmid], w2) + b2).to(dt)
    sc = rows if wd is None else (_k16(rows, wd) + bd).to(dt)
    y3 = (_k16(y2, w3) + b3).to(dt)
    out = torch.relu(sc.float() + y3.float()).to(dt)
    return out.reshape(bsz, h, w, -1)


def _args(shape, dtype, seed):
    b, hw, cin, cmid, cout = shape
    rng = np.random.default_rng(seed)

    def f(*s, scale=1.0):
        return (scale * rng.standard_normal(s)).astype(np.float32)

    x = f(b, hw, hw, cin)
    args = [f(cin, cmid, scale=cin ** -0.5), f(cmid, scale=0.1),
            f(9 * cmid, cmid, scale=(9 * cmid) ** -0.5), f(cmid, scale=0.1),
            f(cmid, cout, scale=cmid ** -0.5), f(cout, scale=0.1)]
    if cin != cout:
        args += [f(cin, cout, scale=cin ** -0.5), f(cout, scale=0.1)]
    return x, args


def _torch(x, args, dtype):
    return (torch.from_numpy(x).to(dtype),
            [torch.from_numpy(a).to(dtype if i % 2 == 0 else torch.float32)
             for i, a in enumerate(args)])


def _err(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.max(np.abs(got - ref) / (1.0 + np.abs(ref))))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 6, 32, 8, 32), (4, 6, 16, 8, 32),
                                   (2, 5, 40, 24, 40)])
def test_walk_bottleneck_matches_pallas_interpret(shape, dtype):
    x, args = _args(shape, dtype, seed=20)
    xt, at = _torch(x, args, dtype)
    got = _walk_bottleneck(xt, *at).float().numpy()
    xj = jnp.asarray(x, JAX_DTYPES[dtype])
    aj = [jnp.asarray(a, JAX_DTYPES[dtype] if i % 2 == 0 else jnp.float32)
          for i, a in enumerate(args)]
    ref = np.asarray(jax_rb.fused_bottleneck(xj, *aj, interpret=True),
                     np.float32)
    err = _err(got, ref)
    print(f"\nwalk bottleneck {shape} {dtype} vs Pallas interpret: "
          f"{err:.3e} (tol {TOL[dtype]:g})")
    np.testing.assert_allclose(got, ref, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("shape", SHAPES)
def test_walk_bottleneck_matches_plain(shape):
    """At the card tests' shapes (batch 1-2), bf16: the walk against
    bottleneck_ref."""
    b, hw, cin, cmid, cout = shape
    x, args = _args((1, hw, cin, cmid, cout), torch.bfloat16,
                    seed=cmid)
    xt, at = _torch(x, args, torch.bfloat16)
    got = _walk_bottleneck(xt, *at)
    ref = rb.bottleneck_ref(xt, *at)
    err = _err(got.float().numpy(), ref.float().numpy())
    print(f"\nwalk bottleneck {shape[1:]} B=1 bf16 vs bottleneck_ref: "
          f"{err:.3e} (tol {TOL[torch.bfloat16]:g})")
    assert got.shape == ref.shape and err <= TOL[torch.bfloat16]
