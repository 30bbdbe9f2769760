"""The bf16 K1 kernels' algorithm on the CPU: the attention step of
csrc/attention_fwd_mma.cuh with its DEFER flag (64-key tiles; pass 1 the
row max, pass 2 e = exp(S − max), its uncast fp32 sum and bf16(e)·V,
then O / sum), as the port's plain tile walk runs it inside the block
(``vit_block._attn_block_tiled_ref``, over
``attention._attend_two_pass(defer=True)``), against the JAX package's K1
(``attn_block`` with ``interpret=True``) and against the port's plain
version ``attn_block_ref``, on seeded numpy inputs.

Widths: C = 64 at D = 16 and 32 (d**-0.5 a power of two at 16, so q is
scaled in the compute dtype; the fp32 scores scaled after the product at
32), C = 128 at D = 128.  Token counts: one partial tile (N = 5), 40 of
64, ViT-B/16's 197 (the last tile 5 keys) and 577 (a 384² image, ten
tiles).  Tolerances:

- against the Pallas K1: fp32 2e-5, bf16 5e-2 (rtol and atol), the
  budgets of tests/test_torch_attention_fwd.py;
- against ``attn_block_ref``, which normalises the softmax before P·V as
  the JAX ``_attn_block_ref`` does: fp32 2e-5; bf16 the one-ulp
  divergence that ``_attn_block_ref``'s docstring names, one bf16 step
  (2^-7 relative) of the output or of the projection o it adds:
  2^-7·(1 + |ref|), rtol and atol (measured: at most exactly that).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfu_multimodal_tpu.ops import vit_block as jax_vit_block
from dfu_multimodal_tpu_torch.ops import attention as at
from dfu_multimodal_tpu_torch.ops import vit_block as vb

torch.set_num_threads(1)

# (batch, width, heads): head dims 16, 32 and 128
WIDTHS = [(2, 64, 4), (2, 64, 2), (1, 128, 1)]
TOKENS = [5, 40, 197, 577]
DTYPES = [torch.float32, torch.bfloat16]
TOL_JAX = {torch.float32: 2e-5, torch.bfloat16: 5e-2}
TOL_REF = {torch.float32: 2e-5, torch.bfloat16: 2 ** -7}


def _inputs(b, n, c, seed):
    """x, g1, b1, wqkv, bqkv, wproj, bproj as numpy fp32."""
    rng = np.random.default_rng(seed)

    def f(*shape, scale=1.0, offset=0.0):
        return (offset + scale * rng.standard_normal(shape)).astype(
            np.float32)

    return (f(b, n, c), f(c, scale=0.1, offset=1.0), f(c, scale=0.1),
            f(c, 3 * c, scale=c ** -0.5), f(3 * c, scale=0.1),
            f(c, c, scale=c ** -0.5), f(c, scale=0.1))


def _operands(arrays, dtype):
    """(torch tensors, jax arrays): x and the weights in ``dtype``, LN
    parameters and biases fp32, the same values in both packages."""
    ts = [torch.from_numpy(a) for a in arrays]
    for i in (0, 3, 5):
        ts[i] = ts[i].to(dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    js = [jnp.asarray(t.float().numpy(), jdt if i in (0, 3, 5) else
                      jnp.float32) for i, t in enumerate(ts)]
    return ts, js


def _assert_close(out, ref, tol):
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", TOKENS)
@pytest.mark.parametrize("width", WIDTHS)
def test_tile_walk_matches_pallas_attn_block(width, n, dtype):
    b, c, heads = width
    ts, js = _operands(_inputs(b, n, c, seed=n + c + heads), dtype)
    out = vb._attn_block_tiled_ref(*ts, heads)
    assert out.dtype == dtype and out.shape == (b, n, c)
    ref = jax_vit_block.attn_block(*js, num_heads=heads, interpret=True)
    _assert_close(out, ref, TOL_JAX[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", TOKENS)
@pytest.mark.parametrize("width", WIDTHS)
def test_tile_walk_matches_the_plain_version(width, n, dtype):
    b, c, heads = width
    ts, _ = _operands(_inputs(b, n, c, seed=1000 + n + c + heads), dtype)
    out = vb._attn_block_tiled_ref(*ts, heads)
    _assert_close(out, vb.attn_block_ref(*ts, heads).float().numpy(),
                  TOL_REF[dtype])


@pytest.mark.parametrize("n", TOKENS)
def test_deferred_walk_equals_the_normalising_walk_in_fp32(n):
    """In fp32 every cast is a no-op, so the deferred division and the
    normalising walk of the K6/K9 forward compute one function: within
    2e-5 of each other at D = 16 and 128."""
    for b, h, d in ((2, 4, 16), (1, 1, 128)):
        rng = np.random.default_rng(n + d)
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (b, h, n, d)).astype(np.float32)) for _ in range(3))
        _assert_close(at._attend_two_pass(q, k, v, defer=True),
                      at._attend_two_pass(q, k, v).numpy(), 2e-5)
