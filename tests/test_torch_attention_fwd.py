"""The bf16 attention forward's algorithm (two passes over 64-key tiles:
the running row max and rescaled sum, then P normalised before P·V), as
the port's plain tile walk ``_attend_two_pass`` runs it, against the JAX
package's Pallas forwards in interpret mode on the CPU (K9
``flash_attention``, K6 ``qkv_attention``) and against the port's
whole-row plain version, on seeded numpy inputs.

The token counts reach one partial tile (N = 5), a tile edge (40 of 64),
ViT-B/16's 197 (four tiles, the last one 5 keys) and 577 (a 384² image,
ten tiles).  Tolerances are tests/test_torch_attention.py's: fp32 2e-5,
bf16 5e-2; against the whole-row plain version in bf16 the card's
kernel-vs-plain budget, 2e-2·(1 + |ref|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfu_multimodal_tpu.ops.attention import flash_attention as jax_flash
from dfu_multimodal_tpu.ops.attention import qkv_attention as jax_qkv
from dfu_multimodal_tpu_torch.ops import attention as at

torch.set_num_threads(1)

# (B, H, N, D): D = 8 scales the fp32 scores after the product (d**-0.5 is
# no power of two), D = 16 and 64 scale q in the compute dtype first
SHAPES = [(1, 2, 5, 16), (2, 4, 40, 8), (1, 2, 197, 64), (1, 2, 577, 64)]
DTYPES = [torch.float32, torch.bfloat16]
TOL = {torch.float32: 2e-5, torch.bfloat16: 5e-2}
KERNEL_TOL_BF16 = 2e-2


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _operand(x: np.ndarray, dtype: torch.dtype):
    """(torch tensor, jax array) of the same values in ``dtype``."""
    t = torch.from_numpy(x).to(dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return t, jnp.asarray(t.float().numpy(), jdt)


def _assert_close(out: torch.Tensor, ref, tol: float) -> None:
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_two_pass_matches_pallas_flash_attention(shape, dtype):
    (q, jq), (k, jk), (v, jv) = (_operand(_normal(60 + i, *shape), dtype)
                                 for i in range(3))
    out = at._attend_two_pass(q, k, v).to(dtype)
    _assert_close(out, jax_flash(jq, jk, jv, interpret=True), TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_two_pass_matches_pallas_qkv_attention(shape, dtype):
    b, h, n, d = shape
    qkv, jqkv = _operand(_normal(70, b, n, 3 * h * d), dtype)
    out = at._merge_heads(at._attend_two_pass(*at._unpack(qkv, h)), dtype)
    _assert_close(out, jax_qkv(jqkv, h, interpret=True), TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_two_pass_matches_the_whole_row_plain_version(shape, dtype):
    """fp32: within 2e-5 of ``flash_attention_ref`` (one softmax over the
    whole row); bf16: within the card's kernel-vs-plain budget, where a
    P or O value may round to the other bf16 neighbour."""
    q, k, v = (torch.from_numpy(_normal(80 + i, *shape)).to(dtype)
               for i in range(3))
    out = at._attend_two_pass(q, k, v).to(dtype)
    ref = at.flash_attention_ref(q, k, v)
    if dtype == torch.float32:
        _assert_close(out, ref.numpy(), TOL[dtype])
    else:
        err = (out.float() - ref.float()).abs()
        bound = KERNEL_TOL_BF16 * (1 + ref.float().abs())
        assert bool((err <= bound).all()), float(err.max())
