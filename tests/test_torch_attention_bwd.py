"""The bf16 attention backward's algorithm (a query-side walk of the key
tiles in three passes, then a key-side walk of the query tiles with the
rows' max, 1 / sum and δ), as the port's plain tile walk
``_attend_bwd_tiled`` runs it, against the JAX package's Pallas kernels in
interpret mode on the CPU (K9 ``flash_attention`` and K6
``qkv_attention`` through ``jax.vjp``, K5 ``qkv_attention_fwdbwd`` with
its re-forward output), against the port's whole-row plain version
(``_grads``), and, with ``prescale``, against K10's attention step, on
seeded numpy inputs.

The token counts reach one partial tile (N = 5), a tile edge (40 of 64),
ViT-B/16's 197 (four tiles, the last one 5 rows) and 577 (a 384² image,
ten tiles).  Tolerances are tests/test_torch_attention.py's: fp32
gradients 5e-5, bf16 5e-2; against the whole-row plain version in bf16
the card's kernel-vs-plain budget, 2e-2·(1 + |ref|), where a P or dS
value may round to the other bf16 neighbour.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfu_multimodal_tpu.ops.attention import flash_attention as jax_flash
from dfu_multimodal_tpu.ops.attention import qkv_attention as jax_qkv
from dfu_multimodal_tpu.ops.attention import (
    qkv_attention_fwdbwd as jax_fwdbwd)
from dfu_multimodal_tpu_torch.ops import attention as at

torch.set_num_threads(1)

# (B, H, N, D): D = 8 scales the fp32 scores after the product (d**-0.5 is
# no power of two), D = 16 and 64 scale q in the compute dtype first
SHAPES = [(1, 2, 5, 16), (2, 4, 40, 8), (1, 2, 197, 64), (1, 2, 577, 64)]
DTYPES = [torch.float32, torch.bfloat16]
TOL = {torch.float32: 5e-5, torch.bfloat16: 5e-2}
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


def _assert_near_plain(out: torch.Tensor, ref: torch.Tensor,
                       dtype: torch.dtype) -> None:
    """fp32: within 5e-5 of the whole-row plain version; bf16: within the
    card's kernel-vs-plain budget."""
    if dtype == torch.float32:
        _assert_close(out, ref.numpy(), TOL[dtype])
    else:
        err = (out.float() - ref.float()).abs()
        bound = KERNEL_TOL_BF16 * (1 + ref.float().abs())
        assert bool((err <= bound).all()), float(err.max())


def _tiled(q, k, v, do, dtype, prescale=False):
    """(o, dq, dk, dv) of the tile walk, each rounded to ``dtype``."""
    return tuple(t.to(dtype) for t in at._attend_bwd_tiled(
        q, k, v, do, prescale=prescale))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_tiled_bwd_matches_pallas_flash_attention(shape, dtype):
    (q, jq), (k, jk), (v, jv), (do, jdo) = (
        _operand(_normal(90 + i, *shape), dtype) for i in range(4))
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, interpret=True),
                     jq, jk, jv)
    for out, ref in zip(_tiled(q, k, v, do, dtype)[1:], vjp(jdo)):
        _assert_close(out, ref, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_tiled_bwd_matches_pallas_qkv_attention(shape, dtype):
    b, h, n, d = shape
    qkv, jqkv = _operand(_normal(100, b, n, 3 * h * d), dtype)
    do, jdo = _operand(_normal(101, b, n, h * d), dtype)
    _, vjp = jax.vjp(lambda x: jax_qkv(x, h, interpret=True), jqkv)
    grads = _tiled(*at._unpack(qkv, h), at._heads_of(do, h), dtype)[1:]
    _assert_close(at._pack_grads(*grads, dtype), vjp(jdo)[0], TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_tiled_bwd_matches_pallas_qkv_attention_fwdbwd(shape, dtype):
    """K5: the re-forward output O and dqkv from one softmax."""
    b, h, n, d = shape
    qkv, jqkv = _operand(_normal(110, b, n, 3 * h * d), dtype)
    do, jdo = _operand(_normal(111, b, n, h * d), dtype)
    ref_o, ref_dqkv = jax_fwdbwd(jqkv, jdo, h, interpret=True)
    o, *grads = _tiled(*at._unpack(qkv, h), at._heads_of(do, h), dtype)
    _assert_close(at._merge_heads(o, dtype), ref_o, TOL[dtype])
    _assert_close(at._pack_grads(*grads, dtype), ref_dqkv, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_tiled_bwd_matches_the_whole_row_plain_version(shape, dtype):
    q, k, v, do = (torch.from_numpy(_normal(120 + i, *shape)).to(dtype)
                   for i in range(4))
    p, p_c = at._probs(q, k)
    refs = (at._attend(p_c, v), *at._grads(p, p_c, q, k, v, do))
    for out, ref in zip(_tiled(q, k, v, do, dtype), refs):
        _assert_near_plain(out, ref.to(dtype), dtype)


def _k10_attention_step(q, k, v, do):
    """K10's attention step (dfu_multimodal_tpu/ops/vit_block.py,
    ``_attn_block_bwd_kernel``) over (B, H, N, D) jax arrays: q scaled in
    the compute dtype before the product for every head dim."""
    dt, f32 = q.dtype, jnp.float32
    scale = q.shape[-1] ** -0.5

    def mm(spec, a, b):
        return jnp.einsum(spec, a, b, preferred_element_type=f32)

    s = mm("bhqd,bhkd->bhqk", q * jnp.asarray(scale, dt), k)
    e = jnp.exp(s - jnp.max(s, axis=-1, keepdims=True))
    p = e / jnp.sum(e, axis=-1, keepdims=True)
    p_c = p.astype(dt)
    dp = mm("bhqd,bhkd->bhqk", do, v)
    ds = (p * (dp - jnp.sum(dp * p, axis=-1, keepdims=True))).astype(dt)
    return (mm("bhqk,bhkd->bhqd", p_c, v).astype(dt),
            (mm("bhqk,bhkd->bhqd", ds, k) * scale).astype(dt),
            (mm("bhqk,bhqd->bhkd", ds, q) * scale).astype(dt),
            mm("bhqk,bhqd->bhkd", p_c, do).astype(dt))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [40, 197])
def test_tiled_bwd_prescale_matches_k10(n, dtype):
    """K10's policy at D = 32, where d**-0.5 is no power of two: q is
    rounded to the compute dtype after scaling, on the query side and, in
    the kernel, in each of the key side's Q fragments."""
    b, h, d = 2, 4, 32
    ops = [_operand(_normal(130 + i, b, h, n, d), dtype) for i in range(4)]
    outs = _tiled(*(t for t, _ in ops), dtype, prescale=True)
    for out, ref in zip(outs, _k10_attention_step(*(j for _, j in ops))):
        _assert_close(out, ref, TOL[dtype])
    qkv = at._pack_grads(*(t for t, _ in ops[:3]), dtype)
    do = ops[3][0].transpose(1, 2).reshape(b, n, h * d)
    ref_o, ref_dqkv = at.qkv_attention_fwdbwd_ref(qkv, do, h, prescale=True)
    _assert_near_plain(at._merge_heads(outs[0], dtype), ref_o, dtype)
    _assert_near_plain(at._pack_grads(*outs[1:], dtype), ref_dqkv, dtype)
