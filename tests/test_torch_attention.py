"""The port's attention (K6 ``qkv_attention``, K9 ``flash_attention``)
against the JAX package's Pallas kernels in interpret mode on the CPU:
the plain versions, which the kernels are held to on the card, and their
gradients, with the same seeded numpy inputs handed to both packages.

Tolerances are the reference's own (tests/test_ops.py): fp32 forward
2e-5, gradients 5e-5, bf16 5e-2.
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

# (B, H, N, D); N = 226 (a 240² image) is past the whole-head backward
# kernel's shared memory on the card, so the plain versions that hold the
# tiled kernels are themselves held there
QKV_SHAPES = [(2, 4, 20, 8), (2, 4, 40, 16), (1, 2, 226, 64)]
SHAPES = [(1, 2, 16, 8), (2, 4, 40, 16),            # tests/test_ops.py
          (1, 2, 226, 64)]
FWD_TOL, GRAD_TOL, BF16_TOL = 2e-5, 5e-5, 5e-2


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _bf16_np(x):
    """numpy fp32 values rounded to bf16, as both packages round them."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("shape", QKV_SHAPES)
def test_qkv_attention_matches_pallas(shape):
    b, h, n, d = shape
    qkv = _normal(0, b, n, 3 * h * d)
    do = _normal(1, b, n, h * d)
    ref, vjp = jax.vjp(lambda x: jax_qkv(x, h, interpret=True),
                       jnp.asarray(qkv))
    (ref_dqkv,) = vjp(jnp.asarray(do))
    out = at.qkv_attention_ref(torch.from_numpy(qkv), h)
    dqkv = at.qkv_attention_bwd_ref(torch.from_numpy(qkv),
                                    torch.from_numpy(do), h)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(dqkv.numpy(), np.asarray(ref_dqkv),
                               rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_flash_attention_matches_pallas(shape):
    q, k, v, do = (_normal(10 + i, *shape) for i in range(4))
    ref, vjp = jax.vjp(lambda *a: jax_flash(*a, interpret=True),
                       *map(jnp.asarray, (q, k, v)))
    ref_grads = vjp(jnp.asarray(do))
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    out = at.flash_attention_ref(*t[:3])
    grads = at.flash_attention_bwd_ref(*t)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=FWD_TOL,
                               atol=FWD_TOL)
    for g, r, name in zip(grads, ref_grads, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("d", [8, 16, 32])
def test_bf16_matches_pallas(d):
    """bf16 operands (the pow2 scale in the compute dtype at d = 16, the
    fp32 scores scaled after the product at d = 8, 32): K6 and K9 plain
    forward and backward against the Pallas kernels in bf16."""
    b, h, n = 2, 2, 24
    qkv = _bf16_np(_normal(20, b, n, 3 * h * d))
    do = _bf16_np(_normal(21, b, n, h * d))
    ref, vjp = jax.vjp(lambda x: jax_qkv(x, h, interpret=True),
                       jnp.asarray(qkv, jnp.bfloat16))
    (ref_dqkv,) = vjp(jnp.asarray(do, jnp.bfloat16))
    tq = torch.from_numpy(qkv).to(torch.bfloat16)
    tdo = torch.from_numpy(do).to(torch.bfloat16)
    out = at.qkv_attention_ref(tq, h)
    dqkv = at.qkv_attention_bwd_ref(tq, tdo, h)
    assert out.dtype == dqkv.dtype == torch.bfloat16
    for o, r in ((out, ref), (dqkv, ref_dqkv)):
        np.testing.assert_allclose(o.float().numpy(),
                                   np.asarray(r, np.float32),
                                   rtol=BF16_TOL, atol=BF16_TOL)

    q, k, v, dob = (_bf16_np(_normal(30 + i, b, h, n, d)) for i in range(4))
    ref, vjp = jax.vjp(lambda *a: jax_flash(*a, interpret=True),
                       *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    ref_grads = vjp(jnp.asarray(dob, jnp.bfloat16))
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, dob)]
    outs = (at.flash_attention_ref(*t[:3]), *at.flash_attention_bwd_ref(*t))
    for o, r in zip(outs, (ref, *ref_grads)):
        assert o.dtype == torch.bfloat16
        np.testing.assert_allclose(o.float().numpy(),
                                   np.asarray(r, np.float32),
                                   rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("d", [8, 16])
def test_gradcheck_fp64(d):
    """The autograd Functions' backward is the gradient of their forward
    (fp64 plain versions)."""
    b, h, n = 1, 2, 6
    gen = torch.Generator().manual_seed(d)
    qkv = torch.randn(b, n, 3 * h * d, generator=gen, dtype=torch.float64,
                      requires_grad=True)
    assert torch.autograd.gradcheck(lambda x: at.qkv_attention(x, h), (qkv,))
    qkv_ = [torch.randn(b, h, n, d, generator=gen, dtype=torch.float64,
                        requires_grad=True) for _ in range(3)]
    assert torch.autograd.gradcheck(at.flash_attention, qkv_)


@pytest.mark.parametrize("shape", QKV_SHAPES)
def test_k6_plain_equals_k5_plain(shape):
    """K6's plain forward and backward give exactly the attn and dqkv of
    K5's plain version (one set of numerics), in fp32."""
    b, h, n, d = shape
    qkv = torch.from_numpy(_normal(40, b, n, 3 * h * d))
    do = torch.from_numpy(_normal(41, b, n, h * d))
    attn, dqkv = at.qkv_attention_fwdbwd_ref(qkv, do, h)
    assert torch.equal(at.qkv_attention_ref(qkv, h), attn)
    assert torch.equal(at.qkv_attention_bwd_ref(qkv, do, h), dqkv)


def test_trainable_entry_points_and_cpu_dispatch():
    """``qkv_attention`` / ``flash_attention`` on CPU tensors take the
    plain versions (no launch is counted) and give their gradients."""
    b, h, n, d = 2, 2, 10, 8
    qkv = torch.from_numpy(_normal(50, b, n, 3 * h * d)).requires_grad_()
    do = torch.from_numpy(_normal(51, b, n, h * d))
    before = (at.qkv_attention_fwd.launches, at.qkv_attention_bwd.launches)
    out = at.qkv_attention(qkv, h)
    out.backward(do)
    assert torch.equal(out.detach(), at.qkv_attention_ref(qkv.detach(), h))
    assert torch.equal(qkv.grad,
                       at.qkv_attention_bwd_ref(qkv.detach(), do, h))
    assert (at.qkv_attention_fwd.launches,
            at.qkv_attention_bwd.launches) == before
    q, k, v = (torch.from_numpy(_normal(52 + i, b, h, n, d)).requires_grad_()
               for i in range(3))
    dob = torch.from_numpy(_normal(55, b, h, n, d))
    at.flash_attention(q, k, v).backward(dob)
    for g, r in zip((q.grad, k.grad, v.grad), at.flash_attention_bwd_ref(
            q.detach(), k.detach(), v.detach(), dob)):
        assert torch.equal(g, r)
