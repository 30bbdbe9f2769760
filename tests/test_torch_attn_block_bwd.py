"""K10, the one-kernel attention-block backward (plain version), and
``AttnBlockFusedBwd`` against the JAX package on the CPU.

The same seeded numpy inputs go to both packages; the JAX side is the
alternative custom VJP ``_attn_block_bwd_fused`` with its Pallas kernel
in interpret mode.  Tolerances:

- 2e-4 (rtol and atol) in fp32: the JAX test's own budget for this kernel
  (tests/test_ops.py), where both compute the same fp32 math in another
  summation order;
- 5e-2 in bf16: K6's bf16 budget (tests/test_torch_attention.py); both
  sides round the same intermediates to bf16, in another order;
- the port's chain rule (K5) against K10 in fp32 within 2e-4: they differ
  only where K10 scales q before the product (D = 8);
- ``torch.autograd.gradcheck`` defaults in float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfu_multimodal_tpu.ops.vit_block import _attn_block_bwd_fused
from dfu_multimodal_tpu_torch.ops import vit_block as vb

torch.set_num_threads(1)

NAMES = ("x", "g1", "b1", "wqkv", "bqkv", "wproj", "bproj")


def _inputs(b, n, c, seed):
    """(x, g1, b1, wqkv, bqkv, wproj, bproj) and the output gradient g."""
    rng = np.random.default_rng(seed)

    def f(*shape, scale=1.0, offset=0.0):
        return (offset + scale * rng.standard_normal(shape)).astype(
            np.float32)

    args = (f(b, n, c), f(c, scale=0.1, offset=1.0), f(c, scale=0.1),
            f(c, 3 * c, scale=0.1), f(3 * c, scale=0.1), f(c, c, scale=0.1),
            f(c, scale=0.1))
    return args, f(b, n, c)


def _jax_grads(args, g, heads, dtype=jnp.float32):
    """The JAX ``_attn_block_bwd_fused`` (interpret mode) on the block
    inputs: x and the weights in ``dtype``, LN params and biases fp32."""
    res = tuple(jnp.asarray(a, dtype if name in ("x", "wqkv", "wproj")
                            else jnp.float32)
                for name, a in zip(NAMES, args))
    return _attn_block_bwd_fused(heads, True, res,
                                 jnp.asarray(g).astype(dtype))


def _port_args(args, g, dtype=torch.float32):
    t = [torch.from_numpy(a).to(dtype if name in ("x", "wqkv", "wproj")
                                else torch.float32)
         for name, a in zip(NAMES, args)]
    x, g1, b1, wqkv, bqkv, wproj, bproj = t
    return (x, torch.from_numpy(g).to(dtype), g1, b1, wqkv, bqkv, wproj,
            bproj)


def _compare(grads, ref, tol):
    for name, out, r in zip(NAMES, grads, ref):
        r = np.asarray(jnp.asarray(r, jnp.float32))
        assert out.shape == r.shape, name
        np.testing.assert_allclose(out.float().numpy(), r, rtol=tol,
                                   atol=tol, err_msg=f"grad {name}")


# (batch, tokens, width, heads): b = 4 takes the JAX kernel's two images
# per grid step and b = 3 one; D = 8 (the scale no power of two, which
# K10 applies to q in the compute dtype) and D = 16
@pytest.mark.parametrize("shape", [(4, 20, 32, 4), (3, 20, 32, 4),
                                   (2, 20, 64, 4)])
def test_attn_block_bwd_fused_ref_matches_pallas(shape):
    b, n, c, heads = shape
    args, g = _inputs(b, n, c, seed=21)
    ref = _jax_grads(args, g, heads)
    grads = vb.attn_block_bwd_fused(*_port_args(args, g), heads)
    assert grads[0].dtype == torch.float32
    _compare(grads, ref, 2e-4)
    assert vb.attn_block_bwd_fused.launches == 0


def test_attn_block_bwd_fused_ref_matches_pallas_bf16():
    b, n, c, heads = 2, 20, 32, 4
    args, g = _inputs(b, n, c, seed=22)
    ref = _jax_grads(args, g, heads, jnp.bfloat16)
    grads = vb.attn_block_bwd_fused(*_port_args(args, g, torch.bfloat16),
                                    heads)
    dtypes = [t.dtype for t in grads]
    assert dtypes == [torch.bfloat16, torch.float32, torch.float32,
                      torch.bfloat16, torch.float32, torch.bfloat16,
                      torch.float32]
    _compare(grads, ref, 5e-2)


@pytest.mark.parametrize("shape", [(2, 20, 32, 4), (2, 13, 64, 4)])
def test_attn_block_fused_bwd_matches_chain_rule(shape):
    """AttnBlockFusedBwd (K1 forward, K10 backward) against AttnBlock (K1
    forward, K5 chain rule) through autograd on the same inputs."""
    b, n, c, heads = shape
    args, g = _inputs(b, n, c, seed=23)
    grads = {}
    for fn in (vb.AttnBlockFusedBwd, vb.AttnBlock):
        t = [torch.from_numpy(a).requires_grad_() for a in args]
        out = fn.apply(*t, heads)
        out.backward(torch.from_numpy(g))
        grads[fn] = [a.grad for a in t]
    for name, a, r in zip(NAMES, grads[vb.AttnBlockFusedBwd],
                          grads[vb.AttnBlock]):
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=2e-4,
                                   atol=2e-4, err_msg=f"grad {name}")


def test_attn_block_fused_bwd_gradcheck():
    args, _ = _inputs(2, 5, 16, seed=24)
    t = [torch.from_numpy(a).double().requires_grad_() for a in args]
    assert torch.autograd.gradcheck(
        lambda *a: vb.AttnBlockFusedBwd.apply(*a, 2), tuple(t))

