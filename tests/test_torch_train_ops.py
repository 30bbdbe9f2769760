"""Backward kernels K4/K5 (plain versions) and the ViT blocks' hand chain
rules, against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
JAX kernels run in Pallas interpret mode.  Tolerances:

- 2e-5 (rtol and atol) where both sides compute the same fp32 math in
  another summation order: K5 against the Pallas kernel, K4 against
  ``jax.vjp`` of an exact-erf MLP block, the attention-block VJP against
  the JAX custom VJP;
- rtol 1e-3 / atol 3e-3 against the Pallas K4, whose logistic GELU and
  its derivative meet the port's exact erf (the reference's budget,
  tests/test_ops.py);
- ``torch.autograd.gradcheck`` defaults in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfu_multimodal_tpu.ops import attention as jax_attention
from dfu_multimodal_tpu.ops import vit_block as jax_vit_block
from dfu_multimodal_tpu_torch.ops import attention as port_attention
from dfu_multimodal_tpu_torch.ops import vit_block as port_vit_block

torch.set_num_threads(1)

# (batch, tokens, width, heads): head dims 8 (scale not a power of two)
# and 16 (power of two), tokens not a multiple of 8
SHAPES = [(2, 20, 32, 4), (3, 13, 64, 4)]
# and for the attention: 226 tokens (a 240² image) at D = 64, past the
# whole-head backward kernel on the card
ATTN_SHAPES = SHAPES + [(1, 226, 128, 2)]


def _f(rng, *shape, scale=1.0, offset=0.0):
    return (offset + scale * rng.standard_normal(shape)).astype(np.float32)


def _block_inputs(b, n, c, seed):
    rng = np.random.default_rng(seed)
    h = 4 * c
    return dict(
        x=_f(rng, b, n, c), g=_f(rng, b, n, c, scale=0.5),
        gamma=_f(rng, c, scale=0.1, offset=1.0), beta=_f(rng, c, scale=0.1),
        wqkv=_f(rng, c, 3 * c, scale=c ** -0.5), bqkv=_f(rng, 3 * c, scale=0.1),
        wproj=_f(rng, c, c, scale=c ** -0.5), bproj=_f(rng, c, scale=0.1),
        w1=_f(rng, c, h, scale=c ** -0.5), b1=_f(rng, h, scale=0.1),
        w2=_f(rng, h, c, scale=h ** -0.5), b2=_f(rng, c, scale=0.1))


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _close(out, ref, rtol=2e-5, atol=2e-5, what=""):
    np.testing.assert_allclose(np.asarray(out, np.float64),
                               np.asarray(ref, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


# ------------------------------------------------------------------ K5


@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_qkv_attention_fwdbwd_matches_pallas(shape):
    b, n, c, heads = shape
    rng = np.random.default_rng(10)
    qkv, do = _f(rng, b, n, 3 * c), _f(rng, b, n, c)
    ref_attn, ref_dqkv = jax_attention.qkv_attention_fwdbwd(
        jnp.asarray(qkv), jnp.asarray(do), heads, interpret=True)
    attn, dqkv = port_attention.qkv_attention_fwdbwd(*_t(qkv, do), heads)
    assert attn.shape == (b, n, c) and dqkv.shape == (b, n, 3 * c)
    _close(attn.numpy(), ref_attn, what="attn")
    _close(dqkv.numpy(), ref_dqkv, what="dqkv")
    assert port_attention.qkv_attention_fwdbwd.launches == 0


# ------------------------------------------------------------------ K4


def _jax_mlp_exact(x, g2, b2, w1, b1, w2, b2b):
    y = jax_vit_block._layernorm_f32(x, g2, b2)
    h = jax.nn.gelu(y @ w1 + b1, approximate=False)
    return x + (h @ w2 + b2b)


@pytest.mark.parametrize("shape", SHAPES)
def test_mlp_block_bwd_matches_exact_vjp(shape):
    b, n, c, _ = shape
    p = _block_inputs(b, n, c, seed=11)
    names = ("x", "gamma", "beta", "w1", "b1", "w2", "b2")
    jargs = [jnp.asarray(p[k]) for k in names]
    _, vjp = jax.vjp(_jax_mlp_exact, *jargs)
    dx_r, dg2_r, db2_r, dw1_r, db1_r, dw2_r, db2b_r = vjp(jnp.asarray(p["g"]))
    x, g, gamma, beta, w1, b1, w2 = _t(p["x"], p["g"], p["gamma"], p["beta"],
                                       p["w1"], p["b1"], p["w2"])
    dx, y, h, dhpre, dg2, db2 = port_vit_block.mlp_block_bwd(
        x, g, gamma, beta, w1, b1, w2)
    assert y.shape == (b * n, c) and h.shape == dhpre.shape == (b * n, 4 * c)
    _close(dx.numpy(), dx_r, what="dx")
    _close(dg2.numpy(), dg2_r, what="dg2")
    _close(db2.numpy(), db2_r, what="db2")
    # the hand chain rule of _mlp_block_bwd on top of K4
    grads = port_vit_block.mlp_block_grads(x, g, gamma, beta, w1, b1, w2,
                                           torch.float32)
    for out, ref, what in zip(grads, (dx_r, dg2_r, db2_r, dw1_r, db1_r,
                                      dw2_r, db2b_r),
                              ("dx", "dg2", "db2", "dw1", "db1", "dw2",
                               "db2b")):
        _close(out.numpy(), ref, what=what)


@pytest.mark.parametrize("shape", SHAPES)
def test_mlp_block_bwd_matches_pallas_interpret(shape):
    b, n, c, _ = shape
    p = _block_inputs(b, n, c, seed=12)
    names = ("x", "g", "gamma", "beta", "w1", "b1", "w2")
    ref = jax_vit_block._mlp_block_bwd_call(
        *[jnp.asarray(p[k]) for k in names], 4, True)
    out = port_vit_block.mlp_block_bwd_ref(*_t(*[p[k] for k in names]))
    rows = b * n
    for o, r, what in zip(out, ref, ("dx", "y", "h", "dhpre", "dg2", "db2")):
        r = np.asarray(r)
        if what in ("y", "h", "dhpre"):
            r = r[:rows]            # the Pallas wrapper pads the rows
        _close(o.numpy(), r, rtol=1e-3, atol=3e-3, what=what)


# -------------------------------------------------------- chain rules


@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_attn_block_vjp_matches_jax(shape):
    b, n, c, heads = shape
    p = _block_inputs(b, n, c, seed=13)
    names = ("x", "gamma", "beta", "wqkv", "bqkv", "wproj", "bproj")
    _, vjp = jax.vjp(
        lambda *a: jax_vit_block.attn_block(*a, num_heads=heads,
                                            interpret=True),
        *[jnp.asarray(p[k]) for k in names])
    refs = vjp(jnp.asarray(p["g"]))
    args = [t.requires_grad_() for t in _t(*[p[k] for k in names])]
    out = port_vit_block.AttnBlock.apply(*args, heads)
    out.backward(torch.from_numpy(p["g"]))
    for a, r, what in zip(args, refs, names):
        _close(a.grad.numpy(), r, what=what)


def _gradcheck_args(b, n, c, seed):
    p = _block_inputs(b, n, c, seed)
    return {k: torch.from_numpy(v).double().requires_grad_()
            for k, v in p.items()}


def test_attn_block_function_gradcheck():
    p = _gradcheck_args(2, 5, 16, seed=14)
    args = [p[k] for k in ("x", "gamma", "beta", "wqkv", "bqkv", "wproj",
                           "bproj")]
    assert torch.autograd.gradcheck(
        lambda *a: port_vit_block.AttnBlock.apply(*a, 2), args)


def test_mlp_block_function_gradcheck():
    p = _gradcheck_args(2, 5, 8, seed=15)
    args = [p[k] for k in ("x", "gamma", "beta", "w1", "b1", "w2", "b2")]
    assert torch.autograd.gradcheck(port_vit_block.MlpBlock.apply, args)


def _check_needs_input_grad(fn, names, monkeypatch):
    """Only the inputs that need a gradient get one, the data-only
    backward matches the full one, and it runs no weight-gradient product
    or column sum."""
    p = _block_inputs(2, 6, 16, seed=16)
    full = [t.requires_grad_() for t in _t(*[p[k] for k in names])]
    fn(*full).sum().backward()
    part = _t(*[p[k] for k in names])
    part[0].requires_grad_()
    calls = []
    for helper in ("_wgrad", "_colsum"):
        orig = getattr(port_vit_block, helper)
        monkeypatch.setattr(port_vit_block, helper,
                            lambda *a, _f=orig, _n=helper:
                            calls.append(_n) or _f(*a))
    fn(*part).sum().backward()
    assert calls == []
    assert all(t.grad is None for t in part[1:])
    np.testing.assert_array_equal(part[0].grad.numpy(), full[0].grad.numpy())


def test_functions_honour_needs_input_grad(monkeypatch):
    _check_needs_input_grad(port_vit_block.MlpBlock.apply,
                            ("x", "gamma", "beta", "w1", "b1", "w2", "b2"),
                            monkeypatch)


def test_attn_function_honours_needs_input_grad(monkeypatch):
    _check_needs_input_grad(
        lambda *a: port_vit_block.AttnBlock.apply(*a, 4),
        ("x", "gamma", "beta", "wqkv", "bqkv", "wproj", "bproj"),
        monkeypatch)


def test_mlp_block_grads_keeps_each_bias_dtype():
    p = _block_inputs(1, 3, 8, seed=17)
    args = _t(*[p[k] for k in ("x", "g", "gamma", "beta", "w1", "b1", "w2")])
    grads = port_vit_block.mlp_block_grads(*args, torch.float64)
    assert grads[4].dtype == torch.float32 and grads[6].dtype == torch.float64
