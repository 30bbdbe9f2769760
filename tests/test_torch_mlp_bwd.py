"""The bf16 K4 products' algorithm (csrc/gemm_sm90.cuh) on the CPU.

The kernel itself runs only on the card (tests/test_torch_cuda.py); here
its plain tile walk, ``vit_block._mlp_bwd_dual_ref`` (y·w1 and g·w2ᵀ
accumulated over 64-deep k steps in fp32, then the epilogue), is held
against the plain version ``mlp_block_bwd_ref`` and against the JAX
Pallas kernel in interpret mode, and the wrapper's operand checks run on
CPU tensors.  Inputs are made with numpy from a seed.  Tolerances:

- fp32 inputs: 2e-5 (rtol and atol), the same math in another summation
  order (k steps of 64 against one product);
- bf16 inputs: one bf16 step (2^-7 relative, plus 1e-6) — both round
  the same fp32 value, summed in another order, to bf16;
- against the Pallas K4: rtol 1e-3 / atol 3e-3, whose logistic GELU and
  its derivative meet the port's exact erf (the budget of
  tests/test_torch_train_ops.py::test_mlp_block_bwd_matches_pallas_interpret).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfu_multimodal_tpu.ops import vit_block as jax_vit_block
from dfu_multimodal_tpu_torch.ops import vit_block as vb

torch.set_num_threads(1)

# (rows, C): one row; C below, at and past one 64-deep k step, and one
# that ends in a partial step (200 = 3·64 + 8)
WALK_SHAPES = [(1, 64), (37, 40), (29, 64), (45, 200)]
# (batch, tokens, width) as tests/test_torch_train_ops.py::SHAPES
PALLAS_SHAPES = [(2, 20, 32), (3, 13, 64)]


def _f(rng, *shape, scale=1.0, offset=0.0):
    return (offset + scale * rng.standard_normal(shape)).astype(np.float32)


def _products_inputs(rows, c, seed):
    """y, g (rows, C), w1 (C, 4C), b1 (4C,), w2 (4C, C) as numpy fp32."""
    rng = np.random.default_rng(seed)
    hidden = 4 * c
    return (_f(rng, rows, c), _f(rng, rows, c, scale=0.5),
            _f(rng, c, hidden, scale=c ** -0.5), _f(rng, hidden, scale=0.1),
            _f(rng, hidden, c, scale=hidden ** -0.5))


def _plain_h_dhpre(y, g, w1, b1, w2):
    """h and dhpre as mlp_block_bwd_ref forms them from y (its hpre, dh
    and epilogue, past the LayerNorm)."""
    hpre = vb._mm_f32(y, w1) + b1.to(vb._acc(y))
    dh = vb._mm_f32(g, w2.t())
    return (torch.nn.functional.gelu(hpre).to(y.dtype),
            (dh * vb._gelu_grad(hpre)).to(y.dtype))


@pytest.mark.parametrize("shape", WALK_SHAPES)
def test_dual_tile_walk_matches_plain_fp32(shape):
    rows, c = shape
    args = [torch.from_numpy(a) for a in _products_inputs(rows, c, seed=c)]
    h, dhpre = vb._mlp_bwd_dual_ref(*args)
    h_ref, dhpre_ref = _plain_h_dhpre(*args)
    assert h.shape == dhpre.shape == (rows, 4 * c)
    assert h.dtype == dhpre.dtype == torch.float32
    np.testing.assert_allclose(h.numpy(), h_ref.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(dhpre.numpy(), dhpre_ref.numpy(), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("shape", WALK_SHAPES)
def test_dual_tile_walk_matches_plain_bf16(shape):
    rows, c = shape
    args = [torch.from_numpy(a) for a in _products_inputs(rows, c, seed=c)]
    args = [a.bfloat16() if i in (0, 1, 2, 4) else a
            for i, a in enumerate(args)]        # b1 stays fp32
    outs = vb._mlp_bwd_dual_ref(*args)
    for out, ref in zip(outs, _plain_h_dhpre(*args)):
        assert out.dtype == torch.bfloat16
        out, ref = out.float(), ref.float()
        assert bool(((out - ref).abs()
                     <= 2.0 ** -7 * ref.abs() + 1e-6).all())


@pytest.mark.parametrize("shape", PALLAS_SHAPES)
def test_dual_tile_walk_matches_pallas_interpret(shape):
    b, n, c = shape
    rows = b * n
    rng = np.random.default_rng(12)
    x, g = _f(rng, b, n, c), _f(rng, b, n, c, scale=0.5)
    gamma, beta = _f(rng, c, scale=0.1, offset=1.0), _f(rng, c, scale=0.1)
    _, _, w1, b1, w2 = _products_inputs(rows, c, seed=13)
    ref = jax_vit_block._mlp_block_bwd_call(
        *[jnp.asarray(a) for a in (x, g, gamma, beta, w1, b1, w2)], 4, True)
    y_ref, h_ref, dhpre_ref = (np.asarray(r)[:rows] for r in ref[1:4])
    y = vb._layernorm_f32(torch.from_numpy(x).reshape(rows, c),
                          torch.from_numpy(gamma), torch.from_numpy(beta))
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=2e-5, atol=2e-5)
    h, dhpre = vb._mlp_bwd_dual_ref(
        y, torch.from_numpy(g).reshape(rows, c),
        *(torch.from_numpy(a) for a in (w1, b1, w2)))
    np.testing.assert_allclose(h.numpy(), h_ref, rtol=1e-3, atol=3e-3)
    np.testing.assert_allclose(dhpre.numpy(), dhpre_ref, rtol=1e-3,
                               atol=3e-3)


def _offset(*shape):
    """A contiguous bf16 CPU tensor whose base lies 2 bytes past the
    allocation's (16-byte-aligned or better) base."""
    flat = torch.zeros(1 + math.prod(shape), dtype=torch.bfloat16)
    return flat[1:].view(*shape)


def test_tma_operand_checks_accept_aligned_operands():
    c, hidden = 64, 256
    ops = {"g": torch.zeros(5, c, dtype=torch.bfloat16),
           "w1": torch.zeros(c, hidden, dtype=torch.bfloat16),
           "w2": torch.zeros(hidden, c, dtype=torch.bfloat16)}
    assert all(t.data_ptr() % 16 == 0 for t in ops.values())
    vb._check_tma_operands("mlp_block_bwd", c, hidden, **ops)


@pytest.mark.parametrize("arg", ["g", "w1", "w2"])
def test_tma_operand_checks_refuse_a_misaligned_base(arg):
    c, hidden = 64, 256
    shapes = {"g": (5, c), "w1": (c, hidden), "w2": (hidden, c)}
    ops = {k: torch.zeros(*s, dtype=torch.bfloat16)
           for k, s in shapes.items()}
    ops[arg] = _offset(*shapes[arg])
    assert ops[arg].is_contiguous() and ops[arg].data_ptr() % 16 == 2
    with pytest.raises(ValueError, match=f"{arg} at address"):
        vb._check_tma_operands("mlp_block_bwd", c, hidden, **ops)


@pytest.mark.parametrize("c, hidden", [(36, 144), (64, 260), (12, 48)])
def test_tma_operand_checks_refuse_widths_not_a_multiple_of_8(c, hidden):
    with pytest.raises(ValueError, match="multiples of 8"):
        vb._check_tma_operands("mlp_block_bwd", c, hidden)
