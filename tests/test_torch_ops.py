"""Port kernels' plain versions against the JAX package's kernels and
oracles, on the CPU (the JAX kernels run in Pallas interpret mode).

Inputs are made with numpy from a seed and handed to both packages.
Tolerances are the reference's own budgets (tests/test_ops.py): 2e-5 for
kernel vs oracle in fp32, rtol 1e-3 / atol 3e-3 where the Pallas MLP's
logistic GELU meets the port's exact erf GELU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfu_multimodal_tpu.ops import vit_block as jax_vit_block
from dfu_multimodal_tpu.ops.fused_mlp import (
    _fused_mlp_ref as jax_fused_mlp_ref, fused_mlp as jax_fused_mlp)
from dfu_multimodal_tpu_torch.ops import fused_mlp as port_fused_mlp
from dfu_multimodal_tpu_torch.ops import vit_block as port_vit_block

torch.set_num_threads(1)

# (batch, tokens, width, heads): tokens not a multiple of 8, and an odd
# batch (the Pallas attention kernel then takes one image per grid step)
BLOCK_SHAPES = [(2, 20, 32, 4), (3, 13, 64, 4)]


def _block_inputs(b, n, c, seed, hidden_mult=4):
    rng = np.random.default_rng(seed)

    def f(*shape, scale=1.0, offset=0.0):
        return (offset + scale * rng.standard_normal(shape)).astype(
            np.float32)

    h = hidden_mult * c
    return dict(
        x=f(b, n, c),
        g=f(c, scale=0.1, offset=1.0), beta=f(c, scale=0.1),
        wqkv=f(c, 3 * c, scale=c ** -0.5), bqkv=f(3 * c, scale=0.1),
        wproj=f(c, c, scale=c ** -0.5), bproj=f(c, scale=0.1),
        w1=f(c, h, scale=c ** -0.5), b1=f(h, scale=0.1),
        w2=f(h, c, scale=h ** -0.5), b2=f(c, scale=0.1))


def _port(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# 577 tokens (a 384² image) at D = 64: past one block's shared memory
# for the forward attention core on the card
@pytest.mark.parametrize("oracle", ["jax_ref", "pallas_interpret"])
@pytest.mark.parametrize("shape", BLOCK_SHAPES + [(1, 577, 128, 2)])
def test_attn_block_matches_jax(shape, oracle):
    b, n, c, heads = shape
    p = _block_inputs(b, n, c, seed=1)
    args = (p["x"], p["g"], p["beta"], p["wqkv"], p["bqkv"], p["wproj"],
            p["bproj"])
    jargs = [jnp.asarray(a) for a in args]
    if oracle == "jax_ref":
        ref = jax_vit_block._attn_block_ref(*jargs, num_heads=heads)
    else:
        ref = jax_vit_block.attn_block(*jargs, num_heads=heads,
                                       interpret=True)
    # the public op on CPU tensors takes the plain version
    out = port_vit_block.attn_block(*_port(*args), heads)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        port_vit_block.attn_block_ref(*_port(*args), heads).numpy(),
        out.numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("shape", BLOCK_SHAPES)
def test_mlp_block_matches_jax_exact_gelu(shape):
    b, n, c, _ = shape
    p = _block_inputs(b, n, c, seed=2)
    x, g, beta, w1, b1, w2, b2 = (jnp.asarray(p[k]) for k in
                                  ("x", "g", "beta", "w1", "b1", "w2", "b2"))
    y = jax_vit_block._layernorm_f32(x, g, beta)
    h = jax.nn.gelu(y @ w1 + b1, approximate=False)
    ref = x + (h @ w2 + b2)
    out = port_vit_block.mlp_block(*_port(p["x"], p["g"], p["beta"], p["w1"],
                                          p["b1"], p["w2"], p["b2"]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape", BLOCK_SHAPES)
def test_mlp_block_matches_pallas_interpret(shape):
    b, n, c, _ = shape
    p = _block_inputs(b, n, c, seed=3)
    args = (p["x"], p["g"], p["beta"], p["w1"], p["b1"], p["w2"], p["b2"])
    ref = jax_vit_block.mlp_block(*[jnp.asarray(a) for a in args],
                                  interpret=True)
    out = port_vit_block.mlp_block_ref(*_port(*args))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=1e-3, atol=3e-3)


def _mlp_head_inputs(batch, seed, dims=(48, 32, 16, 2)):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((batch, dims[0])).astype(np.float32)]
    for din, dout in zip(dims[:-1], dims[1:]):
        arrays.append((rng.standard_normal((din, dout)) * din ** -0.5)
                      .astype(np.float32))
        arrays.append((0.1 * rng.standard_normal(dout)).astype(np.float32))
    return arrays


@pytest.mark.parametrize("oracle", ["jax_ref", "pallas_interpret"])
@pytest.mark.parametrize("batch", [8, 13])      # 13: ragged vs block_rows
def test_fused_mlp_matches_jax(batch, oracle):
    args = _mlp_head_inputs(batch, seed=batch)
    jargs = [jnp.asarray(a) for a in args]
    if oracle == "jax_ref":
        ref = jax_fused_mlp_ref(*jargs)
    else:
        ref = jax_fused_mlp(*jargs, block_rows=8, interpret=True)
    out = port_fused_mlp.fused_mlp(*_port(*args))
    assert out.dtype == torch.float32 and out.shape == (batch, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)


def test_unported_options_and_devices_raise():
    """No hidden fallback: a tensor that is neither on the CPU nor on a
    CUDA device has no kernel, with or without ToMe's key bias; the bias
    itself is taken and matches JAX's biased oracle (2e-5)."""
    p = _block_inputs(1, 5, 16, seed=4)
    arrays = (p["x"], p["g"], p["beta"], p["wqkv"], p["bqkv"], p["wproj"],
              p["bproj"])
    args = _port(*arrays)
    bias = np.log(np.arange(1, 6, dtype=np.float32))[None]
    out = port_vit_block.attn_block(*args, 2, bias=torch.from_numpy(bias))
    ref = jax_vit_block._attn_block_ref(*map(jnp.asarray, arrays),
                                        num_heads=2, bias=jnp.asarray(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="no kernel"):
        port_vit_block.attn_block(*meta, 2)
    with pytest.raises(ValueError, match="no kernel"):
        port_vit_block.attn_block(*meta, 2,
                                  bias=torch.zeros(1, 5, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        port_fused_mlp.fused_mlp(
            *[torch.from_numpy(a).to("meta")
              for a in _mlp_head_inputs(2, seed=5)])
    assert port_vit_block.attn_block.launches == 0
    assert port_fused_mlp.fused_mlp.launches == 0


def test_fusion_mlp_eval_kernel_path_equals_train_path():
    """FusionMLP runs the fused op in eval mode and its Linear/ReLU/
    Dropout Sequential in train mode; with dropout off both compute the
    same function of the same weights."""
    from dfu_multimodal_tpu_torch.models.fusion import FusionMLP
    head = FusionMLP(in_dim=48, num_classes=2, drop_rate=0.0)
    x = torch.from_numpy(_mlp_head_inputs(5, seed=6)[0])
    with torch.no_grad():
        train_out = head.train()(x)
        eval_out = head.eval()(x)
    np.testing.assert_allclose(eval_out.numpy(), train_out.numpy(),
                               rtol=1e-6, atol=1e-6)


def test_fusion_mlp_eval_path_copies_no_weight(monkeypatch):
    """The eval forward hands the kernel each nn.Linear weight as its
    (in, out) transposed view: the same storage, no copy per call."""
    from dfu_multimodal_tpu_torch.models import fusion
    head = fusion.FusionMLP(in_dim=48, num_classes=2, drop_rate=0.0).eval()
    params = port_fused_mlp.fusion_mlp_params(head)
    for w, fc in zip(params[::2], (head.fc1, head.fc2, head.fc3)):
        assert w.data_ptr() == fc.weight.data_ptr()
        assert w.untyped_storage().data_ptr() == \
            fc.weight.untyped_storage().data_ptr()
        assert w.shape == fc.weight.shape[::-1]
        assert w.stride() == (1, w.shape[0])
    seen = []
    kernel = port_fused_mlp.fused_mlp

    def spy(x, w1, b1, w2, b2, w3, b3):
        seen.extend(w.data_ptr() for w in (w1, w2, w3))
        return kernel(x, w1, b1, w2, b2, w3, b3)

    # the eval head calls the kernel through FusedMlp (ops/fused_mlp.py)
    monkeypatch.setattr(port_fused_mlp, "fused_mlp", spy)
    x = torch.from_numpy(_mlp_head_inputs(3, seed=7)[0])
    with torch.no_grad():
        head(x)
    assert seen == [fc.weight.data_ptr()
                    for fc in (head.fc1, head.fc2, head.fc3)]
