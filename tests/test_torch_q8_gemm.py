"""The int8 blocks' GEMM (``csrc/gemm_sm90.cuh``, its int8 modes) as a
plain tile walk on the CPU, and the int8 model's K-major weight copies.

The card runs each int8 product as 128-deep stages of four k32 wgmma
steps summed in int32, and at the end of each K group flushes the sum
into fp32 as facc + (float(acc)·a[r, g])·s[n] before the epilogue.
:func:`_s8_walk` runs the same stages and steps on the CPU, each step's
product exact in fp32 (32·127² < 2²⁴) and summed in integers, TMA's zero
fill past k included.  Tolerances, each with its reason:

- the walk against the plain integer arithmetic
  (``ops.vit_block_q8.gemm_q8_ref``): bit for bit, for every epilogue and
  for 1 and 4 K groups (groups that end inside a stage included): integer
  sums are exact in any order, and the flush rounds the same operations
  in the same order;
- blocks composed of the walk against the JAX package's Pallas kernels in
  interpret mode: the tolerances of ``tests/test_torch_q8.py`` (1e-3 for
  the attention blocks, 1e-2 for the MLP blocks, whose exact-erf GELU
  meets the Pallas kernels' logistic one).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dfu_multimodal_tpu.ops import vit_block_q8 as jax_q8
from dfu_multimodal_tpu_torch.config import TrainConfig, thermal_modality
from dfu_multimodal_tpu_torch.models import zoo
from dfu_multimodal_tpu_torch.models.vit import QDense
from dfu_multimodal_tpu_torch.ops import vit_block_q8 as q8
from dfu_multimodal_tpu_torch.ops.vit_block import _layernorm_f32
from dfu_multimodal_tpu_torch.serve.engine import quantize_for_serving
from dfu_multimodal_tpu_torch.train.engine import Trainer

torch.set_num_threads(1)

STAGE, STEP = 128, 32          # the int8 stage's depth and wgmma's k
B, N, C, HEADS, HIDDEN, CHUNKS = 2, 17, 64, 4, 256, 4
ACT = np.array([4.0 / 127, 1.5 / 127], np.float32)


def _s8_walk(epi, a_q, w_t, row_scale, col_scale, bias, resid=None,
             inv=None, group=None, dtype=torch.float32):
    """One int8 product as the kernel walks it: a_q (m, k) int8, w_t (n,
    k) int8 (the weight's K-major copy), row_scale (m, k / group) or None
    (static)."""
    m, k = a_q.shape
    group = k if group is None else group
    steps = -(-k // STAGE) * (STAGE // STEP)     # past k: TMA's zeros
    a = F.pad(a_q.float(), (0, steps * STEP - k))
    w = F.pad(w_t.float(), (0, steps * STEP - k))
    acc = torch.zeros((m, w_t.shape[0]), dtype=torch.int64)
    facc = torch.zeros((m, w_t.shape[0]))
    for t in range(steps):
        sl = slice(t * STEP, (t + 1) * STEP)
        acc += (a[:, sl] @ w[:, sl].t()).long()         # exact in fp32
        done = t + 1
        if done % (group // STEP) == 0 and done * STEP <= k:
            v = acc.float()
            if row_scale is not None:
                g = done // (group // STEP) - 1
                v = v * row_scale[:, g:g + 1]
            facc = facc + v * col_scale
            acc.zero_()
    v = facc + bias
    if epi == q8.QEPI_OUT:
        return v.to(dtype)
    if epi == q8.QEPI_RESID:
        return (resid.float() + v.to(dtype).float()).to(dtype)
    if epi == q8.QEPI_GELU_F32:
        return F.gelu(v)
    return q8.static_quant(F.gelu(v), inv[0])


# name: (epilogue, dynamic row scales)
EPILOGUES = {"out": (q8.QEPI_OUT, True), "out_static": (q8.QEPI_OUT, False),
             "resid": (q8.QEPI_RESID, True),
             "resid_static": (q8.QEPI_RESID, False),
             "gelu_f32": (q8.QEPI_GELU_F32, True),
             "gelu_q8": (q8.QEPI_GELU_Q8, False)}


@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(EPILOGUES))
def test_s8_walk_equals_plain_integer_arithmetic(name, dtype, groups):
    """One group over k = 320 (two stages and a half one of TMA's zeros),
    or 4 groups of 64 over k = 256 (two groups end inside each stage)."""
    epi, dynamic = EPILOGUES[name]
    k = 320 if groups == 1 else 256
    rng = np.random.default_rng(len(name) * 10 + groups)
    m, n = 37, 48
    a_q = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8))
    row_scale = torch.from_numpy(
        rng.uniform(1e-3, 2e-2, (m, groups)).astype(np.float32)) \
        if dynamic else None
    col_scale = torch.from_numpy(
        rng.uniform(1e-4, 2e-3, n).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.1, n).astype(np.float32))
    resid = torch.from_numpy(rng.normal(0, 1, (m, n)).astype(np.float32)
                             ).to(dtype)
    inv = torch.tensor([127 / 1.5])
    args = (a_q, row_scale, col_scale, bias, resid, inv, k // groups, dtype)
    walked = _s8_walk(epi, a_q, w.t().contiguous(), *args[1:])
    plain = q8.gemm_q8_ref(epi, a_q, w, *args[1:])
    assert walked.dtype == plain.dtype and walked.shape == (m, n)
    assert torch.equal(walked, plain)


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed):
    rng = np.random.default_rng(seed)

    def f32(*shape, scale=1.0, offset=0.0):
        return (offset + scale * rng.standard_normal(shape)).astype(
            np.float32)

    x = f32(B, N, C)
    ln = (f32(C, scale=0.1, offset=1.0), f32(C, scale=0.1))

    def dense(din, dout):
        q, s = jax_q8.quantize_weight(
            jnp.asarray(f32(din, dout, scale=din ** -0.5)))
        return np.asarray(q), np.asarray(s), f32(dout, scale=0.1)

    return x, ln, dense(C, 3 * C), dense(C, C), dense(C, HIDDEN), \
        dense(HIDDEN, C)


def _quant(y, inv):
    """Dynamic (inv None: int8 and row scales) or static int8 of y."""
    if inv is None:
        return q8.row_quant(y)
    return q8.static_quant(y, inv), None


def _attn_walk(x, g, b, wqkv, sqkv, bqkv, wproj, sproj, bproj, inv):
    """The attention block as the card chains it, its products walked."""
    bsz, n, c = x.shape
    y_q, a = _quant(_layernorm_f32(x.reshape(-1, c), g, b),
                    None if inv is None else inv[0])
    qkv = _s8_walk(q8.QEPI_OUT, y_q, wqkv.t().contiguous(), a, sqkv, bqkv,
                   dtype=x.dtype)
    attn = q8._attention_f32(qkv.reshape(bsz, n, 3 * c), HEADS)
    attn_q, a2 = _quant(attn.reshape(-1, c), None if inv is None else inv[1])
    return _s8_walk(q8.QEPI_RESID, attn_q, wproj.t().contiguous(), a2, sproj,
                    bproj, x.reshape(-1, c), dtype=x.dtype).reshape(x.shape)


def _mlp_walk(x, g, b, w1, s1, b1, w2, s2, b2b, inv):
    """The MLP block as the card chains it, its products walked."""
    c = x.shape[-1]
    rows, chunk = x.numel() // c, HIDDEN // CHUNKS
    y_q, a = _quant(_layernorm_f32(x.reshape(-1, c), g, b),
                    None if inv is None else inv[0])
    if inv is None:
        h = _s8_walk(q8.QEPI_GELU_F32, y_q, w1.t().contiguous(), a, s1, b1)
        h_q, ah = q8.row_quant(h.reshape(rows, CHUNKS, chunk))
        h_q, ah = h_q.reshape(rows, HIDDEN), ah.reshape(rows, CHUNKS)
    else:
        h_q = _s8_walk(q8.QEPI_GELU_Q8, y_q, w1.t().contiguous(), None, s1,
                       b1, inv=inv[1:])
        ah = None
    return _s8_walk(q8.QEPI_RESID, h_q, w2.t().contiguous(), ah, s2, b2b,
                    x.reshape(-1, c), group=chunk,
                    dtype=x.dtype).reshape(x.shape)


@pytest.mark.parametrize("static", [False, True], ids=["q8", "q8s"])
@pytest.mark.parametrize("block", ["attn", "mlp"])
def test_walked_blocks_match_jax(block, static):
    x, (g, b), qkv, proj, fc1, fc2 = _inputs(seed=5)
    first, second = (qkv, proj) if block == "attn" else (fc1, fc2)
    (w_a, s_a, b_a), (w_b, s_b, b_b) = first, second
    inv = None
    if static:
        s_a, s_b = s_a * ACT[0], s_b * ACT[1]
        inv = np.float32(1.0) / ACT
    args = (x, g, b, w_a, s_a, b_a, w_b, s_b, b_b)
    jargs = tuple(map(jnp.asarray, args + ((inv,) if static else ())))
    if block == "attn":
        fn = jax_q8.attn_block_q8s if static else jax_q8.attn_block_q8
        ref = fn(*jargs, num_heads=HEADS, interpret=True)
        out = _attn_walk(*map(_t, args), None if inv is None else _t(inv))
        tol = 1e-3
    else:
        fn = jax_q8.mlp_block_q8s if static else jax_q8.mlp_block_q8
        ref = fn(*jargs, hidden_chunks=CHUNKS, interpret=True)
        out = _mlp_walk(*map(_t, args), None if inv is None else _t(inv))
        tol = 1e-2
    ref = np.asarray(ref, np.float32)
    err = float((np.abs(out.numpy() - ref) / (1.0 + np.abs(ref))).max())
    print(f"[q8 walk] {block} {'q8s' if static else 'q8'} vs JAX: "
          f"measured {err:.3e}, tolerance {tol:g}")
    assert out.shape == ref.shape and err <= tol


# ------------------------------------------------ the K-major copies


def _assert_kmajor(module):
    dense = [m for m in module.modules() if isinstance(m, QDense)]
    assert dense
    for m in dense:
        assert m.kernel_kmajor.is_contiguous()
        assert torch.equal(m.kernel_kmajor, m.kernel_q8.t())


def test_kmajor_copy_is_not_state_and_follows_load_state_dict():
    dense = QDense(64, 96)
    assert "kernel_kmajor" not in dense.state_dict()
    assert set(dense.state_dict()) == {"kernel_q8", "scale", "bias"}
    rng = np.random.default_rng(6)
    state = dense.state_dict()
    state["kernel_q8"] = torch.from_numpy(
        rng.integers(-127, 128, (64, 96), dtype=np.int8))
    dense.load_state_dict(state)
    assert dense.kernel_kmajor.shape == (96, 64)
    _assert_kmajor(dense)


def test_kmajor_copy_follows_quantize_for_serving():
    tiny = dict(image_size=32, depth=2, hidden_dim=64, num_heads=4,
                patch_size=8)
    base = Trainer("thermal_only", TrainConfig(compute_dtype="float32"),
                   {"thermal": thermal_modality()}, device="cpu", **tiny)
    zoo.init_model(base.module, torch.Generator().manual_seed(0))
    served = quantize_for_serving(base, image_size=32)
    _assert_kmajor(served.module)
    assert not any("kernel_kmajor" in k for k in served.variables())
    # a second load (the card-vs-CPU comparisons' path) refreshes it too
    again = Trainer("thermal_only", TrainConfig(compute_dtype="float32"),
                    {"thermal": thermal_modality()}, device="cpu",
                    block_impl="fused_q8", **tiny)
    again.module.load_state_dict(served.variables())
    _assert_kmajor(again.module)
