"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test skips without a CUDA device; this file imports no jax
(the card's machine has none), so run it there without the JAX conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Tolerances: fp32 kernels vs fp32 plain versions differ only in the
order of fp32 sums (1e-4); bf16 kernels vs bf16 plain versions may round
an intermediate (qkv, attention, hidden, dhpre, dS) one bf16 step apart,
and the forward kernel defers the softmax division past P·V (2e-2).
Each bound is tol·(1 + |ref|).
"""

import ctypes
import dataclasses
import math

import numpy as np
import pytest
import torch

from dfu_multimodal_tpu_torch.ops import attention as at
from dfu_multimodal_tpu_torch.ops import fused_mlp as fm
from dfu_multimodal_tpu_torch.ops import resnet_block as rb
from dfu_multimodal_tpu_torch.ops import vit_block as vb
from dfu_multimodal_tpu_torch.ops import vit_block_q8 as q8

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _randn(gen, *shape, scale=1.0, offset=0.0, dtype=torch.float32):
    t = torch.randn(*shape, generator=gen, device=gen.device)
    return (offset + scale * t).to(dtype)


def _block_args(dev, b, n, c, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = _randn(g, b, n, c, dtype=dtype)
    ln = (_randn(g, c, scale=0.1, offset=1.0), _randn(g, c, scale=0.1))
    attn = (_randn(g, c, 3 * c, scale=c ** -0.5, dtype=dtype),
            _randn(g, 3 * c, scale=0.1),
            _randn(g, c, c, scale=c ** -0.5, dtype=dtype),
            _randn(g, c, scale=0.1))
    mlp = (_randn(g, c, 4 * c, scale=c ** -0.5, dtype=dtype),
           _randn(g, 4 * c, scale=0.1),
           _randn(g, 4 * c, c, scale=(4 * c) ** -0.5, dtype=dtype),
           _randn(g, c, scale=0.1))
    return x, ln, attn, mlp


def _assert_close(out, ref, tol):
    assert out.dtype == ref.dtype and out.shape == ref.shape
    out, ref = out.float(), ref.float()
    assert bool(torch.isfinite(out).all())
    err = (out - ref).abs()
    bound = tol + tol * ref.abs()
    assert bool((err <= bound).all()), float(err.max())


# (batch, tokens, width, heads): the ViT-B/16 block at the serving batch,
# small widths reaching every head dim the attention core takes, and 577
# tokens (a 384² image), where the core takes its tiled kernel
SHAPES = [(2, 197, 768, 12), (3, 20, 64, 4), (2, 33, 128, 4),
          (1, 9, 512, 4), (1, 577, 128, 2)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_attn_block_kernel_matches_plain(shape, dtype):
    dev = _cuda()
    b, n, c, heads = shape
    x, (g1, b1), (wqkv, bqkv, wproj, bproj), _ = _block_args(
        dev, b, n, c, dtype, seed=1)
    before = vb.attn_block.launches
    out = vb.attn_block(x, g1, b1, wqkv, bqkv, wproj, bproj, heads)
    torch.cuda.synchronize()
    assert vb.attn_block.launches == before + 1
    ref = vb.attn_block_ref(x, g1, b1, wqkv, bqkv, wproj, bproj, heads)
    _assert_close(out, ref, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_mlp_block_kernel_matches_plain(shape, dtype):
    dev = _cuda()
    b, n, c, _ = shape
    x, (g2, b2), _, (w1, bb1, w2, bb2) = _block_args(dev, b, n, c, dtype,
                                                      seed=2)
    before = vb.mlp_block.launches
    out = vb.mlp_block(x, g2, b2, w1, bb1, w2, bb2)
    torch.cuda.synchronize()
    assert vb.mlp_block.launches == before + 1
    _assert_close(out, vb.mlp_block_ref(x, g2, b2, w1, bb1, w2, bb2),
                  TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch", [1, 8, 13])
def test_fused_mlp_kernel_matches_plain(batch, dtype):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(batch)
    dims = (2816, 512, 256, 2)
    args = [_randn(g, batch, dims[0], dtype=dtype)]
    for din, dout in zip(dims[:-1], dims[1:]):
        args += [_randn(g, din, dout, scale=din ** -0.5, dtype=dtype),
                 _randn(g, dout, scale=0.1)]
    before = fm.fused_mlp.launches
    out = fm.fused_mlp(*args)
    torch.cuda.synchronize()
    assert fm.fused_mlp.launches == before + 1
    _assert_close(out, fm.fused_mlp_ref(*args), TOL[dtype])


def _fused_mlp_args(dev, batch, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    dims = (2816, 512, 256, 2)
    args = [_randn(g, batch, dims[0], dtype=dtype)]
    for din, dout in zip(dims[:-1], dims[1:]):
        args += [_randn(g, din, dout, scale=din ** -0.5, dtype=dtype),
                 _randn(g, dout, scale=0.1)]
    return args


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_mlp_kernel_matches_plain_at_batch_128(dtype):
    """A batch of many 8-row passes through each weight tile."""
    dev = _cuda()
    args = _fused_mlp_args(dev, 128, dtype, seed=128)
    before = fm.fused_mlp.launches
    out = fm.fused_mlp(*args)
    torch.cuda.synchronize()
    assert fm.fused_mlp.launches == before + 1
    _assert_close(out, fm.fused_mlp_ref(*args), TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_mlp_is_deterministic(dtype):
    """No atomics: the split sums run in a fixed order, two calls give
    equal bits."""
    dev = _cuda()
    for batch in (8, 13):
        args = _fused_mlp_args(dev, batch, dtype, seed=200 + batch)
        assert torch.equal(fm.fused_mlp(*args), fm.fused_mlp(*args))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch", [1, 8, 13])
def test_fused_mlp_reads_transposed_weights(batch, dtype):
    """nn.Linear's (out, in) weights seen transposed, read in place, give
    the bits of the same weights made row-major (in, out)."""
    dev = _cuda()
    x, w1, b1, w2, b2, w3, b3 = _fused_mlp_args(dev, batch, dtype,
                                                seed=300 + batch)
    views = [w.t().contiguous().t() for w in (w1, w2, w3)]
    assert all(v.stride(0) == 1 and not v.is_contiguous() for v in views)
    out = fm.fused_mlp(x, views[0], b1, views[1], b2, views[2], b3)
    assert torch.equal(out, fm.fused_mlp(x, w1, b1, w2, b2, w3, b3))
    with pytest.raises(ValueError):          # neither layout: a strided view
        fm.fused_mlp(x, w1[:, ::2], b1[::2].contiguous(), w2[::2], b2, w3,
                     b3)


def test_kernels_refuse_bad_operands():
    dev = _cuda()
    x, (g1, b1), (wqkv, bqkv, wproj, bproj), _ = _block_args(
        dev, 1, 9, 64, torch.float32, seed=3)
    with pytest.raises(TypeError):          # weights not in x's dtype
        vb.attn_block(x, g1, b1, wqkv.bfloat16(), bqkv, wproj, bproj, 4)
    with pytest.raises(ValueError):         # operand on another device
        vb.attn_block(x, g1.cpu(), b1, wqkv, bqkv, wproj, bproj, 4)
    with pytest.raises(ValueError):         # head dim 12 has no kernel
        vb.attn_block(x[..., :48].contiguous(), g1[:48], b1[:48],
                      wqkv[:48, :144].contiguous(), bqkv[:144],
                      wproj[:48, :48].contiguous(), bproj[:48], 4)


def test_multimodal_eval_on_card_matches_cpu():
    """The whole eval step in fp32 on the card against the same weights
    on the CPU (plain versions): only summation order differs."""
    dev = _cuda()
    from dfu_multimodal_tpu_torch.models import zoo
    from dfu_multimodal_tpu_torch.train.engine import (Trainer, TrainConfig,
                                                       rgb_modality,
                                                       thermal_modality)
    mods = {"rgb": rgb_modality(), "thermal": thermal_modality()}
    cfg = TrainConfig(compute_dtype="float32")
    cpu = Trainer("multimodal", cfg, mods, device="cpu", image_size=32)
    zoo.init_model(cpu.module, torch.Generator().manual_seed(0))
    card = Trainer("multimodal", cfg, mods, device=dev, image_size=32)
    card.module.load_state_dict(cpu.module.state_dict())
    rng = np.random.default_rng(0)
    batch = {m: rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
             for m in mods}
    ref = cpu.eval_step(batch)
    out = card.eval_step(batch)
    np.testing.assert_allclose(out["probs"].cpu().numpy(),
                               ref["probs"].numpy(), rtol=1e-4, atol=1e-5)


def _assert_all_close(outs, refs, tol):
    assert len(outs) == len(refs)
    for out, ref in zip(outs, refs):
        _assert_close(out, ref, tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_mlp_block_bwd_kernel_matches_plain(shape, dtype):
    dev = _cuda()
    b, n, c, _ = shape
    x, (g2, b2), _, (w1, bb1, w2, _) = _block_args(dev, b, n, c, dtype,
                                                    seed=4)
    g = _randn(torch.Generator(device=dev).manual_seed(5), b, n, c,
               dtype=dtype)
    before = vb.mlp_block_bwd.launches
    outs = vb.mlp_block_bwd(x, g, g2, b2, w1, bb1, w2)
    torch.cuda.synchronize()
    assert vb.mlp_block_bwd.launches == before + 1
    _assert_all_close(outs, vb.mlp_block_bwd_ref(x, g, g2, b2, w1, bb1, w2),
                      TOL[dtype])


# the bf16 K4 products (csrc/gemm_sm90.cuh, TMA + wgmma): SHAPES, the
# ragged row counts 1, 129 and 3152 (B = 16 of ViT-B/16: 24.6 tiles of
# 128 rows), and widths whose hidden is no multiple of the 128-column tile
# (C = 8, 24, 40: hidden 32, 96, 160) or whose C is no multiple of the
# 64-deep k step
K4_SHAPES = SHAPES + [(1, 1, 768, 12), (1, 129, 768, 12),
                      (16, 197, 768, 12), (2, 5, 8, 1), (1, 7, 24, 1),
                      (2, 20, 40, 1)]
# bf16 K4: each output's distance from the fp32 result within 10% of the
# plain version's, plus fp32's 1e-4·(1 + max) for the summation order
K4_VS_PLAIN = 0.1


def _k4_args(dev, shape, seed):
    b, n, c, _ = shape
    x, (g2, b2), _, (w1, bb1, w2, _) = _block_args(dev, b, n, c,
                                                    torch.bfloat16, seed)
    g = _randn(torch.Generator(device=dev).manual_seed(seed + 1), b, n, c,
               dtype=torch.bfloat16)
    return x, g, g2, b2, w1, bb1, w2


@pytest.mark.parametrize("shape", K4_SHAPES)
def test_bf16_mlp_block_bwd_matches_plain(shape):
    """The bf16 K4 against its plain version within the bf16 budget, one
    launch a call, two calls bit-equal (fixed sum order, no atomics)."""
    dev = _cuda()
    args = _k4_args(dev, shape, seed=40)
    before = vb.mlp_block_bwd.launches
    outs, again = vb.mlp_block_bwd(*args), vb.mlp_block_bwd(*args)
    torch.cuda.synchronize()
    assert vb.mlp_block_bwd.launches == before + 2
    _assert_all_close(outs, vb.mlp_block_bwd_ref(*args), TOL[torch.bfloat16])
    assert all(torch.equal(a, b) for a, b in zip(outs, again))


@pytest.mark.parametrize("shape", [(2, 197, 768, 12), (16, 197, 768, 12),
                                   (2, 20, 40, 1)])
def test_bf16_mlp_block_bwd_no_further_from_fp32_than_plain(shape):
    dev = _cuda()
    args = _k4_args(dev, shape, seed=41)
    outs = vb.mlp_block_bwd(*args)
    plains = vb.mlp_block_bwd_ref(*args)
    truths = vb.mlp_block_bwd_ref(*(t.float() for t in args))
    for out, plain, truth in zip(outs, plains, truths):
        truth = truth.float()
        a = float((out.float() - truth).abs().max())
        p = float((plain.float() - truth).abs().max())
        slack = TOL[torch.float32] * (1 + float(truth.abs().max()))
        assert a <= (1 + K4_VS_PLAIN) * p + slack, (a, p, slack)


def test_bf16_mlp_block_bwd_refuses_misaligned_operands():
    """TMA needs 16-byte-aligned bases and rows: a bf16 g, w1 or w2 whose
    base lies 2 bytes past a 16-byte boundary, or a width that is no
    multiple of 8, raises ValueError (no fallback); fp32 takes the SIMT
    chain, which needs neither."""
    dev = _cuda()
    args = list(_k4_args(dev, (2, 9, 64, 4), seed=42))

    def offset(t):                        # contiguous, one element in
        flat = torch.empty(1 + t.numel(), dtype=t.dtype, device=dev)
        flat[1:].copy_(t.reshape(-1))
        return flat[1:].view(t.shape)

    for i in (1, 4, 6):                   # g, w1, w2
        bad = list(args)
        bad[i] = offset(args[i])
        assert bad[i].is_contiguous() and bad[i].data_ptr() % 16 == 2
        with pytest.raises(ValueError):
            vb.mlp_block_bwd(*bad)
    narrow = _k4_args(dev, (2, 9, 36, 4), seed=43)       # C = 36
    with pytest.raises(ValueError):
        vb.mlp_block_bwd(*narrow)
    narrow32 = [t.float() if t.dtype == torch.bfloat16 else t
                for t in narrow]
    _assert_all_close(vb.mlp_block_bwd(*narrow32),
                      vb.mlp_block_bwd_ref(*narrow32), TOL[torch.float32])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES[:3])      # head dims 64, 16, 32
def test_qkv_attention_fwdbwd_kernel_matches_plain(shape, dtype):
    dev = _cuda()
    b, n, c, heads = shape
    gen = torch.Generator(device=dev).manual_seed(6)
    qkv = _randn(gen, b, n, 3 * c, dtype=dtype)
    do = _randn(gen, b, n, c, dtype=dtype)
    before = at.qkv_attention_fwdbwd.launches
    outs = at.qkv_attention_fwdbwd(qkv, do, heads)
    torch.cuda.synchronize()
    assert at.qkv_attention_fwdbwd.launches == before + 1
    _assert_all_close(outs, at.qkv_attention_fwdbwd_ref(qkv, do, heads),
                      TOL[dtype])


def test_qkv_attention_fwdbwd_refuses_head_dim_128():
    dev = _cuda()
    qkv = torch.zeros(1, 9, 3 * 512, device=dev)
    with pytest.raises(ValueError):
        at.qkv_attention_fwdbwd(qkv, torch.zeros(1, 9, 512, device=dev), 4)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES[:3])
def test_attn_block_bwd_chain_matches_plain(shape, dtype):
    dev = _cuda()
    b, n, c, heads = shape
    x, (g1, b1), (wqkv, bqkv, wproj, _), _ = _block_args(dev, b, n, c,
                                                         dtype, seed=7)
    g = _randn(torch.Generator(device=dev).manual_seed(8), b, n, c,
               dtype=dtype)
    outs = vb.attn_block_bwd(x, g, g1, b1, wqkv, bqkv, wproj, heads)
    torch.cuda.synchronize()
    refs = vb.attn_block_bwd_ref(x, g, g1, b1, wqkv, bqkv, wproj, heads)
    # the weight gradients sum B·N rows: relative to their scale
    for out, ref in zip(outs, refs):
        scale = float(ref.float().abs().max())
        assert out.dtype == ref.dtype and out.shape == ref.shape
        err = float((out.float() - ref.float()).abs().max())
        assert err <= TOL[dtype] * (1.0 + scale), (err, scale)


def test_thermal_train_step_on_card_matches_cpu():
    """One fp32 train step of a small thermal_only model on the card
    against the same step on the CPU (plain versions): gradients differ in
    summation order only; params after AdamW within 2·lr (a ~0 gradient
    may take either sign)."""
    dev = _cuda()
    from dfu_multimodal_tpu_torch.config import AugmentConfig
    from dfu_multimodal_tpu_torch.models import zoo
    from dfu_multimodal_tpu_torch.train.engine import (Trainer, TrainConfig,
                                                       thermal_modality)
    cfg = TrainConfig(compute_dtype="float32", optimizer_mu_dtype="float32",
                      drop_rate=0.0, batch_size=4)
    # identity augmentation on both sides: zero flip/rotation/aug odds
    aug = AugmentConfig(horizontal_flip_prob=0.0, vertical_flip_prob=0.0,
                        rotation_degrees=0.0, aug_prob=0.0,
                        color_jitter=False)
    mods = {"thermal": dataclasses.replace(thermal_modality(), augment=aug)}
    tiny = dict(image_size=32, depth=2, hidden_dim=64, num_heads=4,
                patch_size=8)
    cpu = Trainer("thermal_only", cfg, mods, device="cpu", **tiny)
    zoo.init_model(cpu.module, torch.Generator().manual_seed(0))
    card = Trainer("thermal_only", cfg, mods, device=dev, **tiny)
    card.module.load_state_dict(cpu.module.state_dict())
    rng = np.random.default_rng(0)
    batch = {"thermal": rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8),
             "label": np.array([0, 1, 1, 0], np.int32),
             "valid": np.array([1, 1, 1, 0], np.float32)}
    before = (vb.mlp_block_bwd.launches, at.qkv_attention_fwdbwd.launches)
    out = card.train_step(batch, torch.Generator(device=dev))
    ref = cpu.train_step(batch, torch.Generator())
    assert (vb.mlp_block_bwd.launches, at.qkv_attention_fwdbwd.launches) \
        == (before[0] + 2, before[1] + 2)
    assert float(out["loss"]) == pytest.approx(float(ref["loss"]), rel=1e-5)
    cpu_params = dict(cpu.module.named_parameters())
    for name, p in card.module.named_parameters():
        q = cpu_params[name]
        # each parameter's gradient against its own largest entry
        assert float((p.grad.cpu() - q.grad).abs().max()) \
            <= 1e-4 * float(q.grad.abs().max()), name
        assert float((p.detach().cpu() - q.detach()).abs().max()) \
            <= 2 * cfg.learning_rate


# --------------------------------------------------------- int8 (K7, K8)

# int8 kernels vs their plain versions: the two take the LayerNorm and
# attention sums in another order, so a value within an ulp of a rounding
# boundary quantises one int8 step apart, and when it is a row's absmax
# the whole row's scale moves (up to the int8 noise itself).  Each element
# within 2e-2·(1+|ref|); the mean of |err|/(1+|ref|) within 5e-4, which a
# systematic fault (a wrong scale, a wrong chunk) would exceed.
Q8_TOL, Q8_MEAN_TOL = 2e-2, 5e-4
# 60 rows and 197·B: none a multiple of the GEMM's 128-row tile; C = 64
# with 4 hidden chunks of 64 (K groups that end inside a 128-deep stage),
# and the ViT-B/16 block at B = 1, 2 and the serving batch 8
Q8_SHAPES = [(3, 20, 64, 4), (1, 197, 768, 12), (2, 197, 768, 12),
             (8, 197, 768, 12)]
Q8_ACT = (4.5 / 127, 1.5 / 127)        # calibrated act scales (static)
Q8_KERNELS = {"attn_block_q8": (q8.attn_block_q8, q8.attn_block_q8_ref),
              "mlp_block_q8": (q8.mlp_block_q8, q8.mlp_block_q8_ref),
              "attn_block_q8s": (q8.attn_block_q8s, q8.attn_block_q8s_ref),
              "mlp_block_q8s": (q8.mlp_block_q8s, q8.mlp_block_q8s_ref)}


def _q8_args(dev, name, shape, dtype, seed):
    """x and the remaining arguments of int8 kernel ``name``: int8
    weights from quantize_weight, static scales folded as the converter
    does, the head count last for the attention blocks."""
    b, n, c, heads = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    x = _randn(g, b, n, c, dtype=dtype)
    ln = (_randn(g, c, scale=0.1, offset=1.0), _randn(g, c, scale=0.1))

    def dense(din, dout, act):
        w_q8, s = q8.quantize_weight(_randn(g, din, dout, scale=din ** -0.5))
        return w_q8, s * act, _randn(g, dout, scale=0.1)

    static = name.endswith("s")
    act = Q8_ACT if static else (1.0, 1.0)
    if name.startswith("attn"):
        args = (*ln, *dense(c, 3 * c, act[0]), *dense(c, c, act[1]))
    else:
        args = (*ln, *dense(c, 4 * c, act[0]), *dense(4 * c, c, act[1]))
    if static:
        args += (torch.tensor([1.0 / a for a in Q8_ACT], device=dev),)
    return x, args + ((heads,) if name.startswith("attn") else ())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", Q8_SHAPES)
@pytest.mark.parametrize("name", list(Q8_KERNELS))
def test_q8_kernel_matches_plain(name, shape, dtype):
    dev = _cuda()
    kernel, plain = Q8_KERNELS[name]
    x, args = _q8_args(dev, name, shape, dtype, seed=10)
    before = kernel.launches
    out = kernel(x, *args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    ref = plain(x, *args)
    assert out.dtype == ref.dtype == dtype and out.shape == ref.shape
    assert bool(torch.isfinite(out.float()).all())
    scaled = (out.float() - ref.float()).abs() / (1.0 + ref.float().abs())
    assert float(scaled.max()) <= Q8_TOL, float(scaled.max())
    assert float(scaled.mean()) <= Q8_MEAN_TOL, float(scaled.mean())


def test_q8_kernels_refuse_bad_int8_weights():
    dev = _cuda()
    x, (g1, b1, wq, sq, bq, wp, sp, bp, heads) = _q8_args(
        dev, "attn_block_q8", (1, 9, 64, 4), torch.float32, seed=11)
    before = q8.attn_block_q8.launches
    with pytest.raises(ValueError):         # an int8 weight on the CPU
        q8.attn_block_q8(x, g1, b1, wq.cpu(), sq, bq, wp, sp, bp, heads)
    with pytest.raises(ValueError):         # an int8 weight not contiguous
        q8.attn_block_q8(x, g1, b1, wq.t().contiguous().t(), sq, bq, wp, sp,
                         bp, heads)
    with pytest.raises(TypeError):          # a weight that is not int8
        q8.attn_block_q8(x, g1, b1, wq.float(), sq, bq, wp, sp, bp, heads)
    x, (g2, b2, w1, s1, bb1, w2, s2, bb2, inv) = _q8_args(
        dev, "mlp_block_q8s", (1, 9, 64, 4), torch.float32, seed=12)
    with pytest.raises(ValueError):         # w2 transposed, not contiguous
        q8.mlp_block_q8s(x, g2, b2, w1, s1, bb1, w1.t(), s2, bb2, inv)
    with pytest.raises(ValueError):         # inv_scales on the CPU
        q8.mlp_block_q8s(x, g2, b2, w1, s1, bb1, w2, s2, bb2, inv.cpu())
    assert q8.attn_block_q8.launches == before


def test_q8_kernels_take_kmajor_copies():
    """The K-major copies passed as ``kmajor`` give the bits the blocks
    give when they make the copies themselves; a copy of the wrong shape,
    dtype or alignment raises before any launch."""
    dev = _cuda()
    x, args = _q8_args(dev, "attn_block_q8", (2, 197, 768, 12),
                       torch.bfloat16, seed=13)
    g1, b1, wq, sq, bq, wp, sp, bp, heads = args
    kmajor = (wq.t().contiguous(), wp.t().contiguous())
    assert torch.equal(q8.attn_block_q8(x, *args, kmajor=kmajor),
                       q8.attn_block_q8(x, *args))
    x, args = _q8_args(dev, "mlp_block_q8s", (2, 197, 768, 12),
                       torch.bfloat16, seed=14)
    w1, w2 = args[2], args[5]
    kmajor = (w1.t().contiguous(), w2.t().contiguous())
    assert torch.equal(q8.mlp_block_q8s(x, *args, kmajor=kmajor),
                       q8.mlp_block_q8s(x, *args))
    before = q8.mlp_block_q8s.launches
    with pytest.raises(ValueError):         # (in, out), not (out, in)
        q8.mlp_block_q8s(x, *args, kmajor=(w1, w2))
    with pytest.raises(TypeError):          # not int8
        q8.mlp_block_q8s(x, *args, kmajor=(kmajor[0].float(), kmajor[1]))
    shifted = torch.empty(kmajor[0].numel() + 1, dtype=torch.int8,
                          device=dev)[1:].view(kmajor[0].shape)
    shifted.copy_(kmajor[0])
    with pytest.raises(ValueError):         # not 16-byte aligned (TMA)
        q8.mlp_block_q8s(x, *args, kmajor=(shifted, kmajor[1]))
    assert q8.mlp_block_q8s.launches == before


# the int8 GEMM's epilogues (csrc/gemm_sm90.cuh's int8 modes) against the
# plain integer arithmetic (q8.gemm_q8_ref), bit for bit: the int32 sums
# are exact in any order and the flush and epilogue round the same
# operations in the same order.  GELU_F32's erf may differ in its last
# bits (erff against PyTorch's gelu), within Q8_ERF_TOL·(1+|ref|);
# GELU_Q8 rounds that GELU to int8 and is held bit for bit.
Q8_ERF_TOL = 1e-6
# name: (epilogue, dynamic row scales)
Q8_GEMM_EPIS = {"out": (q8.QEPI_OUT, True),
                "out_static": (q8.QEPI_OUT, False),
                "resid": (q8.QEPI_RESID, True),
                "resid_static": (q8.QEPI_RESID, False),
                "gelu_f32": (q8.QEPI_GELU_F32, True),
                "gelu_q8": (q8.QEPI_GELU_Q8, False)}


def _q8_gemm_case(dev, name, dtype, rows, groups, seed, k=768, n=384,
                  bn=0):
    """The card's int8 product of seeded operands and the plain integer
    arithmetic on the same operands: (out, ref)."""
    epi, dynamic = Q8_GEMM_EPIS[name]
    g = torch.Generator(device=dev).manual_seed(seed)
    a_q = torch.randint(-127, 128, (rows, k), generator=g, device=dev,
                        dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                      dtype=torch.int8)
    row_scale = (torch.rand(rows, groups, generator=g, device=dev) * 0.02
                 + 1e-3) if dynamic else None
    col_scale = torch.rand(n, generator=g, device=dev) * 2e-3 + 1e-4
    if not dynamic:
        col_scale = col_scale * 0.02
    bias = _randn(g, n, scale=0.1)
    resid = _randn(g, rows, n, dtype=dtype)
    inv = torch.tensor([127 / 1.5], device=dev)
    out_dtype = {q8.QEPI_GELU_F32: torch.float32,
                 q8.QEPI_GELU_Q8: torch.int8}.get(epi, dtype)
    out = torch.empty(rows, n, dtype=out_dtype, device=dev)
    q8._gemm(q8._lib(), dtype, epi, a_q, w.t().contiguous(), row_scale,
             col_scale, bias, resid, inv.data_ptr(), out, k // groups,
             f"int8 product {name}", bn)
    torch.cuda.synchronize()
    ref = q8.gemm_q8_ref(epi, a_q, w, row_scale, col_scale, bias, resid,
                         inv, k // groups, dtype)
    return out, ref


def _assert_q8_gemm(name, out, ref):
    assert out.dtype == ref.dtype and out.shape == ref.shape
    if Q8_GEMM_EPIS[name][0] == q8.QEPI_GELU_F32:
        err = (out - ref).abs() / (1 + ref.abs())
        assert float(err.max()) <= Q8_ERF_TOL, float(err.max())
    else:
        assert torch.equal(out, ref), int((out != ref).sum())


# k = 768 in 1 group, or 4 groups of 192 (each ending inside a stage)
@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("rows", [5, 197, 394, 1576])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(Q8_GEMM_EPIS))
def test_q8_gemm_epilogue_bit_equal_to_plain(name, dtype, rows, groups):
    dev = _cuda()
    out, ref = _q8_gemm_case(dev, name, dtype, rows, groups, seed=rows)
    _assert_q8_gemm(name, out, ref)


# every tile width at fc2's depth, ragged rows: one K group (every width)
# or fc2's 4 groups of 768 (the grouped mode stops at 128 wide)
@pytest.mark.parametrize("bn,groups", [(64, 1), (96, 1), (128, 1), (192, 1),
                                       (64, 4), (96, 4), (128, 4)])
@pytest.mark.parametrize("name", list(Q8_GEMM_EPIS))
def test_q8_gemm_every_width_bit_equal(name, bn, groups):
    dev = _cuda()
    out, ref = _q8_gemm_case(dev, name, torch.bfloat16, 394, groups,
                             seed=bn, k=3072, n=768, bn=bn)
    _assert_q8_gemm(name, out, ref)


def test_q8_gemm_refuses_a_grouped_tile_past_its_widest():
    """The grouped int8 product at BN = 192 (its sums spill) is refused."""
    dev = _cuda()
    with pytest.raises(RuntimeError, match="invalid argument"):
        _q8_gemm_case(dev, "resid", torch.bfloat16, 197, 4, seed=0, bn=192)
    lib, width = q8._lib(), ctypes.c_int()    # fc2 at B = 128: 192 unpicked
    q8._build.check(lib, lib.dfu_q8_gemm_width(
        0, q8.QEPI_RESID, 25216, 768, 3072, 768, ctypes.addressof(width)),
        "pick")
    assert width.value == 128


@pytest.mark.parametrize("block_impl", ["fused_q8", "fused_q8s"])
def test_thermal_int8_eval_on_card_matches_cpu(block_impl):
    """A small thermal_only model quantised (on the card through
    quantize_for_serving, or calibrated on the CPU) and evaluated in fp32
    on the card against the same int8 weights on the CPU (plain versions):
    sums in another order, plus the int8 roundings that flips."""
    dev = _cuda()
    from dfu_multimodal_tpu_torch.models import zoo
    from dfu_multimodal_tpu_torch.models.vit import quantize_variables
    from dfu_multimodal_tpu_torch.serve.engine import quantize_for_serving
    from dfu_multimodal_tpu_torch.train.engine import (Trainer, TrainConfig,
                                                       thermal_modality)
    mods = {"thermal": thermal_modality()}
    tiny = dict(image_size=32, depth=2, hidden_dim=64, num_heads=4,
                patch_size=8)

    def trainer(device, impl):
        return Trainer("thermal_only", TrainConfig(compute_dtype="float32"),
                       mods, device=device, block_impl=impl, **tiny)

    fp32 = trainer("cpu", "fused")
    zoo.init_model(fp32.module, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {"thermal": rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)}
    if block_impl == "fused_q8":
        card_fp32 = trainer(dev, "fused")
        card_fp32.module.load_state_dict(fp32.variables())
        card = quantize_for_serving(card_fp32, image_size=32)
        state = quantize_variables(fp32.variables())
        for k, v in card.variables().items():   # quantised on the card
            assert torch.equal(v.cpu(), state[k]), k
    else:
        calib = torch.from_numpy(rng.standard_normal((4, 32, 32, 3)).astype(
            np.float32))
        state = quantize_variables(fp32.variables(), calib_batches=[calib])
        card = trainer(dev, block_impl)
        card.module.load_state_dict(state)
    cpu = trainer("cpu", block_impl)
    cpu.module.load_state_dict(state)
    kernel = Q8_KERNELS[f"attn_block_{block_impl[6:]}"][0]
    before = kernel.launches
    out = card.eval_step(batch)
    assert kernel.launches == before + 2            # one per block
    ref = cpu.eval_step(batch)
    np.testing.assert_allclose(out["probs"].cpu().numpy(),
                               ref["probs"].numpy(), rtol=0, atol=1e-2)


# ------------------------------------------- ToMe's key bias (K1, K7, K8)

# (batch, tokens, width, heads): the token-merged ViT-B/16 block at
# --token-merge 4:128 and at the least keep at 224² (99 tokens, a partial
# second key tile), small widths at head dims 16 and 32 (no power-of-two
# scale), and 577 tokens (the fp32 core's tiled kernel)
BIAS_SHAPES = [(8, 128, 768, 12), (2, 99, 768, 12), (3, 40, 64, 4),
               (2, 33, 64, 2), (1, 577, 128, 2)]


def _log_sizes(dev, b, n, seed):
    """A proportional-attention bias: log of token sizes 1..8, (B, N)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(1, 9, (b, n), generator=g, device=dev).float().log()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", BIAS_SHAPES)
def test_biased_attn_block_kernel_matches_plain(shape, dtype):
    """K1 with the key bias against ``attn_block_ref(bias=)``, counted in
    ``launches`` and ``bias_launches``; a zero bias gives the unbiased
    kernel's bits."""
    dev = _cuda()
    b, n, c, heads = shape
    x, ln, attn, _ = _block_args(dev, b, n, c, dtype, seed=30)
    bias = _log_sizes(dev, b, n, seed=31)
    before = (vb.attn_block.launches, vb.attn_block.bias_launches)
    out = vb.attn_block(x, *ln, *attn, heads, bias=bias)
    torch.cuda.synchronize()
    assert (vb.attn_block.launches, vb.attn_block.bias_launches) == (
        before[0] + 1, before[1] + 1)
    _assert_close(out, vb.attn_block_ref(x, *ln, *attn, heads, bias=bias),
                  TOL[dtype])
    assert torch.equal(vb.attn_block(x, *ln, *attn, heads,
                                     bias=torch.zeros_like(bias)),
                       vb.attn_block(x, *ln, *attn, heads))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", BIAS_SHAPES[:4])
@pytest.mark.parametrize("name", ["attn_block_q8", "attn_block_q8s"])
def test_biased_q8_attn_kernel_matches_plain(name, shape, dtype):
    dev = _cuda()
    kernel, plain = Q8_KERNELS[name]
    x, args = _q8_args(dev, name, shape, dtype, seed=32)
    bias = _log_sizes(dev, shape[0], shape[1], seed=33)
    before = kernel.bias_launches
    out = kernel(x, *args, bias)
    torch.cuda.synchronize()
    assert kernel.bias_launches == before + 1
    ref = plain(x, *args, bias)
    scaled = (out.float() - ref.float()).abs() / (1.0 + ref.float().abs())
    assert bool(torch.isfinite(out.float()).all())
    assert float(scaled.max()) <= Q8_TOL, float(scaled.max())
    assert float(scaled.mean()) <= Q8_MEAN_TOL, float(scaled.mean())
    assert torch.equal(kernel(x, *args, torch.zeros_like(bias)),
                       kernel(x, *args))


def test_biased_kernels_refuse_a_bias_of_another_shape():
    dev = _cuda()
    x, ln, attn, _ = _block_args(dev, 2, 40, 64, torch.bfloat16, seed=34)
    for bad in (torch.zeros(2, 41, device=dev), torch.zeros(40, device=dev),
                torch.zeros(2, 40)):
        with pytest.raises(ValueError, match="bias"):
            vb.attn_block(x, *ln, *attn, 4, bias=bad)
    x, args = _q8_args(dev, "attn_block_q8", (2, 40, 64, 4), torch.bfloat16,
                       seed=35)
    with pytest.raises(ValueError, match="bias"):
        q8.attn_block_q8(x, *args, torch.zeros(2, 39, device=dev))


# ------------------------------------------------- fused ResNet bottleneck

# (batch, H=W, Cin, Cmid, Cout): ResNet-50's stage 1 projection block and
# stage 3 / stage 4 identity blocks at small batches (a 64-row tile spans
# several 7x7 images), and ragged small shapes (K = 9·24 and 40 not
# multiples of the tile's K step, a projection with Cin < Cout)
BOTTLENECK_SHAPES = [(2, 56, 64, 64, 256), (2, 14, 1024, 256, 1024),
                     (3, 7, 2048, 512, 2048), (3, 6, 16, 8, 32),
                     (2, 5, 40, 24, 40)]


def _bottleneck_args(dev, shape, dtype, seed):
    """x (B, H, W, Cin) and (w1, b1, w2, b2, w3, b3[, wd, bd]): weights in
    the compute dtype, biases fp32; the projection when Cin != Cout."""
    b, hw, cin, cmid, cout = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    x = _randn(g, b, hw, hw, cin, dtype=dtype)
    args = [_randn(g, cin, cmid, scale=cin ** -0.5, dtype=dtype),
            _randn(g, cmid, scale=0.1),
            _randn(g, 9 * cmid, cmid, scale=(9 * cmid) ** -0.5, dtype=dtype),
            _randn(g, cmid, scale=0.1),
            _randn(g, cmid, cout, scale=cmid ** -0.5, dtype=dtype),
            _randn(g, cout, scale=0.1)]
    if cin != cout:
        args += [_randn(g, cin, cout, scale=cin ** -0.5, dtype=dtype),
                 _randn(g, cout, scale=0.1)]
    return x, args


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", BOTTLENECK_SHAPES)
def test_bottleneck_kernel_matches_plain(shape, dtype):
    dev = _cuda()
    x, args = _bottleneck_args(dev, shape, dtype, seed=5)
    proj = len(args) == 8
    before = (rb.fused_bottleneck.launches, rb.fused_bottleneck.proj_launches)
    out = rb.fused_bottleneck(x, *args)
    torch.cuda.synchronize()
    assert (rb.fused_bottleneck.launches,
            rb.fused_bottleneck.proj_launches) == (before[0] + (not proj),
                                                   before[1] + proj)
    _assert_close(out, rb.bottleneck_ref(x, *args), TOL[dtype])


@pytest.mark.parametrize("shape", [(3, 6, 16, 8, 32), (2, 5, 40, 24, 40)])
def test_bottleneck_remat_backward_on_card(shape):
    """FusedBottleneck on the card in fp32: the kernel forward and the
    gradients of x and every weight (remat through the plain version)
    against autograd of the plain version on the CPU."""
    dev = _cuda()
    x, args = _bottleneck_args(dev, shape, torch.float32, seed=6)
    extra = [] if len(args) == 8 else [None, None]
    grads = {}
    for where in (dev, "cpu"):
        leaves = [t.detach().to(where).requires_grad_(True)
                  for t in [x] + args]
        if where == "cpu":
            out = rb.bottleneck_ref(*leaves, *extra)
        else:
            out = rb.FusedBottleneck.apply(*leaves, *extra)
        (out ** 2).sum().backward()
        grads[str(where)] = [out.detach().cpu()] + [t.grad.cpu()
                                                    for t in leaves]
    for got, ref in zip(grads[str(dev)], grads["cpu"]):
        _assert_close(got, ref, TOL[torch.float32])


def test_bottleneck_refuses_bad_operands():
    """A CUDA operand the kernel does not take raises; nothing falls back
    to the plain version."""
    dev = _cuda()
    x, args = _bottleneck_args(dev, (2, 6, 32, 8, 32), torch.float32, seed=7)
    before = rb.fused_bottleneck.launches
    with pytest.raises(TypeError):          # half precision has no kernel
        rb.fused_bottleneck(x.half(), *args)
    with pytest.raises(TypeError):          # weight not in x's dtype
        rb.fused_bottleneck(x, args[0].bfloat16(), *args[1:])
    with pytest.raises(ValueError):         # operand on another device
        rb.fused_bottleneck(x, *args[:5], args[5].cpu())
    with pytest.raises(ValueError):         # NCHW view: not NHWC-contiguous
        rb.fused_bottleneck(x.permute(0, 3, 1, 2).contiguous().permute(
            0, 2, 3, 1), *args)
    with pytest.raises(ValueError):         # identity needs Cin == Cout
        rb.fused_bottleneck(x[..., :16].contiguous(),
                            args[0][:16].contiguous(), *args[1:])
    with pytest.raises(ValueError):         # w2 is (9·Cmid, Cmid)
        rb.fused_bottleneck(x, args[0], args[1], args[2][:64].contiguous(),
                            *args[3:])
    assert rb.fused_bottleneck.launches == before


@pytest.mark.parametrize("shape", [(2, 14, 1024, 256, 1024),
                                   (2, 56, 64, 64, 256), (2, 5, 40, 24, 40)])
def test_bottleneck_bf16_is_deterministic(shape):
    """The bf16 products on the TMA + wgmma GEMM (no split-K, no atomics):
    two calls give equal bits."""
    dev = _cuda()
    x, args = _bottleneck_args(dev, shape, torch.bfloat16, seed=13)
    assert torch.equal(rb.fused_bottleneck(x, *args),
                       rb.fused_bottleneck(x, *args))


def test_bottleneck_bf16_refuses_what_the_gemm_does_not_take():
    """The bf16 products read 16-byte rows by TMA and the 3x3 gathers
    16-byte chunks of one tap: a channel count that is no multiple of 8
    or an operand off a 16-byte boundary raises ValueError (fp32 takes
    any of them on the SIMT tile); nothing falls back."""
    dev = _cuda()
    before = (rb.fused_bottleneck.launches, rb.fused_bottleneck.proj_launches)
    for shape in [(2, 6, 32, 12, 32), (2, 6, 20, 8, 20), (2, 6, 16, 8, 36)]:
        x, args = _bottleneck_args(dev, shape, torch.bfloat16, seed=14)
        with pytest.raises(ValueError, match="multiples of 8"):
            rb.fused_bottleneck(x, *args)
    x, args = _bottleneck_args(dev, (2, 6, 32, 8, 32), torch.bfloat16,
                               seed=15)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
    shifted = flat[1:].view(x.shape)                 # 2 bytes off
    shifted.copy_(x)
    with pytest.raises(ValueError, match="16-byte"):
        rb.fused_bottleneck(shifted, *args)
    w1 = torch.empty(args[0].numel() + 1, dtype=x.dtype, device=dev)
    w1 = w1[1:].view(args[0].shape)
    w1.copy_(args[0])
    with pytest.raises(ValueError, match="16-byte"):
        rb.fused_bottleneck(x, w1, *args[1:])
    assert (rb.fused_bottleneck.launches,
            rb.fused_bottleneck.proj_launches) == before
    x, args = _bottleneck_args(dev, (2, 6, 32, 12, 32), torch.float32,
                               seed=16)
    _assert_close(rb.fused_bottleneck(x, *args), rb.bottleneck_ref(x, *args),
                  TOL[torch.float32])


def test_rgb_only_fused_eval_on_card_matches_cpu_and_cudnn():
    """The rgb_only eval step with block_impl="fused" in fp32 on the card
    against the same weights on the CPU (plain versions) and against the
    card's cuDNN blocks (TF32 off): only summation order and where BN is
    applied differ.  One eval step launches 12 identity and 1 projection
    bottleneck."""
    dev = _cuda()
    from dfu_multimodal_tpu_torch.models import zoo
    from dfu_multimodal_tpu_torch.train.engine import (Trainer, TrainConfig,
                                                       rgb_modality)
    mods = {"rgb": rgb_modality()}
    cfg = TrainConfig(compute_dtype="float32")
    cpu = Trainer("rgb_only", cfg, mods, device="cpu", image_size=64,
                  block_impl="fused")
    zoo.init_model(cpu.module, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():                   # BN statistics off identity
        for m in cpu.module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.running_mean.normal_(0.0, 0.1, generator=g)
    rng = np.random.default_rng(0)
    batch = {"rgb": rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)}
    ref = cpu.eval_step(batch)["probs"].numpy()
    for block_impl in ("fused", "flax"):
        card = Trainer("rgb_only", cfg, mods, device=dev, image_size=64,
                       block_impl=block_impl)
        card.module.load_state_dict(cpu.module.state_dict())
        before = (rb.fused_bottleneck.launches,
                  rb.fused_bottleneck.proj_launches)
        out = card.eval_step(batch)["probs"].cpu().numpy()
        launched = (rb.fused_bottleneck.launches - before[0],
                    rb.fused_bottleneck.proj_launches - before[1])
        assert launched == ((12, 1) if block_impl == "fused" else (0, 0))
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


# ------------------------------------------------- whole-stage kernel K12

# (batch, H=W, C, Cmid, blocks): ResNet-50's four stage tails, and a small
# ragged stage (K = 9·24 and 40 not multiples of the tile's K step)
STAGE_SHAPES = [(2, 56, 256, 64, 2), (2, 28, 512, 128, 3),
                (2, 14, 1024, 256, 5), (2, 7, 2048, 512, 2),
                (3, 5, 40, 24, 3)]


def _stage_args(dev, shape, dtype, seed):
    """x (B, H, W, C) and the blocks' (w1, b1, w2, b2, w3, b3)."""
    b, hw, c, cmid, n = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    x = _randn(g, b, hw, hw, c, dtype=dtype)
    blocks = [(_randn(g, c, cmid, scale=c ** -0.5, dtype=dtype),
               _randn(g, cmid, scale=0.1),
               _randn(g, 9 * cmid, cmid, scale=(9 * cmid) ** -0.5,
                      dtype=dtype),
               _randn(g, cmid, scale=0.1),
               _randn(g, cmid, c, scale=cmid ** -0.5, dtype=dtype),
               _randn(g, c, scale=0.1)) for _ in range(n)]
    return x, blocks


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", STAGE_SHAPES)
def test_stage_kernel_matches_plain(shape, dtype):
    """One launch per call.  fp32: the stage within TOL of stage_ref.
    bf16: the one-step roundings TOL admits for a block carry into the
    next, so each block of the chain that the kernel runs is held within
    TOL of its plain version on the same input."""
    dev = _cuda()
    x, blocks = _stage_args(dev, shape, dtype, seed=8)
    before = rb.fused_stage.launches
    out = rb.fused_stage(x, blocks)
    torch.cuda.synchronize()
    assert rb.fused_stage.launches == before + 1
    if dtype == torch.float32:
        _assert_close(out, rb.stage_ref(x, blocks), TOL[dtype])
        return
    h = x
    for blk in blocks:
        nxt = rb.fused_bottleneck(h, *blk)
        _assert_close(nxt, rb.bottleneck_ref(h, *blk), TOL[dtype])
        h = nxt
    assert torch.equal(out, h)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", STAGE_SHAPES)
def test_stage_kernel_equals_the_k11_chain(shape, dtype):
    dev = _cuda()
    x, blocks = _stage_args(dev, shape, dtype, seed=9)
    h = x
    for blk in blocks:
        h = rb.fused_bottleneck(h, *blk)
    assert torch.equal(rb.fused_stage(x, blocks), h)


@pytest.mark.parametrize("shape", [(3, 5, 40, 24, 3), (2, 7, 64, 16, 2)])
def test_stage_remat_backward_on_card(shape):
    """FusedStage on the card in fp32: the kernel forward and the
    gradients of x and every block weight (remat through stage_ref)
    against autograd of stage_ref on the CPU."""
    dev = _cuda()
    x, blocks = _stage_args(dev, shape, torch.float32, seed=10)
    results = {}
    for where in (dev, "cpu"):
        leaves = [t.detach().to(where).requires_grad_(True)
                  for t in [x] + rb.FusedStage.flat(blocks)]
        if where == "cpu":
            out = rb.stage_ref(leaves[0], [leaves[i:i + 6] for i in range(
                1, len(leaves), 6)])
        else:
            out = rb.FusedStage.apply(*leaves)
        (out ** 2).sum().backward()
        results[str(where)] = [out.detach().cpu()] + [t.grad.cpu()
                                                      for t in leaves]
    for got, ref in zip(results[str(dev)], results["cpu"]):
        _assert_close(got, ref, TOL[torch.float32])


def test_stage_refuses_bad_operands():
    """A CUDA operand the kernel does not take raises; nothing falls back
    to the plain version or to the K11 chain."""
    dev = _cuda()
    x, blocks = _stage_args(dev, (2, 6, 32, 8, 3), torch.float32, seed=11)
    before = (rb.fused_stage.launches, rb.fused_bottleneck.launches)
    w1, b1, w2, b2, w3, b3 = blocks[1]
    with pytest.raises(TypeError):          # half precision has no kernel
        rb.fused_stage(x.half(), blocks)
    with pytest.raises(TypeError):          # weight not in x's dtype
        rb.fused_stage(x, [blocks[0], (w1.bfloat16(), b1, w2, b2, w3, b3)])
    with pytest.raises(ValueError):         # operand on another device
        rb.fused_stage(x, [blocks[0], (w1, b1, w2, b2, w3, b3.cpu())])
    with pytest.raises(ValueError):         # NCHW view: not NHWC-contiguous
        rb.fused_stage(x.permute(0, 3, 1, 2).contiguous().permute(
            0, 2, 3, 1), blocks)
    with pytest.raises(ValueError):         # projection: identity only
        rb.fused_stage(x, [blocks[0] + (w1, b1)])
    with pytest.raises(ValueError):         # w2 is (9·Cmid, Cmid)
        rb.fused_stage(x, [(w1, b1, w2[:64].contiguous(), b2, w3, b3)])
    with pytest.raises(ValueError):         # more blocks than one launch
        rb.fused_stage(x, blocks * 14)
    # bf16 (the TMA + wgmma stage kernel): channel counts that are not
    # multiples of 8, and operands not 16-byte aligned
    for shape in ((2, 6, 36, 8, 2), (2, 6, 32, 12, 2)):
        xb, bb = _stage_args(dev, shape, torch.bfloat16, seed=11)
        with pytest.raises(ValueError):
            rb.fused_stage(xb, bb)
    xb, bb = _stage_args(dev, (2, 6, 32, 8, 2), torch.bfloat16, seed=11)

    def offset(t):                          # t's values two bytes off
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        out = flat[1:].view(t.shape)
        out.copy_(t)
        assert out.data_ptr() % 16 == 2
        return out

    with pytest.raises(ValueError):
        rb.fused_stage(offset(xb), bb)
    for i in (0, 2, 4):                     # w1, w2, w3
        blk = list(bb[1])
        blk[i] = offset(blk[i])
        with pytest.raises(ValueError):
            rb.fused_stage(xb, [bb[0], tuple(blk)])
    assert (rb.fused_stage.launches, rb.fused_bottleneck.launches) == before


# ResNet-50's four stage tails at the serving batch and at 128: the tile
# shapes the stage kernel takes (64 x 64 at stages 2-4 of batch 8, 128
# rows at 64 or 128 columns elsewhere) and stage 1's 401,408 rows
@pytest.mark.parametrize("batch", [8, 128])
@pytest.mark.parametrize("tail", [(56, 256, 64, 2), (28, 512, 128, 3),
                                  (14, 1024, 256, 5), (7, 2048, 512, 2)])
def test_stage_kernel_equals_the_k11_chain_at_the_stage_tails(tail, batch):
    dev = _cuda()
    x, blocks = _stage_args(dev, (batch,) + tail, torch.bfloat16, seed=13)
    h = x
    for blk in blocks:
        h = rb.fused_bottleneck(h, *blk)
    out = rb.fused_stage(x, blocks)
    assert torch.equal(out, h)
    assert torch.equal(rb.fused_stage(x, blocks), out)


def test_stage_kernel_mixes_gathered_and_tma_3x3s():
    """bf16 blocks of one launch whose 3x3s take both A paths (Cmid 64:
    TMA boxes; Cmid 24: the cp.async gather, whose full barriers count 129
    arrivals, so every TMA phase's producer arrives 128 times more), equal
    to the K11 chain bit for bit."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(14)
    c = 64
    x = _randn(g, 2, 7, 7, c, dtype=torch.bfloat16)
    blocks = [(_randn(g, c, m, scale=c ** -0.5, dtype=torch.bfloat16),
               _randn(g, m, scale=0.1),
               _randn(g, 9 * m, m, scale=(9 * m) ** -0.5,
                      dtype=torch.bfloat16),
               _randn(g, m, scale=0.1),
               _randn(g, m, c, scale=m ** -0.5, dtype=torch.bfloat16),
               _randn(g, c, scale=0.1)) for m in (64, 24, 64)]
    h = x
    for blk in blocks:
        h = rb.fused_bottleneck(h, *blk)
    assert torch.equal(rb.fused_stage(x, blocks), h)


def test_stage_tile_mirror():
    """The stage kernel's tile shape (dfu_stage_tile) equals the plain
    mirror the CPU schedule walk uses, at the four stage tails."""
    dev = _cuda()
    lib = rb._lib()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for batch in (2, 8, 128):
        for hw, _, cmid, _ in ((56, 256, 64, 2), (28, 512, 128, 3),
                               (14, 1024, 256, 5), (7, 2048, 512, 2)):
            rm, bn = ctypes.c_int(), ctypes.c_int()
            rows = batch * hw * hw
            assert lib.dfu_stage_tile(dev.index, rows, cmid,
                                      ctypes.addressof(rm),
                                      ctypes.addressof(bn)) == 0
            assert (rm.value, bn.value) == rb._stage_tile(rows, cmid, sms)


def test_stage_kernel_is_deterministic():
    """No atomics: two calls give equal bits."""
    dev = _cuda()
    for dtype in DTYPES:
        x, blocks = _stage_args(dev, (8, 14, 1024, 256, 5), dtype, seed=12)
        assert torch.equal(rb.fused_stage(x, blocks),
                           rb.fused_stage(x, blocks))


# ------------------------------------------------- attention (K6, K9)

# packed (batch, tokens, width, heads): head dims 64, 16, 32 and 8
QKV_SHAPES = SHAPES[:3] + [(3, 20, 32, 4)]
# (B, H, N, D): ViT-B/16 at the serving batch, tests/test_ops.py's shapes
# and the non-power-of-two scale at D = 32
FLASH_SHAPES = [(2, 12, 197, 64), (1, 2, 16, 8), (2, 4, 40, 16),
                (2, 4, 40, 32)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", QKV_SHAPES)
def test_qkv_attention_kernels_match_plain(shape, dtype):
    dev = _cuda()
    b, n, c, heads = shape
    gen = torch.Generator(device=dev).manual_seed(20)
    qkv = _randn(gen, b, n, 3 * c, dtype=dtype)
    do = _randn(gen, b, n, c, dtype=dtype)
    before = (at.qkv_attention_fwd.launches, at.qkv_attention_bwd.launches)
    out = at.qkv_attention_fwd(qkv, heads)
    dqkv = at.qkv_attention_bwd(qkv, do, heads)
    torch.cuda.synchronize()
    assert (at.qkv_attention_fwd.launches,
            at.qkv_attention_bwd.launches) == (before[0] + 1, before[1] + 1)
    _assert_close(out, at.qkv_attention_ref(qkv, heads), TOL[dtype])
    _assert_close(dqkv, at.qkv_attention_bwd_ref(qkv, do, heads), TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_attention_kernels_match_plain(shape, dtype):
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(21)
    q, k, v, do = (_randn(gen, *shape, dtype=dtype) for _ in range(4))
    before = (at.flash_attention_fwd.launches,
              at.flash_attention_bwd.launches)
    out = at.flash_attention_fwd(q, k, v)
    grads = at.flash_attention_bwd(q, k, v, do)
    torch.cuda.synchronize()
    assert (at.flash_attention_fwd.launches,
            at.flash_attention_bwd.launches) == (before[0] + 1,
                                                 before[1] + 1)
    _assert_close(out, at.flash_attention_ref(q, k, v), TOL[dtype])
    _assert_all_close(grads, at.flash_attention_bwd_ref(q, k, v, do),
                      TOL[dtype])


def test_attention_kernels_refuse_a_head_that_does_not_fit():
    """400 rows of D = 64: past one block's shared memory for the
    whole-head kernels (the backward's K, V, dK and dV; the fp32
    forward's K and V; the bf16 forward is one kernel for every N), so
    the tiled kernels run, and match their plain versions; a
    head dim no kernel takes (128) is still refused, with no plain
    fallback."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(9)
    for dtype in DTYPES:
        qkv = _randn(gen, 2, 400, 3 * 128, dtype=dtype)
        do = _randn(gen, 2, 400, 128, dtype=dtype)
        _assert_close(at.qkv_attention_fwd(qkv, 2),
                      at.qkv_attention_ref(qkv, 2), TOL[dtype])
        _assert_all_close(at.qkv_attention_fwdbwd(qkv, do, 2),
                          at.qkv_attention_fwdbwd_ref(qkv, do, 2),
                          TOL[dtype])
        _assert_close(at.qkv_attention_bwd(qkv, do, 2),
                      at.qkv_attention_bwd_ref(qkv, do, 2), TOL[dtype])
        q, k, v, dob = (_randn(gen, 1, 2, 400, 64, dtype=dtype)
                        for _ in range(4))
        _assert_close(at.flash_attention_fwd(q, k, v),
                      at.flash_attention_ref(q, k, v), TOL[dtype])
        _assert_all_close(at.flash_attention_bwd(q, k, v, dob),
                          at.flash_attention_bwd_ref(q, k, v, dob),
                          TOL[dtype])
    q = torch.zeros(1, 1, 400, 128, device=dev)
    with pytest.raises(ValueError):
        at.flash_attention_bwd(q, q, q, q)
    with pytest.raises(ValueError):
        at.qkv_attention_fwd(torch.zeros(1, 400, 3 * 128, device=dev), 1)
    with pytest.raises(TypeError):
        at.qkv_attention_fwd(qkv.double(), 2)


# the bf16 K1 and K2 run their products on the TMA + wgmma GEMM
# (csrc/gemm_sm90.cuh) and K1's attention step on the tensor-core forward
# with the deferred division (csrc/attention_fwd_mma.cuh, DEFER): every
# head dim K1 takes, (C, heads) by D, at B = 1, 2, 8 and N = 5, 40, 197
# (ViT-B/16's) and 577 (a 384² image)
FWD_WIDTHS = {16: (64, 4), 32: (128, 4), 64: (768, 12), 128: (256, 2)}


def _assert_mean_no_further_from_fp32(out, plain, truth):
    """The bf16 output's mean distance from the fp32 result on the same
    values within BF16_VS_PLAIN of the plain version's, plus fp32's
    TOL·mean|fp32| for the summation order.  K1's kernel divides by the
    softmax sum after P·V, as the Pallas kernel does, where its plain
    version normalises first, as the JAX oracle does: the two round
    different values, so over a few rows one element's rounding sets the
    max distance, and the mean is the measure of how far each lies."""
    truth = truth.float()
    kernel = float((out.float() - truth).abs().mean())
    ref = float((plain.float() - truth).abs().mean())
    slack = TOL[torch.float32] * float(truth.abs().mean())
    assert kernel <= (1 + BF16_VS_PLAIN) * ref + slack, (kernel, ref)


@pytest.mark.parametrize("d", sorted(FWD_WIDTHS))
@pytest.mark.parametrize("n", [5, 40, 197, 577])
@pytest.mark.parametrize("b", [1, 2, 8])
def test_bf16_vit_forward_blocks_match_plain(b, n, d):
    """The bf16 K1 and K2 against their plain versions within the bf16
    budget, one launch a call, two calls bit-equal; each no further from
    the fp32 result on the same values than its plain version: in mean
    distance, and in max distance than the plain walk of its own numerics
    (K2: the plain version; K1: its tile walk ``_attn_block_tiled_ref``,
    the deferred division), both within BF16_VS_PLAIN."""
    dev = _cuda()
    c, heads = FWD_WIDTHS[d]
    x, ln, attn, mlp = _block_args(dev, b, n, c, torch.bfloat16,
                                   seed=3000 + 10 * n + b)
    for fn, plains, args in ((vb.attn_block,
                              (vb.attn_block_ref, vb._attn_block_tiled_ref),
                              (x, *ln, *attn, heads)),
                             (vb.mlp_block, (vb.mlp_block_ref,),
                              (x, *ln, *mlp))):
        before = fn.launches
        out, again = fn(*args), fn(*args)
        torch.cuda.synchronize()
        assert fn.launches == before + 2
        ref = plains[0](*args)
        truth = plains[0](*(a.float() if isinstance(a, torch.Tensor) else a
                            for a in args))
        _assert_close(out, ref, TOL[torch.bfloat16])
        _assert_mean_no_further_from_fp32(out, ref, truth)
        _assert_no_further_from_fp32((out,), (plains[-1](*args),), (truth,))
        assert torch.equal(out, again)


def test_bf16_vit_forward_blocks_refuse_misaligned_operands():
    """TMA needs 16-byte-aligned bases and rows: a bf16 operand of K1, K2
    or the attention-block chain rule whose base lies 2 bytes past a
    16-byte boundary, or an MLP width that is no multiple of 8, raises
    ValueError (no fallback to another kernel); fp32 takes the SIMT
    chain, which needs neither."""
    dev = _cuda()
    x, ln, attn, mlp = _block_args(dev, 2, 9, 64, torch.bfloat16, seed=45)
    g = _randn(torch.Generator(device=dev).manual_seed(46), 2, 9, 64,
               dtype=torch.bfloat16)

    def offset(t):                        # contiguous, one element in
        flat = torch.empty(1 + t.numel(), dtype=t.dtype, device=dev)
        flat[1:].copy_(t.reshape(-1))
        return flat[1:].view(t.shape)

    cases = ((vb.attn_block, [x, *ln, *attn, 4], (0, 3, 5)),
             (vb.mlp_block, [x, *ln, *mlp], (0, 3, 5)),
             (vb.attn_block_bwd, [x, g, *ln, *attn[:3], 4], (1, 4, 6)))
    for fn, args, bad_at in cases:
        for i in bad_at:
            bad = list(args)
            bad[i] = offset(args[i])
            assert bad[i].is_contiguous() and bad[i].data_ptr() % 16 == 2
            with pytest.raises(ValueError):
                fn(*bad)
    _, ln36, _, mlp36 = _block_args(dev, 2, 9, 36, torch.bfloat16, seed=47)
    x36 = _randn(torch.Generator(device=dev).manual_seed(48), 2, 9, 36,
                 dtype=torch.bfloat16)
    with pytest.raises(ValueError):                     # C = 36
        vb.mlp_block(x36, *ln36, *mlp36)
    args32 = [t.float() for t in (x, *ln, *attn)] + [4]
    args32[0] = offset(args32[0])
    _assert_close(vb.attn_block(*args32), vb.attn_block_ref(*args32),
                  TOL[torch.float32])


# the bf16 forwards of K6 and K9 run one tensor-core kernel
# (csrc/attention_fwd_mma.cuh) for every token count and head dim: one
# partial 64-key tile up to ten (577, a 384² image); D = 8 and 32 scale the
# scores after the product
MMA_TOKENS = [1, 5, 16, 40, 197, 226, 577]
MMA_HEAD_DIMS = [8, 16, 32, 64]


@pytest.mark.parametrize("d", MMA_HEAD_DIMS)
@pytest.mark.parametrize("n", MMA_TOKENS)
def test_bf16_attention_forwards_match_plain(n, d):
    """The bf16 K6 and K9 forwards against their plain versions within the
    bf16 budget, one launch a call, two calls bit-equal."""
    dev = _cuda()
    b, heads = 2, 3
    gen = torch.Generator(device=dev).manual_seed(1000 * d + n)
    qkv = _randn(gen, b, n, 3 * heads * d, dtype=torch.bfloat16)
    q, k, v = (_randn(gen, b, heads, n, d, dtype=torch.bfloat16)
               for _ in range(3))
    for fn, plain, args in ((at.qkv_attention_fwd, at.qkv_attention_ref,
                             (qkv, heads)),
                            (at.flash_attention_fwd, at.flash_attention_ref,
                             (q, k, v))):
        before = fn.launches
        out, again = fn(*args), fn(*args)
        torch.cuda.synchronize()
        assert fn.launches == before + 2
        _assert_close(out, plain(*args), TOL[torch.bfloat16])
        assert torch.equal(out, again)


def test_bf16_attention_forwards_refuse_misaligned_operands():
    """The tensor-core forward copies 16-byte chunks: a bf16 operand whose
    base lies 2 bytes past a 16-byte boundary raises ValueError (no SIMT
    fallback); the same offset in fp32 runs the SIMT kernels."""
    dev = _cuda()
    b, heads, n, d = 2, 2, 40, 16

    def offset(dtype, *shape):            # contiguous, one element in
        flat = torch.randn(1 + math.prod(shape), device=dev).to(dtype)
        return flat[1:].view(*shape)

    qkv = offset(torch.bfloat16, b, n, 3 * heads * d)
    assert qkv.is_contiguous() and qkv.data_ptr() % 16 == 2
    with pytest.raises(ValueError):
        at.qkv_attention_fwd(qkv, heads)
    q = offset(torch.bfloat16, b, heads, n, d)
    k = torch.randn(b, heads, n, d, device=dev).to(torch.bfloat16)
    for args in ((q, k, k), (k, q, k), (k, k, q)):
        with pytest.raises(ValueError):
            at.flash_attention_fwd(*args)
    qkv32 = offset(torch.float32, b, n, 3 * heads * d)
    _assert_close(at.qkv_attention_fwd(qkv32, heads),
                  at.qkv_attention_ref(qkv32, heads), TOL[torch.float32])


# the bf16 backwards of K5, K6 and K9 run one tensor-core path
# (csrc/attention_bwd_mma.cuh) for every token count: one partial tile
# (1, 5) up to ten (577), both sides of the fp32 kernels' split (197,
# 209); D = 8 and 32 scale the scores after the product
BWD_TOKENS = [1, 5, 40, 197, 209, 226, 577]
# bf16: a kernel's distance from the fp32 result within 10% of the plain's
BF16_VS_PLAIN = 0.1


def _assert_no_further_from_fp32(outs, plains, truths):
    """Each bf16 output no further from the fp32 result on the same
    values than the plain version: within BF16_VS_PLAIN of its distance,
    plus fp32's TOL·(1 + max|fp32|) for the summation order."""
    for i, (out, ref, truth) in enumerate(zip(outs, plains, truths)):
        truth = truth.float()
        kernel = float((out.float() - truth).abs().max())
        plain = float((ref.float() - truth).abs().max())
        slack = TOL[torch.float32] * (1 + float(truth.abs().max()))
        assert kernel <= (1 + BF16_VS_PLAIN) * plain + slack, (i, kernel,
                                                               plain)


@pytest.mark.parametrize("d", MMA_HEAD_DIMS)
@pytest.mark.parametrize("n", BWD_TOKENS)
def test_bf16_attention_backwards_match_plain(n, d):
    """The bf16 K5, K6 and K9 backwards against their plain versions within
    the bf16 budget and no further from the fp32 result than they are, one
    launch a call, two calls bit-equal."""
    dev = _cuda()
    b, heads = 2, 3
    gen = torch.Generator(device=dev).manual_seed(2000 * d + n)
    qkv = _randn(gen, b, n, 3 * heads * d, dtype=torch.bfloat16)
    do = _randn(gen, b, n, heads * d, dtype=torch.bfloat16)
    q, k, v, dob = (_randn(gen, b, heads, n, d, dtype=torch.bfloat16)
                    for _ in range(4))
    for fn, plain, args in (
            (at.qkv_attention_fwdbwd, at.qkv_attention_fwdbwd_ref,
             (qkv, do, heads)),
            (at.qkv_attention_bwd, at.qkv_attention_bwd_ref,
             (qkv, do, heads)),
            (at.flash_attention_bwd, at.flash_attention_bwd_ref,
             (q, k, v, dob))):
        before = fn.launches
        out, again = fn(*args), fn(*args)
        torch.cuda.synchronize()
        assert fn.launches == before + 2
        if isinstance(out, torch.Tensor):
            out, again = (out,), (again,)
        refs = plain(*args)
        truths = plain(*(a.float() if isinstance(a, torch.Tensor) else a
                         for a in args))
        if isinstance(refs, torch.Tensor):
            refs, truths = (refs,), (truths,)
        _assert_all_close(out, refs, TOL[torch.bfloat16])
        _assert_no_further_from_fp32(out, refs, truths)
        assert all(torch.equal(a, b) for a, b in zip(out, again))


def test_bf16_attention_backwards_refuse_misaligned_operands():
    """The tensor-core backward copies 16-byte chunks: a bf16 operand of
    K5, K6, K9 or K10 whose base lies 2 bytes past a 16-byte boundary
    raises ValueError (no SIMT fallback); the same offset in fp32 runs the
    SIMT kernels."""
    dev = _cuda()
    b, heads, n, d = 2, 2, 40, 16

    def offset(dtype, *shape):            # contiguous, one element in
        flat = torch.randn(1 + math.prod(shape), device=dev).to(dtype)
        return flat[1:].view(*shape)

    qkv = offset(torch.bfloat16, b, n, 3 * heads * d)
    do = offset(torch.bfloat16, b, n, heads * d)
    assert qkv.data_ptr() % 16 == 2 and do.data_ptr() % 16 == 2
    good_qkv = torch.randn(b, n, 3 * heads * d, device=dev).bfloat16()
    good_do = torch.randn(b, n, heads * d, device=dev).bfloat16()
    for args in ((qkv, good_do), (good_qkv, do)):
        for fn in (at.qkv_attention_bwd, at.qkv_attention_fwdbwd):
            with pytest.raises(ValueError):
                fn(*args, heads)
    bad = offset(torch.bfloat16, b, heads, n, d)
    good = torch.randn(b, heads, n, d, device=dev).bfloat16()
    for i in range(4):
        args = [good] * 4
        args[i] = bad
        with pytest.raises(ValueError):
            at.flash_attention_bwd(*args)
    k10 = list(_k10_args(dev, b, n, heads * d, torch.bfloat16, seed=62))
    k10[0] = offset(torch.bfloat16, b, n, heads * d)
    with pytest.raises(ValueError):
        vb.attn_block_bwd_fused(*k10, heads)
    qkv32 = offset(torch.float32, b, n, 3 * heads * d)
    do32 = offset(torch.float32, b, n, heads * d)
    _assert_all_close(at.qkv_attention_fwdbwd(qkv32, do32, heads),
                      at.qkv_attention_fwdbwd_ref(qkv32, do32, heads),
                      TOL[torch.float32])


# (batch, tokens, width, heads): ViT-B/16's block; D = 8 and 32, where
# K10 scales q before the product and K5 after it; 226 tokens (a 240²
# image), which takes the tiled attention kernels
K10_SHAPES = [(2, 197, 768, 12), (2, 40, 32, 4), (2, 40, 128, 4),
              (1, 226, 128, 2)]
# bf16: K10's distance from the fp32 result within 10% of the plain's
K10_VS_PLAIN = 0.1


def _k10_args(dev, b, n, c, dtype, seed):
    x, (g1, b1), (wqkv, bqkv, wproj, bproj), _ = _block_args(
        dev, b, n, c, dtype, seed)
    g = _randn(torch.Generator(device=dev).manual_seed(seed + 1), b, n, c,
               dtype=dtype)
    return x, g, g1, b1, wqkv, bqkv, wproj, bproj


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", K10_SHAPES)
def test_attn_block_bwd_fused_kernel_matches_plain(shape, dtype):
    """K10 against its plain version: dx per element, and the six
    parameter gradients (each in its parameter's dtype) per element in
    fp32; in bf16 within tol·(1 + max|ref|) of each gradient, as they are
    sums over all rows of bf16-rounded terms whose rounding noise follows
    the terms, not the sum (the k-bias gradient is 0 in exact
    arithmetic), and each of the seven results no further from the fp32
    result on the same values than the plain version is, within
    K10_VS_PLAIN of its distance plus fp32's TOL·(1 + max|fp32|) for the
    summation order.  One launch per call."""
    dev = _cuda()
    b, n, c, heads = shape
    args = _k10_args(dev, b, n, c, dtype, seed=60)
    before = vb.attn_block_bwd_fused.launches
    out = vb.attn_block_bwd_fused(*args, heads)
    torch.cuda.synchronize()
    assert vb.attn_block_bwd_fused.launches == before + 1
    ref = vb.attn_block_bwd_fused_ref(*args, heads)
    _assert_close(out[0], ref[0], TOL[dtype])
    for o, r, p in zip(out[1:], ref[1:], args[2:]):
        assert o.dtype == r.dtype == p.dtype and o.shape == r.shape
        if dtype == torch.float32:
            _assert_close(o, r, TOL[dtype])
        else:
            err = float((o.float() - r.float()).abs().max())
            assert err <= TOL[dtype] * (1 + float(r.float().abs().max()))
    if dtype == torch.bfloat16:
        truth = vb.attn_block_bwd_fused_ref(*(a.float() for a in args),
                                            heads)
        for i, (o, r, t) in enumerate(zip(out, ref, truth)):
            k10 = float((o.float() - t).abs().max())
            plain = float((r.float() - t).abs().max())
            slack = TOL[torch.float32] * (1 + float(t.abs().max()))
            assert k10 <= (1 + K10_VS_PLAIN) * plain + slack, (i, k10, plain)


def test_attn_block_bwd_fused_is_deterministic():
    """No atomics: two calls give equal bits, the tiled attention too."""
    dev = _cuda()
    for shape in (K10_SHAPES[0], K10_SHAPES[-1]):
        b, n, c, heads = shape
        args = _k10_args(dev, b, n, c, torch.bfloat16, seed=61)
        first = vb.attn_block_bwd_fused(*args, heads)
        second = vb.attn_block_bwd_fused(*args, heads)
        assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_flax_thermal_on_card_matches_cpu():
    """A small thermal_only model with ``block_impl="flax",
    attention_impl="pallas"``: the card's fp32 eval step and train step
    (K6 forward and backward, one launch each per block) against the
    CPU's plain versions, at the budgets of the fused train step test."""
    dev = _cuda()
    from dfu_multimodal_tpu_torch.config import AugmentConfig
    from dfu_multimodal_tpu_torch.models import zoo
    from dfu_multimodal_tpu_torch.train.engine import (Trainer, TrainConfig,
                                                       thermal_modality)
    cfg = TrainConfig(compute_dtype="float32", optimizer_mu_dtype="float32",
                      drop_rate=0.0, batch_size=4)
    aug = AugmentConfig(horizontal_flip_prob=0.0, vertical_flip_prob=0.0,
                        rotation_degrees=0.0, aug_prob=0.0,
                        color_jitter=False)
    mods = {"thermal": dataclasses.replace(thermal_modality(), augment=aug)}
    tiny = dict(image_size=32, depth=2, hidden_dim=64, num_heads=4,
                patch_size=8, block_impl="flax", attention_impl="pallas")
    cpu = Trainer("thermal_only", cfg, mods, device="cpu", **tiny)
    zoo.init_model(cpu.module, torch.Generator().manual_seed(0))
    card = Trainer("thermal_only", cfg, mods, device=dev, **tiny)
    card.module.load_state_dict(cpu.module.state_dict())
    rng = np.random.default_rng(0)
    batch = {"thermal": rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8),
             "label": np.array([0, 1, 1, 0], np.int32),
             "valid": np.array([1, 1, 1, 0], np.float32)}
    probs = card.eval_step(batch)["probs"].cpu()
    torch.testing.assert_close(probs, cpu.eval_step(batch)["probs"],
                               rtol=1e-4, atol=1e-5)
    before = (at.qkv_attention_fwd.launches, at.qkv_attention_bwd.launches,
              vb.attn_block.launches, at.qkv_attention_fwdbwd.launches)
    out = card.train_step(batch, torch.Generator(device=dev))
    ref = cpu.train_step(batch, torch.Generator())
    assert (at.qkv_attention_fwd.launches, at.qkv_attention_bwd.launches,
            vb.attn_block.launches, at.qkv_attention_fwdbwd.launches) \
        == (before[0] + 2, before[1] + 2, before[2], before[3])
    assert float(out["loss"]) == pytest.approx(float(ref["loss"]), rel=1e-5)
    cpu_params = dict(cpu.module.named_parameters())
    for name, p in card.module.named_parameters():
        q = cpu_params[name]
        assert float((p.grad.cpu() - q.grad).abs().max()) \
            <= 1e-4 * float(q.grad.abs().max()), name
        assert float((p.detach().cpu() - q.detach()).abs().max()) \
            <= 2 * cfg.learning_rate


# ------------------------------------------------- the int8 convolution

from chip_smoke import resnet_conv_shapes  # noqa: E402
from dfu_multimodal_tpu_torch.ops import conv_q8 as cq  # noqa: E402

# every distinct conv of ResNet-50 at 224² (name, H, Cin, Cout, k, stride,
# role), and one odd batch
CONV_SHAPES = resnet_conv_shapes()


def _conv_case(dev, b, h, cin, cout, k, stride, role, dtype, seed):
    """Seeded operands of one conv of the int8 trunk: x in the compute
    dtype (int8 for a projection block's conv1 and its "down"), the
    kernel's K-major int8 copy, its column scale and bias, and the
    shortcut of a conv3."""
    g = torch.Generator(device=dev).manual_seed(seed)
    ho = -(-h // stride)
    act = torch.tensor(0.02 + 0.01 * (seed % 3), device=dev)
    x = _randn(g, b, h, h, cin, dtype=dtype)
    if role == "down":
        x = cq.quantize_act(x, act)
    w = torch.randint(-127, 128, (cout, k * k * cin), generator=g,
                      device=dev, dtype=torch.int32).to(torch.int8)
    scale = _randn(g, cout, scale=1e-3, offset=4e-3).abs()
    resid = (_randn(g, b, ho, ho, cout, dtype=dtype) if role == "conv3"
             else None)
    return dict(x=x, kernel_kmajor=w, col_scale=act * scale,
                bias=_randn(g, cout, scale=0.1), act_scale=act, k=k,
                stride=stride, relu=role != "down", resid=resid,
                dtype=dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", CONV_SHAPES, ids=[s[0] for s in CONV_SHAPES])
def test_conv_q8_bit_equal_to_plain(shape, dtype):
    """Every ResNet-50 conv at B = 8 (and B = 3, a ragged last row tile)
    bit-equal to ``conv_q8_ref`` on the card: exact int32 sums, the flush
    and epilogue rounded in the same order."""
    dev = _cuda()
    _, h, cin, cout, k, stride, role = shape
    for b in (8, 3):
        case = _conv_case(dev, b, h, cin, cout, k, stride, role, dtype,
                          seed=h + cin + b)
        before = cq.conv_q8.launches
        out = cq.conv_q8(**case)
        assert cq.conv_q8.launches == before + 1
        ref = cq.conv_q8_ref(**case)
        assert out.dtype == ref.dtype == dtype
        assert torch.equal(out, ref), float((out.float() - ref.float())
                                            .abs().max())


@pytest.mark.parametrize("dtype", DTYPES)
def test_quantize_act_q8_equals_plain(dtype):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(3)
    x = _randn(g, 8, 56, 56, 256, scale=3.0, dtype=dtype)
    s = torch.tensor(0.0213, device=dev)
    assert torch.equal(cq.quantize_act_q8(x, s), cq.quantize_act(x, s))


def test_conv_q8_refuses_what_the_gemm_does_not_take():
    dev = _cuda()
    case = _conv_case(dev, 2, 8, 64, 64, 3, 1, "conv2", torch.bfloat16, 0)
    with pytest.raises(ValueError, match="multiple"):
        cq.conv_q8(**{**case, "x": case["x"][..., :24].contiguous(),
                      "kernel_kmajor": case["kernel_kmajor"][:, :216]
                      .contiguous()})
    with pytest.raises(TypeError, match="col_scale"):
        cq.conv_q8(**{**case, "col_scale": case["col_scale"].double()})
    with pytest.raises(ValueError, match="contiguous"):
        cq.conv_q8(**{**case, "x": case["x"].transpose(1, 2)})


# ------------------------------------------- the research modules' steps


def test_research_steps_on_card_match_cpu():
    """``eval/embed.py::extract_features`` and a corruption eval step
    (``eval/robustness.py``) of a narrow fp32 thermal_only model on the
    card (its blocks on K1/K2) against the CPU: features and
    probabilities within 1e-4·(1 + |ref|), predictions and confusion
    counts equal; the blur and contrast corruptions within 1e-4."""
    dev = _cuda()
    from dfu_multimodal_tpu_torch.data.loader import ArrayDataset
    from dfu_multimodal_tpu_torch.eval import embed
    from dfu_multimodal_tpu_torch.eval import robustness as rob
    from dfu_multimodal_tpu_torch.models import zoo
    from dfu_multimodal_tpu_torch.train.engine import (Trainer, TrainConfig,
                                                       thermal_modality)
    cfg = TrainConfig(compute_dtype="float32", eval_batch_size=4)
    narrow = dict(image_size=32, depth=2, hidden_dim=64, num_heads=4,
                  patch_size=8)
    mods = {"thermal": thermal_modality()}
    cpu = Trainer("thermal_only", cfg, mods, device="cpu", **narrow)
    zoo.init_model(cpu.module, torch.Generator().manual_seed(0))
    card = Trainer("thermal_only", cfg, mods, device=dev, **narrow)
    card.module.load_state_dict(cpu.module.state_dict())
    rng = np.random.default_rng(0)
    ds = ArrayDataset({"thermal": rng.integers(0, 256, (6, 32, 32, 3),
                                               dtype=np.uint8)},
                      np.array([0, 1, 1, 0, 1, 0], np.int32))
    before = vb.attn_block.launches
    ours, ref = (embed.extract_features(t, ds) for t in (card, cpu))
    assert vb.attn_block.launches == before + 2 * 2     # 2 batches, depth 2
    assert set(ours) == set(ref) == {"feat_thermal", "probs", "preds"}
    np.testing.assert_array_equal(ours["preds"], ref["preds"])
    for k in ("feat_thermal", "probs"):
        assert ours[k].shape == ref[k].shape and ours[k].dtype == np.float32
        assert np.all(np.abs(ours[k] - ref[k])
                      <= 1e-4 * (1 + np.abs(ref[k]))), k
    x = torch.from_numpy(ds.arrays["thermal"]).float()
    for name, param in (("gaussian_blur", 1.5), ("contrast", 0.4)):
        out = rob.apply_corruption(name, x.to(dev), param).cpu()
        torch.testing.assert_close(out, rob.apply_corruption(name, x, param),
                                   rtol=0, atol=1e-4)
    counts = [rob.corrupted_counts(t, ds, "gaussian_blur", ("thermal",),
                                   [1, 5]) for t in (card, cpu)]
    np.testing.assert_array_equal(np.stack(counts[0]), np.stack(counts[1]))
