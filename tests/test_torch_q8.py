"""The port's int8 ViT serving path against the JAX package's, on the CPU.

The JAX side runs its Pallas int8 kernels in interpret mode
(``interpret=True``, ``block_impl="fused_q8_interpret"`` /
``"fused_q8s_interpret"``), as its own tests do; the port's CPU tensors
take the plain versions.  Inputs are made with numpy from a seed.

Tolerances, each with its reason (``python -m pytest
tests/test_torch_q8.py -s`` prints every measured error beside its
tolerance):

- ``quantize_weight`` and the row / static quantisation: bit-exact (same
  fp32 operations, round half to even, the 1e-12 floor);
- attention blocks, fp32: 1e-3·(1+|ref|) — the same math; a LayerNorm or
  attention sum taken in another order can move a value across a rounding
  boundary (one int8 step) now and then;
- MLP blocks: 1e-2·(1+|ref|) — the port's exact-erf GELU against the
  Pallas kernels' logistic GELU (max 3.8e-4 apart) flips int8 roundings
  of the hidden;
- the converters: int8 equal, weight scales within 1e-6 relative, act
  scales within 1e-5 relative (absmaxes of a float forward summed in
  another order);
- model features (depth 2, int8 both sides): 1e-5·(1+|ref|) with the
  Pallas kernels' logistic GELU swapped into the port, 5e-2·(1+|ref|) with
  the port's exact erf GELU (see the test); the int8 model against the
  fp32 model: max|Δ| / max|ref| < 0.05, the reference's own budget
  (tests/test_ops.py).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfu_multimodal_tpu.models import vit as jax_vit
from dfu_multimodal_tpu.ops import vit_block_q8 as jax_q8
from dfu_multimodal_tpu_torch.config import TrainConfig, thermal_modality
from dfu_multimodal_tpu_torch.models import vit as port_vit
from dfu_multimodal_tpu_torch.models import zoo
from dfu_multimodal_tpu_torch.ops import vit_block_q8 as port_q8
from dfu_multimodal_tpu_torch.serve.engine import (ServingEngine,
                                                   quantize_for_serving)
from dfu_multimodal_tpu_torch.tools.convert_jax import (
    variables_to_state_dict, vit_state_dict)
from dfu_multimodal_tpu_torch.train.engine import Trainer

torch.set_num_threads(1)

B, N, C, HEADS, HIDDEN, CHUNKS = 2, 17, 64, 4, 256, 4
VIT_KW = dict(depth=2, hidden_dim=64, num_heads=4, patch_size=8)
IMAGE = 32


def _f32(rng, *shape, scale=1.0, offset=0.0):
    return (offset + scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _report(label, err, tol):
    """Print a measured error beside its tolerance (shown with ``-s``)."""
    print(f"[q8] {label}: measured {err:.3e}, tolerance {tol:g}")
    assert err <= tol, (label, err)


def _close(label, out, ref, tol):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape and np.isfinite(out).all()
    _report(label, float((np.abs(out - ref) / (1.0 + np.abs(ref))).max()),
            tol)


# ---------------------------------------------------------- quantisation


def test_quantize_weight_bit_exact():
    rng = np.random.default_rng(0)
    w = _f32(rng, 64, 96, scale=0.3)
    w[:, 5] = 0.0                      # all-zero column: the 1e-12 floor
    q_ref, s_ref = jax_q8.quantize_weight(jnp.asarray(w))
    q, s = port_q8.quantize_weight(_t(w))
    assert q.dtype == torch.int8 and q.is_contiguous() and s.shape == (96,)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    assert s[5] == np.float32(1e-12) and not q[:, 5].any()


def test_row_quant_bit_exact_with_ties():
    rng = np.random.default_rng(1)
    y = _f32(rng, 6, 64, scale=3.0)
    # absmax 127 gives a = 1.0, so the halves below are exact ties
    y[0] = 0.0
    y[0, :4] = [127.0, 2.5, 3.5, -0.5]
    y[1] = 0.0                         # an all-zero row: a = 1e-12
    q_ref, a_ref = jax_q8._row_quant(jnp.asarray(y))
    q, a = port_q8.row_quant(_t(y))
    assert q.dtype == torch.int8 and a.shape == (6, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))
    assert float(a[0, 0]) == 1.0
    assert q[0, :4].tolist() == [127, 2, 4, 0]          # half to even
    assert float(a[1, 0]) == np.float32(1e-12) and not q[1].any()


def test_static_quant_bit_exact_and_clipped():
    rng = np.random.default_rng(2)
    y = _f32(rng, 5, 64, scale=4.0)
    inv = np.float32(1.0) / np.float32(0.02)      # 4σ clips at 127·0.02
    ref = jax_q8._static_quant(jnp.asarray(y), jnp.asarray(inv))
    q = port_q8.static_quant(_t(y), torch.tensor(inv))
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref))
    assert int(q.max()) == 127 and int(q.min()) == -127


# ---------------------------------------------------------------- blocks


def _block_inputs(seed):
    rng = np.random.default_rng(seed)
    x = _f32(rng, B, N, C)
    ln = (_f32(rng, C, scale=0.1, offset=1.0), _f32(rng, C, scale=0.1))

    def dense(din, dout):
        q, s = jax_q8.quantize_weight(
            jnp.asarray(_f32(rng, din, dout, scale=din ** -0.5)))
        return np.asarray(q), np.asarray(s), _f32(rng, dout, scale=0.1)

    return x, ln, dense(C, 3 * C), dense(C, C), dense(C, HIDDEN), \
        dense(HIDDEN, C)


# calibrated act scales of a block's two quantisation points (inputs
# beyond 127·a clip): LayerNorm output, then attention / GELU output
ACT = np.array([4.0 / 127, 1.5 / 127], np.float32)


@pytest.mark.parametrize("static", [False, True], ids=["q8", "q8s"])
def test_attn_block_q8_matches_jax(static):
    x, (g, b), (wqkv, sqkv, bqkv), (wproj, sproj, bproj), _, _ = \
        _block_inputs(seed=3)
    if static:
        sqkv, sproj = sqkv * ACT[0], sproj * ACT[1]
        inv = np.float32(1.0) / ACT
        args = (x, g, b, wqkv, sqkv, bqkv, wproj, sproj, bproj, inv)
        ref = jax_q8.attn_block_q8s(*map(jnp.asarray, args),
                                    num_heads=HEADS, interpret=True)
        out = port_q8.attn_block_q8s(*map(_t, args), HEADS)
    else:
        args = (x, g, b, wqkv, sqkv, bqkv, wproj, sproj, bproj)
        ref = jax_q8.attn_block_q8(*map(jnp.asarray, args),
                                   num_heads=HEADS, interpret=True)
        out = port_q8.attn_block_q8(*map(_t, args), HEADS)
    assert out.dtype == torch.float32
    _close(f"attn_block_{'q8s' if static else 'q8'} vs JAX, "
           "|d|/(1+|ref|)", out.numpy(), ref, 1e-3)


@pytest.mark.parametrize("static", [False, True], ids=["q8", "q8s"])
def test_mlp_block_q8_matches_jax(static):
    x, (g, b), _, _, (w1, s1, b1), (w2, s2, b2) = _block_inputs(seed=4)
    if static:
        s1, s2 = s1 * ACT[0], s2 * ACT[1]
        inv = np.float32(1.0) / ACT
        args = (x, g, b, w1, s1, b1, w2, s2, b2, inv)
        ref = jax_q8.mlp_block_q8s(*map(jnp.asarray, args),
                                   hidden_chunks=CHUNKS, interpret=True)
        out = port_q8.mlp_block_q8s(*map(_t, args), hidden_chunks=CHUNKS)
    else:
        args = (x, g, b, w1, s1, b1, w2, s2, b2)
        ref = jax_q8.mlp_block_q8(*map(jnp.asarray, args),
                                  hidden_chunks=CHUNKS, interpret=True)
        out = port_q8.mlp_block_q8(*map(_t, args), hidden_chunks=CHUNKS)
    _close(f"mlp_block_{'q8s' if static else 'q8'} vs JAX, "
           "|d|/(1+|ref|)", out.numpy(), ref, 1e-2)


def test_q8_ops_refuse_bias_and_unknown_devices():
    """No hidden fallback: a tensor that is neither on the CPU nor on a
    CUDA device has no kernel; ToMe's key bias, once refused, is taken by
    both attention blocks and matches JAX's (interpret) within the
    attention blocks' 1e-3."""
    x, (g, b), (wqkv, sqkv, bqkv), (wproj, sproj, bproj), (w1, s1, b1), \
        (w2, s2, b2) = _block_inputs(seed=5)
    arrays = (x, g, b, wqkv, sqkv, bqkv, wproj, sproj, bproj)
    attn = [_t(a) for a in arrays]
    mlp = [_t(a) for a in (x, g, b, w1, s1, b1, w2, s2, b2)]
    inv = _t(np.float32(1.0) / ACT)
    bias = np.log(np.random.default_rng(5).integers(1, 6, (B, N))).astype(
        np.float32)
    jargs, jbias = [jnp.asarray(a) for a in arrays], jnp.asarray(bias)
    _close("attn_block_q8 with the key bias vs JAX, |d|/(1+|ref|)",
           port_q8.attn_block_q8(*attn, HEADS, bias=_t(bias)).numpy(),
           jax_q8.attn_block_q8(*jargs, num_heads=HEADS, interpret=True,
                                bias=jbias), 1e-3)
    _close("attn_block_q8s with the key bias vs JAX, |d|/(1+|ref|)",
           port_q8.attn_block_q8s(*attn, inv, HEADS, bias=_t(bias)).numpy(),
           jax_q8.attn_block_q8s(*jargs, jnp.asarray(inv), num_heads=HEADS,
                                 interpret=True, bias=jbias), 1e-3)
    meta = [a.to("meta") for a in attn]
    with pytest.raises(ValueError, match="no kernel"):
        port_q8.attn_block_q8(*meta, HEADS)
    with pytest.raises(ValueError, match="no kernel"):
        port_q8.attn_block_q8s(*meta, inv.to("meta"), HEADS,
                               bias=torch.zeros(B, N, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        port_q8.mlp_block_q8s(*[a.to("meta") for a in mlp], inv.to("meta"))
    assert (port_q8.attn_block_q8.launches, port_q8.mlp_block_q8.launches,
            port_q8.attn_block_q8s.launches,
            port_q8.mlp_block_q8s.launches) == (0, 0, 0, 0)


# ------------------------------------------------------------ converters


def _perturb(params, seed):
    """Every non-kernel leaf moved off its initial value."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x, np.float32)
        if str(path[-1].key) == "kernel":
            return x
        return x + 0.05 * rng.standard_normal(x.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


@pytest.fixture(scope="module")
def tiny_vit():
    """(fp32 JAX trunk params, the port's trunk state_dict, two normalised
    calibration batches, a test batch), depth 2 at image 32."""
    rng = np.random.default_rng(6)
    x = _f32(rng, 2, IMAGE, IMAGE, 3)
    flax = jax_vit.ViT(block_impl="flax", attention_impl="xla", **VIT_KW)
    params = _perturb(flax.init({"params": jax.random.PRNGKey(6)},
                                jnp.asarray(x), train=False)["params"], 6)
    calib = [_f32(rng, 3, IMAGE, IMAGE, 3) for _ in range(2)]
    return params, vit_state_dict(params), calib, x


def _assert_int8_trees_match(label, out, ref):
    """int8 kernels and the fp32 tensors carried over equal; weight scales
    within 1e-6 and act scales within 1e-5 relative."""
    assert out.keys() == ref.keys()
    worst = {".scale": 0.0, "act_scales": 0.0}
    for key, r in ref.items():
        o = out[key]
        assert o.dtype == r.dtype, key
        kind = next((k for k in worst if key.endswith(k)), None)
        if kind is None:
            np.testing.assert_array_equal(o.numpy(), r.numpy(), err_msg=key)
        else:
            worst[kind] = max(worst[kind], float(
                ((o - r).abs() / r.abs()).max()))
    _report(f"{label} weight scales, relative", worst[".scale"], 1e-6)
    if any(k.endswith("act_scales") for k in ref):
        _report(f"{label} act scales, relative", worst["act_scales"], 1e-5)


def test_quantize_encoder_params_matches_jax(tiny_vit):
    params, trunk, _, _ = tiny_vit
    before = {k: v.clone() for k, v in trunk.items()}
    out = port_vit.quantize_encoder_params(trunk)
    ref = vit_state_dict(jax_vit.quantize_encoder_params(params))
    _assert_int8_trees_match("quantize_encoder_params", out, ref)
    assert out["blocks.0.attn.qkv.kernel_q8"].shape == (64, 192)
    for k, v in before.items():                 # the fp32 input untouched
        assert torch.equal(trunk[k], v), k


def test_calibration_matches_jax(tiny_vit):
    params, trunk, calib, _ = tiny_vit
    ref = jax_vit.calibrate_vit_absmax(
        params, [jnp.asarray(c) for c in calib], num_heads=HEADS)
    enc = ref["encoder"]
    ref = {"ln1_out": enc["ln1_out"][0], "proj_in": enc["attn"]["proj_in"][0],
           "ln2_out": enc["ln2_out"][0], "gelu_out": enc["gelu_out"][0]}
    out = port_vit.calibrate_vit_absmax(trunk, [_t(c) for c in calib],
                                        num_heads=HEADS)
    assert out.keys() == ref.keys()
    for point, r in ref.items():
        assert out[point].shape == (VIT_KW["depth"],)
        r = np.asarray(r)
        _report(f"calibration absmax {point}, relative",
                float((np.abs(out[point].numpy() - r) / r).max()), 1e-5)
    with pytest.raises(ValueError, match="zero calibration batches"):
        port_vit.calibrate_vit_absmax(trunk, [])


@pytest.mark.parametrize("calibrated", [False, True],
                         ids=["dynamic", "calibrated"])
def test_quantize_variables_matches_jax(tiny_vit, calibrated):
    """Both packages' ``quantize_variables`` on a thermal_only model tree
    (trunk + head): only the trunk is quantised, the head is kept."""
    params, trunk, calib, _ = tiny_vit
    rng = np.random.default_rng(7)
    head = {"kernel": _f32(rng, 64, 2), "bias": _f32(rng, 2)}
    variables = {"params": {"ViT_0": params, "head": head}}
    kw = ({} if not calibrated else
          {"calib_batches": [jnp.asarray(c) for c in calib]})
    ref = variables_to_state_dict(
        "thermal_only", jax_vit.quantize_variables(variables, **kw))
    fp32 = variables_to_state_dict("thermal_only", variables)
    kw = {} if not calibrated else {"calib_batches": [_t(c) for c in calib]}
    out = port_vit.quantize_variables(fp32, **kw)
    _assert_int8_trees_match(
        f"quantize_variables ({'calibrated' if calibrated else 'dynamic'})",
        out, ref)
    assert ("vit.blocks.1.act_scales" in out) == calibrated
    assert "vit.blocks.0.attn.qkv.weight" in fp32     # original untouched


def _port_vit(block_impl, state):
    vit = port_vit.ViT(image_size=IMAGE, block_impl=block_impl, **VIT_KW)
    vit.load_state_dict(state, strict=True)
    return vit.eval()


def _int8_params(params, static, calib):
    if not static:
        return jax_vit.quantize_encoder_params(params)
    cal = jax_vit.calibrate_vit_absmax(
        params, [jnp.asarray(c) for c in calib], num_heads=HEADS)
    return jax_vit.quantize_encoder_params(params, cal)


def _logistic_gelu(h):
    """The Pallas kernels' GELU (dfu_multimodal_tpu/ops/vit_block.py::
    _gelu_fast), in torch."""
    return h * torch.sigmoid(h * (1.5976 + 0.07056 * h * h))


@pytest.mark.parametrize("gelu,tol", [("logistic", 1e-5), ("erf", 5e-2)])
@pytest.mark.parametrize("block_impl", ["fused_q8", "fused_q8s"])
def test_int8_vit_matches_jax(tiny_vit, block_impl, gelu, tol, monkeypatch):
    """The port's int8 ViT on the bridged JAX int8 tree against the JAX
    int8 ViT (Pallas interpret), same quantised weights.  With the Pallas
    kernels' logistic GELU swapped in, the two compute the same function
    (1e-5); with the port's exact erf GELU, the 3.8e-4 between the two
    GELUs flips int8 roundings of the hidden in both blocks, and the final
    LayerNorm scales the features to O(1) (measured 1.6e-2 to 4.3e-2 over
    six seeds, so 5e-2)."""
    if gelu == "logistic":
        monkeypatch.setattr(torch.nn.functional, "gelu", _logistic_gelu)
    params, _, calib, x = tiny_vit
    qparams = _int8_params(params, block_impl == "fused_q8s", calib)
    jvit = jax_vit.ViT(block_impl=f"{block_impl}_interpret", **VIT_KW)
    ref = np.asarray(jvit.apply({"params": qparams}, jnp.asarray(x),
                                train=False))
    vit = _port_vit(block_impl, vit_state_dict(qparams))
    assert isinstance(vit.blocks[0], port_vit.BLOCK_IMPLS[block_impl])
    with torch.no_grad():
        out = vit(_t(x))
    assert out.dtype == torch.float32 and out.shape == (2, 64)
    _close(f"{block_impl} ViT features vs JAX, {gelu} GELU, |d|/(1+|ref|)",
           out.numpy(), ref, tol)


@pytest.mark.parametrize("block_impl", ["fused_q8", "fused_q8s"])
def test_int8_vit_close_to_fp32(tiny_vit, block_impl):
    """Quantise the port's own fp32 trunk and compare its forward with
    the fp32 forward (the reference's budget, tests/test_ops.py)."""
    _, trunk, calib, x = tiny_vit
    cal = (None if block_impl == "fused_q8" else
           port_vit.calibrate_vit_absmax(trunk, [_t(c) for c in calib],
                                         num_heads=HEADS))
    qvit = _port_vit(block_impl, port_vit.quantize_encoder_params(trunk, cal))
    with torch.no_grad():
        ref = _port_vit("fused", trunk)(_t(x))
        out = qvit(_t(x))
    rel = float((out - ref).abs().max()) / max(float(ref.abs().max()), 1e-6)
    _report(f"{block_impl} ViT vs the fp32 ViT, max|d|/max|ref|", rel, 0.05)


# --------------------------------------------------------------- serving


def _tiny_thermal_trainer():
    tr = Trainer("thermal_only", TrainConfig(compute_dtype="float32"),
                 {"thermal": thermal_modality()}, device="cpu",
                 image_size=IMAGE, **VIT_KW)
    zoo.init_model(tr.module, torch.Generator().manual_seed(0))
    return tr


def test_quantize_for_serving_thermal_only():
    tr = _tiny_thermal_trainer()
    before = {k: v.clone() for k, v in tr.variables().items()}
    q = quantize_for_serving(tr, image_size=IMAGE)
    assert q is not tr and q.device == tr.device and q.spec.name == \
        "thermal_only"
    blocks = q.module.vit.blocks
    assert len(blocks) == 2 and all(
        type(b) is port_vit.QuantizedEncoderBlock for b in blocks)
    assert q.variables()["vit.blocks.0.mlp.fc1.kernel_q8"].dtype == torch.int8
    for k, v in tr.variables().items():          # fp32 source untouched
        assert torch.equal(v, before[k]), k

    rng = np.random.default_rng(8)
    samples = [{"thermal": rng.integers(0, 256, (IMAGE, IMAGE, 3),
                                        dtype=np.uint8)} for _ in range(3)]
    with ServingEngine(q, image_size=IMAGE, max_batch=4,
                       max_wait_ms=200.0) as eng:
        served = eng.predict(samples)
    batch = {"thermal": np.stack([s["thermal"] for s in samples])}
    ref = q.eval_step(batch)
    np.testing.assert_allclose([p for p, _ in served],
                               ref["probs"].numpy(), rtol=1e-6, atol=1e-7)
    assert [c for _, c in served] == ref["preds"].tolist()
    # the int8 answer stays near the fp32 model's
    fp32 = tr.eval_step(batch)["probs"].numpy()
    _report("served int8 P(ulcer) vs the fp32 trainer's",
            float(np.abs(ref["probs"].numpy() - fp32).max()), 0.05)


def test_quantize_for_serving_refuses_other_models():
    """A ResNet trunk needs calibration images, the ResNet-18 students'
    too (their int8 twin is ported: tests/test_torch_students.py); a
    model outside the int8 set gets the JAX package's ValueError."""
    def stub(name):
        return SimpleNamespace(spec=SimpleNamespace(name=name))

    with pytest.raises(ValueError, match="calibration images"):
        quantize_for_serving(stub("multimodal"))
    for student in ("resnet18_rgb", "resnet18_thermal"):
        with pytest.raises(ValueError, match="calibration images"):
            quantize_for_serving(stub(student),
                                 calib_u8=np.zeros((0, 8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="int8 serving is not supported"):
        quantize_for_serving(stub("efficientnet_b0"))
