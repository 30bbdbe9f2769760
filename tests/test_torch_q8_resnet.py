"""The port's int8 ResNet trunk (``models/resnet_q8.py`` on
``ops/conv_q8.py``) against the JAX package's, on the CPU.

The JAX side is ``dfu_multimodal_tpu/models/resnet_q8.py`` (XLA int8
convolutions, no Pallas kernel); the port's CPU tensors take the plain
version of the int8 convolution.  Inputs are made with numpy from a seed;
the trunks are tiny (stages (2, 2), widths (8, 16), 32²) but for
``quantize_rgb_trunks`` on JAX's side, which takes ResNet-50's widths
(stages (1, 1), widths (64, 128)), and the serving rebuilds of the
full-width ``rgb_only`` and ``multimodal`` at 32².

Tolerances, each with its reason (``-s`` prints every measured error):

- calibration absmaxes: 1e-5 relative (a float forward summed in another
  order);
- int8 kernels: equal but for entries one int8 step apart at a rounding
  boundary, at most ``BOUNDARY_SHARE`` of them (BatchNorm folding's rsqrt
  may differ in its last bit between XLA and PyTorch); weight scales
  within 1e-6 relative, folded biases within 1e-6 of the conv's largest
  (b − mean·s may cancel, so a last-bit difference of s can be a larger
  share of a small bias), act scales within 1e-5 (their absmaxes);
- the port's int8 trunk on JAX's int8 tree against JAX's ``Int8ResNet``
  in fp32: within 1e-5 of max|feature| (the same integer sums; XLA may
  contract the dequantisation into an FMA);
- int8 against the fp32 trunk: max|Δ| / max|ref| < 0.05 (JAX's budget,
  tests/test_ops.py) and logits within 0.2 (tests/test_engine.py);
- ``conv_q8_ref`` against a direct int64 convolution: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfu_multimodal_tpu.models import resnet as jax_resnet
from dfu_multimodal_tpu.models import resnet_q8 as jax_q8
from dfu_multimodal_tpu_torch.config import (TrainConfig, rgb_modality,
                                             thermal_modality)
from dfu_multimodal_tpu_torch.models import resnet_q8 as port_q8
from dfu_multimodal_tpu_torch.models import vit as port_vit
from dfu_multimodal_tpu_torch.models import zoo
from dfu_multimodal_tpu_torch.models.resnet import ResNet, ResNetClassifier
from dfu_multimodal_tpu_torch.ops import conv_q8 as cq
from dfu_multimodal_tpu_torch.serve.engine import (ServingEngine,
                                                   quantize_for_serving)
from dfu_multimodal_tpu_torch.tools.convert_jax import (
    int8_resnet_params, int8_resnet_state_dict, resnet_state_dict)
from dfu_multimodal_tpu_torch.train.engine import Trainer

torch.set_num_threads(1)

TINY = dict(stage_sizes=(2, 2), widths=(8, 16))
IMAGE = 32
BOUNDARY_SHARE = 1e-3


def _report(label, err, tol):
    print(f"[q8 resnet] {label}: measured {err:.3e}, tolerance {tol:g}")
    assert err <= tol, (label, err)


def _jax_trunk(kw, seed):
    """A JAX float trunk's variables with BatchNorm statistics off
    identity (folding exercised), and a calibration batch."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, IMAGE, IMAGE, 3)).astype(np.float32)
    net = jax_resnet.ResNet(block_impl="flax", **kw)
    v = net.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(x),
                 train=False)
    v = jax.tree.map(lambda a: np.asarray(
        a + 0.02 * jnp.arange(a.size, dtype=a.dtype).reshape(a.shape)
        if a.ndim == 1 else a), v)
    return v, x


@pytest.fixture(scope="module")
def tiny():
    """(JAX variables, calibration batch, port float trunk, JAX absmaxes,
    JAX int8 tree) of the tiny trunk."""
    v, x = _jax_trunk(TINY, 1)
    port = ResNet(dtype=torch.float32, block_impl="flax", **TINY)
    port.load_state_dict(resnet_state_dict(v["params"], v["batch_stats"]),
                         strict=True)
    # eval mode from the start: the tests serve it, and calibration leaves
    # it there anyway (a test run alone must not see train-mode BatchNorm)
    port.eval()
    cal = jax_resnet.ResNet(block_impl="flax", calibrate=True, **TINY)
    absmax = jax_q8.calibrate_resnet(cal, v, [jnp.asarray(x)])
    tree = jax_q8.quantize_resnet_params(
        v, absmax, stage_sizes=TINY["stage_sizes"])["params"]
    return v, x, port, absmax, jax.tree.map(np.asarray, tree)


def _nested(absmax):
    """JAX's {(block, conv_in, 0): v} -> the port's {block: {conv_in: v}}."""
    out = {}
    for (block, conv, _), val in absmax.items():
        out.setdefault(block, {})[conv] = val
    return out


def test_calibration_matches_jax(tiny):
    _, x, port, absmax, _ = tiny
    ours = port_q8.calibrate_resnet(port, [torch.from_numpy(x)])
    ref = _nested(absmax)
    assert ours.keys() == ref.keys()
    err = max(abs(ours[b][c] - v) / v for b in ref for c, v in ref[b].items())
    _report("calibration absmax (relative)", err, 1e-5)


def _compare_trees(label, ours, ref):
    """Two int8 trunk trees (JAX layout): int8 kernels equal but for
    boundary entries one step apart, scales and biases close."""
    flips = total = 0
    for scope, convs in ref.items():
        if not scope.startswith("stage"):
            continue
        for conv, p in convs.items():
            q = ours[scope][conv]
            d = np.abs(q["kernel_q8"].astype(np.int32)
                       - p["kernel_q8"].astype(np.int32))
            assert d.max() <= 1, (scope, conv)
            flips += int((d > 0).sum())
            total += d.size
            for key, tol in (("scale", 1e-6), ("bias", 1e-6),
                             ("act_scale", 1e-5)):
                # a folded bias b - mean·s may cancel: its error is taken
                # relative to the largest bias of the conv
                ref_mag = (np.abs(p[key]).max() if key == "bias"
                           else np.abs(p[key]))
                rel = np.abs(q[key] - p[key]) / np.maximum(ref_mag, 1e-12)
                assert float(rel.max()) <= tol, (scope, conv, key,
                                                 float(rel.max()))
    _report(f"{label}: int8 entries one step apart (share of {total})",
            flips / total, BOUNDARY_SHARE)
    np.testing.assert_allclose(ours["stem_kernel"], ref["stem_kernel"],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ours["stem_bias"], ref["stem_bias"],
                               rtol=1e-6, atol=1e-7)


def test_quantize_resnet_params_matches_jax(tiny):
    """The same fp32 weights and absmaxes -> the same int8 tree."""
    v, _, port, absmax, tree = tiny
    sd = port_q8.quantize_resnet_params(port.state_dict(), _nested(absmax),
                                        TINY["stage_sizes"])
    _compare_trees("quantize_resnet_params", int8_resnet_params(sd), tree)


def test_quantize_rgb_trunks_matches_jax():
    """``quantize_rgb_trunks`` on both sides from the same fp32 weights
    and calibration batch, under the multimodal trunk scope (JAX's infers
    ResNet-50's widths: stages (1, 1), widths (64, 128))."""
    kw = dict(stage_sizes=(1, 1), widths=(64, 128))
    v, x = _jax_trunk(kw, 2)
    wrapped = {"params": {"rgb_branch": v["params"]},
               "batch_stats": {"rgb_branch": v["batch_stats"]}}
    ref = jax_q8.quantize_rgb_trunks(wrapped, [jnp.asarray(x)],
                                     dtype=jnp.float32)
    assert "batch_stats" not in ref
    sd = resnet_state_dict(v["params"], v["batch_stats"], "rgb_branch.")
    sd["fusion.0.weight"] = torch.ones(2, 2)          # untouched
    ours = port_q8.quantize_rgb_trunks(sd, [torch.from_numpy(x)],
                                       dtype=torch.float32)
    assert torch.equal(ours["fusion.0.weight"], torch.ones(2, 2))
    assert not any("running" in k or "bn" in k for k in ours)
    _compare_trees("quantize_rgb_trunks",
                   int8_resnet_params(ours, "rgb_branch."),
                   jax.tree.map(np.asarray, ref["params"]["rgb_branch"]))


def test_int8_trunk_on_the_jax_tree_matches_jax(tiny):
    """JAX's int8 tree through ``convert_jax`` into the port's
    ``Int8ResNet`` (strict load): features and taps against JAX's
    ``Int8ResNet`` in fp32."""
    _, x, _, _, tree = tiny
    net = port_q8.Int8ResNet(dtype=torch.float32, **TINY)
    sd = int8_resnet_state_dict(tree)
    net.load_state_dict(sd, strict=True)
    back = int8_resnet_params(sd)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert np.array_equal(a, b)
    taps = {}
    with torch.no_grad():
        out = net(torch.from_numpy(x), taps).numpy()
    jax_net = jax_q8.Int8ResNet(dtype=jnp.float32, **TINY)
    ref, inter = jax_net.apply({"params": tree}, jnp.asarray(x),
                               train=False, mutable=["intermediates"])
    ref = np.asarray(ref)
    scale = float(np.abs(ref).max())
    _report("int8 features vs JAX (of max|feature|)",
            float(np.abs(out - ref).max()) / scale, 1e-5)
    for name in ("stage1", "stage2"):
        theirs = np.asarray(inter["intermediates"][name][0])
        assert taps[name].shape == theirs.shape
        _report(f"tap {name} vs JAX (of its max)",
                float(np.abs(taps[name].numpy() - theirs).max())
                / float(np.abs(theirs).max()), 1e-5)


def test_int8_trunk_near_the_fp32_trunk(tiny):
    """The port's own chain: calibrate, quantise, serve; within JAX's
    relative budget of the fp32 trunk."""
    _, x, port, _, _ = tiny
    xt = torch.from_numpy(x)
    sd = port_q8.quantize_rgb_trunks(
        {f"resnet.{k}": v for k, v in port.state_dict().items()}, [xt],
        dtype=torch.float32)
    net = port_q8.Int8ResNet(dtype=torch.float32, **TINY)
    net.load_state_dict({k[len("resnet."):]: v for k, v in sd.items()},
                        strict=True)
    with torch.no_grad():
        ref, out = port(xt), net(xt)
    _report("int8 vs fp32 trunk (max|Δ| / max|ref|)",
            float((out - ref).abs().max() / ref.abs().max()), 0.05)


@pytest.mark.parametrize("k,stride,role", [
    (1, 1, "conv1"), (3, 1, "conv2"), (3, 2, "conv2"), (1, 2, "down"),
    (1, 1, "conv3")])
def test_conv_q8_ref_equals_a_direct_int64_conv(k, stride, role):
    rng = np.random.default_rng(k * 10 + stride)
    b, h, cin, cout = 2, 9, 16, 24
    x = torch.from_numpy(rng.standard_normal((b, h, h, cin))
                         .astype(np.float32))
    act = torch.tensor(0.031, dtype=torch.float32)
    w = torch.from_numpy(rng.integers(-127, 128, (k, k, cin, cout))
                         .astype(np.int8))
    scale = torch.from_numpy(rng.uniform(1e-3, 1e-2, cout)
                             .astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    xq = cq.quantize_act(x, act)
    ho = (h + 2 * (k // 2) - k) // stride + 1
    resid = (torch.from_numpy(rng.standard_normal((b, ho, ho, cout))
                              .astype(np.float32))
             if role == "conv3" else None)
    src = xq if role == "down" else x
    out = cq.conv_q8(src, w.reshape(-1, cout).t().contiguous(), act * scale,
                     bias, act, k, stride, relu=role != "down", resid=resid,
                     dtype=torch.float32)
    # the direct convolution in int64, tap by tap
    pad = k // 2
    xp = torch.nn.functional.pad(xq.long(), (0, 0, pad, pad, pad, pad))
    acc = torch.zeros(b, ho, ho, cout, dtype=torch.long)
    for dy in range(k):
        for dx in range(k):
            tap = xp[:, dy:dy + stride * (ho - 1) + 1:stride,
                     dx:dx + stride * (ho - 1) + 1:stride]
            acc += torch.einsum("bhwc,cd->bhwd", tap, w[dy, dx].long())
    ref = acc.float() * (act * scale) + bias
    if resid is not None:
        ref = resid + ref
    if role != "down":
        ref = ref.clamp_min(0)
    assert torch.equal(out, ref)


def test_int8_classifier_keys_and_refusals():
    """``ResNetClassifier(block_impl="int8")`` holds the int8 tree's keys;
    so does the ResNet-18 student's int8 twin (basic blocks: conv1,
    conv2 and the projection ``proj``, JAX's scope names)."""
    keys = set(ResNetClassifier(block_impl="int8").state_dict())
    assert "resnet.stem_kernel" in keys
    assert "resnet.layer4.0.down.kernel_q8" in keys
    assert not any("running" in k for k in keys)
    student = set(ResNetClassifier(trunk="resnet18",
                                   block_impl="int8").state_dict())
    assert "resnet.layer4.0.proj.kernel_q8" in student
    assert "resnet.layer4.1.conv2.act_scale" in student
    assert not any("conv3" in k or "down" in k or "running" in k
                   for k in student)
    with pytest.raises(ValueError, match="rgb_impl"):
        zoo.build("multimodal", rgb_impl="int4")


# ------------------------------------------- serving the full-width models


def _images(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, (n, IMAGE, IMAGE, 3), dtype=np.uint8)


def _served(name, seed):
    """fp32 ``name`` at 32², seeded weights with BN statistics off
    identity, and its int8 rebuild."""
    cfg = TrainConfig(batch_size=4, eval_batch_size=4,
                      compute_dtype="float32")
    mods = {"rgb": rgb_modality(), "thermal": thermal_modality()}
    tr = Trainer(name, cfg, mods, device="cpu", image_size=IMAGE)
    zoo.init_model(tr.module, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(10 + seed)
    with torch.no_grad():
        for m in tr.module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    return tr, quantize_for_serving(tr, image_size=IMAGE,
                                    calib_u8=_images(8, 20 + seed))


@pytest.fixture(scope="module")
def rgb_served():
    return _served("rgb_only", 0)


@pytest.mark.parametrize("name", ["rgb_only", "multimodal"])
def test_quantize_for_serving_resnet_models(rgb_served, name):
    """An int8 trainer (the int8 trunk; multimodal's ViT on the int8
    blocks), its logits within JAX's 0.2 of the fp32 model's, and the
    ServingEngine's answers equal to its eval step's."""
    tr, q = rgb_served if name == "rgb_only" else _served(name, 1)
    trunk = q.module.resnet if name == "rgb_only" else q.module.rgb_branch
    assert isinstance(trunk, port_q8.Int8ResNet)
    if name == "multimodal":
        assert isinstance(q.module.thermal_branch.blocks[0],
                          port_vit.QuantizedEncoderBlock)
    inputs = tr.spec.inputs
    batch = {m: _images(4, 30 + j) for j, m in enumerate(inputs)}
    norm = tr._preprocess_eval({m: torch.from_numpy(v)
                                for m, v in batch.items()})
    with torch.no_grad():
        q.module.eval()
        tr.module.eval()
        d = float((q.module(*norm) - tr.module(*norm)).abs().max())
    _report(f"{name} int8 vs fp32 logits", d, 0.2)
    ref = q.eval_step(batch)
    samples = [{m: batch[m][i] for m in inputs} for i in range(4)]
    with ServingEngine(q, image_size=IMAGE, max_batch=4,
                       max_wait_ms=200.0) as eng:
        got = eng.predict(samples)
    np.testing.assert_allclose([p for p, _ in got], ref["probs"].numpy(),
                               rtol=1e-6, atol=1e-7)


def test_quantize_for_serving_needs_calibration_images(rgb_served):
    tr, _ = rgb_served
    with pytest.raises(ValueError, match="calibration images"):
        quantize_for_serving(tr, image_size=IMAGE)
