"""The port's Grad-CAM, ViT attribution and the differentiable K3 against
the JAX package, on the CPU.

- ``FusedMlp`` (K3's autograd Function: forward the kernel, backward
  autograd through its plain version) against ``jax.vjp`` of the JAX
  ``fused_mlp`` in interpret mode (every input's gradient within 1e-5),
  an fp64 ``gradcheck``, and ``FusionMLP``'s eval output unchanged.
- The tap activations against JAX's ``intermediates``: a multimodal of a
  one-block-a-stage ResNet and a depth-2 ViT at 32² (``stage1``..
  ``stage4`` as (B, H, W, C), ``blocks`` as (B, N, C)), within 1e-5.
- ``compute_cam_batch`` against JAX's for ``rgb_only`` at full width
  (ResNet-50, 32²), a depth-2 ViT ``thermal_only`` (input saliency) and
  the small multimodal in fused and strict modes, with class 0, 1 and
  ``"pred"`` (the ResNet-50 with ``"pred"`` alone): probabilities within 1e-5, predictions equal, CAMs within
  CAM_TOL (each is divided by its max; the ResNet-50's fp32 sums in
  another order move a normalised CAM by up to ~1e-4).
- Rollout and Chefer against JAX's (within CAM_TOL), and the Chefer dA
  from ``autograd.grad`` equal to the JAX ``eps`` trick's.
- The overlay helpers against OpenCV (present here, in the tests only):
  the 256 JET entries and ``addWeighted`` bit for bit, ``resize`` within
  1e-6.
- The Grad-CAM CLI against the JAX CLI on the same JAX checkpoints
  (tiny models, 32²): the same files, the same CAMs.
- No explanation leaves a ``.grad`` or clears a ``requires_grad``.
"""


import cv2
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from dfu_multimodal_tpu import config as jax_config
from dfu_multimodal_tpu.cli import grad_cam_visualization as jax_cli
from dfu_multimodal_tpu.eval import gradcam as jax_gradcam
from dfu_multimodal_tpu.eval import vit_attribution as jax_va
from dfu_multimodal_tpu.models import zoo as jax_zoo
from dfu_multimodal_tpu.models.fusion import FusionMLP as JaxFusionMLP
from dfu_multimodal_tpu.models.resnet import ResNet as JaxResNet
from dfu_multimodal_tpu.models.vit import ViT as JaxViT
from dfu_multimodal_tpu.ops.fused_mlp import fused_mlp as jax_fused_mlp
from dfu_multimodal_tpu.train.engine import Trainer as JaxTrainer
from dfu_multimodal_tpu.utils import checkpoint as jax_ckpt
from dfu_multimodal_tpu_torch.cli import grad_cam_visualization as port_cli
from dfu_multimodal_tpu_torch.data.png import read_png
from dfu_multimodal_tpu_torch.data.synthetic import make_synthetic_dataset
from dfu_multimodal_tpu_torch.eval import gradcam
from dfu_multimodal_tpu_torch.eval import vit_attribution as va
from dfu_multimodal_tpu_torch.models import zoo
from dfu_multimodal_tpu_torch.models.fusion import FusionMLP
from dfu_multimodal_tpu_torch.models.resnet import ResNet
from dfu_multimodal_tpu_torch.models.vit import ViT
from dfu_multimodal_tpu_torch.ops.fused_mlp import FusedMlp, fused_mlp
from dfu_multimodal_tpu_torch.tools.convert_jax import variables_to_state_dict

torch.set_num_threads(1)

IMAGE = 32
RESNET = dict(stage_sizes=(1, 1, 1, 1), widths=(8, 8, 16, 16))
FEATS = 4 * RESNET["widths"][-1]
VIT = dict(depth=2, hidden_dim=64, num_heads=4, patch_size=8)
PROB_TOL = 1e-5
CAM_TOL = 1e-3
CLASSES = (0, 1, "pred")


# ---------------------------------------------------------------- K3


def _mlp_args(seed, dims=(24, 16, 8, 2), batch=5, dtype=np.float32):
    rng = np.random.default_rng(seed)
    args = [rng.standard_normal((batch, dims[0]))]
    for a, b in zip(dims[:-1], dims[1:]):
        args += [rng.standard_normal((a, b)) / np.sqrt(a),
                 0.1 * rng.standard_normal(b)]
    return [x.astype(dtype) for x in args]


def test_fused_mlp_gradients_match_jax_vjp():
    args = _mlp_args(0)
    g = np.random.default_rng(1).standard_normal((5, 2)).astype(np.float32)
    out, vjp = jax.vjp(lambda *a: jax_fused_mlp(*a, block_rows=8,
                                                interpret=True),
                       *map(jnp.asarray, args))
    ref = vjp(jnp.asarray(g))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    ours = FusedMlp.apply(*ts)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(out),
                               rtol=0, atol=1e-5)
    grads = torch.autograd.grad(ours, ts, torch.tensor(g))
    for i, (a, b) in enumerate(zip(grads, ref)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5, err_msg=f"input {i}")


def test_fused_mlp_fp64_gradcheck():
    ts = [torch.tensor(a, requires_grad=True)
          for a in _mlp_args(2, dims=(6, 5, 4, 2), batch=3,
                             dtype=np.float64)]
    assert torch.autograd.gradcheck(FusedMlp.apply, ts)


def test_fusion_mlp_eval_output_unchanged():
    head = FusionMLP(24, 2, 0.5).eval()
    x = torch.randn(4, 24, generator=torch.Generator().manual_seed(3))
    w = [t.detach() for t in (head.fc1.weight.t(), head.fc1.bias,
                              head.fc2.weight.t(), head.fc2.bias,
                              head.fc3.weight.t(), head.fc3.bias)]
    before = fused_mlp.launches
    out = head(x)
    assert fused_mlp.launches == before          # CPU calls do not count
    assert torch.equal(out.detach(), fused_mlp(x, *w))
    assert out.requires_grad                      # through FusedMlp


# ----------------------------------------------------- shared models


class TinyJaxFusion(fnn.Module):
    """``MultimodalFusionClassifier``'s scopes at toy width, taps passed to
    both branches as the JAX model does."""

    @fnn.compact
    def __call__(self, rgb, thermal, *, train: bool = False, taps=None):
        r = JaxResNet(name="rgb_branch", **RESNET)(rgb, train=train,
                                                   taps=taps)
        t = JaxViT(block_impl="flax", attention_impl="xla",
                   name="thermal_branch", **VIT)(thermal, train=train,
                                                 taps=taps)
        return JaxFusionMLP(2, 0.0, name="fusion")(
            jnp.concatenate([r, t], axis=-1), train=train)


class TinyJaxViTClassifier(fnn.Module):
    """``ViTClassifier``'s scopes (``ViT_0``, ``head``) at toy width."""

    @fnn.compact
    def __call__(self, x, *, train: bool = False, taps=None):
        feats = JaxViT(block_impl="flax", attention_impl="xla", name="ViT_0",
                       **VIT)(x, train=train, taps=taps)
        return fnn.Dense(2, dtype=jnp.float32, name="head")(feats)


def _random_variables(module, inputs, seed):
    """Variables of ``module`` drawn in numpy (no init compile): scaled
    normal kernels, every other leaf moved off its init value, variances
    positive."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda *xs: module.init(jax.random.PRNGKey(0), *xs, train=False),
        *inputs)

    def leaf(path, s):
        key = str(path[-1].key)
        if key == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape)
                    / np.sqrt(fan_in)).astype(np.float32)
        noise = 0.05 * rng.standard_normal(s.shape).astype(np.float32)
        if key in ("scale", "var"):
            return (1.0 + np.abs(noise)).astype(np.float32)
        if key in ("cls_token", "pos_embed"):
            return (0.02 * rng.standard_normal(s.shape)).astype(np.float32)
        return noise

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _inputs(names, seed, batch=3):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((batch, IMAGE, IMAGE, 3)).astype(np.float32)
          for _ in names]
    return xs


@pytest.fixture(scope="module")
def models():
    """name -> (JAX module, variables, port module, numpy inputs)."""
    out = {}
    x1 = _inputs(["rgb"], 10)
    jm, spec = jax_zoo.build("rgb_only")
    v = _random_variables(jm, x1, 0)
    pm, _ = zoo.build("rgb_only")
    pm.load_state_dict(variables_to_state_dict("rgb_only", v))
    out["rgb_only"] = (jm, v, pm.eval(), x1)

    jm = TinyJaxViTClassifier()
    v = _random_variables(jm, x1, 1)
    pm, _ = zoo.build("thermal_only", image_size=IMAGE, **VIT)
    pm.load_state_dict(variables_to_state_dict("thermal_only", v))
    out["thermal_only"] = (jm, v, pm.eval(), _inputs(["thermal"], 11))

    x2 = _inputs(["rgb", "thermal"], 12)
    jm = TinyJaxFusion()
    v = _random_variables(jm, x2, 2)
    pm, _ = zoo.build("multimodal", image_size=IMAGE)
    pm.rgb_branch = ResNet(**RESNET)
    pm.thermal_branch = ViT(image_size=IMAGE, **VIT)
    pm.fusion = FusionMLP(FEATS + VIT["hidden_dim"], 2, 0.0)
    pm.load_state_dict(variables_to_state_dict("multimodal", v))
    out["multimodal"] = (jm, v, pm.eval(), x2)
    return out


def _torch(xs):
    return tuple(torch.from_numpy(x) for x in xs)


def _jnp(xs):
    return tuple(jnp.asarray(x) for x in xs)


def test_taps_match_jax_intermediates(models):
    jm, v, pm, xs = models["multimodal"]
    _, state = jax.jit(lambda v, *xs: jm.apply(
        v, *xs, train=False, mutable=["intermediates"]))(v, *_jnp(xs))
    taps = {}
    with torch.no_grad():
        pm(*_torch(xs), taps=taps)
    assert sorted(taps) == ["blocks", "stage1", "stage2", "stage3", "stage4"]
    for name, t in taps.items():
        ref = np.asarray(jax_gradcam._find_intermediate(
            state["intermediates"], name))
        assert t.shape == ref.shape, name
        np.testing.assert_allclose(t.numpy(), ref, rtol=0,
                                   atol=1e-5 * (1 + np.abs(ref).max()),
                                   err_msg=name)


def test_unknown_tap_names_the_taps(models):
    _, _, pm, xs = models["thermal_only"]
    with pytest.raises(ValueError, match=r"unknown tap 'stage4'.*blocks"):
        gradcam.compute_cam_batch(pm, _torch(xs), "stage4")


def _assert_outs(ours, ref, cam_tol=CAM_TOL):
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o["probs"], np.asarray(r["probs"]),
                                   rtol=0, atol=PROB_TOL)
        assert o["pred"] == r["pred"]
        assert o["used_saliency"] == r["used_saliency"]
        assert o["cam"].shape == r["cam"].shape
        np.testing.assert_allclose(o["cam"], r["cam"], rtol=0, atol=cam_tol)


@pytest.mark.parametrize("name,tap,index", [
    ("rgb_only", "stage4", 0), ("thermal_only", "blocks", 0),
    ("multimodal", "stage4", 0), ("multimodal", "blocks", 1)])
def test_compute_cam_batch_matches_jax(models, name, tap, index):
    """Each class choice is one JAX compile: the full-width ResNet-50 takes
    "pred" alone (the small multimodal's ResNet covers 0 and 1)."""
    jm, v, pm, xs = models[name]
    for ci in ("pred",) if name == "rgb_only" else CLASSES:
        ref = jax_gradcam.compute_cam_batch(jm, v, _jnp(xs), tap, ci, index)
        ours = gradcam.compute_cam_batch(pm, _torch(xs), tap, ci, index)
        _assert_outs(ours, ref)
    assert all(p.grad is None and p.requires_grad for p in pm.parameters())


def test_multimodal_strict_mode_matches_jax(models):
    """Each trunk alone, score = its feature 0 (the CLI's strict mode):
    the port's branch submodule against JAX's branch variables."""
    jm, v, pm, xs = models["multimodal"]
    for branch, jax_trunk, tap, x in (
            ("rgb_branch", JaxResNet(**RESNET), "stage4", xs[0]),
            ("thermal_branch", JaxViT(block_impl="flax",
                                      attention_impl="xla", **VIT),
             "blocks", xs[1])):
        ref = jax_gradcam.compute_cam_batch(
            jax_trunk, jax_gradcam.branch_variables(v, branch),
            (jnp.asarray(x),), tap, class_index=0)
        ours = gradcam.compute_cam_batch(
            gradcam.branch_module(pm, branch), (torch.from_numpy(x),), tap,
            class_index=0)
        _assert_outs(ours, ref)


@pytest.mark.parametrize("name,scope,index", [
    ("thermal_only", ("ViT_0", "vit"), 0),
    ("multimodal", ("thermal_branch", "thermal_branch"), 1)])
def test_rollout_and_chefer_match_jax(models, name, scope, index):
    jm, v, pm, xs = models[name]
    for method, classes in (("rollout", ("pred",)), ("chefer", CLASSES)):
        for ci in classes:
            ref = jax_va.compute_vit_cam_batch(
                jm, v, _jnp(xs), scope[0], method, class_index=ci,
                input_index=index, num_heads=VIT["num_heads"])
            ours = va.compute_vit_cam_batch(pm, _torch(xs), scope[1], method,
                                            class_index=ci,
                                            input_index=index)
            _assert_outs(ours, ref)
            assert all(o["method"] == method for o in ours)


def test_functional_trunk_and_chefer_grads_match_jax_eps(models):
    """trunk_tokens == the JAX functional trunk, and autograd.grad at the
    attention probabilities == the JAX eps-trick gradient."""
    jm, v, pm, xs = models["thermal_only"]
    trunk = jax_va.stacked_trunk_params(v["params"]["ViT_0"])
    heads, t, x = VIT["num_heads"], 17, jnp.asarray(xs[0])
    tap_grad = np.random.default_rng(5).standard_normal(
        (x.shape[0], t, VIT["hidden_dim"])).astype(np.float32)
    eps = jnp.zeros((VIT["depth"], x.shape[0], heads, t, t))
    ref_tokens, _ = jax_va._trunk_tokens(trunk, x, eps, heads)
    ref_grads = jax.grad(lambda e: jnp.sum(
        jax_va._trunk_tokens(trunk, x, e, heads)[0] * tap_grad))(eps)
    params = va.trunk_params(pm.vit)
    leaf = torch.from_numpy(xs[0]).requires_grad_(True)
    tokens, attn = va.trunk_tokens(params, leaf)
    np.testing.assert_allclose(tokens.detach().numpy(),
                               np.asarray(ref_tokens), rtol=0, atol=1e-5)
    grads = torch.autograd.grad((tokens * torch.from_numpy(tap_grad)).sum(),
                                attn)
    np.testing.assert_allclose(torch.stack(grads).numpy(),
                               np.asarray(ref_grads), rtol=0, atol=1e-5)


def test_int8_trunk_is_refused():
    pm, _ = zoo.build("thermal_only", image_size=IMAGE, block_impl="fused_q8",
                      **VIT)
    with pytest.raises(ValueError, match="full-fidelity"):
        va.trunk_params(pm.vit)


# ------------------------------------------------------------ overlay


def test_jet_table_is_opencvs():
    ramp = np.arange(256, dtype=np.uint8)[None]
    bgr = cv2.applyColorMap(ramp, cv2.COLORMAP_JET)[0]
    np.testing.assert_array_equal(gradcam.JET_RGB, bgr[:, ::-1])


@pytest.mark.parametrize("src,dst", [((7, 7), (224, 224)),
                                     ((14, 14), (160, 224)),
                                     ((5, 9), (33, 17)), ((32, 32), (16, 16)),
                                     ((2, 2), (32, 32)), ((8, 8), (8, 8))])
def test_resize_matches_opencv(src, dst):
    cam = np.random.default_rng(sum(src + dst)).random(src).astype(np.float32)
    w, h = dst
    np.testing.assert_allclose(gradcam.resize_linear(cam, w, h),
                               cv2.resize(cam, (w, h)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("alpha", [0.5, 0.3, 0.7, 0.123])
def test_add_weighted_and_overlay_match_opencv(alpha):
    rng = np.random.default_rng(int(alpha * 1000))
    a = rng.integers(0, 256, (64, 48, 3), dtype=np.uint8)
    b = rng.integers(0, 256, (64, 48, 3), dtype=np.uint8)
    np.testing.assert_array_equal(gradcam.add_weighted(a, 1 - alpha, b, alpha),
                                  cv2.addWeighted(a, 1 - alpha, b, alpha, 0))
    cam = rng.random((7, 7)).astype(np.float32)
    overlay, heat = gradcam.overlay_cam(a, cam, alpha)
    ref_heat = cv2.cvtColor(cv2.applyColorMap(
        (np.clip(cv2.resize(cam, (48, 64)), 0, 1) * 255).astype(np.uint8),
        cv2.COLORMAP_JET), cv2.COLOR_BGR2RGB)
    # the resize may differ by 1e-6, which can move a level at a boundary
    assert np.abs(heat.astype(int) - ref_heat).max() <= 4
    np.testing.assert_array_equal(
        overlay, cv2.addWeighted(a, 1 - alpha, heat, alpha, 0))


# ---------------------------------------------------------------- CLI


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The JAX and the port CLI over the same JAX checkpoints of the tiny
    models; each package's CAMs captured."""
    root = tmp_path_factory.mktemp("gradcam")
    data = root / "data"
    counts = {m: {"train": (1, 1), "val": (1, 1), "test": (3, 3)}
              for m in ("rgb", "thermal")}
    make_synthetic_dataset(data, size=IMAGE, counts=counts)
    cfg = jax_config.TrainConfig(batch_size=4, compute_dtype="float32",
                                 mesh=jax_config.MeshConfig(data=1))
    mods = {"rgb": jax_config.rgb_modality(),
            "thermal": jax_config.thermal_modality()}
    for k, (ckpt, zoo_name) in enumerate((
            ("checkpoints_rgb_only", "tiny_rgb"),
            ("checkpoints_thermal_only", "tiny_thermal"))):
        jt = JaxTrainer(zoo_name, cfg, mods)
        state = jt.init_state(jax.random.PRNGKey(30 + k), image_size=IMAGE)
        jax_ckpt.save_checkpoint(root / "logs" / ckpt, epoch=1,
                                 model_state=jt.variables(state),
                                 opt_state=state.opt_state, val_f1=0.5,
                                 history={}, extra_meta={"model": zoo_name})
    argv = ["--data-dir", str(data), "--checkpoint-root", str(root / "logs"),
            "--image-size", str(IMAGE), "--num-per-class", "2",
            "--cam-class", "pred", "--models", "rgb_only", "thermal_only",
            "--model-overrides", "rgb_only=tiny_rgb",
            "thermal_only=tiny_thermal"]
    cams = {}
    for pkg, mod, extra in (("jax", jax_gradcam, []),
                            ("port", gradcam, ["--device", "cpu"])):
        real = mod.compute_cam_batch

        def capture(*a, _real=real, _pkg=pkg, **kw):
            out = _real(*a, **kw)
            cams.setdefault(_pkg, []).append(out)
            return out

        mod.compute_cam_batch = capture
        try:
            cli = jax_cli if pkg == "jax" else port_cli
            cli.main(argv + extra + ["--output-dir", str(root / pkg)])
        finally:
            mod.compute_cam_batch = real
    return root, cams


def test_gradcam_cli_matches_jax(cli_runs):
    root, cams = cli_runs
    names = {pkg: sorted(str(p.relative_to(root / pkg))
                         for p in (root / pkg).rglob("*.png"))
             for pkg in ("jax", "port")}
    assert names["port"] == names["jax"]
    assert len(names["port"]) == 8
    for rel in names["port"]:
        img = read_png(root / "port" / rel)
        assert img.shape == (port_cli.SINGLE_SIZE[1],
                             port_cli.SINGLE_SIZE[0], 3)
    assert len(cams["port"]) == len(cams["jax"]) == 2
    for ours, ref in zip(cams["port"], cams["jax"]):
        _assert_outs(ours, ref)


def test_gradcam_cli_refuses_strict_with_transformer_method(tmp_path):
    with pytest.raises(SystemExit, match="strict"):
        port_cli.main(["--data-dir", str(tmp_path), "--device", "cpu",
                       "--multimodal-cam", "strict", "--cam-method",
                       "rollout"])


def test_explain_freezes_only_for_its_backward():
    """``frozen`` restores every flag and the train mode: the trainer
    trains on after an explanation."""
    m = nn.Sequential(nn.Linear(3, 2), nn.Linear(2, 2))
    m[1].weight.requires_grad_(False)
    m.train()
    with gradcam.frozen(m):
        assert not any(p.requires_grad for p in m.parameters())
        assert not m.training
    assert [p.requires_grad for p in m.parameters()] == [True, True, False,
                                                         True]
    assert m.training
