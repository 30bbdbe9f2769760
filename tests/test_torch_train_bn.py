"""The rgb_only and multimodal train steps of the port (live BatchNorm with
flax's statistics) against the JAX single-device jit ``Trainer.train_step``
on the CPU.

Both packages train cut-down models at image 32: a ResNet with one block
a stage and narrow widths (stage 4 is 1x1, so its BatchNorm averages 6
values and torch's unbiased running variance would be 6/5 of flax's), and
the tiny ViT of ``test_torch_train.py``, fp32, fp32 first moment, no
dropout, identity augmentation, batch 6 with one padding row, from the
same weights and BatchNorm statistics (perturbed off their init values).
The JAX Trainer's module is swapped for a flax module of the same scopes
in the test; the port's model gets the same cut-down submodules.

Each step starts from the same state in both packages: after a step is
checked, the JAX state (weights, statistics and the optax state, through
``tools/convert_jax.py``'s bridge) is loaded into the port.  Otherwise
the second step would compare sign noise: where a gradient is ~0 its sign
may differ between the packages, Adam's first update is lr·sign(g), and a
stem BatchNorm bias 2·lr apart moves every later activation.

Budgets: loss 1e-5 relative (the same fp32 math); confusion counts equal;
parameters after each AdamW step within 2·lr (the sign noise above);
running mean and variance within 1e-5 of each buffer's largest entry
(torch's unbiased update misses this by ×1.2, and the second step
compounds the first's); first moments, after the first step, within
MU_TOL = 1e-4 of each leaf's largest entry, not the ViT tests' 2e-5: the
JAX step's own fp32 gradients stand up to 5.3e-5 of a leaf's largest
entry from the same step evaluated in fp64 by the port (the port's fp32
ones up to 1.7e-5), measured on these inputs at image 32 and no better at
48 and 64, so no fp32 implementation meets 2e-5 against it.  After the
second step the moments are not held: from the first step's weights a
ReLU pre-activation or a max-pool pair sits within fp32 noise of its kink
on some rows, and the packages' gradients then take different branches
(first moments up to 1.6e-2 and second moments up to 2.2e-2 of a leaf's
largest entry apart, multimodal, with the tier's XLA flags; the losses
within their 1e-5).  The second step holds the update instead, within
UPDATE_TOL·lr = 0.25·lr wherever JAX's first moment is at least
UPDATE_ROWS = 0.3 of its leaf's largest entry: there such a gap moves the
first moment by at most ~5% and Adam's step by about as much (measured
0.022·lr), where a skipped step or a wrong one moves it by about lr.
"""

import dataclasses

import flax.linen as fnn
from flax import serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from dfu_multimodal_tpu import config as jax_config
from dfu_multimodal_tpu.models.fusion import FusionMLP as JaxFusionMLP
from dfu_multimodal_tpu.models.resnet import ResNet as JaxResNet
from dfu_multimodal_tpu.models.vit import ViT as JaxViT
from dfu_multimodal_tpu.train.engine import Trainer as JaxTrainer
from dfu_multimodal_tpu_torch import config as port_config
from dfu_multimodal_tpu_torch.models.fusion import FusionMLP
from dfu_multimodal_tpu_torch.models.resnet import ResNet
from dfu_multimodal_tpu_torch.models.vit import ViT
from dfu_multimodal_tpu_torch.tools.convert_jax import (
    adamw_state_from_optax, variables_to_state_dict)
from dfu_multimodal_tpu_torch.train import engine as port_engine

torch.set_num_threads(1)

IMAGE = 32
RESNET = dict(stage_sizes=(1, 1, 1, 1), widths=(8, 8, 16, 16))
FEATS = 4 * RESNET["widths"][-1]
VIT = dict(depth=2, hidden_dim=64, num_heads=4, patch_size=8)
CFG = dict(batch_size=6, compute_dtype="float32",
           optimizer_mu_dtype="float32", drop_rate=0.0, learning_rate=1e-3,
           weight_decay=1e-4, seed=0)
CLASS_WEIGHTS = np.array([0.75, 1.5], np.float32)
INPUTS = {"rgb_only": ("rgb",), "multimodal": ("rgb", "thermal")}
MU_TOL = 1e-4
UPDATE_TOL, UPDATE_ROWS = 0.25, 0.3


class TinyJaxRgb(fnn.Module):
    """``ResNetClassifier``'s scopes: ``ResNet_0``, Dropout, ``head``."""

    @fnn.compact
    def __call__(self, x, *, train: bool = False, taps=None):
        feats = JaxResNet(name="ResNet_0", **RESNET)(x, train=train)
        feats = fnn.Dropout(0.0, deterministic=not train)(feats)
        return fnn.Dense(2, dtype=jnp.float32, name="head")(feats)


class TinyJaxFusion(fnn.Module):
    """``MultimodalFusionClassifier``'s scopes: ``rgb_branch``,
    ``thermal_branch`` (flax blocks, exact GELU), ``fusion``."""

    @fnn.compact
    def __call__(self, rgb, thermal, *, train: bool = False, taps=None):
        r = JaxResNet(name="rgb_branch", **RESNET)(rgb, train=train)
        t = JaxViT(block_impl="flax", attention_impl="xla",
                   name="thermal_branch", **VIT)(thermal, train=train)
        return JaxFusionMLP(2, 0.0, name="fusion")(
            jnp.concatenate([r, t], axis=-1), train=train)


JAX_MODULES = {"rgb_only": TinyJaxRgb, "multimodal": TinyJaxFusion}


def _neutral(modality_fn, augment_cls):
    aug = augment_cls(horizontal_flip_prob=0.0, vertical_flip_prob=0.0,
                      rotation_degrees=0.0, aug_prob=0.0, affine_degrees=0.0)
    return dataclasses.replace(modality_fn(), augment=aug)


def _modalities(cfg_mod, name):
    fns = {"rgb": cfg_mod.rgb_modality,
           "thermal": lambda: cfg_mod.thermal_modality(blur=False)}
    return {m: _neutral(fns[m], cfg_mod.AugmentConfig)
            for m in INPUTS[name]}


def _perturbed(variables, seed):
    """numpy copy with every non-kernel parameter and every BatchNorm
    statistic moved off its init value (variances kept positive)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x, np.float32)
        key = str(path[-1].key)
        if key == "kernel":
            return x
        noise = 0.05 * rng.standard_normal(x.shape).astype(np.float32)
        return x + (np.abs(noise) if key == "var" else noise)

    return jax.tree_util.tree_map_with_path(leaf, variables)


def jax_trainer(name, **overrides):
    """(JAX Trainer with the tiny module, its state at perturbed
    weights, those numpy variables)."""
    cfg = jax_config.TrainConfig(**{**CFG, **overrides},
                                 mesh=jax_config.MeshConfig(data=1))
    jt = JaxTrainer(name, cfg, _modalities(jax_config, name),
                    class_weights=CLASS_WEIGHTS)
    jt.module = JAX_MODULES[name]()
    state = jt.init_state(jax.random.PRNGKey(0), image_size=IMAGE)
    variables = _perturbed({"params": state.params,
                            "batch_stats": state.batch_stats}, seed=1)
    state = state.replace(
        params=jax.tree.map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=jt.tx.init(variables["params"]))
    return jt, state, variables


def tiny_port_model(trainer) -> None:
    """Give the port trainer's model the test's cut-down submodules."""
    m, dt = trainer.module, trainer.compute_dtype
    if trainer.spec.name == "rgb_only":
        m.resnet = ResNet(dtype=dt, **RESNET)
        m.head = nn.Linear(FEATS, 2)
    else:
        m.rgb_branch = ResNet(dtype=dt, **RESNET)
        m.thermal_branch = ViT(image_size=IMAGE, dtype=dt, **VIT)
        m.fusion = FusionMLP(FEATS + VIT["hidden_dim"], 2,
                             trainer.cfg.drop_rate, dt)
    m.to(trainer.device)


def port_trainer(name, variables=None, **overrides):
    cfg = port_config.TrainConfig(**{**CFG, **overrides})
    pt = port_engine.Trainer(name, cfg, _modalities(port_config, name),
                             class_weights=CLASS_WEIGHTS, device="cpu",
                             image_size=IMAGE)
    tiny_port_model(pt)
    if variables is not None:
        pt.module.load_state_dict(variables_to_state_dict(name, variables))
    return pt


def batches(name, n=2, seed=7, size=6):
    """``n`` batches of ``size`` rows, the last a padding row."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {m: rng.integers(0, 256, (size, IMAGE, IMAGE, 3), dtype=np.uint8)
             for m in INPUTS[name]}
        b["label"] = np.arange(size, dtype=np.int32) % 2
        b["valid"] = np.r_[np.ones(size - 1), 0.0].astype(np.float32)
        out.append(b)
    return out


def assert_state_matches(name, pt, state, lr, first=True):
    """Parameters within 2·lr and BatchNorm statistics within 1e-5 of each
    buffer's largest entry; after the first step (``first``) the first
    moments within MU_TOL of each leaf's largest entry, after the second
    (from JAX's state) the parameters within UPDATE_TOL·lr where JAX's
    first moment is at least UPDATE_ROWS of its leaf's largest entry (the
    module docstring says why)."""
    ours = pt.module.state_dict()
    ref = variables_to_state_dict(name, jax.tree.map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats}))
    assert ref.keys() == ours.keys()
    for k, v in ref.items():
        if k.endswith("num_batches_tracked"):    # JAX keeps no count
            continue
        v = v.numpy()
        if k.endswith(("running_mean", "running_var")):
            atol = 1e-5 * float(np.abs(v).max())
        else:
            atol = 2 * lr
        np.testing.assert_allclose(ours[k].numpy(), v, rtol=0, atol=atol,
                                   err_msg=k)
    mu = variables_to_state_dict(name, {"params": jax.tree.map(
        np.asarray, state.opt_state[0].mu)})
    ours_mu = pt.optimizer.state_dict()["mu"]
    assert ours_mu.keys() == mu.keys()
    for k, v in mu.items():
        v = v.numpy()
        if first:
            np.testing.assert_allclose(ours_mu[k].numpy(), v, rtol=0,
                                       atol=MU_TOL * float(np.abs(v).max()),
                                       err_msg=k)
        else:
            rows = np.abs(v) >= UPDATE_ROWS * np.abs(v).max()
            np.testing.assert_allclose(ours[k].numpy()[rows],
                                       ref[k].numpy()[rows], rtol=0,
                                       atol=UPDATE_TOL * lr, err_msg=k)


def load_jax_state(name, pt, state):
    """The JAX state after a step -> the port trainer (weights, BatchNorm
    statistics, the optimizer's count and moments)."""
    variables = jax.tree.map(np.asarray, {"params": state.params,
                                          "batch_stats": state.batch_stats})
    sd = variables_to_state_dict(name, variables)
    pt.module.load_state_dict({k: v for k, v in sd.items()
                               if not k.endswith("num_batches_tracked")},
                              strict=False)
    pt.optimizer.load_state_dict(adamw_state_from_optax(
        name, serialization.to_state_dict(jax.device_get(state.opt_state))))


def step_both(jt, state, pt, batch):
    state, jm = jt.train_step(state, jax.device_put(batch, jt.batch_sharding),
                              jax.random.PRNGKey(1))
    pm = pt.train_step(batch, torch.Generator().manual_seed(0))
    assert float(pm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    np.testing.assert_array_equal(pm["counts"].numpy(),
                                  np.asarray(jm["counts"]))
    return state


@pytest.mark.parametrize("name", ["rgb_only", "multimodal"])
def test_train_steps_match_jax_trainer(name):
    jt, state, variables = jax_trainer(name)
    pt = port_trainer(name, variables)
    for i, batch in enumerate(batches(name)):
        state = step_both(jt, state, pt, batch)
        assert_state_matches(name, pt, state, CFG["learning_rate"],
                             first=i == 0)
        load_jax_state(name, pt, state)
    assert pt.optimizer.count == 2
    bn = pt.module.state_dict()
    key = ("resnet" if name == "rgb_only" else "rgb_branch")
    assert int(bn[f"{key}.layer4.0.bn3.num_batches_tracked"]) == 2


def test_grad_accum_with_batchnorm_matches_jax():
    """grad_accum 2 at batch 12: two microbatches of 6 (the second ending
    in the padding row), so stage 4's BatchNorm averages 6 values as in the
    test above; the statistics move once by each microbatch, the gradient
    is divided once by the whole batch's weight.  (At batch 6, microbatches
    of 3, the JAX step's fp32 loss stands 2.8e-5 from the port's fp64
    evaluation of it, the port's fp32 one 4e-6: past the 1e-5 budget on
    the reference's side.)"""
    jt, state, variables = jax_trainer("rgb_only", grad_accum=2,
                                       batch_size=12)
    pt = port_trainer("rgb_only", variables, grad_accum=2, batch_size=12)
    for i, batch in enumerate(batches("rgb_only", size=12)):
        state = step_both(jt, state, pt, batch)
        assert_state_matches("rgb_only", pt, state, CFG["learning_rate"],
                             first=i == 0)
        load_jax_state("rgb_only", pt, state)
    bn = pt.module.state_dict()
    assert int(bn["resnet.layer4.0.bn3.num_batches_tracked"]) == 4


def test_batchnorm_keeps_flax_statistics():
    """One train-mode forward of the port's BatchNorm2d: the output is
    torch's (biased variance), the running variance moves by the biased
    variance, where ``nn.BatchNorm2d`` moves it by n/(n-1) of it."""
    from dfu_multimodal_tpu_torch.models.resnet import BatchNorm2d
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (6, 4, 1, 1)).astype(np.float32))
    ours, theirs = BatchNorm2d(4).train(), nn.BatchNorm2d(4).train()
    torch.testing.assert_close(ours(x), theirs(x), rtol=0, atol=1e-6)
    biased = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(ours.running_var, 0.9 + 0.1 * biased)
    torch.testing.assert_close(theirs.running_var, 0.9 + 0.1 * biased * 1.2)
    torch.testing.assert_close(ours.running_mean, theirs.running_mean)
    assert int(ours.num_batches_tracked) == 1


@pytest.mark.parametrize("smooth", [False, True], ids=["relu", "softplus"])
def test_trunk_gradient_jumps_at_relu_kinks(smooth, monkeypatch):
    """Why the card's fp32 ResNet trunk gradient is held as one vector
    (``chip_smoke.py``'s TRUNK_L2_TOL): the full-width ResNet-50 trunk in
    train mode, fp64, seeded weights, at image 64 and batch 4, a fixed
    projection of its features backpropagated.  Moving the normalised
    input by 1e-7 (fp32's rounding) moves the trunk's gradient by far more
    than 100 times what 1e-9 moves it (measured 8.0e3 times: 1.7e-3 of its
    norm against 2.1e-7): pre-activations cross ReLU's kink.  With
    softplus(beta=20) in place of ReLU the response is linear: 100 times
    (measured 100.0)."""
    from dfu_multimodal_tpu_torch.models import zoo
    from torch.nn import functional as F
    if smooth:
        monkeypatch.setattr(F, "relu", lambda t: F.softplus(t, beta=20.0))
    model, _ = zoo.build("rgb_only", drop_rate=0.0)
    zoo.init_model(model, torch.Generator().manual_seed(0))
    trunk = model.resnet.double().train()
    trunk.dtype = torch.float64
    gens = [torch.Generator().manual_seed(s) for s in (1, 2, 3)]
    x = torch.randn(4, 64, 64, 3, dtype=torch.float64, generator=gens[0])
    noise = torch.randn(x.shape, dtype=torch.float64, generator=gens[1])
    proj = torch.randn(4, 2048, dtype=torch.float64, generator=gens[2])
    start = {k: v.clone() for k, v in trunk.state_dict().items()}

    def grads(eps):
        trunk.load_state_dict(start)
        trunk.zero_grad()
        (trunk(x + eps * noise) * proj).sum().backward()
        return torch.cat([p.grad.flatten() for p in trunk.parameters()])

    ref = grads(0.0)
    moved = [float((grads(eps) - ref).norm() / ref.norm())
             for eps in (1e-9, 1e-7)]
    ratio = moved[1] / moved[0]
    if smooth:
        assert 90.0 <= ratio <= 110.0, moved
    else:
        assert ratio >= 1e3, moved


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_value_batchnorm_matches_flax(dtype):
    """A train-mode BatchNorm over one value a channel (N·H·W = 1, which
    ``F.batch_norm`` refuses): the port normalises it as flax's
    ``nn.BatchNorm`` does (batch variance 0, output the bias), with flax's
    input gradient and running statistics (momentum 0.9 in flax's terms),
    all within 1e-6; bf16 input gives the fp32 result rounded."""
    from dfu_multimodal_tpu_torch.models.resnet import BatchNorm2d
    rng = np.random.default_rng(5)
    c = 8
    x = rng.standard_normal((1, 1, 1, c)).astype(np.float32)     # NHWC
    # both sides see the same input values
    x = torch.from_numpy(x).to(getattr(torch, dtype)).float().numpy()
    g = rng.standard_normal((1, 1, 1, c)).astype(np.float32)
    scale = 1.0 + 0.1 * rng.standard_normal(c).astype(np.float32)
    bias = 0.1 * rng.standard_normal(c).astype(np.float32)
    mean0 = 0.1 * rng.standard_normal(c).astype(np.float32)
    var0 = 1.0 + np.abs(0.1 * rng.standard_normal(c)).astype(np.float32)

    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}

    def loss(xx):
        y, upd = bn.apply(variables, xx, mutable=["batch_stats"])
        return jnp.sum(y * g), (y, upd["batch_stats"])

    (_, (y_ref, stats)), dx_ref = jax.value_and_grad(loss, has_aux=True)(
        jnp.asarray(x))

    ours = BatchNorm2d(c).train()
    with torch.no_grad():
        ours.weight.copy_(torch.from_numpy(scale))
        ours.bias.copy_(torch.from_numpy(bias))
        ours.running_mean.copy_(torch.from_numpy(mean0))
        ours.running_var.copy_(torch.from_numpy(var0))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(getattr(torch, dtype))
    xt.requires_grad_(True)
    y = ours(xt)
    (y.float() * torch.from_numpy(g).permute(0, 3, 1, 2)).sum().backward()
    y_ref = np.asarray(y_ref).transpose(0, 3, 1, 2)
    if dtype == "bfloat16":
        y_ref = torch.tensor(y_ref).bfloat16().float().numpy()
    np.testing.assert_allclose(y.detach().float().numpy(), y_ref, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(
        xt.grad.float().numpy(), np.asarray(dx_ref).transpose(0, 3, 1, 2),
        rtol=0, atol=1e-6)
    np.testing.assert_allclose(ours.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ours.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=0, atol=1e-6)
    assert int(ours.num_batches_tracked) == 1


def test_one_row_microbatch_matches_jax():
    """rgb_only at image 32, batch 2, grad_accum 2: microbatches of one
    row, so stage 4's 1x1 map gives its BatchNorm one value a channel
    (the second microbatch is the padding row).  The port's step against
    the JAX single-device step, at this module's budgets.  (Here autograd
    hands layer 4's bn3 and downsample biases views of one gradient;
    divided in place once for each, their first moments stood 4/3 of
    JAX's, the class weight 0.75 divided twice.)"""
    jt, state, variables = jax_trainer("rgb_only", grad_accum=2,
                                       batch_size=2)
    pt = port_trainer("rgb_only", variables, grad_accum=2, batch_size=2)
    batch = batches("rgb_only", n=1, size=2)[0]
    state = step_both(jt, state, pt, batch)
    assert_state_matches("rgb_only", pt, state, CFG["learning_rate"])
    bn = pt.module.state_dict()
    assert int(bn["resnet.layer4.0.bn3.num_batches_tracked"]) == 2
