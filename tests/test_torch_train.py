"""The thermal_only train slice of the port against the JAX package on the
CPU: config copy, transforms, loader, metrics, AdamW, the weight bridge,
and one and two ``Trainer.train_step``s against the JAX ``Trainer``.

Inputs are made with numpy from a seed and handed to both packages.  JAX
PRNG streams cannot be reproduced in torch, so augmentation is compared
by injecting the same matrices, sigmas and jitter factors, and the train
steps run with augmentation neutralised and dropout off.  Tolerances are
stated at each comparison.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dfu_multimodal_tpu import config as jax_config
from dfu_multimodal_tpu.data import loader as jax_loader
from dfu_multimodal_tpu.data import transforms as jax_transforms
from dfu_multimodal_tpu.eval import metrics as jax_metrics
from dfu_multimodal_tpu.models.vit import ViT as JaxViT
from dfu_multimodal_tpu.tools.convert_torch import convert_state_dict
from dfu_multimodal_tpu.train.engine import Trainer as JaxTrainer
from dfu_multimodal_tpu_torch import config as port_config
from dfu_multimodal_tpu_torch.data import loader as port_loader
from dfu_multimodal_tpu_torch.data import transforms as port_transforms
from dfu_multimodal_tpu_torch.eval import metrics as port_metrics
from dfu_multimodal_tpu_torch.models import zoo
from dfu_multimodal_tpu_torch.tools.convert_jax import variables_to_state_dict
from dfu_multimodal_tpu_torch.train import engine as port_engine
from dfu_multimodal_tpu_torch.train.optim import AdamW

torch.set_num_threads(1)

IMAGE = 32
TINY = dict(depth=2, hidden_dim=64, num_heads=4, patch_size=8)


# ---------------------------------------------------------------- config


def test_config_copy_equals_jax_defaults():
    asdict = dataclasses.asdict
    assert asdict(port_config.TrainConfig()) == asdict(
        jax_config.TrainConfig())
    assert asdict(port_config.AugmentConfig()) == asdict(
        jax_config.AugmentConfig())
    for name in ("rgb_modality", "thermal_modality"):
        assert asdict(getattr(port_config, name)()) == asdict(
            getattr(jax_config, name)())
    assert asdict(port_config.thermal_modality(blur=False)) == asdict(
        jax_config.thermal_modality(blur=False))
    for name in ("RGB_MEAN", "RGB_STD", "THERMAL_MEAN", "THERMAL_STD"):
        assert getattr(port_config, name) == getattr(jax_config, name)


# ------------------------------------------------------------ transforms


def _images(b, h, w, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32)


def test_affine_warp_matches_jax_on_injected_matrices():
    imgs = _images(3, 16, 20, seed=1)
    cfg = jax_config.AugmentConfig()
    inv = np.stack([np.asarray(jax_transforms.sample_inverse_affine(
        jax.random.PRNGKey(i), cfg, 16, 20)) for i in range(3)])
    ref = jax.vmap(jax_transforms.affine_warp)(jnp.asarray(imgs),
                                               jnp.asarray(inv))
    out = port_transforms.affine_warp(torch.from_numpy(imgs),
                                      torch.from_numpy(inv))
    # the same fp32 bilinear arithmetic on [0, 255] pixels
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-3)


def test_gaussian_blur_and_jitter_match_jax_on_injected_draws():
    imgs = _images(2, 12, 10, seed=2)
    cfg = jax_config.AugmentConfig(aug_prob=1.0)
    sigmas = (0.2, 0.45)
    ref_blur, ref_jit, factors = [], [], []
    for i, s in enumerate(sigmas):
        key = jax.random.PRNGKey(10 + i)
        ref_blur.append(jax_transforms._gaussian_blur(
            key, jnp.asarray(imgs[i]),
            dataclasses.replace(cfg, blur_sigma=(s, s))))
        ref_jit.append(jax_transforms._color_jitter(key, jnp.asarray(imgs[i]),
                                                    cfg))
        # the factors _color_jitter draws from this key (aug_prob = 1)
        _, kb, kc, ks = jax.random.split(key, 4)
        factors.append([float(jax.random.uniform(k, minval=1 - f,
                                                 maxval=1 + f))
                        for k, f in ((kb, cfg.brightness),
                                     (kc, cfg.contrast),
                                     (ks, cfg.saturation))])
    x = torch.from_numpy(imgs)
    blur = port_transforms.gaussian_blur(x, torch.tensor(sigmas),
                                         torch.tensor([True, True]))
    jit = port_transforms.color_jitter(
        x, *torch.tensor(factors, dtype=torch.float32).T)
    # fp32 on [0, 255]: a few ulps of 255
    np.testing.assert_allclose(blur.numpy(), np.stack(ref_blur), atol=1e-3,
                               rtol=0)
    np.testing.assert_allclose(jit.numpy(), np.stack(ref_jit), atol=1e-3,
                               rtol=0)
    kept = port_transforms.gaussian_blur(x, torch.tensor(sigmas),
                                         torch.tensor([False, True]))
    np.testing.assert_array_equal(kept[0].numpy(), imgs[0])


def test_sample_inverse_affine_structure():
    gen = torch.Generator().manual_seed(0)
    flips = port_config.AugmentConfig(horizontal_flip_prob=1.0,
                                      vertical_flip_prob=0.0,
                                      rotation_degrees=0.0, aug_prob=0.0)
    inv = port_transforms.sample_inverse_affine(gen, flips, 8, 8, 4)
    np.testing.assert_array_equal(
        inv.numpy(), np.broadcast_to(np.diag([-1.0, 1.0, 1.0]), (4, 3, 3)))
    cfg = port_config.AugmentConfig(aug_prob=1.0)
    inv = port_transforms.sample_inverse_affine(gen, cfg, 8, 8, 256)
    # |det| = 1/scale^2 with scale in [0.8, 1.2]; last row stays (0, 0, 1)
    det = np.abs(np.linalg.det(inv[:, :2, :2].double().numpy()))
    assert det.min() >= 1 / 1.2 ** 2 - 1e-5 and det.max() <= 1 / 0.8 ** 2 + 1e-5
    np.testing.assert_allclose(inv[:, 2].numpy(),
                               np.broadcast_to([0.0, 0.0, 1.0], (256, 3)))


def _neutral(modality_fn, augment_cls):
    aug = augment_cls(horizontal_flip_prob=0.0, vertical_flip_prob=0.0,
                      rotation_degrees=0.0, aug_prob=0.0, affine_degrees=0.0)
    return dataclasses.replace(modality_fn(), augment=aug)


def test_neutral_augmentation_is_eval_normalize():
    rng = np.random.default_rng(3)
    imgs = torch.from_numpy(rng.integers(0, 256, (3, 16, 16, 3),
                                         dtype=np.uint8))
    mod = _neutral(port_config.thermal_modality, port_config.AugmentConfig)
    out = port_transforms.augment_and_normalize(
        imgs, mod, torch.float32, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(
        out.numpy(), port_transforms.eval_normalize(imgs, mod).numpy())


# ---------------------------------------------------- loader and metrics


def test_loader_and_metrics_match_jax():
    labels = np.array([0, 1, 1, 1, 0, 1, 1], np.int32)
    rng = np.random.default_rng(4)
    ds_np = {"thermal": rng.integers(0, 256, (7, 4, 4, 3), dtype=np.uint8)}
    for weighted in (True, False):
        np.testing.assert_array_equal(
            port_loader.epoch_indices(labels, np.random.default_rng(5),
                                      weighted),
            jax_loader.epoch_indices(labels, np.random.default_rng(5),
                                     weighted))
    order = np.arange(7)
    ours = list(port_loader.batch_slices(
        port_loader.ArrayDataset(ds_np, labels), order, 3))
    theirs = list(jax_loader.batch_slices(
        jax_loader.ArrayDataset(ds_np, labels), order, 3))
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    on_dev = list(port_loader.device_prefetch(iter(ours), "cpu"))
    np.testing.assert_array_equal(on_dev[2]["valid"].numpy(), [1, 0, 0])

    preds = np.array([1, 0, 1, 1, 0, 0, 1])
    valid = np.array([1, 1, 1, 0, 1, 1, 1], np.float32)
    counts = port_metrics.confusion_counts(
        torch.from_numpy(preds), torch.from_numpy(labels),
        torch.from_numpy(valid))
    ref = jax_metrics.confusion_counts(jnp.asarray(preds),
                                       jnp.asarray(labels),
                                       jnp.asarray(valid))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ref))
    assert port_metrics.f1_from_counts(counts) == pytest.approx(
        jax_metrics.f1_from_counts(np.asarray(ref)))
    assert port_metrics.accuracy_from_counts(counts) == pytest.approx(
        jax_metrics.accuracy_from_counts(np.asarray(ref)))


def test_loss_helpers_match_jax():
    from dfu_multimodal_tpu.train import engine as jax_engine
    labels = np.array([0, 0, 0, 1, 1], np.int32)
    np.testing.assert_array_equal(
        port_engine.class_weights_from_labels(labels),
        jax_engine.class_weights_from_labels(labels))
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((5, 2)).astype(np.float32)
    weights = np.array([2.0, 1.0, 0.0, 0.5, 1.5], np.float32)
    ours = port_engine.weighted_ce(torch.from_numpy(logits),
                                   torch.from_numpy(labels),
                                   torch.from_numpy(weights))
    ref = jax_engine.weighted_ce(jnp.asarray(logits), jnp.asarray(labels),
                                 jnp.asarray(weights))
    assert float(ours) == pytest.approx(float(ref), rel=1e-6)   # fp32


# ----------------------------------------------------------------- AdamW


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_adamw_matches_optax(mu_dtype):
    rng = np.random.default_rng(6)
    shapes = [(5, 3), (7,)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * 10.0 ** -k
              for s in shapes] for k in range(3)]
    lr, wd = 1e-2, 1e-2
    tx = optax.adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=wd,
                     mu_dtype=jnp.dtype(mu_dtype))
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt = AdamW(tp, lr=lr, weight_decay=wd,
                mu_dtype=getattr(torch, mu_dtype))
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for t, x in zip(tp, g):
            t.grad = torch.from_numpy(x)
        opt.step()
    # fp32: the same operations in optax's order.  bf16 first moment: the
    # stored mu carries bf16's 2^-8 relative rounding into each update of
    # size <= lr, so three steps stay within 3·lr·2^-7.
    atol = 1e-6 if mu_dtype == "float32" else 3 * lr * 2 ** -7
    for t, j in zip(tp, jp):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=atol)
    if mu_dtype == "float32":
        for t, j in zip(opt.mu + opt.nu, list(state[0].mu) + list(
                state[0].nu)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                       atol=1e-9)
    assert opt.mu[0].dtype == getattr(torch, mu_dtype)


# ------------------------------------------------------ bridge and model


class _TinyJaxViTClassifier(fnn.Module):
    """``ViTClassifier``-shaped flax module at TINY width: trunk scope
    ``ViT_0`` (flax blocks, exact GELU), Dropout, Dense head."""

    drop_rate: float = 0.0

    @fnn.compact
    def __call__(self, x, *, train: bool = False, taps=None):
        feats = JaxViT(block_impl="flax", attention_impl="xla", name="ViT_0",
                       **TINY)(x, train=train)
        feats = fnn.Dropout(self.drop_rate, deterministic=not train)(feats)
        return fnn.Dense(2, dtype=jnp.float32, name="head")(feats)


def _perturbed_params(params, seed):
    """numpy copy with every non-kernel leaf moved off its init value."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x, np.float32)
        if str(path[-1].key) == "kernel":
            return x
        return x + 0.05 * rng.standard_normal(x.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


def _tiny_variables():
    x = jnp.zeros((1, IMAGE, IMAGE, 3), jnp.float32)
    v = _TinyJaxViTClassifier().init({"params": jax.random.PRNGKey(0)}, x)
    return {"params": _perturbed_params(v["params"], seed=0)}


def test_thermal_only_bridge_round_trip_and_strict_load():
    variables = _tiny_variables()
    sd = variables_to_state_dict("thermal_only", variables)
    model, spec = zoo.build("thermal_only", image_size=IMAGE, **TINY)
    assert spec.inputs == ("thermal",)
    assert sd.keys() == model.state_dict().keys()
    model.load_state_dict(sd, strict=True)
    zeros = jax.tree.map(np.zeros_like, variables)
    merged, skipped = convert_state_dict("thermal_only", sd, zeros)
    assert skipped == 0
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(variables))
    flat_out = dict(jax.tree_util.tree_leaves_with_path(merged))
    assert flat_out.keys() == flat_ref.keys()
    for path, ref in flat_ref.items():
        np.testing.assert_array_equal(np.asarray(flat_out[path]), ref,
                                      err_msg=str(path))


def test_thermal_only_param_count_at_224():
    model, _ = zoo.build("thermal_only")
    assert zoo.param_count(model) == 85_800_194     # tests/test_models.py
    zoo.init_model(model, torch.Generator().manual_seed(0))
    assert float(model.head.bias.detach().abs().max()) == 0.0


CFG = dict(batch_size=6, compute_dtype="float32",
           optimizer_mu_dtype="float32", drop_rate=0.0, learning_rate=1e-3,
           weight_decay=1e-4, seed=0)
CLASS_WEIGHTS = np.array([0.75, 1.5], np.float32)


def _batches():
    rng = np.random.default_rng(7)
    out = []
    for _ in range(2):
        out.append({"thermal": rng.integers(0, 256, (6, IMAGE, IMAGE, 3),
                                            dtype=np.uint8),
                    "label": np.array([0, 1, 1, 0, 1, 0], np.int32),
                    "valid": np.array([1, 1, 1, 1, 1, 0], np.float32)})
    return out


def _port_trainer(block_impl="fused", attention_impl="auto", **overrides):
    cfg = port_config.TrainConfig(**{**CFG, **overrides})
    mod = _neutral(port_config.thermal_modality, port_config.AugmentConfig)
    return port_engine.Trainer("thermal_only", cfg, {"thermal": mod},
                               class_weights=CLASS_WEIGHTS, device="cpu",
                               image_size=IMAGE, block_impl=block_impl,
                               attention_impl=attention_impl, **TINY)


@pytest.mark.parametrize("block_impl,attention_impl", [
    ("fused", "auto"), ("flax", "pallas"), ("flax", "xla")])
def test_train_steps_match_jax_trainer(block_impl, attention_impl):
    """Two steps of the port's train_step — the fused blocks' hand chain
    rules, or autograd through the flax blocks with the packed-qkv
    attention's own backward (``"pallas"``) or plain attention
    (``"xla"``) — against the JAX single-device jit Trainer.train_step
    (flax blocks, fp32, fp32 first moment, no dropout, identity
    augmentation) from the same weights.  Loss: 1e-5 relative (the same
    fp32 math).  Params after each AdamW step: within 2·lr, the
    reference's budget — where a gradient is ~0 its sign may differ
    between the two packages, and Adam's first update is lr·sign(g)."""
    variables = _tiny_variables()
    cfg = jax_config.TrainConfig(**CFG, mesh=jax_config.MeshConfig(data=1))
    mod = _neutral(jax_config.thermal_modality, jax_config.AugmentConfig)
    jt = JaxTrainer("thermal_only", cfg, {"thermal": mod},
                    class_weights=CLASS_WEIGHTS, attention_impl="xla",
                    block_impl="flax")
    jt.module = _TinyJaxViTClassifier()
    state = jt.init_state(jax.random.PRNGKey(0), image_size=IMAGE)
    state = state.replace(params=jax.tree.map(jnp.asarray,
                                              variables["params"]),
                          opt_state=jt.tx.init(variables["params"]))

    pt = _port_trainer(block_impl, attention_impl)
    pt.module.load_state_dict(variables_to_state_dict("thermal_only",
                                                      variables))
    gen = torch.Generator().manual_seed(0)
    lr = CFG["learning_rate"]
    for batch in _batches():
        state, jm = jt.train_step(state, jax.device_put(batch,
                                                        jt.batch_sharding),
                                  jax.random.PRNGKey(1))
        pm = pt.train_step(batch, gen)
        assert float(pm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-5)
        np.testing.assert_array_equal(pm["counts"].numpy(),
                                      np.asarray(jm["counts"]))
        # the first moments hold (1 - b1)·g summed over the steps: each
        # leaf's gradient against JAX's, at the fp32 budget of the block
        # tests (2e-5) relative to that leaf's largest entry
        ref_mu = variables_to_state_dict(
            "thermal_only", {"params": jax.tree.map(np.asarray,
                                                    state.opt_state[0].mu)})
        names = [k for k, _ in pt.module.named_parameters()]
        assert sorted(names) == sorted(ref_mu)
        for k, mu in zip(names, pt.optimizer.mu):
            ref = ref_mu[k].numpy()
            np.testing.assert_allclose(
                mu.numpy(), ref, rtol=0,
                atol=2e-5 * float(np.abs(ref).max()), err_msg=k)
        ref = variables_to_state_dict(
            "thermal_only", {"params": jax.tree.map(np.asarray,
                                                    state.params)})
        ours = pt.module.state_dict()
        for k, v in ref.items():
            np.testing.assert_allclose(ours[k].numpy(), v.numpy(), rtol=0,
                                       atol=2 * lr, err_msg=k)
    assert pt.optimizer.count == 2


def test_run_train_epoch_and_meter():
    pt = _port_trainer(drop_rate=0.5, batch_size=4)
    rng = np.random.default_rng(8)
    ds = port_loader.ArrayDataset(
        {"thermal": rng.integers(0, 256, (10, IMAGE, IMAGE, 3),
                                 dtype=np.uint8)},
        np.array([0, 1] * 5, np.int32))
    seen = []

    class Meter:
        def update(self, n, metrics):
            seen.append((n, float(metrics["loss"])))

    before = {k: v.clone() for k, v in pt.module.state_dict().items()}
    m = pt.run_train_epoch(ds, np.random.default_rng(0),
                           torch.Generator().manual_seed(0), meter=Meter())
    assert [n for n, _ in seen] == [4, 4, 4]
    assert np.isfinite(m.loss) and 0.0 <= m.accuracy <= 1.0
    assert m.loss == pytest.approx(np.mean([l for _, l in seen]), rel=1e-6)
    after = pt.module.state_dict()
    assert all(not torch.equal(before[k], after[k]) for k in before)


@pytest.mark.parametrize("override,match", [
    (dict(mesh=port_config.MeshConfig(model=2)), "needs 2 devices, have 1"),
    (dict(mesh=port_config.MeshConfig(data=2)), "needs 2 devices, have 1"),
    (dict(mesh=port_config.MeshConfig(fsdp=True)),
     "fsdp needs a process group")])
def test_unported_train_options_raise(override, match):
    """A mesh larger than one device needs a process group of its size
    (JAX's "needs N devices" error); FSDP needs one at all."""
    with pytest.raises(ValueError, match=match):
        _port_trainer(**override)


# ------------------------------------------------- the other train options


@pytest.mark.parametrize("sched,warmup", [("cosine", 0.0), ("cosine", 1.0),
                                          ("constant", 1.0)])
def test_learning_rate_schedule_matches_optax(sched, warmup):
    """The schedule of every update count of a 3-epoch run of 4 steps an
    epoch (and past its end) against the JAX Trainer's optax schedule:
    within 1e-6 of the peak rate, since optax takes the cosine in fp32 (a
    few fp32 steps of the peak; the port's is rounded to fp32 once); a
    warm-up's first step has lr = 0."""
    from dfu_multimodal_tpu.train import engine as jax_engine
    kw = dict(learning_rate=1e-3, lr_schedule=sched, warmup_epochs=warmup,
              steps_per_epoch=4, num_epochs=3)
    ours = port_engine.learning_rate_schedule(port_config.TrainConfig(**kw))
    ref = jax_engine.learning_rate_schedule(jax_config.TrainConfig(**kw))
    counts = np.arange(15)
    np.testing.assert_allclose([ours(int(c)) for c in counts],
                               np.asarray(jax.vmap(ref)(counts)), rtol=0,
                               atol=1e-6 * kw["learning_rate"])
    if warmup:
        assert ours(0) == 0.0
    with pytest.raises(ValueError, match="steps_per_epoch"):
        port_engine.learning_rate_schedule(port_config.TrainConfig(
            **{**kw, "steps_per_epoch": 0}))


MIXUP_LAM, MIXUP_PERM = 0.3, np.array([2, 0, 5, 1, 3, 4])

OPTIONS = {
    "focal": dict(loss="focal", focal_gamma=2.0),
    "ema": dict(ema_decay=0.9),
    "cosine_warmup": dict(lr_schedule="cosine", warmup_epochs=1.0,
                          steps_per_epoch=1, num_epochs=3),
    "mixup": dict(mixup_alpha=0.4),
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_train_options_match_jax_trainer(option, monkeypatch):
    """The train options against the JAX jit ``Trainer.train_step`` on the
    tiny ViT, at ``test_train_steps_match_jax_trainer``'s budgets: focal
    loss; EMA of the parameters (see ``_check_ema``); a cosine schedule with one
    warm-up step over three steps (the first leaves the weights as they
    were: lr = 0); mixup on an injected (lam, perm): JAX's ``mixup_batch``
    draws them through the patched ``jax.random.beta`` / ``permutation``,
    the port's through the patched ``sample_mixup``, and each package
    mixes and weighs the loss with its own code (row 5, padding, is
    partner 2's, so its lam drops to 1 there)."""
    from dfu_multimodal_tpu.train import engine as jax_engine
    overrides = OPTIONS[option]
    if option == "mixup":
        monkeypatch.setattr(jax.random, "beta",
                            lambda *a, **k: jnp.float32(MIXUP_LAM))
        monkeypatch.setattr(jax.random, "permutation",
                            lambda *a, **k: jnp.asarray(MIXUP_PERM))
        monkeypatch.setattr(port_engine, "sample_mixup",
                            lambda gen, alpha, b: (
                                torch.tensor(MIXUP_LAM),
                                torch.from_numpy(MIXUP_PERM)))
        assert jax_engine.mixup_batch is not None
    variables = _tiny_variables()
    cfg = jax_config.TrainConfig(**{**CFG, **overrides},
                                 mesh=jax_config.MeshConfig(data=1))
    mod = _neutral(jax_config.thermal_modality, jax_config.AugmentConfig)
    jt = JaxTrainer("thermal_only", cfg, {"thermal": mod},
                    class_weights=CLASS_WEIGHTS, attention_impl="xla",
                    block_impl="flax")
    jt.module = _TinyJaxViTClassifier()
    state = jt.init_state(jax.random.PRNGKey(0), image_size=IMAGE)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = state.replace(
        params=params, opt_state=jt.tx.init(variables["params"]),
        ema_params=(jax.tree.map(jnp.copy, params)
                    if option == "ema" else None))
    pt = _port_trainer(**overrides)
    pt.module.load_state_dict(variables_to_state_dict("thermal_only",
                                                      variables))
    before = {k: v.clone() for k, v in pt.module.state_dict().items()}
    lr = CFG["learning_rate"]
    batches = _batches() + (_batches()[:1] if option == "cosine_warmup"
                            else [])
    gen = torch.Generator().manual_seed(0)
    ema_expect = ({k: v.numpy() for k, v in before.items()},
                  {k: np.zeros(v.shape, np.float32) for k, v in before.items()})
    for i, batch in enumerate(batches):
        state, jm = jt.train_step(state, jax.device_put(batch,
                                                        jt.batch_sharding),
                                  jax.random.PRNGKey(1))
        pm = pt.train_step(batch, gen)
        if option == "ema":
            ema_expect = _check_ema(pt, state, before, ema_expect,
                                    overrides["ema_decay"], lr)
        assert float(pm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-5)
        np.testing.assert_array_equal(pm["counts"].numpy(),
                                      np.asarray(jm["counts"]))
        ref = variables_to_state_dict("thermal_only", {
            "params": jax.tree.map(np.asarray, state.params)})
        ours = pt.module.state_dict()
        for k, v in ref.items():
            np.testing.assert_allclose(ours[k].numpy(), v.numpy(), rtol=0,
                                       atol=2 * lr, err_msg=k)
        if option == "cosine_warmup" and i == 0:
            for k, v in before.items():
                torch.testing.assert_close(ours[k], v, rtol=0, atol=0)
    assert pt.optimizer.count == len(batches)


def _check_ema(pt, state, p0, expect, decay, lr):
    """After a step: the port's EMA against JAX's rule
    ``e·decay + p·(1 - decay)`` (``jax.tree.map`` over jnp, as in the JAX
    trainer) applied to the port's own parameters, and against JAX's own
    EMA.  Where a gradient is ~0 the two packages' Adam steps may differ in
    sign, so the second check allows, entry by entry, the gap that the
    same rule carries from the parameters into the EMA (gap ← gap·decay +
    |p − p_jax|·(1 - decay)).  Both at 1e-2·(1 - decay)·lr beyond that: a
    step moves the EMA by up to (1 - decay)·lr, so an EMA left as it was,
    or with decay and 1 - decay swapped, fails.  The EMA shares no storage
    with the parameters.  ``expect``: (the EMA the rule gives, the gap)
    after the last step, returned for the next."""
    atol = 1e-2 * (1.0 - decay) * lr
    params = {k: p.detach().numpy()
              for k, p in pt.module.named_parameters()}
    assert pt.ema_params.keys() == params.keys()
    ema, gap = expect
    ref_p, ref_ema = (variables_to_state_dict("thermal_only", {
        "params": jax.tree.map(np.asarray, tree)})
        for tree in (state.params, state.ema_params))
    ema = jax.tree.map(lambda e, p: e * decay + p * (1.0 - decay),
                       {k: jnp.asarray(v) for k, v in ema.items()},
                       {k: jnp.asarray(v) for k, v in params.items()})
    ema = {k: np.asarray(v) for k, v in ema.items()}
    gap = {k: gap[k] * decay
           + np.abs(params[k] - ref_p[k].numpy()) * (1.0 - decay)
           for k in gap}
    live = dict(pt.module.named_parameters())
    for k, ours in pt.ema_params.items():
        assert ours.data_ptr() != live[k].data_ptr(), k
        start = p0[k].numpy()
        np.testing.assert_allclose(ours.numpy() - start, ema[k] - start,
                                   rtol=0, atol=atol, err_msg=k)
        off = np.abs(ours.numpy() - ref_ema[k].numpy()) - gap[k]
        assert off.max() <= atol, (k, float(off.max()))
    return ema, gap


def test_sample_mixup_draws_from_the_generator():
    """lam in [0, 1] and a permutation, the same for the same seed."""
    draws = [port_engine.sample_mixup(torch.Generator().manual_seed(5),
                                      0.4, 6) for _ in range(2)]
    (lam, perm), (lam2, perm2) = draws
    assert 0.0 <= float(lam) <= 1.0 and float(lam) == float(lam2)
    assert sorted(perm.tolist()) == list(range(6))
    assert torch.equal(perm, perm2)
