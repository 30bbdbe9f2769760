"""Self-supervised pretraining of the port (``train/ssl.py``,
``cli/pretrain.py``, the ViT's ``keep_ids`` / ``return_tokens``) against
the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages; JAX
variables are drawn with numpy over ``init_shapes`` (no jitted init).
JAX PRNG streams cannot be reproduced in torch, so the steps are compared
on injected views and ``keep_ids``: the JAX side runs its trainer's own
``_project_views`` / module and optax transform on them.  Tolerances, at
each comparison, follow the JAX package's own budget (tests/test_ssl.py:
1e-5 relative on losses, 1e-5 absolute on features, 1e-6 on the masked
loss): the losses and forwards within 1e-5 (the same fp32 math in another
summation order), and the parameters after one AdamW step within 2·lr
(Adam's first update is lr·sign(g), and a ~0 gradient's sign may differ
between the packages).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfu_multimodal_tpu import config as jax_config
from dfu_multimodal_tpu.models import vit as jax_vit
from dfu_multimodal_tpu.train import ssl as jax_ssl
from dfu_multimodal_tpu.utils import checkpoint as jax_ckpt
from dfu_multimodal_tpu_torch import config as port_config
from dfu_multimodal_tpu_torch.cli import pretrain as port_pretrain
from dfu_multimodal_tpu_torch.cli import train_rgb_only as port_rgb_cli
from dfu_multimodal_tpu_torch.cli import (
    train_multimodal_fusion as port_mm_cli)
from dfu_multimodal_tpu_torch.cli import (
    train_thermal_only as port_thermal_cli)
from dfu_multimodal_tpu_torch.data.synthetic import make_synthetic_dataset
from dfu_multimodal_tpu_torch.models.resnet import ResNet50
from dfu_multimodal_tpu_torch.models.vit import ViT
from dfu_multimodal_tpu_torch.tools.convert_jax import (
    pretrain_state_dict, vit_state_dict)
from dfu_multimodal_tpu_torch.train import engine as port_engine
from dfu_multimodal_tpu_torch.train import ssl as port_ssl
from dfu_multimodal_tpu_torch.utils import checkpoint as port_ckpt

torch.set_num_threads(1)

IMAGE = 32
NARROW = dict(patch_size=8, hidden_dim=64, depth=2, num_heads=4)
VIT_CFG = (8, 64, 2, 4)
CFG = dict(batch_size=6, learning_rate=1e-3, weight_decay=1e-4,
           warmup_epochs=0.0, num_epochs=2, compute_dtype="float32",
           vit_patch=8, vit_hidden=64, vit_depth=2, vit_heads=4,
           proj_hidden=32, proj_dim=16, decoder_dim=32, decoder_depth=1,
           decoder_heads=4)
LR = CFG["learning_rate"]
FWD_TOL = 1e-5
MU_TOL = 1e-2
ZERO_GRAD = 1e-4


def _numpy_variables(shapes, seed):
    """A variables tree of ``shapes`` drawn with numpy: LeCun-normal
    kernels, BatchNorm variances in [0.5, 1.5], every other leaf small
    noise (a key landing in the wrong place cannot hide)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(path[-1].key)
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape)
                    / np.sqrt(fan_in)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name == "scale":
            return (1 + 0.05 * rng.standard_normal(s.shape)).astype(
                np.float32)
        return (0.05 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _images(b, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(
        (b, IMAGE, IMAGE, 3))).astype(np.float32)


def _mesh1():
    return jax_config.MeshConfig(data=1)


# ----------------------------------------------------------- the copies


@pytest.mark.parametrize("jitter", [True, False])
def test_config_and_view_augments_equal_jax(jitter):
    asdict = dataclasses.asdict
    assert asdict(port_ssl.PretrainConfig()) == asdict(
        jax_ssl.PretrainConfig())
    for name in ("rgb_modality", "thermal_modality"):
        port_mod = getattr(port_config, name)()
        jax_mod = getattr(jax_config, name)()
        for method in ("simclr", "mae"):
            assert asdict(port_ssl.ssl_modality(port_mod, method, jitter)) \
                == asdict(jax_ssl.ssl_modality(jax_mod, method, jitter))


# ------------------------------------------------------------------ losses


@pytest.mark.parametrize("valid", [[1, 1, 1, 1, 1, 1], [1, 1, 1, 1, 0, 0],
                                   [0, 0, 0, 0, 0, 0]])
def test_nt_xent_matches_jax(valid):
    """Rows and mean loss, and the gradient, within 1e-6 (an all-padded
    batch gives a finite 0, as the finite mask promises)."""
    rng = np.random.default_rng(1)
    z1, z2 = (rng.standard_normal((6, 8)).astype(np.float32)
              for _ in range(2))
    v = np.asarray(valid, np.float32)
    jl, jv = jax_ssl.nt_xent_row_losses(z1, z2, v, 0.3)
    pz1, pz2 = (torch.tensor(z, requires_grad=True) for z in (z1, z2))
    pl, pv = port_ssl.nt_xent_row_losses(pz1, pz2, torch.from_numpy(v), 0.3)
    np.testing.assert_allclose(pl.detach().numpy(), np.asarray(jl),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    loss = port_ssl.nt_xent_loss(pz1, pz2, torch.from_numpy(v), 0.3)
    want = jax_ssl.nt_xent_loss(z1, z2, v, 0.3)
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-6,
                                                 abs=1e-6)
    loss.backward()
    g1, g2 = jax.grad(lambda a, b: jax_ssl.nt_xent_loss(a, b, v, 0.3),
                      argnums=(0, 1))(z1, z2)
    for got, ref in ((pz1.grad, g1), (pz2.grad, g2)):
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("norm_pix", [True, False])
def test_patchify_mask_and_masked_loss_match_jax(norm_pix):
    """patchify and the visible mask exactly; the masked pixel loss over
    valid rows within 1e-6."""
    x = _images(3, 2)
    np.testing.assert_array_equal(
        port_ssl.patchify(torch.from_numpy(x), 8).numpy(),
        np.asarray(jax_ssl.patchify(x, 8)))
    ids = np.array([[3, 1, 7, 0], [15, 2, 9, 4], [5, 6, 11, 12]], np.int32)
    np.testing.assert_array_equal(
        port_ssl.keep_mask_from_ids(torch.from_numpy(ids), 16).numpy(),
        np.asarray(jax_ssl.keep_mask_from_ids(ids, 16)))
    pred = np.random.default_rng(3).standard_normal((3, 16, 192)).astype(
        np.float32)
    target = jax_ssl.patchify(x, 8)
    valid = np.array([1, 0, 1], np.float32)
    got = port_ssl.masked_pixel_loss(
        torch.from_numpy(pred), torch.from_numpy(np.asarray(target)),
        torch.from_numpy(ids), torch.from_numpy(valid), norm_pix)
    want = jax_ssl.masked_pixel_loss(pred, target, ids, valid, norm_pix)
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_random_keep_ids_are_distinct_patches():
    gen = torch.Generator().manual_seed(0)
    ids = port_ssl.random_keep_ids(gen, 5, 16, 4)
    assert ids.shape == (5, 4)
    assert all(len(set(r.tolist())) == 4 for r in ids)
    assert int(ids.min()) >= 0 and int(ids.max()) < 16


def test_schedule_matches_optax():
    """The warm-up cosine with its clamped warm-up against the JAX
    trainer's optax schedule at every count and past the end: within 1e-6
    of the peak rate, as the engine's schedule test (optax takes the
    cosine in fp32; the port rounds to fp32 once)."""
    lr = 3e-3
    for epochs, warm, spe in ((3, 1.0, 4), (1, 5.0, 1), (4, 0.5, 3),
                              (2, 0.0, 5)):
        cfg = port_ssl.PretrainConfig(num_epochs=epochs, warmup_epochs=warm,
                                      learning_rate=lr)
        jt = jax_ssl.SSLTrainer.__new__(jax_ssl.SSLTrainer)
        jt.cfg = jax_ssl.PretrainConfig(num_epochs=epochs,
                                        warmup_epochs=warm,
                                        learning_rate=lr)
        ref = jt._schedule(spe)
        ours = port_ssl.ssl_schedule(cfg, spe)
        counts = np.arange(epochs * spe + 2)
        np.testing.assert_allclose([ours(int(c)) for c in counts],
                                   np.asarray(jax.vmap(ref)(counts)),
                                   rtol=0, atol=1e-6 * lr,
                                   err_msg=str((epochs, warm, spe)))


def test_refusals_match_jax():
    mod = port_config.thermal_modality()
    mae = port_ssl.PretrainConfig(method="mae")
    with pytest.raises(ValueError, match="MAE pretrains the ViT trunk"):
        port_ssl.SSLTrainer("resnet", mae, mod, device="cpu")
    with pytest.raises(ValueError, match="MAE encodes masked"):
        port_ssl.SSLTrainer("vit", mae, mod, block_impl="fused",
                            device="cpu")
    with pytest.raises(ValueError, match="unknown SSL method"):
        port_ssl.SSLTrainer("vit", port_ssl.PretrainConfig(method="byol"),
                            mod, device="cpu")
    with pytest.raises(NotImplementedError, match="one device"):
        port_ssl.SSLTrainer("tiny", port_ssl.PretrainConfig(
            mesh=port_config.MeshConfig(data=4)), mod, device="cpu")


# ------------------------------------------------------------------ models


@pytest.fixture(scope="module")
def narrow_vit():
    module = jax_vit.ViT(block_impl="flax", attention_impl="xla", **NARROW)
    shapes = jax.eval_shape(
        lambda x: module.init({"params": jax.random.PRNGKey(0)}, x),
        jnp.zeros((1, IMAGE, IMAGE, 3)))
    params = _numpy_variables(shapes, 4)["params"]
    port = ViT(image_size=IMAGE, block_impl="fused", **NARROW)
    port.load_state_dict(vit_state_dict(params), strict=True)
    return module, params, port


def test_vit_keep_ids_and_return_tokens_match_jax(narrow_vit):
    """The visible tokens' post-norm sequence and the CLS features, and
    the full sequence, within 1e-5 of JAX's (the port's fused blocks'
    plain versions against the flax blocks)."""
    module, params, port = narrow_vit
    x = _images(3, 5)
    ids = np.array([[3, 1, 7], [0, 15, 2], [9, 9 - 1, 14]], np.int32)
    with torch.no_grad():
        tokens = port(torch.from_numpy(x), keep_ids=torch.from_numpy(ids),
                      return_tokens=True)
        full = port(torch.from_numpy(x), return_tokens=True)
        cls = port(torch.from_numpy(x))
    ref_tokens, ref_full, ref_cls = jax.jit(lambda p, x, i: (
        module.apply({"params": p}, x, keep_ids=i, return_tokens=True),
        module.apply({"params": p}, x, return_tokens=True),
        module.apply({"params": p}, x)))(params, x, ids)
    assert tokens.shape == (3, 4, 64) and tokens.dtype == torch.float32
    np.testing.assert_allclose(tokens.numpy(), np.asarray(ref_tokens),
                               atol=FWD_TOL)
    np.testing.assert_allclose(full.numpy(), np.asarray(ref_full),
                               atol=FWD_TOL)
    np.testing.assert_allclose(cls.numpy(), np.asarray(ref_cls),
                               atol=FWD_TOL)
    np.testing.assert_array_equal(full[:, 0].numpy(), cls.numpy())


def _jax_mae_variables():
    jm = jax_ssl.MAEModel(vit_cfg=VIT_CFG, decoder_dim=32, decoder_depth=1,
                          decoder_heads=4)
    shapes = jax.eval_shape(
        lambda x, i: jm.init({"params": jax.random.PRNGKey(0)}, x, i),
        jnp.zeros((1, IMAGE, IMAGE, 3)), jnp.zeros((1, 4), jnp.int32))
    return jm, _numpy_variables(shapes, 6)


def test_mae_model_matches_jax():
    """The MAE model on injected keep_ids: its per-patch predictions
    within 1e-5 of JAX's, through the pretraining bridge."""
    jm, variables = _jax_mae_variables()
    pm = port_ssl.MAEModel(vit_cfg=VIT_CFG, decoder_dim=32, decoder_depth=1,
                           decoder_heads=4, image_size=IMAGE)
    sd = pretrain_state_dict(variables["params"], None)
    assert sd.keys() == pm.state_dict().keys()
    pm.load_state_dict(sd, strict=True)
    x = _images(2, 7)
    ids = np.array([[3, 1, 7, 12], [0, 15, 2, 5]], np.int32)
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(ids))
    ref = jax.jit(jm.apply)(variables, x, ids)
    assert got.shape == (2, 16, 192)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=FWD_TOL)


# ------------------------------------------------------------------- steps


def _jax_trainer(trunk, method):
    cfg = jax_ssl.PretrainConfig(method=method, mesh=_mesh1(), **CFG)
    jt = jax_ssl.SSLTrainer(trunk, cfg, jax_config.rgb_modality(),
                            image_size=IMAGE, block_impl="flax",
                            attention_impl="xla")
    jt.make_tx(1)
    return jt


def _port_trainer(trunk, method, block_impl="auto"):
    cfg = port_ssl.PretrainConfig(method=method, **CFG)
    pt = port_ssl.SSLTrainer(trunk, cfg, port_config.rgb_modality(),
                             image_size=IMAGE, block_impl=block_impl,
                             device="cpu")
    pt.build_optimizer(1)
    return pt


def _shapes(jt, *inputs):
    return jax.eval_shape(
        lambda *a: jt.module.init({"params": jax.random.PRNGKey(0)}, *a,
                                  train=False), *inputs)


def _jax_update(jt, params, loss_fn):
    """JAX's step body on injected inputs, jitted: value_and_grad of
    ``loss_fn`` and the trainer's optax update from a fresh state; returns
    the loss, the new parameters, ``loss_fn``'s aux and the first moment."""
    import optax

    @jax.jit
    def step(params):
        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        updates, opt_state = jt._tx.update(grads, jt._tx.init(params),
                                           params)
        return (loss, optax.apply_updates(params, updates), aux,
                opt_state[0].mu)

    return step(params)


def _check_params(pt, params, mu, stats=None):
    """Parameters within 2·lr, BatchNorm statistics within 1e-5, and the
    first moment of every parameter within MU_TOL of its leaf's largest
    entry (a missing, detached or sign-flipped gradient fails here)."""
    ref = pretrain_state_dict(
        jax.tree.map(np.asarray, params),
        None if stats is None else jax.tree.map(np.asarray, stats))
    ours = pt.module.state_dict()
    for k, v in ref.items():
        if k.endswith("num_batches_tracked"):
            continue
        tol = 2 * LR if "running" not in k else 1e-5
        np.testing.assert_allclose(ours[k].numpy(), v.numpy(), rtol=0,
                                   atol=tol, err_msg=k)
    ref_mu = pretrain_state_dict(
        jax.tree.map(lambda a: np.asarray(a, np.float32), mu), None)
    ours_mu = pt.optimizer.state_dict()["mu"]
    assert ours_mu.keys() == ref_mu.keys()
    top = max(float(v.abs().max()) for v in ref_mu.values())
    for k, v in ref_mu.items():
        got, v = ours_mu[k].float().numpy(), v.numpy()
        scale = float(np.abs(v).max())
        if scale < ZERO_GRAD * top:
            assert float(np.abs(got).max()) < ZERO_GRAD * top, k
            continue
        np.testing.assert_allclose(got, v, rtol=0, atol=MU_TOL * scale,
                                   err_msg=k)


@pytest.mark.parametrize("trunk,block_impl", [("tiny", "auto"),
                                              ("vit", "fused")])
def test_simclr_step_matches_jax(trunk, block_impl):
    """One SimCLR step on injected views: the tiny BatchNorm trunk (two
    passes, statistics threaded view 1 -> view 2) and a narrow ViT on the
    fused blocks' plain versions (one pass over the 2B views), against
    JAX's flax trunk.  Loss 1e-5 relative; parameters within 2·lr; first
    moments within MU_TOL; BatchNorm statistics within 1e-5."""
    jt = _jax_trainer(trunk, "simclr")
    variables = _numpy_variables(
        _shapes(jt, jnp.zeros((1, IMAGE, IMAGE, 3))), 8)
    params, stats = variables["params"], variables.get("batch_stats", {})
    pt = _port_trainer(trunk, "simclr", block_impl)
    pt.module.load_state_dict(pretrain_state_dict(params, stats or None),
                              strict=True)
    v1, v2 = _images(6, 9), _images(6, 10)
    valid = np.array([1, 1, 1, 1, 1, 0], np.float32)

    def loss_fn(p):
        z1, z2, bs = jt._project_views(p, stats, v1, v2)
        return jax_ssl.nt_xent_loss(z1, z2, valid, jt.cfg.temperature), bs

    loss, new_params, new_stats, mu = _jax_update(jt, params, loss_fn)
    got = pt.step_on_views((torch.from_numpy(v1), torch.from_numpy(v2)),
                           torch.from_numpy(valid))
    assert float(got) == pytest.approx(float(loss), rel=1e-5)
    _check_params(pt, new_params, mu, new_stats or None)


def test_mae_step_matches_jax():
    """One MAE step on an injected view and keep_ids (the decoder's
    scatter, mask token and position embedding, the flax blocks): loss
    1e-5 relative, parameters within 2·lr, first moments within MU_TOL."""
    jt = _jax_trainer("vit", "mae")
    ids = np.array([[3, 1, 7, 12], [0, 15, 2, 5], [4, 8, 10, 11]], np.int32)
    variables = _numpy_variables(
        _shapes(jt, jnp.zeros((1, IMAGE, IMAGE, 3)),
                jnp.zeros((1, 4), jnp.int32)), 11)
    params = variables["params"]
    pt = _port_trainer("vit", "mae")
    pt.module.load_state_dict(pretrain_state_dict(params, None), strict=True)
    x = _images(3, 12)
    valid = np.array([1, 1, 0], np.float32)
    target = jax_ssl.patchify(x, 8)

    def loss_fn(p):
        pred = jt.module.apply({"params": p}, x, ids, train=True)
        return jax_ssl.masked_pixel_loss(pred, target, ids, valid), None

    loss, new_params, _, mu = _jax_update(jt, params, loss_fn)
    got = pt.step_on_views((torch.from_numpy(x),), torch.from_numpy(valid),
                           torch.from_numpy(ids))
    assert float(got) == pytest.approx(float(loss), rel=1e-5)
    _check_params(pt, new_params, mu)


# --------------------------------------------------------------------- CLI


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("ssl")
    make_synthetic_dataset(root / "data", images_per_class=6, size=IMAGE)
    return root


def _pretrain(tree, out, *extra):
    return port_pretrain.main([
        "--data-dir", str(tree / "data"), "--out", str(tree / out),
        "--image-size", str(IMAGE), "--batch-size", "4", "--epochs", "1",
        "--compute-dtype", "float32", "--device", "cpu", *extra])


def test_pretrain_cli_tiny_and_narrow_vit_with_resume(tree):
    """simclr on the tiny trunk (then --resume for one more epoch), simclr
    and mae on a narrow ViT: each writes the checkpoint, its meta and
    run_info; the ViT trunk sits under vit. and thermal_branch., equal."""
    vit = ["--vit-patch", "8", "--vit-hidden", "64", "--vit-depth", "2",
           "--vit-heads", "4", "--modality", "thermal"]
    assert _pretrain(tree, "tiny", "--trunk", "tiny") == 0
    assert _pretrain(tree, "tiny", "--trunk", "tiny", "--resume",
                     "--epochs", "2") == 0
    meta = json.loads((tree / "tiny" / "best_model.meta.json").read_text())
    assert meta["epoch"] == 2 and len(meta["history"]["loss"]) == 2
    assert meta["ssl_method"] == "simclr" and meta["trunk"] == "tiny"
    for method in ("simclr", "mae"):
        assert _pretrain(tree, f"vit_{method}", "--method", method,
                         *vit) == 0
        state = torch.load(tree / f"vit_{method}" / "best_model.pt",
                           weights_only=True)["model_state_dict"]
        trunk = {k[4:]: v for k, v in state.items() if k.startswith("vit.")}
        assert len(trunk) == 2 + 2 + 12 * 2 + 2       # narrow depth 2
        for k, v in trunk.items():
            assert torch.equal(state["thermal_branch." + k], v), k
        info = json.loads((tree / f"vit_{method}" / "run_info.json")
                          .read_text())
        assert info["config"]["method"] == method
    with pytest.raises(SystemExit, match="no CUDA device"):
        _pretrain(tree, "cuda", "--trunk", "tiny", "--device", "cuda")


@pytest.fixture(scope="module")
def resnet_pretrain(tree):
    assert _pretrain(tree, "resnet", "--modality", "rgb",
                     "--batch-size", "6") == 0
    return torch.load(tree / "resnet" / "best_model.pt",
                      weights_only=True)["model_state_dict"]


def _warm_start(monkeypatch, cli, tree, ckpt, extra=()):
    """Run a train CLI with ``--init-from ckpt --epochs 0`` and return the
    module's state right after its fit (the loaded weights)."""
    seen = {}
    fit = port_engine.Trainer.fit

    def recording(self, *a, **kw):
        out = fit(self, *a, **kw)
        seen.update({k: v.clone() for k, v in
                     self.module.state_dict().items()})
        return out

    monkeypatch.setattr(port_engine.Trainer, "fit", recording)
    cli.main(["--data-dir", str(tree / "data"), "--checkpoint-root",
              str(tree / "logs"), "--device", "cpu", "--image-size",
              str(IMAGE), "--epochs", "0", "--init-from", str(ckpt),
              "--skip-test-eval", "--compute-dtype", "float32", *extra])
    return seen


def test_resnet_pretrain_warm_starts_rgb_only_and_multimodal(
        tree, resnet_pretrain, monkeypatch):
    """The port's ResNet-50 SimCLR checkpoint into train_rgb_only
    (resnet.*) and train_multimodal_fusion (rgb_branch.*): bit-equal."""
    for cli, prefix in ((port_rgb_cli, "resnet."),
                        (port_mm_cli, "rgb_branch.")):
        seen = _warm_start(monkeypatch, cli, tree, tree / "resnet")
        keys = [k for k in resnet_pretrain if k.startswith(prefix)]
        assert len(keys) == len(ResNet50().state_dict())
        for k in keys:
            assert torch.equal(seen[k], resnet_pretrain[k]), k


def _narrow_thermal_only(monkeypatch):
    """The port's thermal_only entry at the narrow ViT's widths, so the
    train CLI takes a narrow pretraining checkpoint."""
    from functools import partial

    from dfu_multimodal_tpu_torch.models import zoo
    from dfu_multimodal_tpu_torch.models.vit import ViTClassifier
    monkeypatch.setitem(zoo._REGISTRY, "thermal_only", zoo.ModelSpec(
        "thermal_only", partial(ViTClassifier, **NARROW), ("thermal",)))


def test_mae_pretrain_warm_starts_thermal_only(tree, monkeypatch):
    """The port's MAE checkpoint (the narrow ViT of the CLI test above,
    the thermal_only entry at its widths) into train_thermal_only: vit.*
    bit-equal."""
    _narrow_thermal_only(monkeypatch)
    if not (tree / "vit_mae" / "best_model.pt").exists():
        test_pretrain_cli_tiny_and_narrow_vit_with_resume(tree)
    state = torch.load(tree / "vit_mae" / "best_model.pt",
                       weights_only=True)["model_state_dict"]
    seen = _warm_start(monkeypatch, port_thermal_cli, tree, tree / "vit_mae")
    keys = [k for k in state if k.startswith("vit.")]
    assert len(keys) == 4 + 2 * 12 + 2
    for k in keys:
        assert torch.equal(seen[k], state[k]), k


def test_jax_pretrain_checkpoint_warm_starts_the_port(tree, monkeypatch):
    """A JAX-written MAE checkpoint (narrow ViT, with its thermal_branch
    alias, decoder and optimizer state) into the port's thermal_only: the
    trunk equal to JAX's arrays through the bridge; the port's
    pretraining keys hold all of it."""
    _narrow_thermal_only(monkeypatch)
    cfg = jax_ssl.PretrainConfig(method="mae", mesh=_mesh1(), **CFG)
    jt = jax_ssl.SSLTrainer("vit", cfg, jax_config.thermal_modality(),
                            image_size=IMAGE)
    variables = _numpy_variables(
        _shapes(jt, jnp.zeros((1, IMAGE, IMAGE, 3)),
                jnp.zeros((1, 4), jnp.int32)), 13)
    tx = jt.make_tx(1)
    out = tree / "jax_mae"
    jax_ckpt.save_checkpoint(
        out, epoch=1, model_state=jax_ssl.alias_model_state(variables),
        opt_state=tx.init(variables["params"]), val_f1=0.0,
        history={"loss": [1.0]},
        extra_meta={"ssl_method": "mae", "trunk": "vit",
                    "image_size": IMAGE})
    seen = _warm_start(monkeypatch, port_thermal_cli, tree, out)
    ref = vit_state_dict(variables["params"]["ViT_0"], "vit.")
    for k, v in ref.items():
        assert torch.equal(seen[k], v), k
    payload, _ = port_ckpt.load_checkpoint(out, model_name="thermal_only")
    module = port_ssl.MAEModel(vit_cfg=VIT_CFG, decoder_dim=32,
                               decoder_depth=1, decoder_heads=4,
                               image_size=IMAGE)
    want = set(port_ssl.alias_state(module.state_dict()))
    assert set(payload["model_state_dict"]) == want
    assert set(payload["optimizer_state_dict"]["mu"]) == set(
        module.state_dict())
