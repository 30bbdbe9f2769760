"""The legacy lineage and the reference-checkpoint tools of the port
(``models/efficientnet.py``, the legacy classes of ``models/fusion.py``
and their zoo entries, the legacy config, ``cli/train_legacy.py``,
``cli/fix_checkpoint_keys.py``, ``cli/convert_checkpoint.py``) against the
JAX package on the CPU.

JAX variables are drawn with numpy over ``init_shapes`` and carried both
ways through ``tools/convert_jax.py``.  Tolerances, at each comparison:
the bridge exactly; fp32 eval logits of the deep convolutional models
within 1e-4 relative and absolute (train-mode logits 1e-3: TRAIN_TOL) (XLA's and PyTorch's CPU convolutions sum in
other orders; the JAX package's own budget for its full-width ResNet
against the reference's, tests/test_torch_resnet_block.py); BatchNorm
statistics after a train forward within 1e-4 absolute and relative
(STATS_TOL);
configs and counts exactly.  To keep the file's time down, the fusion
classifiers' EfficientNets are cut to B0's first three stages and every
ResNet-50 here (the fusion's RGB encoder, the converted rgb_only) to one
bottleneck a stage, in both packages (each module's own reference
patched); ``efficientnet_rgb`` runs the whole B0.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from functools import partial

from dfu_multimodal_tpu import config as jax_config
from dfu_multimodal_tpu.models import efficientnet as jax_effnet
from dfu_multimodal_tpu.models import fusion as jax_fusion
from dfu_multimodal_tpu.models import resnet as jax_resnet
from dfu_multimodal_tpu.models import zoo as jax_zoo
from dfu_multimodal_tpu.tools.convert_torch import convert_state_dict
from dfu_multimodal_tpu_torch import config as port_config
from dfu_multimodal_tpu_torch.cli import convert_checkpoint as port_convert
from dfu_multimodal_tpu_torch.cli import fix_checkpoint_keys as port_fix
from dfu_multimodal_tpu_torch.cli import train_legacy as port_legacy_cli
from dfu_multimodal_tpu_torch.data.synthetic import make_synthetic_dataset
from dfu_multimodal_tpu_torch.models import efficientnet as port_effnet
from dfu_multimodal_tpu_torch.models import fusion as port_fusion
from dfu_multimodal_tpu_torch.models import resnet as port_resnet
from dfu_multimodal_tpu_torch.models import zoo
from dfu_multimodal_tpu_torch.models.vit import ViTClassifier
from dfu_multimodal_tpu_torch.tools.convert_jax import (
    legacy_variables, variables_to_state_dict)
from dfu_multimodal_tpu_torch.train.engine import Trainer

torch.set_num_threads(1)

IMAGE = 32
# the models' comparison runs at 64², batch 4: at 32² the last stages are
# 1x1, and with a batch of 2 their train-mode BatchNorm sees 2 values a
# channel, whose variance is ill-conditioned (flax takes E[x²] - E[x]²,
# PyTorch two passes: measured 1.1 apart in the logits); at 64² with 4
# images (16 values a channel) the train logits agree within TOL
MODEL_IMAGE = 64
TOL = 1e-4
# train-mode logits: the batch statistics of the last stages (16 values a
# channel) in flax's E[x²] - E[x]² against the two-pass variance, through
# the ResNet-50 of legacy_rgb_resnet_fusion: measured 3.0e-4 absolute
TRAIN_TOL = 1e-3
# running statistics after a train forward: flax's fp32 E[x²] - E[x]²
# against PyTorch's two-pass variance (measured 2.2e-5 relative)
STATS_TOL = 1e-4
LEGACY = ("efficientnet_rgb", "legacy_gated_fusion",
          "legacy_rgb_resnet_fusion")


def _numpy_variables(shapes, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        key = str(path[-1].key)
        if key == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape)
                    / np.sqrt(fan_in)).astype(np.float32)
        if key == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if key == "scale":
            return (1 + 0.05 * rng.standard_normal(s.shape)).astype(
                np.float32)
        return (0.05 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


ONE_A_STAGE = dict(stage_sizes=(1, 1, 1, 1), widths=(64, 128, 256, 512))


def _cut_resnet50(monkeypatch, *modules):
    """ResNet-50 -> one bottleneck a stage (2048 features still) where
    ``modules`` (the JAX and port fusion / resnet modules) call it."""
    for mod in modules:
        if mod.__name__.startswith("dfu_multimodal_tpu_torch"):
            cut = lambda dtype=torch.float32, block_impl="auto": \
                port_resnet.ResNet(dtype=dtype, block_impl=block_impl,
                                   **ONE_A_STAGE)
        else:
            cut = partial(jax_resnet.ResNet, **ONE_A_STAGE)
        monkeypatch.setattr(mod, "ResNet50", cut)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}


def test_legacy_config_equals_jax():
    asdict = dataclasses.asdict
    for name in ("legacy_augment", "legacy_rgb_modality",
                 "legacy_thermal_modality"):
        assert asdict(getattr(port_config, name)()) == asdict(
            getattr(jax_config, name)())


@pytest.mark.parametrize("name", LEGACY)
def test_legacy_model_matches_jax(name, monkeypatch):
    """Each legacy zoo model at 64²: its parameter count, the bridge both
    ways (exact), the eval logits (and a fusion's ``features`` record
    against JAX's ``rgb_encoder`` / ``thermal_encoder`` outputs) and the
    train-mode logits and BatchNorm statistics (stochastic depth kept in
    both, dropout 0) against JAX."""
    if name != "efficientnet_rgb":
        for mod in (jax_effnet, port_effnet):
            monkeypatch.setattr(mod, "EfficientNetB0", partial(
                mod.EfficientNetB0, stages=mod.B0_STAGES[:3]))
        _cut_resnet50(monkeypatch, jax_fusion, port_fusion)
    jm, spec = jax_zoo.build(name, drop_rate=0.0)
    variables = _numpy_variables(jax_zoo.init_shapes(jm, spec, MODEL_IMAGE),
                                 1)
    pm, pspec = zoo.build(name, drop_rate=0.0)
    assert pspec.inputs == spec.inputs
    assert zoo.param_count(pm) == jax_zoo.param_count(variables)
    sd = variables_to_state_dict(name, variables)
    pm.load_state_dict(sd, strict=True)
    back = _flat(legacy_variables(name, pm.state_dict()))
    ref = _flat(variables)
    assert back.keys() == ref.keys()
    for k, v in ref.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)

    rng = np.random.default_rng(2)
    xs = [rng.standard_normal((4, MODEL_IMAGE, MODEL_IMAGE, 3)).astype(
        np.float32) for _ in spec.inputs]
    # train mode: every stochastic-depth branch kept in both packages
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.ones(shape, bool))
    monkeypatch.setattr(port_effnet, "stochastic_depth_mask",
                        lambda gen, keep, b: torch.ones(b))
    encoders = ("rgb_encoder", "thermal_encoder")
    # eval and train mode in one program (one compile)
    (ref_eval, inter), (ref_train, new) = jax.jit(lambda v, *x: (
        jm.apply(v, *x, train=False, mutable=["intermediates"],
                 capture_intermediates=lambda mdl, method: (
                     mdl.name in encoders and method == "__call__")),
        jm.apply(v, *x, train=True, mutable=["batch_stats"],
                 rngs={"dropout": jax.random.PRNGKey(0)})))(variables, *xs)
    pm.eval()
    record = {} if len(xs) == 2 else None
    with torch.no_grad():
        got = pm(*(torch.from_numpy(x) for x in xs),
                 **({} if record is None else {"features": record}))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_eval), rtol=TOL,
                               atol=TOL)
    if record is not None:
        assert record.keys() == set(encoders)
        for k in encoders:
            np.testing.assert_allclose(
                record[k].numpy(),
                np.asarray(inter["intermediates"][k]["__call__"][0]),
                rtol=TOL, atol=TOL, err_msg=k)
    pm.train()
    with torch.no_grad():
        got = pm(*(torch.from_numpy(x) for x in xs),
                 generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_train),
                               rtol=TRAIN_TOL, atol=TRAIN_TOL)
    stats = variables_to_state_dict(name, {"params": variables["params"],
                                           **new})
    ours = pm.state_dict()
    for k, v in stats.items():
        if "running" in k:
            np.testing.assert_allclose(ours[k].numpy(), v.numpy(),
                                       rtol=STATS_TOL, atol=STATS_TOL,
                                       err_msg=k)


@pytest.mark.parametrize("cls", ["LegacyConcatFusion", "LegacyClassifier"])
def test_legacy_heads_match_jax(cls):
    jm = getattr(jax_fusion, cls)()
    rng = np.random.default_rng(3)
    if cls == "LegacyConcatFusion":
        xs = [rng.standard_normal((3, d)).astype(np.float32)
              for d in (2048, 768)]
    else:
        xs = [rng.standard_normal((3, 1280)).astype(np.float32)]
    variables = _numpy_variables(jax.eval_shape(
        lambda *x: jm.init({"params": jax.random.PRNGKey(0)}, *x), *xs), 4)
    pm = getattr(port_fusion, cls)().eval()
    pm.load_state_dict({
        f"{layer}.{ours}": torch.from_numpy(
            np.ascontiguousarray(v.T if leaf == "kernel" else v))
        for layer, p in variables["params"].items()
        for leaf, v in p.items()
        for ours in [{"kernel": "weight", "bias": "bias"}[leaf]]},
        strict=True)
    with torch.no_grad():
        got = pm(*(torch.from_numpy(x) for x in xs))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(
        variables, *xs)), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------ CLIs


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("legacy")
    make_synthetic_dataset(root / "data", images_per_class=5, size=IMAGE)
    return root


def test_train_legacy_smoke_cli(tree):
    """--variant smoke: the EfficientNet baseline for one epoch on the
    CPU at 32², with the train CLIs' artifacts."""
    res = port_legacy_cli.main([
        "--variant", "smoke", "--data-dir", str(tree / "data"),
        "--checkpoint-root", str(tree / "logs"), "--device", "cpu",
        "--image-size", str(IMAGE), "--epochs", "1", "--batch-size", "4",
        "--compute-dtype", "float32", "--save-last"])
    out = tree / "logs" / "checkpoints_legacy_smoke"
    info = json.loads((out / "run_info.json").read_text())
    assert info["model"] == "efficientnet_rgb"
    assert info["config"]["drop_rate"] == 0.3
    assert not info["config"]["class_weighted_loss"]
    assert (out / "last_model.pt").exists() and np.isfinite(
        res["test_loss"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        port_legacy_cli.main(["--variant", "smoke", "--data-dir",
                              str(tree / "data"), "--device", "cuda"])


def test_fix_checkpoint_keys_dry_run_and_in_place(tmp_path):
    path = tmp_path / "best_model.pt"
    state = {"backbone.conv1.weight": torch.ones(2), "fc.1.bias":
             torch.zeros(2), "backbone.layer1.0.bn1.bias": torch.ones(1)}
    torch.save({"model_state_dict": state, "epoch": 3}, path)
    before = path.read_bytes()
    assert port_fix.fix_checkpoint_keys(path, "vit", dry_run=True) == 2
    assert path.read_bytes() == before
    assert port_fix.main([str(path), "--to", "resnet"]) == 0
    ckpt = torch.load(path, weights_only=False)
    assert sorted(ckpt["model_state_dict"]) == [
        "fc.1.bias", "resnet.conv1.weight", "resnet.layer1.0.bn1.bias"]
    assert ckpt["epoch"] == 3
    assert port_fix.fix_checkpoint_keys(path) == 0


def test_convert_checkpoint_matches_the_jax_path(tmp_path, monkeypatch):
    """A reference-layout rgb_only best_model.pt (``backbone.*`` keys, the
    Sequential(Dropout, Linear) head ``backbone.fc.1``) through the port's
    CLI and, beside it, through the JAX package's convert_state_dict onto
    numpy variables: the two models' eval logits at 32² within 1e-4, and
    the checkpoint's epoch and history carried over."""
    _cut_resnet50(monkeypatch, jax_resnet, port_resnet)
    jm, spec = jax_zoo.build("rgb_only")
    shapes = jax_zoo.init_shapes(jm, spec, IMAGE)
    seeded = variables_to_state_dict("rgb_only", _numpy_variables(shapes, 5))
    ref_sd = {("backbone.fc.1." + k[len("head."):]) if k.startswith("head.")
              else "backbone." + k[len("resnet."):]: v
              for k, v in seeded.items()
              if not k.endswith("num_batches_tracked")}
    src = tmp_path / "reference.pt"
    torch.save({"model_state_dict": ref_sd, "epoch": 7, "val_f1": 0.8,
                "history": {"val_f1": [np.float32(0.5), 0.8]}}, src)
    out = tmp_path / "converted"
    assert port_convert.main(["--model", "rgb_only", "--torch-checkpoint",
                              str(src), "--output", str(out),
                              "--image-size", str(IMAGE), "--device",
                              "cpu"]) == 0
    meta = json.loads((out / "best_model.meta.json").read_text())
    assert meta["epoch"] == 7 and meta["model"] == "rgb_only"
    assert meta["history"]["val_f1"] == [0.5, 0.8]

    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    jvars, skipped = convert_state_dict(
        "rgb_only", {k: v.numpy() for k, v in ref_sd.items()}, zeros)
    assert skipped == 0
    x = np.random.default_rng(6).standard_normal(
        (2, IMAGE, IMAGE, 3)).astype(np.float32)
    ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))(jvars, x)
    tr = Trainer("rgb_only", port_config.TrainConfig(
        compute_dtype="float32"), {"rgb": port_config.rgb_modality()},
        device="cpu", image_size=IMAGE)
    tr.load_weights(out)
    tr.module.eval()
    with torch.no_grad():
        got = tr.module(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)
    with pytest.raises(SystemExit, match="no CUDA device"):
        port_convert.main(["--model", "rgb_only", "--torch-checkpoint",
                           str(src), "--output", str(out), "--device",
                           "cuda"])


def test_convert_checkpoint_refuses_a_trunk_left_random(tmp_path, capsys,
                                                        monkeypatch):
    """A file whose trunk the key map does not reach (another prefix, or
    another --model) is an error that names the arrays and writes
    nothing; a 1000-class head alone stays fresh and is listed (the
    ResNet-50 cut to a block a stage, thermal_only to a narrow ViT)."""
    _cut_resnet50(monkeypatch, jax_resnet, port_resnet)
    monkeypatch.setitem(zoo._REGISTRY, "thermal_only", zoo.ModelSpec(
        "thermal_only", partial(ViTClassifier, patch_size=8, hidden_dim=64,
                                depth=2, num_heads=4), ("thermal",)))
    module, _ = zoo.build("rgb_only", image_size=IMAGE)
    sd = {k: v for k, v in module.state_dict().items()
          if not k.endswith("num_batches_tracked")}

    def convert(state, model, name):
        src = tmp_path / f"{name}.pt"
        torch.save({"model_state_dict": state}, src)
        return port_convert.main(["--model", model, "--torch-checkpoint",
                                  str(src), "--output", str(tmp_path / name),
                                  "--image-size", str(IMAGE), "--device",
                                  "cpu"])

    imagenet = {("fc." + k[len("head."):]) if k.startswith("head.")
                else "backbone." + k[len("resnet."):]: v
                for k, v in sd.items()}
    imagenet["fc.weight"] = torch.zeros(1000, 2048)
    imagenet["fc.bias"] = torch.zeros(1000)
    assert convert(imagenet, "rgb_only", "imagenet") == 0
    assert "['head.weight', 'head.bias']" in capsys.readouterr().out
    encoder = {"encoder." + k: v for k, v in sd.items()}
    with pytest.raises(SystemExit, match=r"rgb_only arrays have no "
                       r"counterpart.*resnet\.conv1\.weight"):
        convert(encoder, "rgb_only", "encoder")
    with pytest.raises(SystemExit, match="thermal_only arrays"):
        convert(imagenet, "thermal_only", "wrong_model")
    assert not (tmp_path / "encoder").exists()
    assert not (tmp_path / "wrong_model").exists()

