"""Distillation and self-training of the port (``train/distill.py``,
``train/self_train.py``, ``cli/distill.py``, ``cli/self_train.py``)
against the JAX package on the CPU.

The models are the tiny smoke models (a ``tiny_fusion`` teacher, a
``tiny_rgb`` student), their weights drawn with numpy and handed to both
packages.  The KD step runs with augmentation neutralised and dropout off,
so both packages see the same views.  Tolerances, at each comparison,
follow the JAX package's budget (tests/test_distill.py: 1e-6 on the loss
helpers; 1e-5 relative on a step's loss): the KD loss within 1e-6, a
step's loss within 1e-5 relative, the parameters after one AdamW step
within 2·lr (Adam's first update is lr·sign(g), so any two first updates
lie within 2·lr), the optimizer's fp32 first moment, (1 - b1)·g, within
MU_TOL = 1e-4 of each leaf's largest entry (the bound
tests/test_torch_train_bn.py holds a BatchNorm trunk's first step to;
a leaf whose JAX moment stays under ZERO_GRAD = 1e-4 of the model's
largest, a convolution's bias ahead of train-mode BatchNorm, has a
gradient that is zero up to rounding, and the port's must stay under
that bound too),
BatchNorm statistics within 1e-5, the pool's probabilities within 1e-6, and the selection and
combination exactly.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfu_multimodal_tpu import config as jax_config
from dfu_multimodal_tpu.data.loader import ArrayDataset as JaxArrayDataset
from dfu_multimodal_tpu.models import zoo as jax_zoo
from dfu_multimodal_tpu.train import distill as jax_distill
from dfu_multimodal_tpu.train import self_train as jax_self_train
from dfu_multimodal_tpu.train.engine import Trainer as JaxTrainer
from dfu_multimodal_tpu.train.engine import TrainState
from dfu_multimodal_tpu.utils import checkpoint as jax_ckpt
from dfu_multimodal_tpu_torch import config as port_config
from dfu_multimodal_tpu_torch.cli import distill as port_distill_cli
from dfu_multimodal_tpu_torch.cli import self_train as port_self_train_cli
from dfu_multimodal_tpu_torch.data.loader import ArrayDataset
from dfu_multimodal_tpu_torch.data.synthetic import make_synthetic_dataset
from dfu_multimodal_tpu_torch.models import zoo
from dfu_multimodal_tpu_torch.tools.convert_jax import variables_to_state_dict
from dfu_multimodal_tpu_torch.train import distill as port_distill
from dfu_multimodal_tpu_torch.train import engine as port_engine
from dfu_multimodal_tpu_torch.train import self_train as port_self_train
from dfu_multimodal_tpu_torch.utils import checkpoint as port_ckpt

torch.set_num_threads(1)

IMAGE = 32
CFG = dict(batch_size=6, compute_dtype="float32", optimizer_mu_dtype="float32",
           drop_rate=0.0, learning_rate=1e-3, weight_decay=1e-4, seed=0)
LR = CFG["learning_rate"]
MU_TOL = 1e-4
ZERO_GRAD = 1e-4
CLASS_WEIGHTS = np.array([0.75, 1.5], np.float32)


def _numpy_variables(name, seed):
    module, spec = jax_zoo.build(name)
    shapes = jax_zoo.init_shapes(module, spec, IMAGE)
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        key = str(path[-1].key)
        if key == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape)
                    / np.sqrt(fan_in)).astype(np.float32)
        if key == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.05 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _neutral(cfg_mod):
    aug = cfg_mod.AugmentConfig(horizontal_flip_prob=0.0,
                                vertical_flip_prob=0.0, rotation_degrees=0.0,
                                aug_prob=0.0, affine_degrees=0.0)
    return {m: dataclasses.replace(fn(), augment=aug) for m, fn in (
        ("rgb", cfg_mod.rgb_modality),
        ("thermal", lambda: cfg_mod.thermal_modality(blur=False)))}


# ------------------------------------------------------------- the losses


@pytest.mark.parametrize("valid,weighted", [
    ([1, 1, 1, 1, 1, 1], False), ([1, 1, 1, 1, 0, 0], True),
    ([1, 0, 1, 0, 1, 0], True)])
def test_kd_loss_matches_jax(valid, weighted):
    """kd_numerators and kd_loss with padded rows and class weights on
    the CE term only, within 1e-6."""
    rng = np.random.default_rng(2)
    s, t = (3 * rng.standard_normal((6, 2)).astype(np.float32)
            for _ in range(2))
    labels = np.array([0, 1, 1, 0, 1, 0], np.int32)
    v = np.asarray(valid, np.float32)
    w = (CLASS_WEIGHTS[labels] if weighted else np.ones(6, np.float32)) * v
    args = [torch.from_numpy(a) for a in (s, t, labels, w, v)]
    for got, want in zip(port_distill.kd_numerators(*args, 4.0),
                         jax_distill.kd_numerators(s, t, labels, w, v, 4.0)):
        assert float(got) == pytest.approx(float(want), rel=1e-6, abs=1e-6)
    got = port_distill.kd_loss(*args, 0.7, 4.0)
    want = jax_distill.kd_loss(s, t, labels, w, v, 0.7, 4.0)
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    assert dataclasses.asdict(port_distill.DistillConfig()) == \
        dataclasses.asdict(jax_distill.DistillConfig())


# ---------------------------------------------------------------- KD step


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {m: rng.integers(0, 256, (6, IMAGE, IMAGE, 3), dtype=np.uint8)
            for m in ("rgb", "thermal")} | {
        "label": np.array([0, 1, 1, 0, 1, 0], np.int32),
        "valid": np.array([1, 1, 1, 1, 1, 0], np.float32)}


def _jax_state(jt, variables):
    """The JAX trainer's one-device state at ``variables`` (its
    ``init_state`` without the eager init)."""
    params = jax.tree.map(jnp.asarray, variables["params"])
    return jax.device_put(TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=jt.tx.init(params)), jt.replicated)


def _port_teacher(variables):
    teacher, _ = zoo.build("tiny_fusion", drop_rate=0.0)
    teacher.load_state_dict(variables_to_state_dict("tiny_fusion",
                                                    variables))
    return teacher


def test_distill_step_matches_jax_trainer():
    """One KD step of a tiny_rgb student under a tiny_fusion teacher (the
    teacher's rgb is the student's view, its thermal the eval-normalised
    image) against the JAX DistillTrainer's jitted step: loss 1e-5
    relative, the confusion counts exactly, the parameters within 2·lr,
    the first moments (the student's gradient) within MU_TOL and the
    student's BatchNorm statistics within 1e-5."""
    t_vars = _numpy_variables("tiny_fusion", 3)
    s_vars = _numpy_variables("tiny_rgb", 4)
    dcfg = jax_distill.DistillConfig()
    jt = jax_distill.DistillTrainer(
        "tiny_rgb", "tiny_fusion", t_vars, dcfg,
        jax_config.TrainConfig(**CFG, mesh=jax_config.MeshConfig(data=1)),
        _neutral(jax_config), class_weights=CLASS_WEIGHTS)
    state = _jax_state(jt, s_vars)
    batch = _batch(5)
    state, jm = jt.train_step(state, jax.device_put(batch,
                                                    jt.batch_sharding),
                              jax.random.PRNGKey(1))

    pt = port_distill.DistillTrainer(
        "tiny_rgb", "tiny_fusion", _port_teacher(t_vars),
        port_distill.DistillConfig(), port_config.TrainConfig(**CFG),
        _neutral(port_config), class_weights=CLASS_WEIGHTS, device="cpu",
        image_size=IMAGE)
    pt.module.load_state_dict(variables_to_state_dict("tiny_rgb", s_vars))
    pm = pt.train_step(batch, torch.Generator().manual_seed(0))
    assert float(pm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    np.testing.assert_array_equal(pm["counts"].numpy(),
                                  np.asarray(jm["counts"]))
    ref = variables_to_state_dict("tiny_rgb", {
        "params": jax.tree.map(np.asarray, state.params),
        "batch_stats": jax.tree.map(np.asarray, state.batch_stats)})
    ours = pt.module.state_dict()
    for k, v in ref.items():
        if k.endswith("num_batches_tracked"):
            continue
        tol = 1e-5 if "running" in k else 2 * LR
        np.testing.assert_allclose(ours[k].numpy(), v.numpy(), rtol=0,
                                   atol=tol, err_msg=k)
    mu = variables_to_state_dict("tiny_rgb", {"params": jax.tree.map(
        np.asarray, state.opt_state[0].mu)})
    ours_mu = pt.optimizer.state_dict()["mu"]
    assert ours_mu.keys() == mu.keys()
    top = max(float(v.abs().max()) for v in mu.values())
    for k, v in mu.items():
        got, v = ours_mu[k].numpy(), v.numpy()
        scale = float(np.abs(v).max())
        if scale < ZERO_GRAD * top:
            assert float(np.abs(got).max()) < ZERO_GRAD * top, k
            continue
        np.testing.assert_allclose(got, v, rtol=0, atol=MU_TOL * scale,
                                   err_msg=k)
    assert not any(p.requires_grad for p in pt.teacher_module.parameters())


@pytest.mark.parametrize("override", [dict(grad_accum=2),
                                      dict(ema_decay=0.9),
                                      dict(loss="focal"),
                                      dict(mixup_alpha=0.2)])
def test_distill_refuses_what_jax_refuses(override):
    with pytest.raises(ValueError, match="does not compose"):
        port_distill.DistillTrainer(
            "tiny_rgb", "tiny_fusion", _port_teacher(
                _numpy_variables("tiny_fusion", 3)),
            port_distill.DistillConfig(),
            port_config.TrainConfig(**{**CFG, **override}),
            _neutral(port_config), device="cpu", image_size=IMAGE)


# ---------------------------------------------------------- self-training


@pytest.mark.parametrize("threshold,max_per_class,balance", [
    (0.7, None, True), (0.7, None, False), (0.55, 3, True),
    (0.55, 2, False), (0.99, None, True)])
def test_select_confident_and_combine_match_jax(threshold, max_per_class,
                                                balance):
    rng = np.random.default_rng(6)
    p1 = rng.uniform(0, 1, 40).astype(np.float32)
    probs = np.stack([1 - p1, p1], axis=-1)
    got = port_self_train.select_confident(probs, threshold, max_per_class,
                                           balance)
    want = jax_self_train.select_confident(probs, threshold, max_per_class,
                                           balance)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    images = rng.integers(0, 256, (40, 4, 4, 3), dtype=np.uint8)
    lab_imgs = rng.integers(0, 256, (5, 4, 4, 3), dtype=np.uint8)
    paths = {"rgb": [Path(f"p{i}.png") for i in range(40)]}
    labeled = dict(arrays={"rgb": lab_imgs},
                   labels=np.array([0, 1, 0, 1, 1], np.int32),
                   paths={"rgb": [Path(f"l{i}.png") for i in range(5)]})
    a = port_self_train.combine(ArrayDataset(**labeled), {"rgb": images},
                                paths, *got)
    b = jax_self_train.combine(JaxArrayDataset(**labeled), {"rgb": images},
                               paths, *want)
    np.testing.assert_array_equal(a.arrays["rgb"], b.arrays["rgb"])
    np.testing.assert_array_equal(a.labels, b.labels)
    assert a.paths == b.paths


def test_predict_pool_probs_matches_jax():
    """The pool's softmax probabilities (7 images in batches of 4: the
    last padded with repeats and sliced back), within 1e-6."""
    variables = _numpy_variables("tiny_rgb", 7)
    mod = port_config.rgb_modality()
    jt = JaxTrainer("tiny_rgb", jax_config.TrainConfig(
        **CFG, mesh=jax_config.MeshConfig(data=1)),
        {"rgb": jax_config.rgb_modality()})
    state = _jax_state(jt, variables)
    pool = np.random.default_rng(8).integers(0, 256, (7, IMAGE, IMAGE, 3),
                                             dtype=np.uint8)
    want = jax_self_train.predict_pool_probs(jt, state, pool,
                                             jax_config.rgb_modality(),
                                             batch_size=4)
    pt = port_engine.Trainer("tiny_rgb", port_config.TrainConfig(**CFG),
                             {"rgb": mod}, device="cpu", image_size=IMAGE)
    pt.module.load_state_dict(variables_to_state_dict("tiny_rgb",
                                                      variables))
    got = port_self_train.predict_pool_probs(pt, pool, mod, batch_size=4)
    assert got.shape == (7, 2)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)
    assert dataclasses.asdict(port_self_train.SelfTrainConfig()) == \
        dataclasses.asdict(jax_self_train.SelfTrainConfig())


# ------------------------------------------------------------------- CLIs


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("distill")
    make_synthetic_dataset(root / "data", images_per_class=8, size=IMAGE)
    return root


def test_distill_cli_from_port_and_jax_teachers(tree):
    """distill of a tiny_fusion teacher into tiny_rgb, the teacher from the
    port's best_model.pt and from a JAX best_model.msgpack of the same
    weights: both runs write the artifact contract, and the teacher's test
    F1 they report is the same."""
    t_vars = _numpy_variables("tiny_fusion", 9)
    teacher = _port_teacher(t_vars)
    port_ckpt.save_checkpoint(tree / "teacher_port", epoch=1,
                              model_state=teacher.state_dict(),
                              opt_state=None, val_f1=0.5, history={},
                              extra_meta={"model": "tiny_fusion"})
    jax_ckpt.save_checkpoint(tree / "teacher_jax", epoch=1,
                             model_state=t_vars, opt_state={}, val_f1=0.5,
                             history={}, extra_meta={"model": "tiny_fusion"})
    f1 = {}
    for src in ("teacher_port", "teacher_jax"):
        root = tree / f"logs_{src}"
        assert port_distill_cli.main([
            "--teacher-checkpoint", str(tree / src), "--student",
            "tiny_rgb", "--data-dir", str(tree / "data"),
            "--checkpoint-root", str(root), "--image-size", str(IMAGE),
            "--epochs", "2", "--batch-size", "6", "--device", "cpu",
            "--compute-dtype", "float32", "--lr", "1e-2"]) == 0
        out = root / "checkpoints_tiny_rgb_distilled"
        saved = torch.load(out / "test_results.pt", weights_only=False)
        assert saved["teacher_model"] == "tiny_fusion"
        assert saved["alpha"] == 0.7 and saved["temperature"] == 4.0
        assert len(saved["test_preds"]) == len(saved["test_labels"]) > 0
        assert np.isfinite(saved["test_loss"])
        f1[src] = saved["teacher_test_f1"]
    assert f1["teacher_port"] == f1["teacher_jax"]
    with pytest.raises(SystemExit, match="no CUDA device"):
        port_distill_cli.main(["--teacher-checkpoint",
                               str(tree / "teacher_port"), "--data-dir",
                               str(tree / "data"), "--device", "cuda"])


def test_self_train_cli_writes_rounds_and_promotes_the_best(tree):
    """Two rounds of tiny_rgb with the test images as the pool: the
    report names each round's adoption, every round has its directory,
    and best_model.pt is the winning round's, byte for byte."""
    root = tree / "logs_st"
    report = port_self_train_cli.main([
        "--data-dir", str(tree / "data"), "--unlabeled-dir",
        str(tree / "data" / "rgb" / "test"), "--model", "tiny_rgb",
        "--checkpoint-root", str(root), "--image-size", str(IMAGE),
        "--rounds", "2", "--epochs", "3", "--batch-size", "4",
        "--threshold", "0.5", "--no-balance", "--lr", "1e-2",
        "--device", "cpu", "--compute-dtype", "float32"])
    out = root / "checkpoints_tiny_rgb_selftrain"
    saved = json.loads((out / "self_train_report.json").read_text())
    assert [r["round"] for r in saved["rounds"]] == [1, 2]
    adopted = saved["rounds"][0]["adopted"]
    assert adopted["healthy"] + adopted["ulcer"] == \
        saved["rounds"][1]["n_pseudo"] > 0
    best = max(saved["rounds"], key=lambda r: r["val_f1"])
    assert best["val_f1"] > 0
    src = out / f"round_{best['round']}"
    assert (src / "best_model.pt").read_bytes() == \
        (out / "best_model.pt").read_bytes()
    assert "test" in report
    with pytest.raises(SystemExit, match="no CUDA device"):
        port_self_train_cli.main(["--data-dir", str(tree / "data"),
                                  "--unlabeled-dir", str(tree / "data"),
                                  "--device", "cuda"])
