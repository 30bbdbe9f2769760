"""The port's research modules against the JAX package's, on the CPU:
``eval/compare.py`` with ``cli/compare.py``, ``eval/robustness.py`` with
``cli/robustness.py``, ``eval/embed.py`` with ``cli/embed.py``, and
``cli/model_card.py``.

The models are ``tiny_rgb``, ``tiny_fusion`` and a narrow ``multimodal``
(the full ResNet-50 beside a ViT of depth 2, hidden 64, patch 8: the JAX
fusion model's ``ViTBase16`` is swapped for that ViT while this module
runs, and the port model gets the same trunk and a 2112-wide head) at
32², their JAX variables drawn with numpy from a seed and carried to the
port by the weight bridge (``tools/convert_jax.py``).  Tolerances:

- ``compare``'s functions and reports: equal (bit for bit);
- the blur, brightness and contrast corruptions: atol 1e-4 fp32; the
  noise corruption with JAX's own ``jax.random.normal`` draw injected:
  atol 1e-4;
- ``verdict``: equal at and around its thresholds;
- ``corrupted_counts`` on ``tiny_fusion`` for the three deterministic
  corruptions, and the robustness CLI's report against JAX's ``sweep``:
  equal;
- ``extract_features``: features and probabilities within atol 1e-4 fp32,
  predictions equal;
- the ``.npz`` index written by either package loads in the other;
- the model card: JAX's parameter count and SHA-256 on the same file, and
  every line equal to JAX's but the date line and the versions line.
"""

import hashlib
import json
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from dfu_multimodal_tpu import config as jax_config
from dfu_multimodal_tpu.cli import compare as jax_compare_cli
from dfu_multimodal_tpu.cli import model_card as jax_card
from dfu_multimodal_tpu.eval import compare as jax_compare
from dfu_multimodal_tpu.eval import embed as jax_embed
from dfu_multimodal_tpu.eval import robustness as jax_rob
from dfu_multimodal_tpu.models import fusion as jax_fusion
from dfu_multimodal_tpu.models import zoo as jax_zoo
from dfu_multimodal_tpu.models.vit import ViT as JaxViT
from dfu_multimodal_tpu.train.engine import Trainer as JaxTrainer
from dfu_multimodal_tpu.utils import artifacts as jax_artifacts
from dfu_multimodal_tpu.utils import checkpoint as jax_ckpt
from dfu_multimodal_tpu_torch import config as port_config
from dfu_multimodal_tpu_torch.cli import compare as port_compare_cli
from dfu_multimodal_tpu_torch.cli import embed as port_embed_cli
from dfu_multimodal_tpu_torch.cli import model_card as port_card
from dfu_multimodal_tpu_torch.cli import robustness as port_rob_cli
from dfu_multimodal_tpu_torch.data.loader import load_paired
from dfu_multimodal_tpu_torch.data.synthetic import make_synthetic_dataset
from dfu_multimodal_tpu_torch.eval import compare as port_compare
from dfu_multimodal_tpu_torch.eval import embed as port_embed
from dfu_multimodal_tpu_torch.eval import robustness as port_rob
from dfu_multimodal_tpu_torch.models.fusion import FusionMLP
from dfu_multimodal_tpu_torch.models.vit import ViT
from dfu_multimodal_tpu_torch.tools.convert_jax import variables_to_state_dict
from dfu_multimodal_tpu_torch.train.engine import Trainer
from dfu_multimodal_tpu_torch.utils import checkpoint as port_ckpt

torch.set_num_threads(1)
SIZE = 32
FEAT_TOL = CORRUPT_TOL = 1e-4
NARROW_VIT = dict(depth=2, hidden_dim=64, num_heads=4, patch_size=8)
MODELS = ("tiny_rgb", "tiny_fusion", "multimodal")
CKPTS = {"tiny_rgb": "checkpoints_rgb_only",
         "tiny_fusion": "checkpoints_multimodal"}
COUNTS = {m: {"train": (3, 3), "val": (2, 2), "test": (4, 5)}
          for m in ("rgb", "thermal")}


def _narrow_vit(dtype, attention_impl, block_impl, token_merge=None,
                tome_prop_attn=False, name=None):
    return JaxViT(dtype=dtype, attention_impl="xla", block_impl="flax",
                  name=name, **NARROW_VIT)


def _numpy_variables(shapes, seed):
    """A variables tree of ``shapes`` drawn with numpy: LeCun-normal
    kernels, BatchNorm variances in [0.5, 1.5], every other leaf small
    noise (so a key landing in the wrong place cannot hide)."""
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


def _modalities(mod):
    return {"rgb": mod.rgb_modality(), "thermal": mod.thermal_modality()}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Per model: the JAX trainer and a state of numpy-drawn variables,
    the port trainer with the same weights; the synthetic tree, JAX
    checkpoints of the tiny models on disk, and the pseudo-paired test
    split the CLIs load."""
    root = tmp_path_factory.mktemp("research")
    data, logs = root / "data", root / "logs"
    make_synthetic_dataset(data, size=SIZE, counts=COUNTS)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_fusion, "ViTBase16", _narrow_vit)
        models = {}
        for k, name in enumerate(MODELS):
            jcfg = jax_config.TrainConfig(
                batch_size=8, eval_batch_size=8, compute_dtype="float32",
                mesh=jax_config.MeshConfig(data=1))
            jt = JaxTrainer(name, jcfg, _modalities(jax_config))
            shapes = jax_zoo.init_shapes(jt.module, jt.spec, SIZE)
            variables = _numpy_variables(shapes, seed=10 + k)
            state = types.SimpleNamespace(
                params=variables["params"],
                batch_stats=variables.get("batch_stats", {}))
            pt = Trainer(name, port_config.TrainConfig(
                batch_size=8, eval_batch_size=8, compute_dtype="float32"),
                _modalities(port_config), device="cpu", image_size=SIZE)
            if name == "multimodal":
                pt.module.thermal_branch = ViT(image_size=SIZE, **NARROW_VIT)
                pt.module.fusion = FusionMLP(2048 + NARROW_VIT["hidden_dim"])
            pt.module.load_state_dict(
                variables_to_state_dict(name, variables), strict=True)
            if name in CKPTS:
                jax_ckpt.save_checkpoint(
                    logs / CKPTS[name], epoch=1, model_state=variables,
                    opt_state={}, val_f1=0.5, history={},
                    extra_meta={"model": name})
            models[name] = (jt, state, pt)
        ds = load_paired(data, "test", SIZE, strategy="pseudo", seed=42)
        yield {"models": models, "data": data, "logs": logs, "ds": ds,
               "root": root, "jax_steps": {}}


# ----------------------------------------------------------- compare


@pytest.mark.parametrize("n01,n10", [(0, 0), (3, 0), (5, 7), (30, 12),
                                     (1, 1), (0, 40)])
def test_mcnemar_exact_matches_jax(n01, n10):
    assert port_compare.mcnemar_exact(n01, n10) == \
        jax_compare.mcnemar_exact(n01, n10)


def _paired_rows(seed, n=40, with_probs=True):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n)
    pa, pb = rng.uniform(size=n), rng.uniform(size=n)
    pb = np.clip(pb * 0.5 + 0.5 * y, 0, 1)
    ra, rb = (pa > 0.5).astype(int), (pb > 0.5).astype(int)
    return (y, ra, pa if with_probs else None, rb,
            pb if with_probs else None)


@pytest.mark.parametrize("seed,with_probs,n_boot", [
    (0, True, 200), (1, False, 150), (2, True, 50)])
def test_compare_functions_match_jax(seed, with_probs, n_boot):
    rows = _paired_rows(seed, with_probs=with_probs)
    y, ra, _, rb, _ = rows
    assert port_compare.flip_table(y, ra, rb) == \
        jax_compare.flip_table(y, ra, rb)
    ours = port_compare.compare_models(*rows, n_boot=n_boot, seed=seed)
    ref = jax_compare.compare_models(*rows, n_boot=n_boot, seed=seed)
    np.testing.assert_equal(ours, ref)
    deltas = port_compare.paired_bootstrap_deltas(*rows, n_boot=n_boot,
                                                  seed=seed + 1)
    np.testing.assert_equal(deltas, jax_compare.paired_bootstrap_deltas(
        *rows, n_boot=n_boot, seed=seed + 1))
    assert port_compare.format_report(ours, "a", "b") == \
        jax_compare.format_report(ref, "a", "b")


def test_compare_cli_matches_jax(setup):
    """tiny_rgb (A) against tiny_fusion (B) from their JAX checkpoints on
    the union's pseudo-paired rows, B with a deployment.json: the port's
    report equal to JAX's but for the paths."""
    logs, data = setup["logs"], setup["data"]
    a, b = logs / CKPTS["tiny_rgb"], logs / CKPTS["tiny_fusion"]
    # B's threshold at the median of its probabilities, so that it
    # decides both ways on the rows (random weights score them alike)
    _, arrays = setup["models"]["tiny_fusion"][2].run_eval_epoch(setup["ds"])
    threshold = float(np.round(np.median(arrays["y_probs"]), 4))
    (b / "deployment.json").write_text(json.dumps({"threshold": threshold}))
    try:
        argv = ["--checkpoint-a", str(a), "--checkpoint-b", str(b),
                "--data-dir", str(data), "--image-size", str(SIZE),
                "--batch-size", "8", "--compute-dtype", "float32",
                "--bootstrap", "100"]
        out = setup["root"] / "compare"
        assert port_compare_cli.main(
            argv + ["--out", str(out / "port.json"), "--device", "cpu"]) == 0
        assert jax_compare_cli.main(argv + ["--out",
                                            str(out / "jax.json")]) == 0
    finally:
        (b / "deployment.json").unlink()
    ours = json.loads((out / "port.json").read_text())
    ref = json.loads((out / "jax.json").read_text())
    assert ours["decision_rule_b"] == ref["decision_rule_b"] == \
        f"deployment.json: threshold={threshold:.4f}"
    assert ours["flip_table"]["n_flips"] > 0
    for key in ("n", "flip_table", "mcnemar", "model_a", "model_b",
                "split", "decision_rule_a", "checkpoint_a"):
        assert ours[key] == ref[key], key
    assert set(ours["deltas"]) == set(ref["deltas"])
    for k, row in ref["deltas"].items():
        for field, v in row.items():
            if isinstance(v, float):
                np.testing.assert_allclose(ours["deltas"][k][field], v,
                                           rtol=0, atol=1e-6)
            else:
                assert ours["deltas"][k][field] == v, (k, field)


# -------------------------------------------------------- robustness


def _images(seed, shape=(3, 12, 10, 3)):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(
        np.float32)


@pytest.mark.parametrize("name,param", [
    ("gaussian_blur", 0.5), ("gaussian_blur", 3.0), ("gaussian_blur", 0.0),
    ("brightness", 8.0), ("brightness", 64.0), ("contrast", 0.85),
    ("contrast", 0.3)])
def test_corruption_matches_jax(name, param):
    x = _images(0)
    ours = port_rob.apply_corruption(name, torch.from_numpy(x), param)
    ref = jax_rob.apply_corruption(name, x, np.float32(param),
                                   jax.random.PRNGKey(0))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=CORRUPT_TOL)


@pytest.mark.parametrize("param", [4.0, 32.0])
def test_noise_matches_jax_through_its_draw(param):
    x = _images(1)
    key = jax.random.PRNGKey(7)
    draw = np.array(jax.random.normal(key, x.shape, np.float32))
    ours = port_rob.apply_corruption("gaussian_noise", torch.from_numpy(x),
                                     param, torch.from_numpy(draw))
    ref = jax_rob.apply_corruption("gaussian_noise", x, np.float32(param),
                                   key)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=CORRUPT_TOL)
    with pytest.raises(ValueError, match="draw"):
        port_rob.apply_corruption("gaussian_noise", torch.from_numpy(x),
                                  param)


@pytest.mark.parametrize("clean,f1", [(0.9, 0.9), (0.9, 0.8501),
                                      (0.9, 0.85), (0.9, 0.7501),
                                      (0.9, 0.75), (0.9, 0.1), (0.5, 0.9)])
def test_verdict_matches_jax(clean, f1):
    assert port_rob.verdict(clean, f1) == jax_rob.verdict(clean, f1)


@pytest.mark.parametrize("name", ["brightness", "contrast", "gaussian_blur"])
def test_corrupted_counts_match_jax(setup, name):
    jt, state, pt = setup["models"]["tiny_fusion"]
    ds = setup["ds"]
    for subset in (("rgb",), ("rgb", "thermal")):
        steps = setup["jax_steps"]
        if subset not in steps:
            steps[subset] = jax_rob.make_step(jt, subset)
        ref = jax_rob.corrupted_counts(jt, state, ds, name, subset, [1, 5],
                                       step=steps[subset])
        ours = port_rob.corrupted_counts(pt, ds, name, subset, [1, 5])
        np.testing.assert_array_equal(np.stack(ours), np.stack(ref))
        assert all(c.sum() == len(ds) for c in ours)


def test_robustness_rejects_what_jax_rejects(setup):
    _, _, pt = setup["models"]["tiny_rgb"]
    with pytest.raises(ValueError, match="no input"):
        port_rob.make_step(pt, ("thermal",))
    with pytest.raises(ValueError, match="unknown corruption"):
        port_rob.corrupted_counts(pt, setup["ds"], "fog", ("rgb",), [1])
    with pytest.raises(ValueError, match="severities"):
        port_rob.corrupted_counts(pt, setup["ds"], "contrast", ("rgb",), [0])


def test_robustness_cli_report_matches_jax_sweep(setup):
    jt, state, _ = setup["models"]["tiny_fusion"]
    ckpt = setup["logs"] / CKPTS["tiny_fusion"]
    corruptions = ["brightness", "contrast", "gaussian_blur"]
    assert port_rob_cli.main([
        "--checkpoint", str(ckpt), "--data-dir", str(setup["data"]),
        "--image-size", str(SIZE), "--batch-size", "8", "--compute-dtype",
        "float32", "--severities", "1", "5", "--corruptions", *corruptions,
        "--all-modalities-together", "--device", "cpu"]) == 0
    ours = json.loads((ckpt / "robustness_report.json").read_text())
    ref = jax_rob.sweep(jt, state, setup["ds"], corruptions, [1, 5],
                        [("rgb",), ("thermal",), ("rgb", "thermal")],
                        log=lambda s: None)
    assert ours.pop("split") == "test"
    np.testing.assert_allclose(ours.pop("clean_f1"), ref.pop("clean_f1"),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(ours.pop("clean_acc"), ref.pop("clean_acc"),
                               rtol=0, atol=1e-12)
    assert ours == json.loads(json.dumps(ref))


# ------------------------------------------------------------- embed


@pytest.mark.parametrize("name", MODELS)
def test_extract_features_matches_jax(setup, name):
    jt, state, pt = setup["models"][name]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_fusion, "ViTBase16", _narrow_vit)
        ref = jax_embed.extract_features(jt, state, setup["ds"])
    ours = port_embed.extract_features(pt, setup["ds"])
    assert set(ours) == set(ref)
    for k, v in ref.items():
        assert ours[k].shape == v.shape, k
        if k == "preds":
            np.testing.assert_array_equal(ours[k], v)
        else:
            assert ours[k].dtype == np.float32, k
            np.testing.assert_allclose(ours[k], v, rtol=0, atol=FEAT_TOL,
                                       err_msg=k)


@pytest.mark.parametrize("name", ["legacy_gated_fusion"])
def test_extract_features_of_a_legacy_model_matches_jax(setup, name):
    """The legacy gated fusion's two EfficientNet encoders' features
    (``rgb_encoder``, ``thermal_encoder``: JAX's scopes) and their
    concatenation, probabilities and predictions on numpy-drawn weights,
    within FEAT_TOL of JAX's."""
    jt = JaxTrainer(name, jax_config.TrainConfig(
        batch_size=8, eval_batch_size=8, compute_dtype="float32",
        mesh=jax_config.MeshConfig(data=1)), _modalities(jax_config))
    variables = _numpy_variables(
        jax_zoo.init_shapes(jt.module, jt.spec, SIZE), seed=31)
    state = types.SimpleNamespace(params=variables["params"],
                                  batch_stats=variables["batch_stats"])
    pt = Trainer(name, port_config.TrainConfig(
        batch_size=8, eval_batch_size=8, compute_dtype="float32"),
        _modalities(port_config), device="cpu", image_size=SIZE)
    pt.module.load_state_dict(variables_to_state_dict(name, variables),
                              strict=True)
    ref = jax_embed.extract_features(jt, state, setup["ds"])
    ours = port_embed.extract_features(pt, setup["ds"])
    assert set(ours) == set(ref) == {"feat_rgb", "feat_thermal",
                                     "feat_fused", "probs", "preds"}
    assert ours["feat_rgb"].shape == (len(setup["ds"]), 1280)
    np.testing.assert_array_equal(ours["preds"], ref["preds"])
    for k in ("feat_rgb", "feat_thermal", "feat_fused", "probs"):
        np.testing.assert_allclose(ours[k], ref[k], rtol=0, atol=FEAT_TOL,
                                   err_msg=k)


def test_npz_index_loads_both_ways(tmp_path):
    rng = np.random.default_rng(3)
    out = {"feat_rgb": rng.standard_normal((4, 8)).astype(np.float32),
           "probs": rng.uniform(size=4).astype(np.float32),
           "preds": np.array([0, 1, 1, 0])}
    kw = dict(paths=["a.jpg", "b.jpg", "c.jpg", "d.jpg"],
              labels=np.array([0, 1, 1, 0]), model="tiny_rgb",
              embedding="rgb")
    for writer, reader in ((port_embed, jax_embed), (jax_embed, port_embed)):
        f = tmp_path / f"{writer.__name__}.npz"
        writer.save_embeddings(f, out, **kw)
        back, ref = reader.load_embeddings(f), writer.load_embeddings(f)
        assert set(back) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(back[k], ref[k])
        assert str(back["embedding"]) == "rgb"


@pytest.mark.parametrize("seed", [0, 1])
def test_retrieval_functions_match_jax(seed):
    rng = np.random.default_rng(seed)
    index = rng.standard_normal((9, 6)).astype(np.float32)
    queries = np.concatenate([index[:2] * 3.0, rng.standard_normal(
        (3, 6)).astype(np.float32)])
    np.testing.assert_array_equal(port_embed.l2_normalize(queries),
                                  jax_embed.l2_normalize(queries))
    for k in (1, 4, 20):
        for a, b in zip(port_embed.cosine_topk(queries, index, k),
                        jax_embed.cosine_topk(queries, index, k)):
            np.testing.assert_array_equal(a, b)
    probs = rng.uniform(size=12)
    for center in (0.5, 0.3):
        np.testing.assert_array_equal(
            port_embed.uncertainty_order(probs, center),
            jax_embed.uncertainty_order(probs, center))
    feats = {"train": index, "test": np.concatenate([index[3:5], queries])}
    paths = {"train": [f"t{i}.jpg" for i in range(9)],
             "test": [None, "None"] + [f"q{i}.jpg" for i in range(5)]}
    ours = port_embed.cross_split_near_duplicates(feats, paths, 0.99)
    assert ours == jax_embed.cross_split_near_duplicates(feats, paths, 0.99)
    assert [h["path_b"] for h in ours[:2]] == ["q0.jpg", "q1.jpg"]


def test_embed_cli_index_retrieval_and_triage(setup, tmp_path):
    """An index over train, the test images retrieved against it and
    ranked by uncertainty, the near-duplicate audit: on the CPU, from the
    JAX checkpoint of tiny_fusion."""
    ckpt, data = setup["logs"] / CKPTS["tiny_fusion"], setup["data"]
    common = ["--checkpoint", str(ckpt), "--image-size", str(SIZE),
              "--batch-size", "8", "--compute-dtype", "float32",
              "--device", "cpu"]
    index = tmp_path / "train.npz"
    res = port_embed_cli.main(common + ["--data-dir", str(data), "--split",
                                        "train", "--output", str(index)])
    assert res == {"n": 6, "embedding": "fused", "dims": 64}
    idx = port_embed.load_embeddings(index)
    assert str(idx["model"]) == "tiny_fusion" and len(idx["labels"]) == 6
    # an index row queried against its own index finds itself at cosine 1
    top, sims = port_embed.cosine_topk(idx["feat_fused"], idx["feat_fused"],
                                       1)
    np.testing.assert_array_equal(top[:, 0], np.arange(6))
    np.testing.assert_allclose(sims[:, 0], 1.0, rtol=0, atol=1e-5)

    test_rgb = sorted((data / "rgb" / "test").rglob("*.jpg"))
    images = tmp_path / "images"
    images.mkdir()
    for i, p in enumerate(test_rgb[:4]):
        (images / f"{i}_{p.name}").write_bytes(p.read_bytes())
    table = tmp_path / "triage.csv"
    res = port_embed_cli.main(common + [
        "--images", str(images), "--index", str(index), "--neighbors", "3",
        "--rank-uncertainty", "--csv", str(table)])
    assert res == {"n": 4, "embedding": "fused", "dims": 64}
    rows = table.read_text().splitlines()
    assert rows[0].split(",")[:6] == ["path", "prob_ulcer", "prediction",
                                      "nn1_path", "nn1_label", "nn1_sim"]
    probs = [float(r.split(",")[1]) for r in rows[1:]]
    assert len(probs) == 4 and np.all(np.diff(np.abs(np.asarray(probs)
                                                      - 0.5)) >= 0)
    audit = port_embed_cli.main(common + ["--data-dir", str(data),
                                          "--near-dup-check"])
    assert audit["embedding"] == "rgb/thermal"


@pytest.mark.parametrize("name", ["legacy_concat_fusion", "efficientnet_b4"])
def test_embed_refuses_models_the_port_does_not_build(setup, name):
    """Every zoo model has its trunk entries now (the EfficientNets and
    the legacy fusions since their features are recorded); a model no zoo
    builds, such as the reference's concat fusion, is refused by name."""
    with pytest.raises(ValueError, match=name):
        port_embed.trunk_features(name)
    with pytest.raises(ValueError, match=name):
        port_embed_cli.main(["--checkpoint", str(setup["root"]), "--model",
                             name, "--data-dir", str(setup["data"]),
                             "--device", "cpu"])


# -------------------------------------------------------- model card


def _card_artifacts(setup, ckpt):
    """The artifacts a card reads, beside the JAX checkpoint: JAX's
    run_info, test results, extended metrics with bootstrap CIs and
    calibration, deployment, drift baseline, robustness and compare
    reports."""
    (ckpt / "run_info.json").write_text(json.dumps({
        "model": "tiny_rgb", "recipe": "rgb_only",
        "argv": ["--data-dir", "data", "--epochs", "2"],
        "config": {"batch_size": 8, "num_epochs": 2, "learning_rate": 1e-4,
                   "seed": 0, "compute_dtype": "float32"},
        "jax_version": "0.0", "backend": "cpu", "device_count": 8}))
    jax_artifacts.save_pt({"test_acc": 0.75, "test_f1": 0.7,
                           "test_loss": 0.6}, ckpt / "test_results.pt")
    metrics_dir = setup["root"] / "extended_metrics" / "rgb_only"
    jax_artifacts.save_pt({
        "metrics": {"accuracy": 0.8, "f1": 0.75, "sensitivity": 0.7,
                    "specificity": 0.9, "auc_roc": 0.85, "mcc": None},
        "bootstrap": {"accuracy": {"lo": 0.6, "hi": 0.9},
                      "f1": {"lo": 0.5, "hi": 0.95}},
        "calibration": {"errors": {"ece": 0.05, "mce": 0.1, "brier": 0.2},
                        "temperature": {"temperature": 1.3}}},
        metrics_dir / "results.pt")
    (ckpt / "deployment.json").write_text(json.dumps(
        {"threshold": 0.4, "temperature": 1.3}))
    (ckpt / "drift_baseline.json").write_text(json.dumps(
        {"modalities": {"rgb": {}}}))
    (ckpt / "robustness_report.json").write_text(json.dumps({
        "split": "test", "clean_f1": 0.7, "results": [
            {"corruption": "contrast", "modalities": ["rgb"],
             "worst_f1": 0.5, "verdict": "fragile"}]}))
    (ckpt / "compare_report.json").write_text(json.dumps({
        "model_a": "rgb_only", "n": 9, "split": "test",
        "mcnemar": {"p_value": 0.2, "significant": False},
        "deltas": {"accuracy": {"delta": 0.1, "lo": -0.1, "hi": 0.3}}}))
    return metrics_dir


def test_model_card_matches_jax(setup):
    ckpt = setup["root"] / "card" / "checkpoints_rgb_only"
    ckpt.parent.mkdir()
    _, state, pt = setup["models"]["tiny_rgb"]
    jax_ckpt.save_checkpoint(ckpt, epoch=2, model_state={
        "params": state.params, "batch_stats": state.batch_stats},
        opt_state={}, val_f1=0.6, history={}, extra_meta={
            "model": "tiny_rgb"})
    metrics_dir = _card_artifacts(setup, ckpt)
    ours = port_card.build_card(ckpt, metrics_dir).splitlines()
    ref = jax_card.build_card(ckpt, metrics_dir).splitlines()
    assert len(ours) == len(ref)
    differ = [i for i, (a, b) in enumerate(zip(ours, ref)) if a != b]
    # only the date line (which names the package) and the versions line
    assert len(differ) == 2
    assert ref[differ[0]].startswith("*Generated ")
    assert ours[differ[0]].startswith("*Generated ")
    assert ref[differ[1]] == "| backend | cpu × 8 (jax 0.0) |"
    assert ours[differ[1]] == "| backend | cpu × 8 (torch ?) |"
    n_params = sum(p.numel() for p in pt.module.parameters())
    assert f"| Parameters | {n_params:,} |" in ours
    sha = hashlib.sha256((ckpt / "best_model.msgpack").read_bytes())
    assert f"| Weights SHA-256 | `{sha.hexdigest()[:16]}…` |" in ours

    # the port's own checkpoint: parameters only, BatchNorm buffers out
    port_ckpt.save_checkpoint(ckpt, epoch=2,
                              model_state=pt.module.state_dict(),
                              opt_state=None, val_f1=0.6, history={})
    count, digest = port_card._param_count_and_hash(ckpt)
    assert count == n_params < sum(v.numel() for v in
                                   pt.module.state_dict().values())
    assert digest == hashlib.sha256(
        (ckpt / "best_model.pt").read_bytes()).hexdigest()
    res = port_card.main(["--checkpoint", str(ckpt)])
    assert Path(res["output"]).read_text().count(f"{n_params:,}") == 1
