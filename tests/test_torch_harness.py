"""The port's training harness against the JAX package's, on the CPU:
``cli/cross_validate.py``, ``cli/sweep.py``, ``train/soup.py`` with
``cli/soup.py``.

- The folds (stratified and pseudo-patient-grouped), ``pair_pools``,
  ``_pool`` and ``_subset``: equal to JAX's for seeds 0, 1 and 2; the
  cross-validation CLI (``tiny_rgb`` and ``tiny_fusion`` at 32², two
  folds, one epoch, ``--device cpu``) writes JAX's ``cv_results.pt`` keys
  with the folds JAX deals on the same pool.
- ``parse_param`` (and its refusals), ``enumerate_trials`` (grid, and
  ``--random`` under a seed), ``trial_key`` and ``_train_command``: equal;
  a port sweep keys its trials as JAX's sweep of the same argv does (JAX's
  run with its training stubbed out), and ``--resume`` trains nothing.
- ``average_model_states``: within 1e-6 of JAX's on the same weights,
  ``num_batches_tracked`` kept from the first ingredient, a checkpoint
  souped with itself bit-equal; ``greedy_soup`` keeps JAX's list, ties in
  JAX's order; the soup CLI (uniform and ``--greedy``) on two JAX
  checkpoints: weights within 1e-6 of JAX's CLI's, the same val F1 and
  test predictions, and the output directory answers ``predict``.
"""

import json
import types

import jax
import numpy as np
import pytest
import torch

from dfu_multimodal_tpu.cli import cross_validate as jax_cv
from dfu_multimodal_tpu.cli import soup as jax_soup_cli
from dfu_multimodal_tpu.cli import sweep as jax_sweep
from dfu_multimodal_tpu.data.loader import \
    load_single_modality as jax_load_single
from dfu_multimodal_tpu.models import zoo as jax_zoo
from dfu_multimodal_tpu.tools.splits import \
    pseudo_patient_id as jax_patient_id
from dfu_multimodal_tpu.train import soup as jax_soup
from dfu_multimodal_tpu.utils import checkpoint as jax_ckpt
from dfu_multimodal_tpu_torch.cli import cross_validate as port_cv
from dfu_multimodal_tpu_torch.cli import predict as port_predict
from dfu_multimodal_tpu_torch.cli import soup as port_soup_cli
from dfu_multimodal_tpu_torch.cli import sweep as port_sweep
from dfu_multimodal_tpu_torch.data.loader import ArrayDataset
from dfu_multimodal_tpu_torch.data.synthetic import make_synthetic_dataset
from dfu_multimodal_tpu_torch.tools.convert_jax import variables_to_state_dict
from dfu_multimodal_tpu_torch.tools.splits import pseudo_patient_id
from dfu_multimodal_tpu_torch.train import soup as port_soup
from dfu_multimodal_tpu_torch.utils import checkpoint as port_ckpt
from dfu_multimodal_tpu_torch.utils.artifacts import load_pt

torch.set_num_threads(1)
SIZE = 32
SOUP_TOL = 1e-6
SEEDS = (0, 1, 2)
COUNTS = {m: {"train": (5, 4), "val": (3, 3), "test": (3, 3)}
          for m in ("rgb", "thermal")}
SMOKE = ["--image-size", str(SIZE), "--batch-size", "4", "--compute-dtype",
         "float32", "--seed", "0"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("harness")
    make_synthetic_dataset(root / "data", size=SIZE, counts=COUNTS)
    return root


# --------------------------------------------------------------- folds


def _labels_and_groups(seed):
    rng = np.random.default_rng(100 + seed)
    n = 37
    labels = (rng.uniform(size=n) < 0.35).astype(np.int32)
    names = [f"img_{int(i)}.jpg" for i in rng.permutation(60)[:n]]
    return labels, names


@pytest.mark.parametrize("seed", SEEDS)
def test_folds_match_jax(seed):
    labels, names = _labels_and_groups(seed)
    for k in (2, 5):
        ours = port_cv.stratified_folds(labels, k,
                                        np.random.default_rng(seed))
        ref = jax_cv.stratified_folds(labels, k, np.random.default_rng(seed))
        np.testing.assert_equal(ours, ref)
        groups = [pseudo_patient_id(n, 3) for n in names]
        assert groups == [jax_patient_id(n, 3) for n in names]
        ours = port_cv.grouped_folds(labels, groups, k,
                                     np.random.default_rng(seed))
        ref = jax_cv.grouped_folds(labels, groups, k,
                                   np.random.default_rng(seed))
        np.testing.assert_equal(ours, ref)
    for fn in (port_cv.stratified_folds, jax_cv.stratified_folds):
        with pytest.raises(ValueError, match="folds"):
            fn(labels, 1, np.random.default_rng(seed))


def _pool_pair(seed):
    rng = np.random.default_rng(seed)

    def make(n, mod):
        arrays = {mod: rng.integers(0, 256, (n, 2, 2, 3), dtype=np.uint8)}
        return ArrayDataset(arrays=arrays,
                            labels=rng.integers(0, 2, n).astype(np.int32),
                            paths={mod: [f"{mod}{i}.jpg" for i in range(n)]})

    return make(11, "rgb"), make(8, "thermal")


@pytest.mark.parametrize("seed", SEEDS)
def test_pair_pools_and_pooling_match_jax(seed):
    rgb, th = _pool_pair(seed)
    rgb_idx, th_idx = np.arange(1, 10, 2), np.arange(0, 8, 3)
    ours = port_cv.pair_pools(rgb, th, rgb_idx, th_idx, seed)
    ref = jax_cv.pair_pools(rgb, th, rgb_idx, th_idx, seed)
    np.testing.assert_equal(ours.arrays, ref.arrays)
    np.testing.assert_array_equal(ours.labels, ref.labels)
    pooled = port_cv._pool([rgb, port_cv._subset(rgb, rgb_idx)])
    ref = jax_cv._pool([rgb, jax_cv._subset(rgb, rgb_idx)])
    np.testing.assert_equal(pooled.arrays, ref.arrays)
    np.testing.assert_array_equal(pooled.labels, ref.labels)
    assert pooled.paths == ref.paths


@pytest.mark.parametrize("modality,model,extra", [
    ("rgb", "tiny_rgb", ["--group-by-patient", "--group-size", "2"]),
    ("multimodal", "tiny_fusion", [])])
def test_cross_validate_cli_writes_jax_results(tree, modality, model,
                                               extra):
    data, logs = tree / "data", tree / f"cv_{model}"
    summary = port_cv.main(["--data-dir", str(data), "--checkpoint-root",
                            str(logs), "--modality", modality, "--model",
                            model, "--folds", "2", "--epochs", "1",
                            "--device", "cpu", *SMOKE, *extra])
    saved = load_pt(logs / f"cross_validation_{modality}" / "cv_results.pt")
    assert set(saved) == {"fold_metrics", "summary", "folds", "config"}
    assert saved["config"] == {"folds": 2, "modality": modality,
                               "model": model, "seed": 0,
                               "group_by_patient": bool(extra),
                               "epochs": 1}
    assert len(saved["fold_metrics"]) == 2 and summary == saved["summary"]
    assert set(saved["summary"]) <= set(jax_cv.SUMMARY_KEYS)
    # the folds JAX deals on its own pool of the same tree
    rng = np.random.default_rng(0)
    for mod in saved["folds"]:
        pool = jax_cv._pool([jax_load_single(data / mod, split, SIZE, mod)
                             for split in ("train", "val")])
        if extra:
            groups = [jax_patient_id(p.name, 2) for p in pool.paths[mod]]
            ref = jax_cv.grouped_folds(pool.labels, groups, 2, rng)
        else:
            ref = jax_cv.stratified_folds(pool.labels, 2, rng)
        assert saved["folds"][mod] == [f.tolist() for f in ref]


# --------------------------------------------------------------- sweep


@pytest.mark.parametrize("spec", [
    "lr=1e-4,3e-4", "weight_decay=0.0001", "batch_size=8,16",
    "epochs=3", "lr_schedule=constant,cosine", "lr=log(1e-5,1e-3)",
    "ema_decay=uniform(0,0.999)", "loss=ce,focal", "grad_accum=1,2"])
def test_parse_param_matches_jax(spec):
    assert port_sweep.parse_param(spec).__dict__ == \
        jax_sweep.parse_param(spec).__dict__


@pytest.mark.parametrize("spec", ["lr", "nope=1", "lr=", "lr=log(0,1)",
                                  "lr=uniform(2,1)"])
def test_parse_param_refuses_as_jax(spec):
    with pytest.raises(ValueError) as ours:
        port_sweep.parse_param(spec)
    with pytest.raises(ValueError) as ref:
        jax_sweep.parse_param(spec)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("random_n,seed", [(0, 0), (5, 0), (5, 3),
                                           (12, 1)])
def test_enumerate_trials_matches_jax(random_n, seed):
    specs = ["lr=1e-4,3e-4", "lr_schedule=constant,cosine"]
    if random_n:
        specs.append("ema_decay=uniform(0,0.99)")
    ours = port_sweep.enumerate_trials(
        [port_sweep.parse_param(s) for s in specs], random_n, seed)
    ref = jax_sweep.enumerate_trials(
        [jax_sweep.parse_param(s) for s in specs], random_n, seed)
    assert ours == ref
    context = {"model": "tiny_rgb", "epochs": 2}
    assert [port_sweep.trial_key(t, context) for t in ours] == \
        [jax_sweep.trial_key(t, context) for t in ref]
    args = types.SimpleNamespace(modality="thermal")
    assert [port_sweep._train_command(args, "data", t) for t in ours] == \
        [jax_sweep._train_command(args, "data", t) for t in ref]


class _NoTraining:
    """Stands in for the JAX Trainer: the sweep's keys and records
    without a training run."""

    def __init__(self, *args, **kwargs):
        pass

    def fit(self, *args, **kwargs):
        return None, {}, 0.5


def test_sweep_keys_match_jax_and_resume_trains_nothing(tree,
                                                        monkeypatch):
    data = tree / "data"
    argv = ["--data-dir", str(data), "--modality", "rgb", "--model",
            "tiny_rgb", "--param", "lr=3e-3,1e-3", "--epochs", "1",
            *SMOKE]
    monkeypatch.setattr(jax_sweep, "Trainer", _NoTraining)
    jax_sweep.main(argv + ["--checkpoint-root", str(tree / "sweep_jax")])
    out = port_sweep.main(argv + ["--checkpoint-root",
                                  str(tree / "sweep_port"), "--device",
                                  "cpu"])
    assert out["n_trials"] == 2

    def records(root):
        jsonl = root / "sweep_rgb" / "trials.jsonl"
        return [json.loads(x) for x in jsonl.read_text().splitlines()]

    ours, ref = records(tree / "sweep_port"), records(tree / "sweep_jax")
    assert [r["key"] for r in ours] == [r["key"] for r in ref]
    assert [r["params"] for r in ours] == [r["params"] for r in ref]
    assert set(ours[0]) == set(ref[0])
    saved = load_pt(tree / "sweep_port" / "sweep_rgb" / "sweep_results.pt")
    assert set(saved) == {"records", "best", "axes", "config"}

    fits = []
    monkeypatch.setattr(port_sweep.Trainer, "fit",
                        lambda *a, **k: fits.append(a))
    again = port_sweep.main(argv + ["--checkpoint-root",
                                    str(tree / "sweep_port"), "--device",
                                    "cpu", "--resume"])
    assert fits == [] and again["n_trials"] == 2
    assert records(tree / "sweep_port") == ours


# ---------------------------------------------------------------- soup


def _tiny_variables(seed):
    """tiny_rgb variables drawn with numpy (BatchNorm variances in
    [0.5, 1.5])."""
    module, spec = jax_zoo.build("tiny_rgb")
    shapes = jax_zoo.init_shapes(module, spec, SIZE)
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        if str(path[-1].key) == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.3 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _state_dict(variables, tracked=0):
    sd = variables_to_state_dict("tiny_rgb", variables)
    for k in sd:
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(tracked)
    return sd


def test_average_model_states_matches_jax():
    trees = [_tiny_variables(s) for s in SEEDS]
    ref = _state_dict(jax_soup.average_model_states(trees))
    ours = port_soup.average_model_states(
        [_state_dict(t, tracked=i + 3) for i, t in enumerate(trees)])
    assert set(ours) == set(ref)
    for k, v in ref.items():
        if k.endswith("num_batches_tracked"):
            assert int(ours[k]) == 3          # the first ingredient's
            continue
        assert ours[k].dtype == torch.float32
        np.testing.assert_allclose(ours[k].numpy(), v.numpy(), rtol=0,
                                   atol=SOUP_TOL, err_msg=k)
    one = _state_dict(trees[0])
    for k, v in port_soup.average_model_states([one, one]).items():
        assert torch.equal(v, one[k]), k


def test_average_model_states_refuses_as_jax():
    sd = _state_dict(_tiny_variables(0))
    other = dict(sd, extra=torch.zeros(2))
    with pytest.raises(ValueError, match="structure"):
        port_soup.average_model_states([sd, other])
    q = {"w": torch.zeros(3, dtype=torch.int8)}
    with pytest.raises(ValueError, match="int8"):
        port_soup.average_model_states([q, q])
    with pytest.raises(ValueError, match="int8"):
        jax_soup.average_model_states([{"w": np.zeros(3, np.int8)}] * 2)


@pytest.mark.parametrize("values", [(0.3, 0.3, 0.1, 0.9),
                                    (0.9, 0.1, 0.25, 0.25),
                                    (0.2, 0.2, 0.2, 0.2)])
def test_greedy_soup_keeps_jax_list(values):
    """Score = −|w − 0.25| of one weight: ties between candidates, and
    averages that help or hurt."""
    def port_score(state):
        return -abs(float(state["w"][0]) - 0.25)

    def jax_score(state):
        return -abs(float(state["w"][0]) - 0.25)

    names = [f"c{i}" for i in range(len(values))]
    ours = port_soup.greedy_soup(
        [(n, {"w": torch.tensor([v])}) for n, v in zip(names, values)],
        port_score, log=lambda s: None)
    ref = jax_soup.greedy_soup(
        [(n, {"w": np.asarray([v], np.float32)})
         for n, v in zip(names, values)], jax_score, log=lambda s: None)
    assert ours[1] == ref[1]
    assert ours[2] == pytest.approx(ref[2], abs=1e-7)


@pytest.fixture(scope="module")
def ingredients(tree):
    """Two JAX checkpoints of tiny_rgb with numpy-drawn weights."""
    dirs = []
    for seed in (0, 1):
        d = tree / f"ingredient{seed}"
        jax_ckpt.save_checkpoint(d, epoch=1,
                                 model_state=_tiny_variables(10 + seed),
                                 opt_state={}, val_f1=0.5, history={},
                                 extra_meta={"model": "tiny_rgb"})
        dirs.append(d)
    return dirs


@pytest.mark.parametrize("greedy", [False, True])
def test_soup_cli_matches_jax(tree, ingredients, greedy):
    tag = "greedy" if greedy else "uniform"
    argv = ["--checkpoints", *map(str, ingredients), "--data-dir",
            str(tree / "data"), "--image-size", str(SIZE), "--batch-size",
            "4", "--compute-dtype", "float32"] + (
                ["--greedy"] if greedy else [])
    out, ref_dir = tree / f"soup_{tag}", tree / f"soup_{tag}_jax"
    assert port_soup_cli.main(argv + ["--out", str(out), "--device",
                                      "cpu"]) == 0
    assert jax_soup_cli.main(argv + ["--out", str(ref_dir)]) == 0
    ours, meta = port_ckpt.load_checkpoint(out)
    ref, ref_meta = port_ckpt.load_checkpoint(ref_dir,
                                              model_name="tiny_rgb")
    assert meta["soup"] == ref_meta["soup"] and meta["model"] == "tiny_rgb"
    assert meta["val_f1"] == pytest.approx(ref_meta["val_f1"], abs=1e-12)
    for k, v in ref["model_state_dict"].items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(
                ours["model_state_dict"][k].numpy(), v.numpy(), rtol=0,
                atol=SOUP_TOL, err_msg=k)
    saved, ref_saved = (load_pt(d / "test_results.pt")
                        for d in (out, ref_dir))
    assert set(saved) == set(ref_saved)
    np.testing.assert_array_equal(saved["test_preds"],
                                  ref_saved["test_preds"])
    assert saved["soup_ingredients"] == ref_saved["soup_ingredients"]
    # the soup is a checkpoint like any other: predict answers from it
    rows = port_predict.main([
        "--checkpoint", str(out), "--images",
        str(tree / "data" / "rgb" / "test" / "ulcer"), "--image-size",
        str(SIZE), "--compute-dtype", "float32", "--device", "cpu"])
    assert len(rows) == COUNTS["rgb"]["test"][1]


def test_soup_cli_refuses_one_checkpoint(tree):
    with pytest.raises(SystemExit, match="two"):
        port_soup_cli.main(["--checkpoints", str(tree), "--data-dir",
                            str(tree), "--out", str(tree / "o"),
                            "--device", "cpu"])

