"""The port's evaluation suite against the JAX package's, on the CPU.

- ``eval/{threshold,bootstrap,calibration,deployment}.py``: equal to the
  JAX functions on the same numpy inputs (several seeds, a tied and a
  one-class case).
- ``eval/plots.py``: each figure is a PNG that PIL and ``data/png.py``
  read to the same pixels at the JAX figure's size; the confusion
  matrix's darkest cell holds the largest count; the ROC curve's colour
  lies on the canvas points of ``roc_curve``'s (fpr, tpr).
- ``cli/extended_metrics.py`` of both packages with every option on the
  same checkpoints: ``tiny_rgb``, ``tiny_thermal`` and ``tiny_fusion``
  drawn by the JAX zoo and written by the JAX package's
  ``save_checkpoint`` (msgpack, read by the port without flax).  The
  probabilities agree within 1e-5 (the tiny models' logit tolerance in
  ``tests/test_torch_cli.py::test_tiny_models_match_jax``) and the
  predictions are equal; the metrics, operating point, calibration and
  bootstrap in the port's ``results.pt`` equal what the JAX functions
  compute from the port's own arrays; ``EVALUATION_SUMMARY.txt`` is equal
  but for its ``Date:`` line; the same artifacts are written.
"""

import json
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from dfu_multimodal_tpu import config as jax_config
from dfu_multimodal_tpu.cli import extended_metrics as jax_em
from dfu_multimodal_tpu.eval import bootstrap as jax_boot
from dfu_multimodal_tpu.eval import calibration as jax_cal
from dfu_multimodal_tpu.eval import deployment as jax_dep
from dfu_multimodal_tpu.eval import metrics as jax_metrics
from dfu_multimodal_tpu.eval import threshold as jax_thr
from dfu_multimodal_tpu.train.engine import Trainer as JaxTrainer
from dfu_multimodal_tpu.utils import checkpoint as jax_ckpt
from dfu_multimodal_tpu_torch.cli import extended_metrics as port_em
from dfu_multimodal_tpu_torch.data.png import read_png
from dfu_multimodal_tpu_torch.data.synthetic import make_synthetic_dataset
from dfu_multimodal_tpu_torch.eval import bootstrap as port_boot
from dfu_multimodal_tpu_torch.eval import calibration as port_cal
from dfu_multimodal_tpu_torch.eval import deployment as port_dep
from dfu_multimodal_tpu_torch.eval import plots as port_plots
from dfu_multimodal_tpu_torch.eval import threshold as port_thr
from dfu_multimodal_tpu_torch.utils.artifacts import load_pt

torch.set_num_threads(1)
PROB_TOL = 1e-5
MODELS = {"rgb_only": ("checkpoints_rgb_only", "tiny_rgb", "RGB-Only"),
          "thermal_only": ("checkpoints_thermal_only", "tiny_thermal",
                           "Thermal-Only"),
          "multimodal": ("checkpoints_multimodal", "tiny_fusion",
                         "Multimodal")}


def _cases():
    """(y_true, y_probs) pairs: random at three seeds, heavy ties, and
    perfectly separated."""
    out = []
    for seed in (0, 1, 2):
        rng = np.random.default_rng(seed)
        y = rng.integers(0, 2, 40)
        out.append((y, np.clip(0.35 * y + rng.uniform(0, 0.65, 40), 0, 1)))
    rng = np.random.default_rng(3)
    y = rng.integers(0, 2, 30)
    out.append((y, np.round(rng.uniform(0, 1, 30) * 4) / 4))
    out.append((np.r_[np.zeros(5), np.ones(5)].astype(int),
                np.r_[np.full(5, 0.2), np.full(5, 0.9)]))
    return out


def _equal(a, b):
    """Nested equality with NaN == NaN."""
    np.testing.assert_equal(a, b)


# ---------------------------------------------------------- eval modules


@pytest.mark.parametrize("strategy", ["youden", "f1", "sens@0.9"])
def test_threshold_matches_jax(strategy):
    for y, p in _cases():
        _equal(port_thr.pick_threshold(y, p, strategy),
               jax_thr.pick_threshold(y, p, strategy))
        t = port_thr.pick_threshold(y, p, strategy)[0]
        _equal(port_thr.apply_threshold(p, t), jax_thr.apply_threshold(p, t))
    with pytest.raises(ValueError):
        port_thr.pick_threshold(np.ones(4, int), np.linspace(0, 1, 4),
                                strategy)


@pytest.mark.parametrize("seed", [0, 5])
def test_bootstrap_matches_jax(seed):
    for y, p in _cases():
        pred = (p >= 0.5).astype(int)
        ours = port_boot.bootstrap_cis(y, pred, p, n_boot=60, alpha=0.1,
                                       seed=seed)
        _equal(ours, jax_boot.bootstrap_cis(y, pred, p, n_boot=60,
                                            alpha=0.1, seed=seed))
        assert port_boot.format_cis(ours, "m") == jax_boot.format_cis(
            ours, "m")
        _equal(port_boot.roc_band(y, p, n_boot=30, seed=seed),
               jax_boot.roc_band(y, p, n_boot=30, seed=seed))
    y1 = np.zeros(6, int)           # one class: every AUC replicate undefined
    _equal(port_boot.bootstrap_cis(y1, y1, np.linspace(0, 1, 6), n_boot=20),
           jax_boot.bootstrap_cis(y1, y1, np.linspace(0, 1, 6), n_boot=20))


def test_calibration_matches_jax():
    for y, p in _cases():
        for mod in ("brier_score", "reliability_curve",
                    "calibration_errors"):
            _equal(getattr(port_cal, mod)(y, p), getattr(jax_cal, mod)(y, p))
        _equal(port_cal.fit_temperature(y, p), jax_cal.fit_temperature(y, p))
        _equal(port_cal.apply_temperature(p, 1.7),
               jax_cal.apply_temperature(p, 1.7))
    with pytest.raises(ValueError):
        port_cal.fit_temperature(np.ones(5), np.linspace(0, 1, 5))


def test_deployment_matches_jax(tmp_path):
    kw = dict(threshold=0.42, temperature=1.3,
              operating_point={"strategy": "youden"}, source="x")
    port_dep.save_deployment(tmp_path / "p", **kw)
    jax_dep.save_deployment(tmp_path / "j", **kw)
    assert ((tmp_path / "p" / "deployment.json").read_text()
            == (tmp_path / "j" / "deployment.json").read_text())
    for args in ((None, None, False), (0.3, None, False),
                 (None, None, True)):
        assert (port_dep.resolve_deployment(tmp_path / "p", *args)
                == jax_dep.resolve_deployment(tmp_path / "j", *args))
    assert port_dep.load_deployment(tmp_path / "none") == {}


# ------------------------------------------------------------------ plots


def _read_both(path: Path, size):
    with Image.open(path) as img:
        assert img.format == "PNG" and img.size == size
        ref = np.asarray(img.convert("RGB"))
    ours = read_png(path)
    np.testing.assert_array_equal(ours, ref)
    return ours


def test_plots_are_pngs_with_their_elements(tmp_path):
    y, p = _cases()[0]
    pred = (p >= 0.5).astype(int)
    cm = jax_metrics.binary_confusion(y, pred)
    band = port_boot.roc_band(y, p, n_boot=40)
    paths = {
        "cm": port_plots.plot_confusion_matrix(y, pred, "M", tmp_path),
        "roc": port_plots.plot_roc_curve(y, p, "M", tmp_path, band=band),
        "pr": port_plots.plot_precision_recall_curve(y, p, "M", tmp_path),
        "rel": port_plots.plot_reliability_diagram(y, p, "M", tmp_path,
                                                   temperature=1.5)}
    assert sorted(q.name for q in tmp_path.iterdir()) == [
        "confusion_matrix_M.png", "pr_curve_M.png",
        "reliability_diagram_M.png", "roc_curve_M.png"]
    imgs = {k: _read_both(v, port_plots.REL_SIZE if k == "rel"
                          else port_plots.CURVE_SIZE)
            for k, v in paths.items()}

    # the darkest cell (sampled away from its count) holds the most
    ax = port_plots.CM_AXES
    luma = {}
    for i in range(2):
        for j in range(2):
            x, yy = ax.px(j - 0.35, i - 0.35)
            luma[(i, j)] = int(imgs["cm"][int(yy), int(x)].astype(int).sum())
    assert min(luma, key=luma.get) == np.unravel_index(cm.argmax(), cm.shape)

    # the ROC curve's colour at each of its vertices (a vertex on the
    # frame is read at the nearest pixel inside it)
    ax = port_plots.ROC_AXES
    fpr, tpr, _ = jax_metrics.roc_curve(y, p)
    xs, ys = ax.px(fpr, tpr)
    xs = np.clip(np.rint(xs).astype(int), ax.left, ax.right - 1)
    ys = np.clip(np.rint(ys).astype(int), ax.top, ax.bottom - 1)
    assert len(xs) > 10
    for x, yy in zip(xs, ys):
        assert tuple(imgs["roc"][yy, x]) == port_plots.DARKORANGE, (x, yy)
    # the PR curve's colour, the reliability bars and curve are drawn
    for key, color in (("pr", port_plots.GREEN),
                       ("rel", port_plots.STEELBLUE),
                       ("rel", port_plots.C0), ("rel", port_plots.C1)):
        assert (imgs[key] == np.asarray(color, np.uint8)).all(-1).sum() > 500


# -------------------------------------------------------- extended metrics


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A 32² tree and a JAX-written checkpoint of each tiny model, copied
    into one checkpoint root per package."""
    root = tmp_path_factory.mktemp("em")
    data = root / "data"
    counts = {m: {"train": (2, 2), "val": (6, 6), "test": (10, 10)}
              for m in ("rgb", "thermal")}
    make_synthetic_dataset(data, size=32, counts=counts)
    cfg = jax_config.TrainConfig(batch_size=8, compute_dtype="float32",
                                 mesh=jax_config.MeshConfig(data=1))
    mods = {"rgb": jax_config.rgb_modality(),
            "thermal": jax_config.thermal_modality()}
    for k, (ckpt, zoo_name, _) in enumerate(MODELS.values()):
        jt = JaxTrainer(zoo_name, cfg, mods)
        state = jt.init_state(jax.random.PRNGKey(10 + k), image_size=32)
        jax_ckpt.save_checkpoint(
            root / "jax_logs" / ckpt, epoch=1,
            model_state=jt.variables(state), opt_state=state.opt_state,
            val_f1=0.5, history={"val_f1": [0.5]},
            extra_meta={"model": zoo_name})
    shutil.copytree(root / "jax_logs", root / "port_logs")
    return data, root / "jax_logs", root / "port_logs"


ARGS = ["--image-size", "32", "--compute-dtype", "float32", "--seed", "3",
        "--models", "rgb_only", "thermal_only", "multimodal",
        "--model-overrides", "rgb_only=tiny_rgb",
        "--attention-impl", "xla", "--operating-point", "youden",
        "--calibration", "--calibration-bins", "10", "--bootstrap", "40",
        "--bootstrap-alpha", "0.1", "--temperature-from-val",
        "--save-deployment"]


@pytest.fixture(scope="module")
def em_runs(checkpoints):
    data, jax_logs, port_logs = checkpoints
    jax_em.main(["--data-dir", str(data), "--checkpoint-root",
                 str(jax_logs)] + ARGS)
    arrays = {}
    evaluate = port_em.evaluate_model

    def capture(trainer, ckpt_dir, dataset, val_dataset=None):
        out = evaluate(trainer, ckpt_dir, dataset, val_dataset)
        arrays[Path(ckpt_dir).name] = out
        return out

    port_em.evaluate_model = capture
    try:
        port_em.main(["--data-dir", str(data), "--checkpoint-root",
                      str(port_logs), "--device", "cpu"] + ARGS)
    finally:
        port_em.evaluate_model = evaluate
    return jax_logs, port_logs, arrays


def _tree(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file())


@pytest.mark.parametrize("subdir", list(MODELS))
def test_extended_metrics_matches_jax(subdir, em_runs):
    jax_logs, port_logs, arrays = em_runs
    ckpt, _, display = MODELS[subdir]
    ref = load_pt(jax_logs / "extended_metrics" / subdir / "results.pt")
    ours = load_pt(port_logs / "extended_metrics" / subdir / "results.pt")
    assert set(ours) == set(ref) == {"y_true", "y_pred", "y_probs",
                                     "metrics", "operating_point",
                                     "calibration", "bootstrap"}
    np.testing.assert_array_equal(ours["y_true"], ref["y_true"])
    np.testing.assert_allclose(ours["y_probs"], ref["y_probs"], rtol=0,
                               atol=PROB_TOL)
    np.testing.assert_array_equal(ours["y_pred"], ref["y_pred"])

    # the port's payload is what the JAX functions make of its arrays
    a = arrays[ckpt]
    yt, yp, pr = a["y_true"], a["y_pred"], a["y_probs"]
    _equal(ours["metrics"], jax_metrics.compute_all_metrics(yt, yp, pr))
    t, info = jax_thr.pick_threshold(a["val_y_true"], a["val_y_probs"],
                                     "youden")
    _equal(ours["operating_point"], {
        "info": info, "metrics": jax_metrics.compute_all_metrics(
            yt, jax_thr.apply_threshold(pr, t), pr)})
    temp, tinfo = jax_cal.fit_temperature(a["val_y_true"], a["val_y_probs"])
    scaled = jax_cal.apply_temperature(pr, temp)
    _equal(ours["calibration"], {
        "errors": jax_cal.calibration_errors(yt, pr, 10),
        "temperature": tinfo,
        "errors_after": jax_cal.calibration_errors(yt, scaled, 10),
        "y_probs_scaled": scaled})
    _equal(ours["bootstrap"], jax_boot.bootstrap_cis(
        yt, yp, pr, n_boot=40, alpha=0.1, seed=3))
    dep = json.loads((port_logs / ckpt / "deployment.json").read_text())
    t_dep, _ = jax_thr.pick_threshold(
        a["val_y_true"], jax_cal.apply_temperature(a["val_y_probs"], temp),
        "youden")
    assert dep["threshold"] == t_dep and dep["temperature"] == temp
    ref_dep = json.loads((jax_logs / ckpt / "deployment.json").read_text())
    assert set(dep) == set(ref_dep)
    assert dep["temperature"] == pytest.approx(ref_dep["temperature"],
                                               rel=1e-3)
    for name in ("confusion_matrix", "roc_curve", "pr_curve",
                 "reliability_diagram"):
        path = port_logs / "extended_metrics" / subdir / f"{name}_{display}.png"
        _read_both(path, port_plots.REL_SIZE if name == "reliability_diagram"
                   else port_plots.CURVE_SIZE)


def test_extended_metrics_summary_and_files_match_jax(em_runs):
    jax_logs, port_logs, _ = em_runs
    assert _tree(port_logs) == _tree(jax_logs)
    summary = [(d / "extended_metrics" / "EVALUATION_SUMMARY.txt")
               .read_text().splitlines() for d in (jax_logs, port_logs)]
    assert [x for x in summary[0] if not x.startswith("Date:")] == [
        x for x in summary[1] if not x.startswith("Date:")]
    assert len(summary[1]) > 20
