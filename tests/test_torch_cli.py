"""The port's train CLIs end to end on the CPU, and the host modules they
use, against the JAX package.

- The three CLIs (``--device cpu``, the ``tiny_*`` models) on a tree the
  port's ``make_synthetic_dataset`` wrote, in the shape of
  ``tests/test_cli_smoke.py``: the artifact contract (``best_model.pt`` /
  ``last_model.pt`` with their meta JSON, ``test_results.pt`` with the six
  keys and read by JAX's ``load_pt``, ``run_info.json``, the drift
  baseline equal to JAX's), ``--resume`` continuing at the next epoch,
  the leakage gate refusing a duplicated image, ``--device cuda`` on a
  host without a card refusing.
- ``compute_all_metrics``, ``baseline_from_arrays``, ``save_pt`` /
  ``load_pt`` both ways, the argparse glue, and the tiny models' forward
  and one train step through the weight bridge, each against JAX.
- The slice's modules import, and decode a JPEG and a PNG, in a process
  where PIL, torchvision, jax, flax, optax, matplotlib, scikit-learn,
  OpenCV and the JAX package cannot be imported; there a raw download is
  organised, standardized and evaluated by ``extended_metrics --device
  cpu``.
"""

import argparse
import dataclasses
import json
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfu_multimodal_tpu import config as jax_config
from dfu_multimodal_tpu.eval import drift as jax_drift
from dfu_multimodal_tpu.eval import metrics as jax_metrics
from dfu_multimodal_tpu.models import zoo as jax_zoo
from dfu_multimodal_tpu.train.engine import Trainer as JaxTrainer
from dfu_multimodal_tpu.utils import artifacts as jax_artifacts
from dfu_multimodal_tpu_torch import config as port_config
from dfu_multimodal_tpu_torch import native
from dfu_multimodal_tpu_torch.data.synthetic import make_synthetic_dataset
from dfu_multimodal_tpu_torch.eval import drift as port_drift
from dfu_multimodal_tpu_torch.eval import metrics as port_metrics
from dfu_multimodal_tpu_torch.models import zoo as port_zoo
from dfu_multimodal_tpu_torch.tools.convert_jax import variables_to_state_dict
from dfu_multimodal_tpu_torch.train import engine as port_engine
from dfu_multimodal_tpu_torch.utils import artifacts as port_artifacts

REPO_ROOT = Path(__file__).resolve().parents[1]
SMOKE = ["--image-size", "32", "--batch-size", "8", "--lr", "3e-3",
         "--compute-dtype", "float32", "--device", "cpu",
         "--save-best-after", "1"]
CLIS = {"rgb_only": ("train_rgb_only", "tiny_rgb"),
        "thermal_only": ("train_thermal_only", "tiny_thermal"),
        "multimodal": ("train_multimodal_fusion", "tiny_fusion")}
TEST_KEYS = {"test_preds", "test_labels", "test_probs", "test_acc",
             "test_f1", "test_loss"}

torch.set_num_threads(1)


def _main(name):
    module = __import__(f"dfu_multimodal_tpu_torch.cli.{CLIS[name][0]}",
                        fromlist=["main"])
    return module.main


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli") / "data"
    make_synthetic_dataset(root, images_per_class=10, size=32)
    return root


@pytest.mark.parametrize("name", list(CLIS))
def test_train_cli_writes_the_artifact_contract(name, data, tmp_path,
                                                capsys):
    logs = tmp_path / "logs"
    res = _main(name)(["--data-dir", str(data), "--checkpoint-root",
                       str(logs), "--model", CLIS[name][1], "--epochs", "2",
                       "--save-last", "--log-jsonl",
                       str(tmp_path / "log.jsonl")] + SMOKE)
    out = capsys.readouterr().out
    assert {"best_val_f1", "test_acc", "test_f1", "test_loss"} <= set(res)
    ckpt = logs / f"checkpoints_{name}"
    for base in ("best_model", "last_model"):
        if base == "best_model" and not (ckpt / "best_model.pt").exists():
            assert "WARNING: no best_model checkpoint" in out
            continue
        assert (ckpt / f"{base}.pt").exists()
        meta = json.loads((ckpt / f"{base}.meta.json").read_text())
        assert meta["model"] == CLIS[name][1]
    if (ckpt / "best_model.pt").exists():
        assert f"Best model saved to: {ckpt / 'best_model.pt'}" in out
    for reader in (port_artifacts.load_pt, jax_artifacts.load_pt):
        saved = reader(ckpt / "test_results.pt")
        assert set(saved) == TEST_KEYS
        assert len(saved["test_preds"]) == len(saved["test_labels"]) \
            == len(saved["test_probs"])
    assert saved["test_acc"] == pytest.approx(res["test_acc"])
    info = json.loads((ckpt / "run_info.json").read_text())
    assert info["recipe"] == name and info["backend"] == "cpu"
    assert {"torch_version", "cuda_version", "device_name", "argv",
            "config", "python"} <= set(info)
    assert info["config"]["num_epochs"] == 2
    baseline = jax_drift.load_baseline(ckpt / "drift_baseline.json")
    jax_drift._validate_baseline(baseline)
    mods = ("rgb", "thermal") if name == "multimodal" else \
        (name.split("_")[0],)
    assert sorted(baseline["modalities"]) == sorted(mods)
    lines = (tmp_path / "log.jsonl").read_text().splitlines()
    assert [json.loads(x)["epoch"] for x in lines] == [1, 2]
    assert native.describe() in out
    if name == "multimodal":
        assert "Total parameters: 110,880,834" in out


def test_resume_continues_at_the_next_epoch(data, tmp_path, capsys):
    argv = ["--data-dir", str(data), "--checkpoint-root", str(tmp_path),
            "--model", "tiny_fusion", "--save-last"] + SMOKE
    _main("multimodal")(argv + ["--epochs", "2"])
    capsys.readouterr()
    _main("multimodal")(argv + ["--epochs", "3", "--resume"])
    out = capsys.readouterr().out
    assert "at epoch 3" in out
    assert "[Epoch 3/3]" in out and "[Epoch 1/3]" not in out
    meta = json.loads((tmp_path / "checkpoints_multimodal"
                       / "last_model.meta.json").read_text())
    assert meta["epoch"] == 3 and len(meta["history"]["val_f1"]) == 3


def test_leakage_gate_refuses_a_duplicate(data, tmp_path):
    from dfu_multimodal_tpu_torch.data.leakage import LeakageError
    leaky = tmp_path / "data"
    shutil.copytree(data, leaky)
    src = sorted((leaky / "rgb" / "train" / "ulcer").glob("*.jpg"))[0]
    shutil.copy(src, leaky / "rgb" / "test" / "ulcer" / "dup.jpg")
    with pytest.raises(LeakageError, match="leakage"):
        _main("rgb_only")(["--data-dir", str(leaky), "--checkpoint-root",
                           str(tmp_path / "logs"), "--model", "tiny_rgb",
                           "--epochs", "1"] + SMOKE)
    assert not (tmp_path / "logs" / "checkpoints_rgb_only"
                / "test_results.pt").exists()


def test_cuda_device_without_a_card_refuses(data, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--data-dir", str(data), "--checkpoint-root", str(tmp_path),
            "--model", "tiny_rgb", "--epochs", "1"] + SMOKE
    argv[argv.index("cpu")] = "cuda"
    with pytest.raises(SystemExit, match="--device cpu"):
        _main("rgb_only")(argv)


# ----------------------------------------------------------- host modules


@pytest.mark.parametrize("case", ["random", "one_class", "no_probs",
                                  "ties"])
def test_compute_all_metrics_matches_jax(case):
    rng = np.random.default_rng(8)
    y_true = rng.integers(0, 2, 40)
    y_pred = rng.integers(0, 2, 40)
    probs = rng.random(40)
    if case == "one_class":
        y_true = np.ones(40, np.int64)
    if case == "ties":
        probs = np.round(probs, 1)
    if case == "no_probs":
        probs = None
    a = jax_metrics.compute_all_metrics(y_true, y_pred, probs)
    b = port_metrics.compute_all_metrics(y_true, y_pred, probs)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k])
        elif isinstance(a[k], float) and np.isnan(a[k]):
            assert np.isnan(b[k]), k
        else:
            assert a[k] == b[k], k
    if probs is not None:
        for fn in ("roc_curve", "precision_recall_curve"):
            for x, y in zip(getattr(jax_metrics, fn)(y_true, probs),
                            getattr(port_metrics, fn)(y_true, probs)):
                np.testing.assert_array_equal(x, y)


def test_print_report_matches_jax(capsys):
    rng = np.random.default_rng(9)
    m = port_metrics.compute_all_metrics(rng.integers(0, 2, 30),
                                         rng.integers(0, 2, 30),
                                         rng.random(30))
    jax_metrics.print_report(m, "x")
    ref = capsys.readouterr().out
    port_metrics.print_report(m, "x")
    assert capsys.readouterr().out == ref


def test_drift_baseline_matches_jax(tmp_path):
    rng = np.random.default_rng(10)
    arrays = {"rgb": rng.integers(0, 256, (5, 8, 8, 3), np.uint8),
              "thermal": rng.integers(0, 256, (5, 8, 8, 3), np.uint8)}
    paths = {"rgb": ["a", None, "b", "c", None],
             "thermal": [None] * 5}
    a = jax_drift.baseline_from_arrays(arrays, paths)
    b = port_drift.baseline_from_arrays(arrays, paths)
    assert a == b and list(b["modalities"]) == ["rgb"]
    np.testing.assert_array_equal(port_drift.channel_histograms(arrays["rgb"]),
                                  jax_drift.channel_histograms(arrays["rgb"]))
    port_drift.save_baseline(tmp_path / "b.json", b)
    assert jax_drift.load_baseline(tmp_path / "b.json") == a
    assert port_drift.load_baseline(tmp_path / "none.json") is None
    port_drift._validate_baseline(b)
    with pytest.raises(ValueError, match="bins"):
        port_drift._validate_baseline({**b, "bins": 16})


def test_artifacts_round_trip_with_jax(tmp_path):
    payload = {"test_preds": np.array([0, 1, 1]), "test_acc": 0.5,
               "test_probs": torch.tensor([0.1, 0.9, 0.6]),
               "nested": {"x": [np.float32(1.5), "s"]}}
    port_artifacts.save_pt(payload, tmp_path / "port.pt")
    back = jax_artifacts.load_pt(tmp_path / "port.pt")
    np.testing.assert_array_equal(back["test_preds"], [0, 1, 1])
    np.testing.assert_allclose(back["test_probs"], [0.1, 0.9, 0.6])
    assert back["test_acc"] == 0.5 and back["nested"]["x"][1] == "s"
    jax_artifacts.save_pt({"a": np.arange(3), "b": 2.0},
                          tmp_path / "jax.pt")
    got = port_artifacts.load_pt(tmp_path / "jax.pt")
    np.testing.assert_array_equal(got["a"], np.arange(3))
    assert got["b"] == 2.0
    import pickle
    (tmp_path / "raw.pt").write_bytes(pickle.dumps({"old": 1}))
    assert port_artifacts.load_pt(tmp_path / "raw.pt") == {"old": 1}


@pytest.mark.parametrize("argv", [
    [],
    ["--data-dir", "d", "--batch-size", "4", "--epochs", "7", "--lr", "2e-3",
     "--weight-decay", "0.01", "--seed", "3", "--save-best-after", "1",
     "--compute-dtype", "float32", "--optimizer-mu-dtype", "float32",
     "--lr-schedule", "cosine", "--warmup-epochs", "0.5", "--grad-accum",
     "2", "--ema-decay", "0.99", "--early-stop-patience", "2",
     "--save-last", "--async-checkpoint", "--loss", "focal",
     "--focal-gamma", "1.5", "--mixup-alpha", "0.2", "--checkpoint-root",
     "out", "--cache-dir", "c"],
], ids=["defaults", "every_flag"])
def test_argparse_glue_matches_jax(argv, monkeypatch):
    """The same argv through both packages' add_common_args gives equal
    TrainConfig and DataConfig fields (the port adds only --device and
    --mesh-model), and the same help text for every shared flag."""
    # data_config_from_args exports --cache-dir process-wide: set the
    # variable through monkeypatch first, so teardown unsets it again and
    # later tests in this worker do not decode into a relative cache dir
    monkeypatch.setenv("DFU_CACHE_DIR", "")
    monkeypatch.delenv("DFU_CACHE_DIR")
    parsers = []
    for mod in (jax_config, port_config):
        p = argparse.ArgumentParser()
        mod.add_common_args(p)
        parsers.append(p)
    ja, pa = parsers[0].parse_args(argv), parsers[1].parse_args(argv)
    assert pa.device == "cuda"
    defaults = dict(batch_size=6)
    jt = jax_config.train_config_from_args(
        ja, jax_config.TrainConfig(**defaults))
    pt = port_config.train_config_from_args(
        pa, port_config.TrainConfig(**defaults))
    assert dataclasses.asdict(jt) == dataclasses.asdict(pt)
    assert dataclasses.asdict(jax_config.data_config_from_args(ja)) == \
        dataclasses.asdict(port_config.data_config_from_args(pa))
    jax_help = {a.dest: (a.help, a.default) for a in parsers[0]._actions}
    port_help = {a.dest: (a.help, a.default) for a in parsers[1]._actions}
    assert set(port_help) - set(jax_help) == {"device", "mesh_model"}
    assert all(port_help[k] == v for k, v in jax_help.items())


# ------------------------------------------------------------ tiny models


def _neutral(mod, name):
    aug = mod.AugmentConfig(horizontal_flip_prob=0.0, vertical_flip_prob=0.0,
                            rotation_degrees=0.0, aug_prob=0.0,
                            affine_degrees=0.0)
    make = {"rgb": mod.rgb_modality, "thermal": mod.thermal_modality}
    return {m: dataclasses.replace(make[m](), augment=aug)
            for m in port_zoo.get(name).inputs}


@pytest.mark.parametrize("name", ["tiny_rgb", "tiny_fusion"])
def test_tiny_models_match_jax(name):
    """Forward (eval) and one train step (fp32, no dropout, identity
    augmentation, BatchNorm statistics) through the weight bridge: logits
    and loss within 1e-5, BatchNorm statistics and first moments within
    1e-5 of each tensor's largest entry (a zero gradient's moment within
    1e-8), parameters within 2·lr."""
    size, lr = 18, 1e-3                      # 18 -> 9: both SAME paddings
    cfg = dict(batch_size=6, compute_dtype="float32",
               optimizer_mu_dtype="float32", drop_rate=0.0,
               learning_rate=lr, seed=0)
    weights = np.array([0.75, 1.5], np.float32)
    jt = JaxTrainer(name, jax_config.TrainConfig(
        **cfg, mesh=jax_config.MeshConfig(data=1)),
        _neutral(jax_config, name), class_weights=weights)
    state = jt.init_state(jax.random.PRNGKey(0), image_size=size)
    variables = jax.tree.map(np.asarray, {"params": state.params,
                                          "batch_stats": state.batch_stats})
    pt = port_engine.Trainer(name, port_config.TrainConfig(**cfg),
                             _neutral(port_config, name),
                             class_weights=weights, device="cpu",
                             image_size=size)
    pt.module.load_state_dict(variables_to_state_dict(name, variables))
    rng = np.random.default_rng(11)
    batch = {m: rng.integers(0, 256, (6, size, size, 3), np.uint8)
             for m in port_zoo.get(name).inputs}
    batch["label"] = np.arange(6, dtype=np.int32) % 2
    batch["valid"] = np.r_[np.ones(5), 0.0].astype(np.float32)

    module, spec = jax_zoo.build(name, drop_rate=0.0)
    ref = jax_zoo.apply_model(module, spec, variables, {
        m: jnp.asarray(port_engine.eval_normalize(
            torch.from_numpy(batch[m]), _neutral(port_config, name)[m],
            torch.float32).numpy()) for m in spec.inputs}, train=False)
    pt.module.eval()
    with torch.no_grad():
        ours = pt.module(*pt._preprocess_eval(
            {m: torch.from_numpy(batch[m]) for m in spec.inputs}))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)

    state, jm = jt.train_step(state, jax.device_put(batch, jt.batch_sharding),
                              jax.random.PRNGKey(1))
    pm = pt.train_step(batch, torch.Generator().manual_seed(0))
    assert float(pm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    after = variables_to_state_dict(name, jax.tree.map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats}))
    sd = pt.module.state_dict()
    for k, v in after.items():
        if k.endswith("num_batches_tracked"):
            continue
        atol = (1e-5 * float(np.abs(v.numpy()).max())
                if "running" in k else 2 * lr)
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=0,
                                   atol=atol, err_msg=k)
    mu = variables_to_state_dict(name, {"params": jax.tree.map(
        np.asarray, state.opt_state[0].mu)})
    ours_mu = pt.optimizer.state_dict()["mu"]
    for k, v in mu.items():
        # a conv bias before BatchNorm has a zero gradient up to rounding
        # (~1e-10 here): hold those at 1e-8
        v = v.numpy()
        np.testing.assert_allclose(
            ours_mu[k].numpy(), v, rtol=0,
            atol=max(1e-5 * float(np.abs(v).max()), 1e-8), err_msg=k)


# --------------------------------------------------------------- imports

NO_PIL_SCRIPT = r"""
import sys
BLOCKED = ("PIL", "torchvision", "jax", "jaxlib", "flax", "optax",
           "matplotlib", "sklearn", "cv2", "dfu_multimodal_tpu")
for name in BLOCKED:
    sys.modules[name] = None            # any import of them now fails
import importlib, pkgutil
from pathlib import Path
import numpy as np
import dfu_multimodal_tpu_torch
for mod in ("native", "config", "data.layout", "data.pairing",
            "data.leakage", "data.cache", "data.png", "data.loader",
            "data.synthetic", "eval.metrics", "eval.drift",
            "utils.artifacts", "models.tiny", "models.zoo",
            "cli._train_common", "cli.train_rgb_only",
            "cli.train_thermal_only", "cli.train_multimodal_fusion",
            "tools.splits", "tools.organize", "tools.verify",
            "tools.analyze", "tools.standardize", "tools.prepare_legacy",
            "eval.threshold", "eval.bootstrap", "eval.calibration",
            "eval.deployment", "eval.plots", "eval.tta",
            "cli.organize_clean_dataset", "cli.dataset_tools",
            "cli.extended_metrics", "cli.test_time_augmentation",
            "cli.ablation_study", "eval.gradcam", "eval.vit_attribution",
            "serve.explain", "serve.prometheus", "serve.http",
            "cli.grad_cam_visualization", "cli.serve", "cli.predict"):
    importlib.import_module(f"dfu_multimodal_tpu_torch.{mod}")
import torch
from dfu_multimodal_tpu_torch import native
from dfu_multimodal_tpu_torch.cli import (dataset_tools, extended_metrics,
                                          organize_clean_dataset)
from dfu_multimodal_tpu_torch.data.loader import decode_raw
from dfu_multimodal_tpu_torch.models import zoo
from dfu_multimodal_tpu_torch.utils.checkpoint import save_checkpoint
tmp = Path(sys.argv[1])
img = (np.arange(24 * 30 * 3) % 251).astype(np.uint8).reshape(24, 30, 3)
native.encode_jpeg(img, tmp / "a.jpg", 90)
(tmp / "b.png").write_bytes(bytes.fromhex(sys.argv[2]))
out = decode_raw([tmp / "a.jpg", tmp / "b.png"], 16)
assert out.shape == (2, 16, 16, 3) and out[0].any() and out[1].any()

# a raw download -> an organised tree -> standardized -> evaluated
rng = np.random.default_rng(0)
dirs = {"rgb": ("DFU_RGB/Patches/Normal", "DFU_RGB/Patches/Abnormal"),
        "thermal": ("DFU_Thermal/ThermoDataBase/train/Control Group",
                    "DFU_Thermal/ThermoDataBase/train/DM Group")}
for pair in dirs.values():
    for c, d in enumerate(pair):
        (tmp / d).mkdir(parents=True)
        for i in range(8):
            im = rng.integers(0, 256, (20, 28, 3), np.uint8)
            im[..., 0] = 60 + 150 * c
            native.encode_jpeg(im, tmp / d / f"{i}.jpg", 90)
(tmp / "DFU_RGB/TestSet").mkdir()
(tmp / "DFU_RGB/TestSet/x.png").write_bytes(bytes.fromhex(sys.argv[2]))
res = organize_clean_dataset.main([
    "--rgb-source", str(tmp / "DFU_RGB"), "--thermal-source",
    str(tmp / "DFU_Thermal"), "--output", str(tmp / "data")])
assert res["rgb"].healthy == 8 and res["rgb"].ulcer == 9
std = dataset_tools.main(["standardize", "--src", str(tmp / "data" / "rgb"),
                          "--dst", str(tmp / "std" / "rgb"), "--target",
                          "16", "--verify"])
assert std == {"processed": 17, "errors": 0, "ok": 17, "bad": 0}, std
module, _ = zoo.build("tiny_rgb")
zoo.init_model(module, torch.Generator().manual_seed(0))
save_checkpoint(tmp / "logs" / "checkpoints_rgb_only", epoch=1,
                model_state=module.state_dict(), opt_state=None, val_f1=0.5,
                history={}, extra_meta={"model": "tiny_rgb"})
extended_metrics.main(["--data-dir", str(tmp / "std"), "--checkpoint-root",
                       str(tmp / "logs"), "--models", "rgb_only",
                       "--image-size", "16", "--compute-dtype", "float32",
                       "--calibration", "--bootstrap", "10", "--device",
                       "cpu"])
em = tmp / "logs" / "extended_metrics" / "rgb_only"
assert sorted(p.name for p in em.iterdir()) == [
    "confusion_matrix_RGB-Only.png", "pr_curve_RGB-Only.png",
    "reliability_diagram_RGB-Only.png", "results.pt",
    "roc_curve_RGB-Only.png"], sorted(em.iterdir())

# an explanation, then an HTTP predict and explain round trip
import base64, json, threading, urllib.request
from dfu_multimodal_tpu_torch.cli import grad_cam_visualization, serve
from dfu_multimodal_tpu_torch.data.png import decode_png
assert grad_cam_visualization.main([
    "--data-dir", str(tmp / "std"), "--checkpoint-root", str(tmp / "logs"),
    "--models", "rgb_only", "--image-size", "16", "--num-per-class", "1",
    "--device", "cpu"]) == {"rgb_only": 2}
server, router, _ = serve.build_daemon([
    "--checkpoint", str(tmp / "logs" / "checkpoints_rgb_only"), "--device",
    "cpu", "--image-size", "16", "--host", "127.0.0.1", "--port", "0",
    "--explain", "--max-batch", "2", "--compute-dtype", "float32"])
threading.Thread(target=server.serve_forever, daemon=True).start()
url = f"http://127.0.0.1:{server.server_address[1]}/v1/"
jpeg = (tmp / "a.jpg").read_bytes()
for op, body, ctype in (
        ("predict", jpeg, "image/jpeg"),
        ("explain", json.dumps({"rgb": base64.b64encode(jpeg).decode()})
         .encode(), "application/json")):
    req = urllib.request.Request(url + op, data=body,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=60) as r:
        res = json.loads(r.read())
    assert 0.0 <= res["prob_ulcer"] <= 1.0, res
overlay = decode_png(base64.b64decode(
    res["explanations"]["rgb"]["overlay_png"]))
assert overlay.shape == (16, 16, 3)
server.shutdown()
server.server_close()
router.stop()
loaded = [m for m, v in sys.modules.items() if v is not None
          and m.split(".")[0] in BLOCKED]
assert not loaded, loaded
print("ok")
"""


def test_slice_imports_and_decodes_without_pil_or_jax(tmp_path):
    from PIL import Image
    png = tmp_path / "src.png"
    Image.fromarray(np.full((9, 7, 3), 100, np.uint8)).save(png)
    proc = subprocess.run(
        [sys.executable, "-c", NO_PIL_SCRIPT, str(tmp_path),
         png.read_bytes().hex()], cwd=REPO_ROOT, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
