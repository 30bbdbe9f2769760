"""The port's explaining serving surface against the JAX package's, on
the CPU: the Explainer, the engine's explain queue and deployment tuning,
DriftMonitor, the Prometheus text, the HTTP daemon and the serve and
predict CLIs.

Models are the tiny ones at 32² and a depth-2 ViT ``thermal_only``, with
weights from JAX (``tools/convert_jax.py``, or a JAX-written msgpack
checkpoint the port reads).  Budgets: probabilities within 1e-5, CAMs
within 1e-3 of JAX's (each is divided by its max), drift reports and
Prometheus text equal.

HTTP tests bind ``127.0.0.1:0``, give every request a timeout, stop their
servers in fixtures, and assert nothing about requests other tests made.
"""

import base64
import csv
import json
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfu_multimodal_tpu import config as jax_config
from dfu_multimodal_tpu.cli import predict as jax_predict
from dfu_multimodal_tpu.eval import drift as jax_drift
from dfu_multimodal_tpu.models.vit import ViT as JaxViT
from dfu_multimodal_tpu.serve import prometheus as jax_prom
from dfu_multimodal_tpu.serve.engine import ServingEngine as JaxEngine
from dfu_multimodal_tpu.serve.explain import Explainer as JaxExplainer
from dfu_multimodal_tpu.train.engine import Trainer as JaxTrainer
from dfu_multimodal_tpu.utils import checkpoint as jax_ckpt
from dfu_multimodal_tpu_torch import config as port_config
from dfu_multimodal_tpu_torch.cli import predict as port_predict
from dfu_multimodal_tpu_torch.cli import serve as port_serve
from dfu_multimodal_tpu_torch.data.loader import (DecodeError, decode_bytes,
                                                  load_image)
from dfu_multimodal_tpu_torch.data.png import decode_png, write_png
from dfu_multimodal_tpu_torch.data.synthetic import make_synthetic_dataset
from dfu_multimodal_tpu_torch.eval import drift as port_drift
from dfu_multimodal_tpu_torch.serve import prometheus as port_prom
from dfu_multimodal_tpu_torch.serve.engine import (EngineOverloaded,
                                                   ExplainUnavailable,
                                                   ServingEngine)
from dfu_multimodal_tpu_torch.serve.explain import Explainer
from dfu_multimodal_tpu_torch.serve.http import make_server
from dfu_multimodal_tpu_torch.tools.convert_jax import variables_to_state_dict
from dfu_multimodal_tpu_torch.train.engine import Trainer

torch.set_num_threads(1)

SIZE = 32
VIT = dict(depth=2, hidden_dim=128, num_heads=2, patch_size=8)
PROB_TOL, CAM_TOL = 1e-5, 1e-3
INPUTS = {"tiny_rgb": ("rgb",), "tiny_fusion": ("rgb", "thermal"),
          "thermal_only": ("thermal",)}


class TinyJaxViTClassifier(fnn.Module):
    """``ViTClassifier``'s scopes at toy width (hidden 128 = 2 heads of
    64, the head count JAX's explainer infers from the shapes)."""

    @fnn.compact
    def __call__(self, x, *, train: bool = False, taps=None):
        feats = JaxViT(block_impl="flax", attention_impl="xla", name="ViT_0",
                       **VIT)(x, train=train, taps=taps)
        return fnn.Dense(2, dtype=jnp.float32, name="head")(feats)


def _mods(cfg_mod, name):
    fns = {"rgb": cfg_mod.rgb_modality, "thermal": cfg_mod.thermal_modality}
    return {m: fns[m]() for m in INPUTS[name]}


@pytest.fixture(scope="module")
def pairs():
    """name -> (JAX trainer, state, port trainer on the same weights)."""
    out = {}
    for k, name in enumerate(INPUTS):
        cfg = jax_config.TrainConfig(batch_size=8, eval_batch_size=8,
                                     compute_dtype="float32",
                                     mesh=jax_config.MeshConfig(data=1))
        jt = JaxTrainer(name, cfg, _mods(jax_config, name))
        kw = {}
        if name == "thermal_only":
            jt.module = TinyJaxViTClassifier()
            kw = VIT
        state = jt.init_state(jax.random.PRNGKey(40 + k), image_size=SIZE)
        pt = Trainer(name, port_config.TrainConfig(compute_dtype="float32"),
                     _mods(port_config, name), device="cpu",
                     image_size=SIZE, **kw)
        pt.module.load_state_dict(variables_to_state_dict(
            name, jax.tree.map(np.asarray, jt.variables(state))))
        out[name] = (jt, state, pt)
    return out


def _images(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8)


def _assert_explained(ours, ref):
    np.testing.assert_allclose(ours["probs"], ref["probs"], rtol=0,
                               atol=PROB_TOL)
    assert ours["class_explained"] == ref["class_explained"]
    assert set(ours["cams"]) == set(ref["cams"])
    for m, c in ours["cams"].items():
        assert c["method"] == ref["cams"][m]["method"]
        np.testing.assert_allclose(c["cam"], ref["cams"][m]["cam"], rtol=0,
                                   atol=CAM_TOL, err_msg=m)


@pytest.mark.parametrize("name,method,provided", [
    ("tiny_rgb", "saliency", ("rgb",)),
    ("tiny_fusion", "saliency", ("rgb", "thermal")),
    ("tiny_fusion", "saliency", ("thermal",)),
    ("thermal_only", "saliency", ("thermal",)),
    ("thermal_only", "rollout", ("thermal",)),
    ("thermal_only", "chefer", ("thermal",))])
def test_explainer_matches_jax(pairs, name, method, provided):
    jt, state, pt = pairs[name]
    imgs = _images(len(provided), seed=sum(map(ord, name + method)))
    sample = dict(zip(provided, imgs))
    for ci in ("pred", 0, 1):
        ref = JaxExplainer(jt, state, class_index=ci,
                           cam_method=method).explain_one(sample)
        ours = Explainer(pt, class_index=ci,
                         cam_method=method).explain_one(sample)
        _assert_explained(ours, ref)
    assert all(p.grad is None and p.requires_grad
               for p in pt.module.parameters())


def test_explainer_refuses_transformer_method_without_vit(pairs):
    with pytest.raises(ValueError, match="needs a ViT branch"):
        Explainer(pairs["tiny_rgb"][2], cam_method="rollout")


@pytest.mark.parametrize("name,method", [("tiny_rgb", "saliency"),
                                         ("thermal_only", "rollout")])
def test_borderline_reexplain_matches_jax(pairs, name, method):
    """A threshold that overrules the argmax: the engine explains the
    served class (or, rollout being class-agnostic, relabels the map),
    as JAX's engine does; temperature-scaled P(ulcer) equal."""
    jt, state, pt = pairs[name]
    img = _images(1, seed=6)[0]
    sample = {INPUTS[name][0]: img}
    argmax = int(np.argmax(Explainer(pt).explain_one(sample)["probs"]))
    thr = 0.0 if argmax == 0 else 2.0
    outs = []
    for eng in (
            JaxEngine(jt, state, image_size=SIZE, max_batch=2, threshold=thr,
                      temperature=1.7,
                      explainer=JaxExplainer(jt, state, cam_method=method)),
            ServingEngine(pt, image_size=SIZE, max_batch=2, threshold=thr,
                          temperature=1.7,
                          explainer=Explainer(pt, cam_method=method))):
        fut = eng.submit_explain(sample)
        eng._run_explains()             # the batcher thread's step
        outs.append(fut.result(timeout=0))
        eng.stop()
    ref, ours = outs
    assert ours["prediction"] == ref["prediction"] == 1 - argmax
    assert ours["class_explained"] == ref["class_explained"] == 1 - argmax
    assert ours["prob_ulcer"] == pytest.approx(ref["prob_ulcer"], abs=1e-5)
    for m, c in ours["cams"].items():
        np.testing.assert_allclose(c["cam"], ref["cams"][m]["cam"], rtol=0,
                                   atol=CAM_TOL)


def test_engine_threshold_temperature_and_stats(pairs):
    _, _, pt = pairs["tiny_rgb"]
    imgs = _images(3, seed=9)
    raw = pt.eval_step({"rgb": imgs})["probs"].numpy()
    with ServingEngine(pt, image_size=SIZE, max_batch=4, threshold=0.4,
                       temperature=2.0) as eng:
        served = eng.predict([{"rgb": i} for i in imgs])
        stats = eng.stats()
    z = np.log(raw) - np.log1p(-raw)
    want = 1 / (1 + np.exp(-z / 2.0))
    np.testing.assert_allclose([p for p, _ in served], want, atol=1e-6)
    assert [d for _, d in served] == (want >= 0.4).astype(int).tolist()
    assert stats["explains"] == 0 and stats["explain_enabled"] is False
    eng = ServingEngine(pt, image_size=SIZE, max_batch=2)
    with pytest.raises(ExplainUnavailable):
        eng.submit_explain({"rgb": imgs[0]})


# ------------------------------------------------------ drift, prometheus


def test_drift_monitor_matches_jax():
    base = _images(12, seed=1)
    baseline = jax_drift.baseline_from_arrays({"rgb": base})
    assert port_drift.baseline_from_arrays({"rgb": base}) == baseline
    ours, ref = (port_drift.DriftMonitor(baseline, min_images=4,
                                         window_images=6),
                 jax_drift.DriftMonitor(baseline, min_images=4,
                                        window_images=6))
    assert ours.report() == ref.report()
    for k in range(5):
        batch = _images(2, seed=10 + k) // (k + 1)    # drifting darker
        for mon in (ours, ref):
            mon.update("rgb", batch)
            mon.update("thermal", batch[0])
        assert ours.report() == ref.report(), k
    assert port_drift.psi([1, 2, 3], [3, 2, 1]) == jax_drift.psi(
        [1, 2, 3], [3, 2, 1])
    with pytest.raises(ValueError, match="bins"):
        port_drift.DriftMonitor({"bins": 16, "modalities": {}})


class _Stats:
    def __init__(self, stats):
        self._stats = stats

    def stats(self):
        return self._stats


def test_render_prometheus_matches_jax():
    mon = port_drift.DriftMonitor(
        port_drift.baseline_from_arrays({"rgb": _images(8, seed=2)}),
        min_images=1)
    mon.update("rgb", _images(3, seed=3))
    stats = [{"model": "a", "requests": 7, "errors": 1, "rejected": 2,
              "explains": 3, "queue_depth": 0,
              "latency_ms": {"p50": 1.5, "p90": 2.0, "p99": 3.25},
              "batch_size_hist": {1: 4, 3: 1}, "drift": mon.report()},
             {"model": "b", "requests": 0, "errors": 0, "rejected": 0,
              "queue_depth": 5, "batch_size_hist": {}}]

    class Router:
        engines = {s["model"]: _Stats(s) for s in stats}

    text = port_prom.render_prometheus(Router)
    assert text == jax_prom.render_prometheus(Router)
    assert 'dfu_drift_verdict{modality="rgb",verdict=' in text


# ---------------------------------------------------------------- HTTP


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A 32² tree, JAX-written checkpoints of tiny_rgb and tiny_thermal
    (with the port's drift baseline beside each), and their JAX
    trainers."""
    root = tmp_path_factory.mktemp("serve")
    data = root / "data"
    counts = {m: {"train": (1, 1), "val": (1, 1), "test": (3, 3)}
              for m in ("rgb", "thermal")}
    make_synthetic_dataset(data, size=SIZE, counts=counts)
    cfg = jax_config.TrainConfig(batch_size=8, compute_dtype="float32",
                                 mesh=jax_config.MeshConfig(data=1))
    for k, (ckpt, name, mod) in enumerate((
            ("checkpoints_rgb_only", "tiny_rgb", "rgb"),
            ("checkpoints_thermal_only", "tiny_thermal", "thermal"))):
        jt = JaxTrainer(name, cfg, {mod: getattr(jax_config,
                                                 f"{mod}_modality")()})
        state = jt.init_state(jax.random.PRNGKey(50 + k), image_size=SIZE)
        jax_ckpt.save_checkpoint(root / "logs" / ckpt, epoch=1,
                                 model_state=jt.variables(state),
                                 opt_state=state.opt_state, val_f1=0.5,
                                 history={}, extra_meta={"model": name})
        port_drift.save_baseline(
            root / "logs" / ckpt / port_drift.BASELINE_FILENAME,
            port_drift.baseline_from_arrays({mod: _images(8, seed=k)}))
    return root, data, root / "logs"


@pytest.fixture(scope="module")
def daemon(checkpoints):
    """The serve CLI's daemon over both checkpoints (a modality router)
    with --explain, on an ephemeral port; stopped at the end."""
    _, _, logs = checkpoints
    server, router, _ = port_serve.build_daemon(
        ["--checkpoint-root", str(logs), "--device", "cpu", "--image-size",
         str(SIZE), "--host", "127.0.0.1", "--port", "0", "--explain",
         "--max-batch", "4", "--compute-dtype", "float32",
         "--threshold", "0.5"])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}", router
    server.shutdown()
    server.server_close()
    router.stop()
    thread.join(timeout=10)


def _request(url, body=None, ctype=None):
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": ctype} if ctype else {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _post_json(url, payload):
    code, body = _request(url, json.dumps(payload).encode(),
                          "application/json")
    return code, json.loads(body)


def _jpeg(data, modality):
    return sorted((data / modality / "test").rglob("*.jpg"))[0].read_bytes()


def test_decode_bytes_equals_load_image(checkpoints, tmp_path):
    """An upload decodes as its file does, from several request threads
    at once (the in-memory entry reuses its decoders); a PNG too; other
    formats are refused by name."""
    _, data, _ = checkpoints
    paths = sorted((data / "rgb" / "test").rglob("*.jpg"))[:3]
    png = tmp_path / "a.png"
    write_png(png, _images(1, seed=7)[0][:20])
    paths.append(png)
    raws = [p.read_bytes() for p in paths] * 4
    with ThreadPoolExecutor(4) as ex:
        outs = list(ex.map(lambda r: decode_bytes(r, SIZE), raws))
    for k, out in enumerate(outs):
        np.testing.assert_array_equal(
            out, load_image(paths[k % len(paths)], SIZE))
    with pytest.raises(DecodeError, match="gif"):
        decode_bytes(b"GIF89a" + bytes(20), SIZE)


def test_http_predict_equals_the_eval_step(checkpoints, daemon):
    _, data, _ = checkpoints
    url, router = daemon
    rgb, thermal = _jpeg(data, "rgb"), _jpeg(data, "thermal")
    code, out = _request(url + "/v1/predict/tiny_rgb", rgb, "image/jpeg")
    assert code == 200
    out = json.loads(out)
    code, routed = _post_json(url + "/v1/predict",
                              {"thermal": base64.b64encode(thermal).decode()})
    assert code == 200 and routed["model"] == "tiny_thermal"
    for res, name, raw, mod in ((out, "tiny_rgb", rgb, "rgb"),
                                (routed, "tiny_thermal", thermal,
                                 "thermal")):
        step = router.engines[name].trainer.eval_step(
            {mod: decode_bytes(raw, SIZE)[None]})
        assert res["prob_ulcer"] == pytest.approx(
            float(step["probs"][0]), abs=1e-6)
        assert res["prediction"] == ("ulcer" if step["probs"][0] >= 0.5
                                     else "healthy")


def test_http_explain_returns_overlays(checkpoints, daemon):
    _, data, _ = checkpoints
    url, _ = daemon
    code, out = _post_json(url + "/v1/explain/tiny_rgb",
                           {"image": base64.b64encode(
                               _jpeg(data, "rgb")).decode()})
    assert code == 200, out
    assert out["model"] == "tiny_rgb" and out["class_explained"] in (0, 1)
    exp = out["explanations"]["rgb"]
    assert exp["method"] == "gradcam"
    overlay = decode_png(base64.b64decode(exp["overlay_png"]))
    assert overlay.shape == (SIZE, SIZE, 3)       # the submitted size
    cam = decode_png(base64.b64decode(exp["cam_png"]))
    assert cam.shape == (8, 8, 3)                 # the raw tap grid


def test_http_errors(checkpoints, daemon):
    _, data, _ = checkpoints
    url, _ = daemon
    jpeg = base64.b64encode(_jpeg(data, "rgb")).decode()
    code, out = _post_json(url + "/v1/predict/tiny_rgb",
                           {"image": jpeg, "rgb": jpeg})
    assert code == 400 and "duplicate field" in out["error"]
    code, out = _request(url + "/v1/predict/tiny_rgb", b"BM\0\0not-an-image",
                         "image/bmp")
    assert code == 400 and "bmp" in json.loads(out)["error"]
    code, out = _post_json(url + "/v1/predict", {"termal": jpeg})
    assert code == 400 and "unknown field" in out["error"]
    assert _request(url + "/v1/predict/nope", b"x", "image/jpeg")[0] == 404
    assert _request(url + "/v2/predict", b"x", "image/jpeg")[0] == 404
    assert _request(url + "/nothing")[0] == 404


def test_http_health_and_metrics(daemon):
    url, _ = daemon
    code, body = _request(url + "/healthz")
    health = json.loads(body)
    assert code == 200 and health["status"] == "ok"
    assert health["models"] == {"tiny_rgb": ["rgb"],
                                "tiny_thermal": ["thermal"]}
    assert health["explain"] == ["tiny_rgb", "tiny_thermal"]
    assert set(health["drift"]) == {"tiny_rgb", "tiny_thermal"}
    assert health["deployment"]["tiny_rgb"]["threshold"] == 0.5
    code, body = _request(url + "/metrics")
    assert code == 200 and set(json.loads(body)["models"]) == {
        "tiny_rgb", "tiny_thermal"}
    code, body = _request(url + "/metrics/prometheus")
    assert code == 200
    assert 'dfu_requests_total{model="tiny_rgb"}' in body.decode()


def test_http_501_and_503(pairs):
    """No explainer -> 501; a full queue -> 503 (an engine that was never
    started, its one slot taken)."""
    _, _, pt = pairs["tiny_rgb"]
    eng = ServingEngine(pt, image_size=SIZE, max_batch=2, max_queue=1)
    blocker = eng.submit({"rgb": _images(1, seed=1)[0]})
    server = make_server(eng, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        from dfu_multimodal_tpu_torch.serve.explain import encode_png
        png = encode_png(_images(1, seed=2)[0])
        assert _request(url + "/v1/explain", png, "image/png")[0] == 501
        assert _request(url + "/v1/predict", png, "image/png")[0] == 503
        assert eng.stats()["rejected"] == 1
    finally:
        server.shutdown()
        server.server_close()
        eng.stop()
        thread.join(timeout=10)
    with pytest.raises(RuntimeError, match="stopped"):
        blocker.result(timeout=0)
    with pytest.raises(EngineOverloaded):
        full = ServingEngine(pt, image_size=SIZE, max_queue=1)
        full.submit({"rgb": _images(1, seed=3)[0]})
        full.submit({"rgb": _images(1, seed=4)[0]})
    full.stop()


@pytest.mark.parametrize("flag", [["--exported", "x"], ["--shadow", "x"],
                                  ["--token-merge", "4:64"],
                                  ["--pipeline-depth", "2"]])
def test_serve_refuses_unported_flags(flag):
    with pytest.raises(SystemExit, match="not ported"):
        port_serve.build_daemon(["--checkpoint", "x", "--device", "cpu"]
                                + flag)


# ------------------------------------------------------------- predict


def test_predict_cli_matches_jax(checkpoints, capsys):
    root, data, logs = checkpoints
    ckpt = logs / "checkpoints_rgb_only"
    argv = ["--checkpoint", str(ckpt), "--images", str(data / "rgb" / "test"),
            "--image-size", str(SIZE), "--compute-dtype", "float32",
            "--batch-size", "4", "--threshold", "0.45", "--temperature",
            "1.3", "--drift-check"]
    ref = jax_predict.main(argv + ["--output", str(root / "jax.csv"),
                                   "--explain-dir", str(root / "jax_ex")])
    ours = port_predict.main(argv + ["--device", "cpu", "--output",
                                     str(root / "port.csv"), "--explain-dir",
                                     str(root / "port_ex")])
    assert list(ours) == list(ref)
    for path, (p, d) in ours.items():
        assert p == pytest.approx(ref[path][0], abs=1e-5)
        assert d == ref[path][1]
    rows = [list(csv.reader(open(root / f"{pkg}.csv")))
            for pkg in ("jax", "port")]
    assert rows[0][0] == rows[1][0] == ["path", "prob_ulcer", "prediction"]
    assert [r[0] for r in rows[0]] == [r[0] for r in rows[1]]
    names = [sorted(p.name for p in (root / d).iterdir())
             for d in ("jax_ex", "port_ex")]
    assert names[0] == names[1] and len(names[0]) == 6
    for name in names[1]:
        img = decode_png((root / "port_ex" / name).read_bytes())
        assert img.shape == (SIZE, SIZE, 3)
    out = capsys.readouterr().out
    assert out.count("DRIFT CHECK vs training-split baseline") == 2


def test_predict_cli_refuses_token_merge(checkpoints):
    _, data, logs = checkpoints
    with pytest.raises(SystemExit, match="token_merge.py"):
        port_predict.main(["--checkpoint", str(logs / "checkpoints_rgb_only"),
                           "--images", str(data), "--device", "cpu",
                           "--token-merge", "4:64"])


def test_predict_cli_tta(checkpoints):
    """``--tta 2``: a probability in [0, 1] and a decision per image."""
    _, data, logs = checkpoints
    res = port_predict.main(["--checkpoint", str(logs / "checkpoints_rgb_only"),
                             "--images", str(data / "rgb" / "test"),
                             "--device", "cpu", "--image-size", str(SIZE),
                             "--compute-dtype", "float32", "--tta", "2"])
    assert len(res) == 6
    assert all(0.0 <= p <= 1.0 and d in (0, 1) for p, d in res.values())

