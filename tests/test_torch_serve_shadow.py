"""Shadow deployment (``serve/shadow.py``) and the pipelined engine loop of
the port, on the CPU with the tiny models.

The eight cases of the JAX package's tests/test_serve_shadow.py on the
port's engines (candidate scoring on live traffic, the agreement ledger
and its flip directions, modality-subset shadows, router attachment and
its refusals, the bounded shadow queue, HTTP feeding the shadow and
``/metrics`` / ``/healthz`` reporting it); the Prometheus shadow section
against the JAX package's text for the same stats; ``pipeline_depth=2``
answering as depth 1 row for row; and the serve CLI's ``--shadow`` and
``--pipeline-depth 2`` on written checkpoints.
"""

import io
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from dfu_multimodal_tpu.serve import prometheus as jax_prom
from dfu_multimodal_tpu_torch.cli import serve as port_serve
from dfu_multimodal_tpu_torch.config import (TrainConfig, rgb_modality,
                                             thermal_modality)
from dfu_multimodal_tpu_torch.data.png import write_png
from dfu_multimodal_tpu_torch.models import zoo
from dfu_multimodal_tpu_torch.serve import prometheus as port_prom
from dfu_multimodal_tpu_torch.serve.engine import ModelRouter, ServingEngine
from dfu_multimodal_tpu_torch.serve.http import make_server
from dfu_multimodal_tpu_torch.serve.shadow import ShadowTracker, attach_shadow
from dfu_multimodal_tpu_torch.train.engine import Trainer
from dfu_multimodal_tpu_torch.utils import checkpoint as ckpt_mod

torch.set_num_threads(1)

SIZE = 32
MODALITIES = {"tiny_rgb": {"rgb": rgb_modality()},
              "tiny_thermal": {"thermal": thermal_modality()},
              "tiny_fusion": {"rgb": rgb_modality(),
                              "thermal": thermal_modality()}}


def _make(model, seed=0):
    cfg = TrainConfig(batch_size=8, eval_batch_size=8,
                      compute_dtype="float32")
    trainer = Trainer(model, cfg, MODALITIES[model], device="cpu",
                      image_size=SIZE)
    zoo.init_model(trainer.module, torch.Generator().manual_seed(seed))
    return trainer


def rand_images(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(n, SIZE, SIZE, 3), dtype=np.uint8)


def _wait_compared(tracker, n, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        s = tracker.stats()
        if s["compared"] + s["errors"] + s["skipped_no_input"] >= n:
            return s
        time.sleep(0.02)
    raise AssertionError(f"shadow never caught up: {tracker.stats()}")


def test_identical_shadow_agrees_fully():
    """Same weights, same tuning: every live decision agrees and the
    probability delta is ~0."""
    trainer = _make("tiny_rgb")
    primary = ServingEngine(trainer, image_size=SIZE, max_batch=8)
    shadow_eng = ServingEngine(trainer, image_size=SIZE, max_batch=8)
    tracker = ShadowTracker(shadow_eng, "tiny_rgb")
    with primary, shadow_eng:
        imgs = rand_images(6, seed=1)
        for img in imgs:
            (prob, pred), = primary.predict([{"rgb": img}])
            tracker.observe({"rgb": img}, prob, pred)
        s = _wait_compared(tracker, len(imgs))
    assert s["compared"] == 6 and s["errors"] == 0
    assert s["agreement"] == 1.0 and s["decision_flips"] == 0
    assert s["mean_abs_prob_delta"] < 1e-5


def test_disagreeing_shadow_counts_flips_by_direction():
    """Primary thresholded to always-healthy, shadow to always-ulcer:
    every comparison is a healthy -> ulcer flip."""
    trainer = _make("tiny_rgb")
    primary = ServingEngine(trainer, image_size=SIZE, max_batch=8,
                            threshold=2.0)       # prob >= 2 never
    shadow_eng = ServingEngine(trainer, image_size=SIZE, max_batch=8,
                               threshold=0.0)    # always ulcer
    tracker = ShadowTracker(shadow_eng, "tiny_rgb")
    primary.shadow = tracker
    with primary, shadow_eng:
        for img in rand_images(4, seed=2):
            (prob, pred), = primary.predict([{"rgb": img}])
            assert pred == 0
            tracker.observe({"rgb": img}, prob, pred)
        s = _wait_compared(tracker, 4)
    assert s["compared"] == 4
    assert s["agreement"] == 0.0 and s["decision_flips"] == 4
    assert s["flips_healthy_to_ulcer"] == 4
    assert s["flips_ulcer_to_healthy"] == 0
    assert primary.stats()["shadow"]["decision_flips"] == 4


def test_subset_input_shadow_filters_and_skips():
    """An rgb-only candidate shadowing the fusion primary: fusion requests
    compare on the rgb branch; thermal-only requests are skipped."""
    primary = ServingEngine(_make("tiny_fusion"), image_size=SIZE,
                            max_batch=8)
    shadow_eng = ServingEngine(_make("tiny_rgb"), image_size=SIZE,
                               max_batch=8)
    tracker = ShadowTracker(shadow_eng, "tiny_fusion")
    rgb, thermal = rand_images(2, seed=3)
    with primary, shadow_eng:
        (prob, pred), = primary.predict([{"rgb": rgb, "thermal": thermal}])
        tracker.observe({"rgb": rgb, "thermal": thermal}, prob, pred)
        (prob2, pred2), = primary.predict([{"thermal": thermal}])
        tracker.observe({"thermal": thermal}, prob2, pred2)
        s = _wait_compared(tracker, 2)
    assert s["compared"] == 1
    assert s["skipped_no_input"] == 1
    assert s["errors"] == 0


def test_attach_shadow_routes_and_rejects_double():
    trainer = _make("tiny_rgb")
    primary = ServingEngine(trainer, image_size=SIZE, max_batch=8)
    router = ModelRouter({"tiny_rgb": primary})
    cand = ServingEngine(trainer, image_size=SIZE, max_batch=8)
    tracker = attach_shadow(router, cand)
    assert tracker.primary_name == "tiny_rgb"
    assert primary.shadow is tracker
    with pytest.raises(KeyError, match="already has shadow"):
        attach_shadow(router, cand)


def test_attach_shadow_rejects_disjoint_inputs():
    """A thermal-only shadow on an rgb-only primary would skip all
    traffic: attach fails at startup."""
    primary = ServingEngine(_make("tiny_rgb"), image_size=SIZE, max_batch=8)
    router = ModelRouter({"tiny_rgb": primary})
    cand = ServingEngine(_make("tiny_thermal"), image_size=SIZE,
                         max_batch=8)
    with pytest.raises(KeyError, match="no shared modality"):
        attach_shadow(router, cand)
    assert primary.shadow is None


def test_overloaded_shadow_counts_drops_not_errors():
    """A full bounded shadow queue is sampling, not failure: overflow is
    counted as dropped and the requests that fit still compare."""
    shadow_eng = ServingEngine(_make("tiny_rgb"), image_size=SIZE,
                               max_batch=8, max_queue=1)
    tracker = ShadowTracker(shadow_eng, "tiny_rgb")
    # not started: the first observe takes the queue's slot, the rest
    # overflow
    for img in rand_images(3, seed=5):
        tracker.observe({"rgb": img}, 0.5, 1)
    s = tracker.stats()
    assert s["dropped_overloaded"] == 2 and s["errors"] == 0
    with shadow_eng:
        s = _wait_compared(tracker, 1)
    assert s["compared"] == 1 and s["errors"] == 0
    assert s["dropped_overloaded"] == 2


def test_http_predict_feeds_shadow_and_metrics_report():
    trainer = _make("tiny_rgb")
    primary = ServingEngine(trainer, image_size=SIZE, max_batch=8)
    router = ModelRouter({"tiny_rgb": primary})
    tracker = attach_shadow(router, ServingEngine(trainer, image_size=SIZE,
                                                  max_batch=8))
    server = make_server(router, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    buf = io.BytesIO()
    write_png(buf, rand_images(1, seed=4)[0])
    try:
        with router:                       # the shadow starts with it
            req = urllib.request.Request(
                f"{url}/v1/predict", data=buf.getvalue(),
                headers={"Content-Type": "image/png"})
            with urllib.request.urlopen(req, timeout=60) as r:
                assert json.loads(r.read())["model"] == "tiny_rgb"
            _wait_compared(tracker, 1)
            with urllib.request.urlopen(f"{url}/metrics", timeout=30) as r:
                metrics = json.loads(r.read())
            assert metrics["shadow"]["model"] == "tiny_rgb"
            assert metrics["shadow"]["compared"] == 1
            assert metrics["shadow"]["agreement"] == 1.0
            with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
                assert json.loads(r.read())["shadows"] == {
                    "tiny_rgb": "tiny_rgb"}
            with urllib.request.urlopen(f"{url}/metrics/prometheus",
                                        timeout=30) as r:
                text = r.read().decode()
            assert ('dfu_shadow_compared_total{model="tiny_rgb",'
                    'shadow="tiny_rgb"} 1') in text
        assert not tracker.engine._thread
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


def test_attach_shadow_rejects_image_size_mismatch():
    trainer = _make("tiny_rgb")
    primary = ServingEngine(trainer, image_size=SIZE, max_batch=8)
    router = ModelRouter({"tiny_rgb": primary})
    cand = ServingEngine(trainer, image_size=SIZE * 2, max_batch=8)
    with pytest.raises(KeyError, match="px"):
        attach_shadow(router, cand)


def test_prometheus_shadow_section_matches_jax():
    """The same stats (a shadow ledger with flips both ways) render the
    JAX package's text."""
    stats = {"model": "multimodal", "inputs": ["rgb", "thermal"],
             "requests": 12, "errors": 0, "rejected": 1, "explains": 0,
             "explain_enabled": False, "queue_depth": 0, "buckets": [1, 2],
             "batch_size_hist": {1: 4, 2: 4},
             "latency_ms": {"p50": 1.5, "p90": 2.0, "p99": 3.25,
                            "mean": 1.75, "window": 12},
             "shadow": {"model": "multimodal", "inputs": ["rgb", "thermal"],
                        "compared": 11, "agreement": 0.818182,
                        "decision_flips": 2, "flips_healthy_to_ulcer": 1,
                        "flips_ulcer_to_healthy": 1,
                        "mean_abs_prob_delta": 0.0125,
                        "skipped_no_input": 0, "dropped_overloaded": 1,
                        "errors": 0, "pending": 0}}

    class Engine:
        def stats(self):
            return stats

    class Router:
        engines = {"multimodal": Engine()}

    text = port_prom.render_prometheus(Router)
    assert text == jax_prom.render_prometheus(Router)
    assert "dfu_shadow_agreement" in text


@pytest.mark.parametrize("model", ["tiny_rgb", "tiny_fusion"])
def test_pipeline_depth_two_answers_as_depth_one(model):
    """Depth 2 (batch N+1 dispatched before batch N is fetched) gives
    depth 1's answers row for row, over batches of every size."""
    trainer = _make(model)
    inputs = trainer.spec.inputs
    imgs = {m: rand_images(13, seed=10 + i) for i, m in enumerate(inputs)}
    samples = [{m: imgs[m][i] for m in inputs} for i in range(13)]
    got = {}
    for depth in (1, 2):
        eng = ServingEngine(trainer, image_size=SIZE, max_batch=4,
                            max_wait_ms=1.0, pipeline_depth=depth)
        with eng:
            futs = [eng.submit(s) for s in samples]
            got[depth] = [f.result(timeout=60) for f in futs]
        assert eng.stats()["requests"] == 13
    assert got[2] == got[1]
    ref = trainer.eval_step(imgs)
    np.testing.assert_allclose([p for p, _ in got[2]], ref["probs"].numpy(),
                               rtol=1e-6, atol=1e-7)


def test_serve_cli_shadow_and_pipeline_depth(tmp_path):
    """``--shadow`` on a checkpoint (its own deployment.json) and
    ``--pipeline-depth 2``: N requests over HTTP, ``/metrics`` with N
    compared, the answers those of a depth-1 daemon."""
    logs = tmp_path / "logs"
    for k, (ckpt, name) in enumerate((("checkpoints_rgb_only", "tiny_rgb"),
                                      ("candidate", "tiny_rgb"))):
        tr = _make(name, seed=k)
        ckpt_mod.save_checkpoint(logs / ckpt, epoch=1,
                                 model_state=tr.module.state_dict(),
                                 opt_state=None, val_f1=0.5, history={},
                                 extra_meta={"model": name})
    bodies = []
    for img in rand_images(5, seed=9):
        buf = io.BytesIO()
        write_png(buf, img)
        bodies.append(buf.getvalue())
    answers = {}
    for depth in (1, 2):
        argv = ["--checkpoint", str(logs / "checkpoints_rgb_only"),
                "--device", "cpu", "--image-size", str(SIZE), "--host",
                "127.0.0.1", "--port", "0", "--max-batch", "4",
                "--compute-dtype", "float32", "--pipeline-depth",
                str(depth)]
        if depth == 2:
            argv += ["--shadow", str(logs / "candidate")]
        server, router, _ = port_serve.build_daemon(argv)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            out = []
            for body in bodies:
                req = urllib.request.Request(
                    f"{url}/v1/predict", data=body,
                    headers={"Content-Type": "image/png"})
                with urllib.request.urlopen(req, timeout=60) as r:
                    res = json.loads(r.read())
                out.append((res["prob_ulcer"], res["prediction"]))
            answers[depth] = out
            engine = router.single
            assert engine.pipeline_depth == depth
            if depth == 2:
                s = _wait_compared(engine.shadow, len(bodies))
                assert s["compared"] == len(bodies) and s["errors"] == 0
                with urllib.request.urlopen(f"{url}/metrics/prometheus",
                                            timeout=30) as r:
                    text = r.read().decode()
                assert (f'dfu_shadow_compared_total{{model="tiny_rgb",'
                        f'shadow="tiny_rgb"}} {len(bodies)}') in text
        finally:
            server.shutdown()
            server.server_close()
            router.stop()
            thread.join(timeout=10)
    assert answers[2] == answers[1]


def test_serve_cli_shadow_is_full_fidelity_beside_an_int8_primary(
        monkeypatch, tmp_path):
    """The reference's rule: a ``--shadow`` candidate is restored
    full-fidelity whatever the primary's ``--int8`` (an int8 primary
    beside its full-fidelity checkpoint as the shadow asks whether int8
    may replace it), and it is attached to the primary."""
    trainer = _make("tiny_rgb")
    seen = []

    def restore(ckpt, model, args, cfg, modalities, device):
        seen.append((ckpt.name, args.int8))
        return "tiny_rgb", trainer, None

    monkeypatch.setattr(port_serve, "restore_trainer", restore)
    args = port_serve.build_parser().parse_args(
        ["--checkpoint", str(tmp_path / "primary"), "--int8",
         "--shadow", str(tmp_path / "candidate"), "--device", "cpu",
         "--image-size", str(SIZE), "--max-batch", "4",
         "--ignore-deployment"])
    primary = ServingEngine(trainer, image_size=SIZE, max_batch=4)
    router = ModelRouter({"tiny_rgb": primary})
    port_serve._attach_shadows(router, args, TrainConfig(),
                               MODALITIES["tiny_rgb"], torch.device("cpu"))
    assert seen == [("candidate", False)] and args.int8
    assert primary.shadow is not None
    assert primary.shadow.primary_name == "tiny_rgb"
    router.stop()
