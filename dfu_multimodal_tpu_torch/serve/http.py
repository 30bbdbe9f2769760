"""Dependency-free HTTP front end for :class:`ServingEngine` (counterpart
of ``dfu_multimodal_tpu/serve/http.py``).

Stdlib ``ThreadingHTTPServer``: each request thread decodes its own image
bytes in memory through the port's decoder (``data/loader.py::
decode_bytes``: nvJPEG on the card's host, libjpeg elsewhere,
``data/png.py`` for PNG, then the loader's PIL-exact resize) and blocks
on the engine future while the single batcher thread owns the device —
concurrency comes from request coalescing, not from parallel device
access.  A format the loader refuses gets a 400 that names it.

Endpoints:

- ``POST /v1/predict[/<model>]`` —
  * body ``image/jpeg`` / ``image/png``: one image (the primary modality
    of the addressed model, or ``rgb`` when routing among several);
  * body ``application/json``: ``{"<modality>": <base64 image bytes>}``
    per model input (``"image"`` accepted as an alias for the primary
    modality; both at once is a duplicate-field 400).  Missing modalities fill black, the loader's
    masked-modality convention.
  With several models served (:class:`ModelRouter`), the request routes
  to the model whose inputs match the modalities provided — rgb photo
  alone hits rgb_only, both modalities hit the fusion model — unless the
  path names one explicitly.
  Response: ``{"prob_ulcer", "prediction", "model", "latency_ms"}``.
- ``POST /v1/explain[/<model>]`` — same request shapes; responds with
  the prediction PLUS per-modality Grad-CAM evidence (base64 PNG JET
  overlay on the submitted image + raw heatmap; serve/explain.py).
  501 when the daemon runs without ``--explain``.
- ``GET /healthz`` — liveness + served model identities (and
  ``shadows``: each primary's shadow candidate, ``serve/shadow.py``).
  A predict answered by a primary with a shadow is scored by the shadow
  after the answer is ready, fire-and-forget.
- ``GET /metrics`` — engine counters and latency percentiles (JSON;
  per-model when serving several); ``GET /metrics/prometheus`` the same
  in the Prometheus text format.
"""

from __future__ import annotations

import base64
import binascii
import json
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Union

import numpy as np

from dfu_multimodal_tpu_torch.data.loader import DecodeError, decode_bytes
from dfu_multimodal_tpu_torch.serve.engine import (EngineOverloaded,
                                                   ExplainUnavailable,
                                                   ModelRouter,
                                                   ServingEngine)
from dfu_multimodal_tpu_torch.serve.explain import encode_png, render_overlay
from dfu_multimodal_tpu_torch.serve.prometheus import render_prometheus


class _BadRequest(ValueError):
    pass


MODALITIES = ("rgb", "thermal")


class PredictHandler(BaseHTTPRequestHandler):
    """One instance per request (stdlib contract); the shared router hangs
    off the server object (:func:`make_server`)."""

    server_version = "dfu-serve/1.0"
    # silence per-request stderr logging; metrics carry the signal
    def log_message(self, fmt, *args):          # noqa: D102
        pass

    @property
    def router(self) -> ModelRouter:
        return self.server.router               # type: ignore[attr-defined]

    def _send_json(self, code: int, payload: Dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:                   # noqa: N802
        # route on the path alone (see do_POST)
        self.path = self.path.split("?", 1)[0]
        if self.path == "/healthz":
            health = {"status": "ok",
                      "models": {n: list(e.inputs)
                                 for n, e in self.router.engines.items()}}
            single = self.router.single
            if single is not None:      # original single-model shape
                health["model"] = single.model_name
                health["inputs"] = list(single.inputs)
            # applied deployment tuning (threshold/temperature), so ops
            # can audit what each served model actually decides with;
            # key present only when some model is tuned
            dep = {n: {"threshold": e.threshold,
                       "temperature": e.temperature}
                   for n, e in self.router.engines.items()
                   if e.threshold is not None or e.temperature is not None}
            if dep:
                health["deployment"] = dep
            explain = sorted(n for n, e in self.router.engines.items()
                             if e.explainer is not None)
            if explain:
                health["explain"] = explain
            shadows = {n: e.shadow.engine.model_name
                       for n, e in self.router.engines.items()
                       if e.shadow is not None}
            if shadows:
                health["shadows"] = shadows
            # input-drift verdict per monitored model (PSI vs the
            # training-split baseline, eval/drift.py) — the ops signal
            # that the camera/site distribution moved
            def _verdict(e):
                try:
                    return e.drift_monitor.report().get("verdict",
                                                        "no_data")
                except Exception:               # pragma: no cover
                    return "error"
            drift = {n: _verdict(e)
                     for n, e in self.router.engines.items()
                     if e.drift_monitor is not None}
            if drift:
                health["drift"] = drift
            self._send_json(200, health)
        elif self.path == "/metrics":
            self._send_json(200, self.router.stats())
        elif self.path == "/metrics/prometheus":
            body = render_prometheus(self.router).encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self._send_json(404, {"error": f"unknown path {self.path}"})

    # Largest accepted request body.  A full-resolution JPEG is <5 MB;
    # this guards the decode path (and the shared host RAM) against
    # accidental or hostile multi-GB uploads.
    MAX_BODY_BYTES = 32 * 1024 * 1024

    def _read_payload(self,
                      explicit: Optional[str] = None) -> Dict[str, bytes]:
        """Body -> {modality: raw image bytes}. Binary bodies map to the
        ADDRESSED model's primary modality — the explicitly routed model
        when the path names one, else the single served model, else
        ``rgb``; JSON bodies carry named base64 fields."""
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError as exc:
            raise _BadRequest("bad Content-Length header") from exc
        if length <= 0:
            raise _BadRequest("empty body")
        if length > self.MAX_BODY_BYTES:
            raise _BadRequest(
                f"body {length} bytes exceeds limit {self.MAX_BODY_BYTES}")
        data = self.rfile.read(length)
        ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
        # the addressed model decides what one bare image means: without
        # this, POST /v1/predict/thermal_only with an image body would
        # map to 'rgb' and 400 as "needs inputs from ['thermal']"
        target = (self.router.engines.get(explicit)
                  if explicit is not None else self.router.single)
        primary = target.inputs[0] if target is not None else "rgb"
        if ctype.startswith("image/"):
            if target is not None and len(target.inputs) > 1:
                raise _BadRequest(
                    f"model {target.model_name!r} needs "
                    f"{list(target.inputs)} — send application/json "
                    "with one base64 image per modality")
            return {primary: data}
        if ctype == "application/json":
            try:
                payload = json.loads(data)
            except json.JSONDecodeError as exc:
                raise _BadRequest(f"bad JSON: {exc}") from exc
            if not isinstance(payload, dict):
                raise _BadRequest("JSON body must be an object")
            if "image" in payload:
                if primary in payload:
                    raise _BadRequest(
                        f"duplicate field: 'image' is an alias of "
                        f"{primary!r}; send one of them")
                payload[primary] = payload.pop("image")
            unknown = sorted(k for k in payload if k not in MODALITIES)
            if unknown:
                # a typo'd modality key ("termal") must 400, not silently
                # reroute the request to a different (single-modality)
                # model — in a clinical API a wrong-model 200 is worse
                # than an error
                raise _BadRequest(
                    f"unknown field(s) {unknown}; expected fields from "
                    f"{list(MODALITIES)}")
            raws = {}
            for m in MODALITIES:
                if m not in payload:
                    continue
                try:
                    raws[m] = base64.b64decode(payload[m], validate=True)
                except (binascii.Error, TypeError) as exc:
                    raise _BadRequest(
                        f"field {m!r} is not valid base64") from exc
            if not raws:
                raise _BadRequest(
                    f"no model input present; expected fields from "
                    f"{list(MODALITIES)}")
            return raws
        raise _BadRequest(f"unsupported Content-Type {ctype!r}")

    def do_POST(self) -> None:                  # noqa: N802
        # standard clients/load balancers append query params (trace
        # ids, cache busters); route on the path alone
        path = self.path.split("?", 1)[0]
        parts = [p for p in path.split("/") if p]
        if parts[:1] == ["v1"]:
            parts = parts[1:]
        if (not parts or parts[0] not in ("predict", "explain")
                or len(parts) > 2):
            self._send_json(404, {"error": f"unknown path {self.path}"})
            return
        op = parts[0]
        explicit = parts[1] if len(parts) == 2 else None
        t0 = time.monotonic()
        try:
            raws = self._read_payload(explicit)
            engine = self.router.select(raws.keys(), explicit)
        except _BadRequest as exc:
            self._send_json(400, {"error": str(exc)})
            return
        except KeyError as exc:
            self._send_json(404 if explicit else 400,
                            {"error": str(exc).strip("'\"")})
            return
        try:
            sample = {m: decode_bytes(raw, engine.image_size)
                      for m, raw in raws.items() if m in engine.inputs}
            if not sample:
                raise _BadRequest(
                    f"model {engine.model_name!r} needs inputs from "
                    f"{list(engine.inputs)}")
        except (_BadRequest, DecodeError) as exc:
            self._send_json(400, {"error": str(exc)})
            return
        except Exception as exc:
            self._send_json(400, {"error": f"undecodable image: {exc}"})
            return
        if op == "explain":
            self._do_explain(engine, sample, t0)
            return
        try:
            fut = engine.submit(sample)
        except Exception as exc:   # bounded queue full (EngineOverloaded)
            self.send_response(503)
            self.send_header("Retry-After", "1")
            self.send_header("Content-Type", "application/json")
            body = json.dumps({"error": str(exc)}).encode()
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        try:
            prob, pred = fut.result(timeout=60.0)
        except Exception as exc:
            self._send_json(500, {"error": f"inference failed: {exc}"})
            return
        if engine.shadow is not None:
            # fire-and-forget candidate scoring (serve/shadow.py); the
            # response below never waits on the shadow engine
            engine.shadow.observe(sample, prob, pred)
        self._send_json(200, {
            "prob_ulcer": round(prob, 6),
            "prediction": "ulcer" if pred == 1 else "healthy",
            "model": engine.model_name,
            "latency_ms": round((time.monotonic() - t0) * 1e3, 3)})

    def _do_explain(self, engine: ServingEngine,
                    sample: Dict[str, np.ndarray], t0: float) -> None:
        """POST /v1/explain[/<model>] — same request shapes as predict;
        the response adds per-modality Grad-CAM evidence: a JET overlay
        PNG on the submitted image plus the raw heatmap PNG (base64).
        PNG rendering runs HERE, on the request thread — the batcher
        thread only computes the CAM tensors (serve/explain.py)."""
        try:
            fut = engine.submit_explain(sample)
        except ExplainUnavailable as exc:
            self._send_json(501, {"error": str(exc)})
            return
        except EngineOverloaded as exc:
            self._send_json(503, {"error": str(exc)})
            return
        try:
            out = fut.result(timeout=120.0)
        except Exception as exc:
            self._send_json(500, {"error": f"explanation failed: {exc}"})
            return
        explanations = {}
        try:
            for m, cam_out in out["cams"].items():
                cam = cam_out["cam"]
                cam_u8 = (np.clip(cam, 0.0, 1.0) * 255).astype(np.uint8)
                explanations[m] = {
                    "method": cam_out["method"],
                    "overlay_png": base64.b64encode(
                        render_overlay(sample[m], cam)).decode(),
                    "cam_png": base64.b64encode(
                        encode_png(np.repeat(cam_u8[..., None], 3,
                                             axis=-1))).decode()}
        except Exception as exc:
            # rendering errors (a malformed cam) must come back as a
            # JSON 500, not a dropped connection
            self._send_json(500, {"error": f"overlay render failed: "
                                           f"{exc}"})
            return
        self._send_json(200, {
            "prob_ulcer": round(out["prob_ulcer"], 6),
            "prediction": "ulcer" if out["prediction"] == 1 else "healthy",
            "model": engine.model_name,
            "class_explained": out.get("class_explained",
                                       engine.explainer.class_index),
            "explanations": explanations,
            "latency_ms": round((time.monotonic() - t0) * 1e3, 3)})


def make_server(engine: Union[ServingEngine, ModelRouter],
                host: str = "0.0.0.0", port: int = 8000
                ) -> ThreadingHTTPServer:
    """Bind (but do not start) the HTTP server; ``serve_forever()`` to run.
    Accepts one :class:`ServingEngine` or a :class:`ModelRouter`.
    ``port=0`` picks an ephemeral port (tests)."""
    if isinstance(engine, ServingEngine):
        engine = ModelRouter({engine.model_name: engine})
    server = ThreadingHTTPServer((host, port), PredictHandler)
    server.router = engine                      # type: ignore[attr-defined]
    return server
