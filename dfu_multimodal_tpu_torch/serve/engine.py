"""Dynamic micro-batching serving engine over the Trainer's eval step
(counterpart of ``ServingEngine`` and ``ModelRouter`` in
``dfu_multimodal_tpu/serve/engine.py``).

- ONE thread owns the device.  Request threads enqueue (sample, Future)
  pairs; the batcher thread drains the queue, coalescing up to
  ``max_batch`` requests or waiting at most ``max_wait_ms`` after the
  first, then runs one forward and fans the rows back out.
- Batches are padded with black images to a power-of-two bucket, so the
  kernels see a small fixed set of shapes; :meth:`warmup` runs every
  bucket once before traffic (the first call also builds the kernels).
- Deployment tuning: a temperature scales the responded P(ulcer) and a
  threshold on it decides the class (else the argmax); a bounded queue
  (``max_queue``) refuses with :class:`EngineOverloaded`.
- Explanations (``serve/explain.py::Explainer``) wait in their own small
  queue and run one at a time on the batcher thread between predict
  batches; a borderline request whose tuned decision differs from the
  argmax is explained again for the class it was served.
- A :class:`eval.drift.DriftMonitor` folds each batch's provided
  modalities in; :meth:`stats` reports it beside the counters and the
  end-to-end latency percentiles.
- :class:`ModelRouter` serves several engines, routing a request to the
  model whose inputs match its modalities.

- ``pipeline_depth=2`` overlaps: batch N+1 is assembled, copied to the
  card from its own pinned host buffers and dispatched before batch N's
  results are fetched (each batch's results land in pinned memory behind
  a CUDA event); futures resolve in dispatch order, and the answers are
  depth 1's row for row.
- A shadow (``serve/shadow.py::attach_shadow``) scores the live traffic
  of the engine it is attached to, fire-and-forget, and :meth:`stats`
  reports its agreement ledger.

One device, so no mesh padding.  :func:`quantize_for_serving` rebuilds a
trainer around the int8 serving paths: the fused int8 ViT blocks
(``ops/vit_block_q8.py``) and the calibrated int8 ResNet trunk
(``models/resnet_q8.py`` on ``ops/conv_q8.py``, the ResNet-18 students'
basic-block trunks too); :func:`tome_for_serving` around the
token-merged ViT (``ops/token_merge.py``, ``models/vit.py``
``token_merge``), after it or alone.  An exported bundle
(``serve/export.py::load_bundle``) serves through the same engine:
pass its buckets (``buckets=servable.buckets``).
"""

from __future__ import annotations

import queue
import threading
import time
from collections import Counter, deque
from concurrent.futures import Future, InvalidStateError
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dfu_multimodal_tpu_torch.data.transforms import eval_normalize
from dfu_multimodal_tpu_torch.eval.calibration import apply_temperature
from dfu_multimodal_tpu_torch.models.resnet_q8 import quantize_rgb_trunks
from dfu_multimodal_tpu_torch.models.vit import quantize_variables
from dfu_multimodal_tpu_torch.serve.export import default_buckets
from dfu_multimodal_tpu_torch.train.engine import Trainer

# models with an int8 serving path, and the subset whose ResNet trunk
# needs activation-scale calibration images (the JAX package's sets)
RESNET_TRUNK_MODELS = frozenset(
    {"rgb_only", "multimodal", "resnet18_rgb", "resnet18_thermal"})
INT8_MODELS = RESNET_TRUNK_MODELS | {"thermal_only"}
# the model argument that picks each one's ResNet trunk (int8, or the
# ResNet-50's fused bottlenecks)
RGB_IMPL_ARG = {"rgb_only": "block_impl", "multimodal": "rgb_impl",
                "resnet18_rgb": "block_impl",
                "resnet18_thermal": "block_impl"}


def quantize_for_serving(trainer: Trainer, image_size: int = 224,
                         calib_u8: Optional[np.ndarray] = None) -> Trainer:
    """Rebuild a trainer around the int8 serving paths (JAX
    ``serve/engine.py::quantize_for_serving``): a new ``Trainer`` on the
    same device whose ViT branch runs the fused int8 blocks
    (``block_impl="fused_q8"``, dynamic per-row activation scales; trunk
    quantised by ``models/vit.py::quantize_variables``) and whose ResNet
    trunk is the calibrated static-scale int8 trunk (``rgb_impl="int8"``,
    ``models/resnet_q8.py::quantize_rgb_trunks``).  The source trainer's
    weights are left as they are.  On the card the quantisation and the
    calibration run on the card.

    ``calib_u8``: (N, S, S, 3) uint8 images that fix the ResNet trunk's
    activation scales (the first 32, normalised as the eval step does, in
    the compute dtype, of the modality that feeds the trunk); required
    for ``rgb_only``, ``multimodal`` and the ResNet-18 students, ignored
    by ``thermal_only``."""
    model_name = trainer.spec.name
    if model_name not in INT8_MODELS:
        # the int8 paths are trunk-specific — reject other models with
        # the contract instead of failing deep inside the conversion
        raise ValueError(
            f"int8 serving is not supported for model {model_name!r}: "
            f"it covers {sorted(INT8_MODELS)}. Serve other models "
            "fp32/bf16.")
    if model_name in RESNET_TRUNK_MODELS and (calib_u8 is None
                                              or len(calib_u8) == 0):
        raise ValueError(
            "int8 serving of a ResNet trunk needs calibration images "
            "(calib_u8) to fix the static activation scales")
    state = trainer.variables()
    impls = {}
    if model_name in ("thermal_only", "multimodal"):
        state = quantize_variables(state)
        impls["block_impl"] = "fused_q8"
    if model_name in RESNET_TRUNK_MODELS:
        # calibrate with the modality that feeds the ResNet trunk
        modality = ("rgb" if "rgb" in trainer.spec.inputs
                    else trainer.spec.inputs[0])
        u8 = torch.as_tensor(np.asarray(calib_u8[:32])).to(trainer.device)
        calib = eval_normalize(u8, trainer.modalities[modality],
                               trainer.compute_dtype)
        state = quantize_rgb_trunks(state, [calib],
                                    dtype=trainer.compute_dtype)
        impls[RGB_IMPL_ARG[model_name]] = "int8"
    qtrainer = Trainer(model_name, trainer.cfg, trainer.modalities,
                       device=trainer.device,
                       **{**trainer.model_kwargs, "image_size": image_size,
                          **impls})
    qtrainer.module.load_state_dict(state, strict=True)
    return qtrainer


def parse_token_merge(spec: str) -> Tuple[int, int]:
    """Parse a CLI ``--token-merge`` value 'L:K' -> (merge_at, keep): the
    one definition of that flag's format, shared by the serve and predict
    CLIs (both feed :func:`tome_for_serving`)."""
    try:
        merge_at, keep = (int(v) for v in spec.split(":"))
    except ValueError:
        raise SystemExit("--token-merge expects L:K (e.g. 4:128)")
    return merge_at, keep


def tome_for_serving(trainer: Trainer, merge_at: int, keep: int,
                     image_size: int = 224,
                     prop_attn: bool = False) -> Trainer:
    """Rebuild a restored trainer around the token-merged ViT serving path
    (JAX ``serve/engine.py::tome_for_serving``): a new ``Trainer`` on the
    same device whose ViT runs blocks [0, merge_at) on all tokens, one
    bipartite merge down to ``keep`` tokens, and the rest on ``keep``
    (``models/vit.py`` ``token_merge``); with ``prop_attn`` those blocks
    bias each key's scores by log(token size) (ToMe's proportional
    attention).  Inference only.  It keeps the source's model arguments,
    so it composes after :func:`quantize_for_serving` with the int8 block
    impls kept.  The blocks keep their keys, so the source's state_dict
    loads as it is (JAX splits its scanned stack here); the source's
    weights are left as they are."""
    kwargs = {k: v for k, v in trainer.model_kwargs.items()
              if k not in ("token_merge", "tome_prop_attn")}
    ttrainer = Trainer(trainer.spec.name, trainer.cfg, trainer.modalities,
                       device=trainer.device,
                       **{**kwargs, "image_size": image_size},
                       token_merge=(merge_at, keep),
                       tome_prop_attn=prop_attn)
    ttrainer.module.load_state_dict(trainer.variables(), strict=True)
    return ttrainer


class EngineOverloaded(RuntimeError):
    """Raised by :meth:`ServingEngine.submit` when the bounded request
    queue (``max_queue``) is full — backpressure instead of unbounded
    memory growth under overload.  The HTTP layer maps it to 503."""


class ExplainUnavailable(RuntimeError):
    """Raised by :meth:`ServingEngine.submit_explain` when the engine was
    built without an explainer (``serve --explain`` opts in).  The HTTP
    layer maps it to 501."""


class ServingEngine:
    """Coalesce concurrent single-image requests into bucketed batches.

    Thread-safe entry points: :meth:`submit` (a ``Future`` of
    ``(prob_ulcer, prediction)``), :meth:`submit_explain`, :meth:`predict`
    (synchronous, over :meth:`submit`) and :meth:`stats`.  Use as a
    context manager or call :meth:`start` / :meth:`stop`.

    ``threshold``: predict ulcer when P(ulcer) >= it instead of the
    argmax; ``temperature``: scale the responded probabilities (an
    explicit threshold applies to the scaled ones); ``drift_monitor``: an
    ``eval.drift.DriftMonitor``; ``explainer``: a
    ``serve.explain.Explainer`` (None: :meth:`submit_explain` raises
    :class:`ExplainUnavailable`); ``pipeline_depth``: 1 runs a batch to
    its results before the next, 2 dispatches the next batch before
    fetching the last one's (the module docstring); ``buckets``: the batch
    sizes to pad to (an exported bundle's; default the power-of-two
    ladder up to ``max_batch``, which is then the largest bucket).
    """

    def __init__(self, trainer, *, image_size: int = 224,
                 max_batch: int = 64, max_wait_ms: float = 2.0,
                 max_queue: Optional[int] = None,
                 threshold: Optional[float] = None,
                 temperature: Optional[float] = None,
                 drift_monitor=None, explainer=None,
                 pipeline_depth: int = 1,
                 buckets: Optional[Sequence[int]] = None):
        self.threshold = None if threshold is None else float(threshold)
        self.temperature = (None if temperature is None
                            else float(temperature))
        if self.temperature is not None and self.temperature <= 0:
            raise ValueError(f"temperature must be > 0: {temperature}")
        self.drift_monitor = drift_monitor
        self.explainer = explainer
        self.pipeline_depth = max(1, int(pipeline_depth))
        # a candidate fed this engine's traffic (serve/shadow.py), set by
        # attach_shadow; it never answers a request
        self.shadow = None
        self._explain_queue: "queue.Queue" = queue.Queue(maxsize=64)
        self.trainer = trainer
        self.image_size = int(image_size)
        self.inputs: Tuple[str, ...] = tuple(trainer.spec.inputs)
        self.model_name: str = trainer.spec.name
        self.max_wait_s = float(max_wait_ms) * 1e-3
        self.buckets = tuple(sorted(set(int(b) for b in (
            buckets if buckets is not None
            else default_buckets(max_batch)))))
        self.max_batch = self.buckets[-1]
        # bounded admission: None keeps an unbounded queue
        self.max_queue = None if max_queue is None else int(max_queue)
        self._queue: "queue.Queue" = queue.Queue(
            maxsize=0 if self.max_queue is None else self.max_queue)
        self._stop = threading.Event()
        self._closed = False        # stop() sets; submit() then raises
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._latencies = deque(maxlen=4096)     # p50/p99 reservoir
        self._batch_sizes: Counter = Counter()
        self._requests = 0
        self._errors = 0
        self._rejected = 0
        self._explains = 0

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "ServingEngine":
        if self._thread is not None and self._thread.is_alive():
            if not self._stop.is_set():
                return self                       # already running
            # a previous stop() timed out with a batch in flight: wait for
            # that batcher to exit before spawning a fresh one — never two
            # batchers side by side
            self._thread.join(timeout=60.0)
            if self._thread.is_alive():
                raise RuntimeError(
                    "previous batcher thread is still busy 60s after "
                    "stop(); cannot safely restart")
        self._stop.clear()
        self._closed = False
        ready = threading.Event()
        self._thread = threading.Thread(target=self._loop, args=(ready,),
                                        name="dfu-serve-batcher",
                                        daemon=True)
        self._thread.start()
        ready.wait()            # the batcher has run every bucket once
        return self

    def stop(self, timeout: float = 5.0) -> None:
        # refuse NEW work first: a submit() after stop() would enqueue
        # into a queue no batcher drains; start() re-opens
        self._closed = True
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                return          # keep the reference; start() waits it out
            self._thread = None
        # fail any stragglers enqueued after the drain
        for q in (self._queue, self._explain_queue):
            while True:
                try:
                    _, fut, _ = q.get_nowait()
                except queue.Empty:
                    break
                if not fut.done():
                    fut.set_exception(RuntimeError("serving engine stopped"))

    def __enter__(self) -> "ServingEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------- serving

    def submit(self, sample: Dict[str, np.ndarray]) -> Future:
        """Enqueue one sample (``{modality: (S, S, 3) uint8}``; missing
        modalities fill black).  Returns a Future of ``(prob_ulcer,
        pred_int)``.  Shape and dtype are checked here, so one malformed
        sample raises to its own caller instead of failing the batch."""
        if self._closed:
            raise RuntimeError("serving engine stopped")
        if not sample:
            raise ValueError("sample needs at least one modality")
        self._validate_sample(sample)
        fut: Future = Future()
        try:
            self._queue.put_nowait((sample, fut, time.monotonic()))
        except queue.Full:
            with self._lock:
                self._rejected += 1
            raise EngineOverloaded(
                f"request queue full ({self.max_queue} waiting); retry")
        if self._closed and not fut.done():
            # raced a concurrent stop() past its straggler drain
            try:
                fut.set_exception(RuntimeError("serving engine stopped"))
            except InvalidStateError:
                pass
        return fut

    def predict(self, samples: Sequence[Dict[str, np.ndarray]]
                ) -> List[Tuple[float, int]]:
        """Synchronous batch convenience: submit all, wait for all."""
        futs = [self.submit(s) for s in samples]
        return [f.result() for f in futs]

    def _validate_sample(self, sample: Dict[str, np.ndarray]) -> None:
        S = self.image_size
        for m, arr in sample.items():
            if m not in self.inputs:
                raise ValueError(
                    f"unknown modality {m!r}; model takes "
                    f"{list(self.inputs)}")
            a = np.asarray(arr)
            if a.shape != (S, S, 3) or a.dtype != np.uint8:
                raise ValueError(
                    f"sample[{m!r}] must be ({S}, {S}, 3) uint8, got "
                    f"{a.shape} {a.dtype}")

    def submit_explain(self, sample: Dict[str, np.ndarray]) -> Future:
        """Enqueue one explanation.  Returns a Future of ``{"prob_ulcer",
        "prediction", "class_explained", "cams": {modality: {"cam",
        "method"}}}``: the probability and decision carry the deployment
        tuning, as :meth:`submit`'s, and when the tuned decision differs
        from the argmax the CAM is computed again for the served class
        (``class_explained`` states it).  Raises
        :class:`ExplainUnavailable` without an explainer."""
        if self._closed:
            raise RuntimeError("serving engine stopped")
        if self.explainer is None:
            raise ExplainUnavailable(
                f"model {self.model_name!r} is served without "
                "explanations (start the daemon with --explain)")
        if not sample:
            raise ValueError("explanation needs at least one modality")
        self._validate_sample(sample)
        fut: Future = Future()
        try:
            self._explain_queue.put_nowait((sample, fut, time.monotonic()))
        except queue.Full:
            with self._lock:
                self._rejected += 1
            raise EngineOverloaded("explanation queue full; retry")
        return fut

    def _run_explains(self, max_items: int = 4) -> None:
        """Run up to ``max_items`` queued explanations on the batcher
        thread (one forward and backward each), so a burst of them cannot
        starve the predict path."""
        for _ in range(max_items):
            try:
                sample, fut, _ = self._explain_queue.get_nowait()
            except queue.Empty:
                return
            try:
                out = self.explainer.explain_one(sample)
                probs, preds = self._apply_deployment(
                    np.asarray([out["probs"][1]], np.float64))
                decided = int(preds[0])
                if (self.explainer.class_index == "pred"
                        and out["class_explained"] != decided):
                    # borderline: the threshold on the scaled P(ulcer)
                    # decided the other class than the argmax the CAM
                    # explained; explain the served decision (a
                    # class-agnostic map would come out the same)
                    if self.explainer.class_agnostic:
                        out = {**out, "class_explained": decided}
                    else:
                        out = self.explainer.explain_one(
                            sample, class_override=decided)
                fut.set_result({"prob_ulcer": float(probs[0]),
                                "prediction": decided,
                                "class_explained": out["class_explained"],
                                "cams": out["cams"]})
                with self._lock:
                    self._explains += 1
            except Exception as exc:
                if not fut.done():
                    fut.set_exception(exc)
                with self._lock:
                    self._errors += 1

    def _explain_warmup_classes(self) -> Tuple[int, ...]:
        """The fixed classes a borderline re-explain may ask for: (0, 1)
        when a threshold can overrule the argmax, else none."""
        if (self.threshold is not None
                and self.explainer.class_index == "pred"
                and not self.explainer.class_agnostic):
            return (0, 1)
        return ()

    def warmup(self) -> None:
        """Run every bucket once on the calling thread before taking
        traffic (the first call also builds the kernels), and an
        explanation when there is an explainer.  Fail-fast: a bucket that
        cannot run fails startup here (re-raised from its futures)
        instead of failing live requests later.  :meth:`start` runs them
        again on the batcher thread, whose per-thread library state this
        call cannot warm."""
        for bucket in self.buckets:
            items = self._blank_items(bucket)
            self._execute(items, record=False)
            for _, fut, _ in items:     # _execute is synchronous
                fut.result(timeout=0)
        if self.explainer is not None:
            self.explainer.warmup(self.image_size,
                                  self._explain_warmup_classes())

    def _blank_items(self, n: int):
        zero = {m: np.zeros((self.image_size, self.image_size, 3), np.uint8)
                for m in self.inputs}
        return [(zero, Future(), time.monotonic()) for _ in range(n)]

    # ------------------------------------------------------------- batcher

    def _collect(self, first_timeout: float):
        """Coalesce up to ``max_batch`` queued requests: block up to
        ``first_timeout`` for the first, then keep the window open
        ``max_wait_ms`` after it.  Returns [] on timeout."""
        try:
            first = self._queue.get(timeout=first_timeout)
        except queue.Empty:
            return []
        items = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(items) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                try:        # drain what is already queued, stop waiting
                    items.append(self._queue.get_nowait())
                    continue
                except queue.Empty:
                    break
            try:
                items.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return items

    def _loop(self, ready: threading.Event) -> None:
        # cuDNN and cuBLAS keep their handles, and PyTorch its cuDNN conv
        # plans, per thread: the first call of each shape on a new thread
        # is slow.  Run every bucket once, unrecorded, on this thread
        # before start() returns (a failure here shows on the requests).
        try:
            for bucket in self.buckets:
                self._execute(self._blank_items(bucket), record=False)
            if self.explainer is not None:
                self.explainer.warmup(self.image_size,
                                      self._explain_warmup_classes())
        finally:
            ready.set()
        # depth 2: with a batch in flight, take what is queued without
        # waiting and dispatch it before fetching the one in flight
        pending = None
        while not self._stop.is_set():
            items = self._collect(0.0 if pending else 0.05)
            handle = self._dispatch(items) if items else None
            if self.pipeline_depth < 2 and handle is not None:
                self._resolve(*handle)
                handle = None
            if pending is not None:
                self._resolve(*pending)
            pending = handle
            if self.explainer is not None:
                self._run_explains()
        if pending is not None:
            self._resolve(*pending)

    def _bucket(self, n: int) -> int:
        return next(b for b in self.buckets if b >= n)

    def _dispatch(self, items, record: bool = True):
        """Assemble one padded batch and enqueue its eval step on the
        device without waiting: on the card the batch is copied from its
        own pinned host buffers and the results are copied back into
        pinned memory behind a CUDA event.  Returns (items, results,
        event, record) for :meth:`_resolve`, or None when the dispatch
        failed (the items' futures are failed)."""
        n = len(items)
        bucket = self._bucket(n)
        S = self.image_size
        device = self.trainer.device
        try:
            batch = {m: np.zeros((bucket, S, S, 3), np.uint8)
                     for m in self.inputs}
            for i, (sample, _, _) in enumerate(items):
                for m in self.inputs:
                    if m in sample:
                        batch[m][i] = sample[m]
            if self.drift_monitor is not None and record:
                # provided modalities only: black fill-ins are padding,
                # not camera output
                for m in self.inputs:
                    rows = [i for i, (s, _, _) in enumerate(items)
                            if m in s]
                    if rows:
                        self.drift_monitor.update(m, batch[m][rows])
            event = None
            if device.type == "cuda":
                batch = {m: torch.from_numpy(a).pin_memory().to(
                    device, non_blocking=True) for m, a in batch.items()}
            out = self.trainer.eval_step(batch)
            results = (out["probs"][:n], out["preds"][:n])
            if device.type == "cuda":
                results = tuple(r.to("cpu", non_blocking=True)
                                for r in results)
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(device))
        except Exception as exc:                     # fan the failure out
            self._fail(items, exc, record)
            return None
        return items, results, event, record

    def _resolve(self, items, results, event, record: bool = True) -> None:
        """Wait for a dispatched batch's results and resolve its
        futures."""
        n = len(items)
        try:
            if event is not None:
                event.synchronize()
            probs, preds = self._apply_deployment(results[0].numpy(),
                                                  results[1].numpy())
        except Exception as exc:
            self._fail(items, exc, record)
            return
        now = time.monotonic()
        for (_, fut, t0), prob, pred in zip(items, probs, preds):
            if not fut.done():
                fut.set_result((float(prob), int(pred)))
            if record:
                with self._lock:
                    self._latencies.append(now - t0)
        if record:
            with self._lock:
                self._requests += n
                self._batch_sizes[n] += 1

    def _fail(self, items, exc, record: bool) -> None:
        for _, fut, _ in items:
            if not fut.done():
                fut.set_exception(exc)
        if record:
            with self._lock:
                self._errors += len(items)

    def _execute(self, items, record: bool = True) -> None:
        """One batch to its results (warm-up, and the tests)."""
        handle = self._dispatch(items, record)
        if handle is not None:
            self._resolve(*handle)

    def _apply_deployment(self, probs: np.ndarray,
                          preds: Optional[np.ndarray] = None):
        """Deployment tuning of a (B,) P(ulcer) vector: temperature-scale
        it, then decide by the threshold when one is set (else keep the
        argmax ``preds``, or the equivalent 0.5 cut without them)."""
        if self.temperature is not None:
            probs = apply_temperature(probs, self.temperature)
        if self.threshold is not None:
            preds = (probs >= self.threshold).astype(np.int64)
        elif preds is None:
            preds = (probs >= 0.5).astype(np.int64)
        return probs, preds

    # ------------------------------------------------------------- metrics

    def stats(self) -> Dict:
        with self._lock:
            lat = np.asarray(self._latencies, np.float64) * 1e3
            sizes = dict(sorted(self._batch_sizes.items()))
            requests, errors = self._requests, self._errors
            rejected, explains = self._rejected, self._explains
        out = {"model": self.model_name,
               "inputs": list(self.inputs),
               "requests": requests,
               "errors": errors,
               "rejected": rejected,
               "explains": explains,
               "explain_enabled": self.explainer is not None,
               "queue_depth": self._queue.qsize(),
               "buckets": list(self.buckets),
               "batch_size_hist": sizes}
        if lat.size:
            out["latency_ms"] = {
                "p50": float(np.percentile(lat, 50)),
                "p90": float(np.percentile(lat, 90)),
                "p99": float(np.percentile(lat, 99)),
                "mean": float(lat.mean()),
                "window": int(lat.size)}
        if self.drift_monitor is not None:
            # a reporting bug degrades to an error string: monitoring must
            # never take down the metrics and liveness surface
            try:
                out["drift"] = self.drift_monitor.report()
            except Exception as exc:            # pragma: no cover
                out["drift"] = {"verdict": "error", "error": str(exc)}
        if self.shadow is not None:
            out["shadow"] = self.shadow.stats()
        return out


class ModelRouter:
    """Serve several models from one daemon, routing each request to the
    engine whose input set matches the modalities the request carries.

    The clinical deployment shape: one box holds the rgb_only,
    thermal_only and multimodal checkpoints; a request with only an RGB
    photo hits the RGB model, one with both modalities hits the fusion
    model — no client-side model selection needed (an explicit
    ``/v1/predict/<model>`` path still forces one).  Each engine keeps its
    own batcher thread and queue; their kernels share the card's stream
    order, so mixed traffic shares it without cross-engine locking.
    """

    def __init__(self, engines: Dict[str, "ServingEngine"]):
        if not engines:
            raise ValueError("ModelRouter needs at least one engine")
        self.engines = dict(engines)

    # Lifecycle fans out to every engine, then to their shadows
    # (serve/shadow.py), which no request reaches through the router.
    def _lifecycle(self) -> list:
        return [*self.engines.values(),
                *(e.shadow for e in self.engines.values()
                  if e.shadow is not None)]

    def start(self) -> "ModelRouter":
        for e in self._lifecycle():
            e.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        for e in self._lifecycle():
            e.stop(timeout=timeout)

    def warmup(self) -> None:
        for e in self._lifecycle():
            e.warmup()

    def __enter__(self) -> "ModelRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def single(self) -> Optional["ServingEngine"]:
        """The one engine when exactly one is registered, else None."""
        if len(self.engines) == 1:
            return next(iter(self.engines.values()))
        return None

    def select(self, modalities, explicit: Optional[str] = None
               ) -> "ServingEngine":
        """Explicit model name wins; otherwise prefer the engine whose
        inputs EXACTLY match the provided modalities, then the
        largest-input engine fully covered by them."""
        if explicit is not None:
            try:
                return self.engines[explicit]
            except KeyError:
                raise KeyError(
                    f"unknown model {explicit!r}; serving "
                    f"{sorted(self.engines)}") from None
        if self.single is not None:
            return self.single
        mods = set(modalities)
        exact = [(n, e) for n, e in self.engines.items()
                 if set(e.inputs) == mods]
        if len(exact) > 1:
            # two served models take the same inputs (e.g. two RGB
            # checkpoints): implicit routing would pick one silently, and
            # WHICH one could flip across restarts — refuse, like the
            # explicit path 404s on an unknown name
            raise KeyError(
                "ambiguous request: models "
                + ", ".join(sorted(n for n, _ in exact))
                + f" all take {sorted(mods)} — use /v1/predict/<model>")
        if exact:
            return exact[0][1]
        covered = [e for e in self.engines.values()
                   if set(e.inputs) <= mods]
        if covered:
            best = max(len(e.inputs) for e in covered)
            top = [(n, e) for n, e in self.engines.items()
                   if e in covered and len(e.inputs) == best]
            if len(top) > 1:
                raise KeyError(
                    "ambiguous request: models "
                    + ", ".join(sorted(n for n, _ in top))
                    + " match equally — use /v1/predict/<model>")
            return top[0][1]
        raise KeyError(
            f"no served model accepts modalities {sorted(mods)}; "
            f"serving " + ", ".join(
                f"{n}={list(e.inputs)}" for n, e in self.engines.items()))

    def stats(self) -> Dict:
        if self.single is not None:     # back-compat single-model shape
            return self.single.stats()
        per = {n: e.stats() for n, e in self.engines.items()}
        return {"models": per,
                "requests": sum(s["requests"] for s in per.values()),
                "errors": sum(s["errors"] for s in per.values())}
