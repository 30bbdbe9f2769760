"""Dynamic micro-batching serving engine over the Trainer's eval step
(counterpart of ``ServingEngine`` in ``dfu_multimodal_tpu/serve/engine.py``).

- ONE thread owns the device.  Request threads enqueue (sample, Future)
  pairs; the batcher thread drains the queue, coalescing up to
  ``max_batch`` requests or waiting at most ``max_wait_ms`` after the
  first, then runs one forward and fans the rows back out.
- Batches are padded with black images to a power-of-two bucket, so the
  kernels see a small fixed set of shapes; :meth:`warmup` runs every
  bucket once before traffic (the first call also builds the kernels).
- Latency is end to end per request (submit -> result on the caller's
  future), kept in a bounded reservoir for p50/p99.

One device, so no mesh padding.  :func:`quantize_for_serving` rebuilds a
trainer around the int8 serving path (``thermal_only``: the fused int8 ViT
blocks, ``ops/vit_block_q8.py``).  Not ported yet: the int8 ResNet trunk
(``models/resnet_q8.py``, so int8 ``multimodal``), explanations, drift
monitoring, shadow traffic, ``pipeline_depth > 1``, the decision threshold
and temperature, and the ToMe rebuild.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import Counter, deque
from concurrent.futures import Future, InvalidStateError
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from dfu_multimodal_tpu_torch.models.vit import quantize_variables
from dfu_multimodal_tpu_torch.train.engine import Trainer

# models with an int8 serving path, and the subset whose ResNet trunk
# needs activation-scale calibration images (the JAX package's sets)
RESNET_TRUNK_MODELS = frozenset(
    {"rgb_only", "multimodal", "resnet18_rgb", "resnet18_thermal"})
INT8_MODELS = RESNET_TRUNK_MODELS | {"thermal_only"}


def quantize_for_serving(trainer: Trainer, image_size: int = 224,
                         calib_u8: Optional[np.ndarray] = None) -> Trainer:
    """Rebuild a trainer around the int8 serving path: a new ``Trainer``
    on the same device with ``block_impl="fused_q8"`` (the fused int8 ViT
    blocks, dynamic per-row activation scales) holding the trunk quantised
    once by ``models/vit.py::quantize_variables``; the source trainer's
    fp32 weights are left as they are.  On the card the quantisation runs
    on the card.

    ``calib_u8`` calibrates a ResNet trunk's activation scales in the JAX
    package; ``thermal_only`` has none and ignores it.  Models with a
    ResNet trunk raise ``NotImplementedError``: the int8 ResNet
    (``models/resnet_q8.py``) is not ported yet."""
    model_name = trainer.spec.name
    if model_name not in INT8_MODELS:
        # the int8 paths are trunk-specific — reject other models with
        # the contract instead of failing deep inside the conversion
        raise ValueError(
            f"int8 serving is not supported for model {model_name!r}: "
            f"it covers {sorted(INT8_MODELS)}. Serve other models "
            "fp32/bf16.")
    if model_name in RESNET_TRUNK_MODELS:
        raise NotImplementedError(
            f"int8 serving of {model_name!r} needs the int8 ResNet trunk "
            "(models/resnet_q8.py), which is not ported yet")
    qtrainer = Trainer(model_name, trainer.cfg, trainer.modalities,
                       device=trainer.device,
                       **{**trainer.model_kwargs, "image_size": image_size,
                          "block_impl": "fused_q8"})
    qtrainer.module.load_state_dict(quantize_variables(trainer.variables()),
                                    strict=True)
    return qtrainer


class EngineOverloaded(RuntimeError):
    """Raised by :meth:`ServingEngine.submit` when the bounded request
    queue (``max_queue``) is full — backpressure instead of unbounded
    memory growth under overload."""


class ServingEngine:
    """Coalesce concurrent single-image requests into bucketed batches.

    Thread-safe entry points: :meth:`submit` (a ``Future`` of
    ``(prob_ulcer, prediction)``), :meth:`predict` (synchronous, over
    :meth:`submit`) and :meth:`stats`.  Use as a context manager or call
    :meth:`start` / :meth:`stop`.
    """

    def __init__(self, trainer, *, image_size: int = 224,
                 max_batch: int = 64, max_wait_ms: float = 2.0,
                 max_queue: Optional[int] = None):
        self.trainer = trainer
        self.image_size = int(image_size)
        self.inputs: Tuple[str, ...] = tuple(trainer.spec.inputs)
        self.model_name: str = trainer.spec.name
        self.max_wait_s = float(max_wait_ms) * 1e-3
        # power-of-two ladder capped by max_batch
        self.max_batch = int(max_batch)
        ladder: List[int] = []
        b = 1
        while b < self.max_batch:
            ladder.append(b)
            b *= 2
        self.buckets = tuple(ladder) + (self.max_batch,)
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
        while True:
            try:
                _, fut, _ = self._queue.get_nowait()
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

    def warmup(self) -> None:
        """Run every bucket once on the calling thread before taking
        traffic (the first call also builds the kernels).  Fail-fast: a
        bucket that cannot run fails startup here (re-raised from its
        futures) instead of failing live requests later.  :meth:`start`
        runs the buckets again on the batcher thread, whose per-thread
        library state this call cannot warm."""
        for bucket in self.buckets:
            items = self._blank_items(bucket)
            self._execute(items, record=False)
            for _, fut, _ in items:     # _execute is synchronous
                fut.result(timeout=0)

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
        finally:
            ready.set()
        while not self._stop.is_set():
            items = self._collect(0.05)
            if items:
                self._execute(items)

    def _bucket(self, n: int) -> int:
        return next(b for b in self.buckets if b >= n)

    def _execute(self, items, record: bool = True) -> None:
        """Assemble one padded batch, run the eval step, and resolve the
        items' futures (with the results, or with the failure)."""
        n = len(items)
        bucket = self._bucket(n)
        S = self.image_size
        try:
            batch = {m: np.zeros((bucket, S, S, 3), np.uint8)
                     for m in self.inputs}
            for i, (sample, _, _) in enumerate(items):
                for m in self.inputs:
                    if m in sample:
                        batch[m][i] = sample[m]
            out = self.trainer.eval_step(batch)
            probs = out["probs"][:n].cpu().numpy()
            preds = out["preds"][:n].cpu().numpy()
        except Exception as exc:                     # fan the failure out
            for _, fut, _ in items:
                if not fut.done():
                    fut.set_exception(exc)
            if record:
                with self._lock:
                    self._errors += n
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

    # ------------------------------------------------------------- metrics

    def stats(self) -> Dict:
        with self._lock:
            lat = np.asarray(self._latencies, np.float64) * 1e3
            sizes = dict(sorted(self._batch_sizes.items()))
            requests, errors = self._requests, self._errors
            rejected = self._rejected
        out = {"model": self.model_name,
               "inputs": list(self.inputs),
               "requests": requests,
               "errors": errors,
               "rejected": rejected,
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
        return out
