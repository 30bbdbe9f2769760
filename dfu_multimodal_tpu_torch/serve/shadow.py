"""Shadow deployment: score a candidate model on live traffic, risk-free
(the port's counterpart of ``dfu_multimodal_tpu/serve/shadow.py``).

Before a new checkpoint replaces the serving model, run it as a SHADOW:
every request the primary answers is also scored by the candidate, the
response comes only from the primary, and ``/metrics`` accumulates the
live decision-agreement evidence (flips, probability deltas) that says
whether the candidate behaves on real traffic as the offline test split
promised — for example whether an int8 rebuild may replace the bf16
model.

- The shadow is a full :class:`ServingEngine` (its own batcher thread and
  bucket ladder) that is not registered in the router: it can never
  answer a request.  Its kernels share the card's stream order with the
  primary's, so shadow scoring costs throughput, not correctness.
- :meth:`ShadowTracker.observe` is fire-and-forget from the HTTP request
  thread: it filters the request's modalities to the shadow's inputs,
  submits, and compares in a Future callback.  The primary's response
  never waits on the shadow.
- A shadow may take a subset of the primary's modalities (an rgb-only
  candidate shadowing the multimodal model); requests carrying none of
  its inputs count as ``skipped``, not compared.
- Agreement is measured on deployed decisions: each engine's own
  threshold and temperature apply.
"""

from __future__ import annotations

import threading
from typing import Dict

import numpy as np

from dfu_multimodal_tpu_torch.serve.engine import EngineOverloaded


class ShadowTracker:
    """Feed a shadow engine the primary's traffic and keep the live
    agreement ledger.  Thread-safe; attached as ``primary.shadow``."""

    def __init__(self, engine, primary_name: str):
        self.engine = engine
        self.primary_name = primary_name
        self._lock = threading.Lock()
        self._compared = 0
        self._agree = 0
        self._flips = 0
        self._abs_delta_sum = 0.0
        self._skipped = 0
        self._dropped = 0
        self._errors = 0
        self._pending = 0
        # decision contingency: [primary][shadow] counts, the McNemar
        # discordant cells `dfu compare` tests offline
        self._table = np.zeros((2, 2), np.int64)

    # lifecycle passthroughs (the CLI drives these alongside the router)
    def start(self):
        self.engine.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self.engine.stop(timeout=timeout)

    def warmup(self) -> None:
        self.engine.warmup()

    def observe(self, sample: Dict[str, np.ndarray], primary_prob: float,
                primary_pred: int) -> None:
        """Fire-and-forget: score ``sample`` on the shadow and record the
        comparison when its future resolves.  Never raises into the
        caller (a shadow failure must not fail live traffic)."""
        sub = {m: v for m, v in sample.items() if m in self.engine.inputs}
        if not sub:
            with self._lock:
                self._skipped += 1
            return
        try:
            fut = self.engine.submit(sub)
        except EngineOverloaded:
            # bounded shadow queue full: the shadow is sampling traffic,
            # not failing — count separately so agreement stats can note
            # the coverage (compared / (compared + dropped))
            with self._lock:
                self._dropped += 1
            return
        except Exception:           # stopped/misconfigured shadow: error
            with self._lock:
                self._errors += 1
            return
        with self._lock:
            self._pending += 1

        def _done(f):
            with self._lock:
                self._pending -= 1
                try:
                    prob, pred = f.result()
                except Exception:
                    self._errors += 1
                    return
                self._compared += 1
                self._abs_delta_sum += abs(float(prob)
                                           - float(primary_prob))
                p, s = int(primary_pred), int(pred)
                self._table[p, s] += 1
                if p == s:
                    self._agree += 1
                else:
                    self._flips += 1

        fut.add_done_callback(_done)

    def stats(self) -> Dict:
        with self._lock:
            out = {
                "model": self.engine.model_name,
                "inputs": list(self.engine.inputs),
                "compared": self._compared,
                "agreement": (round(self._agree / self._compared, 6)
                              if self._compared else None),
                "decision_flips": self._flips,
                # the two discordant directions (offline: dfu compare's
                # McNemar cells): shadow says ulcer where primary said
                # healthy, and the reverse
                "flips_healthy_to_ulcer": int(self._table[0, 1]),
                "flips_ulcer_to_healthy": int(self._table[1, 0]),
                "mean_abs_prob_delta": (
                    round(self._abs_delta_sum / self._compared, 6)
                    if self._compared else None),
                "skipped_no_input": self._skipped,
                "dropped_overloaded": self._dropped,
                "errors": self._errors,
                "pending": self._pending,
            }
        return out


def attach_shadow(router, shadow_engine) -> "ShadowTracker":
    """Attach ``shadow_engine`` to the routed primary that would answer
    the shadow's own input set (the router's request-matching rule —
    exact inputs first, then the widest covering model).  Returns the
    tracker; raises KeyError if no primary accepts those inputs, or if
    that primary already has a shadow."""
    primary = router.select(shadow_engine.inputs)
    if primary.image_size != shadow_engine.image_size:
        # observe() forwards the primary's decoded samples verbatim; a
        # size-mismatched shadow would reject 100% of them as validation
        # errors (compared=0, silently) — fail at startup instead
        raise KeyError(
            f"shadow {shadow_engine.model_name!r} expects "
            f"{shadow_engine.image_size}px inputs but the routed primary "
            f"{primary.model_name!r} serves {primary.image_size}px")
    if not set(primary.inputs) & set(shadow_engine.inputs):
        # a single-model router's select() returns its only engine
        # regardless of overlap; a disjoint shadow would attach fine but
        # skip 100% of traffic (compared=0, silently) — fail at startup
        raise KeyError(
            f"shadow {shadow_engine.model_name!r} takes "
            f"{list(shadow_engine.inputs)} but the routed primary "
            f"{primary.model_name!r} takes {list(primary.inputs)}: "
            "no shared modality, the shadow would never see traffic")
    if getattr(primary, "shadow", None) is not None:
        raise KeyError(
            f"model {primary.model_name!r} already has shadow "
            f"{primary.shadow.engine.model_name!r}")
    tracker = ShadowTracker(shadow_engine, primary.model_name)
    primary.shadow = tracker
    return tracker
