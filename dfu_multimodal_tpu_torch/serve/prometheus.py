"""Prometheus text exposition of the serving metrics (counterpart of
``dfu_multimodal_tpu/serve/prometheus.py``, the same text for the same
stats).

``GET /metrics/prometheus`` renders the same counters the JSON
``/metrics`` endpoint reports (engine stats, drift verdicts, the
shadow ledger of ``serve/shadow.py``) in the
Prometheus text format (version 0.0.4) so a
standard scrape job can alert on the daemon — no client library, the
format is plain lines.  JSON stays the default ``/metrics`` payload
(the load harness and tests consume it); point the scraper at the
``/prometheus`` path.

Conventions: counters end in ``_total``; latency percentiles are
emitted as a ``summary``-style gauge with ``quantile`` labels (computed
over the engine's bounded reservoir, not a true streaming summary —
documented in the HELP line); drift sections appear only for models that
have them.
"""

from __future__ import annotations

from typing import Dict, List

_DRIFT_VERDICTS = ("stable", "moderate_drift", "major_drift",
                   "warming_up", "no_baseline", "no_data", "error")


def _esc(value: str) -> str:
    return (str(value).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _labels(**kv) -> str:
    inner = ",".join(f'{k}="{_esc(v)}"' for k, v in kv.items()
                     if v is not None)
    return "{" + inner + "}" if inner else ""


class _Writer:
    """Buffers samples PER METRIC FAMILY and renders each family as one
    contiguous group (HELP, TYPE, then every sample across all models).
    The text-format 0.0.4 spec requires this grouping — with multiple
    served models, emitting per-engine would interleave families and
    strict parsers (promtool, OpenMetrics ingesters) may reject or
    mis-group the exposition."""

    def __init__(self):
        # insertion-ordered: family -> (header lines, sample lines)
        self._families: Dict[str, List[List[str]]] = {}

    def metric(self, name: str, mtype: str, help_text: str, value,
               **labels) -> None:
        fam = self._families.get(name)
        if fam is None:
            fam = self._families[name] = [
                [f"# HELP {name} {help_text}", f"# TYPE {name} {mtype}"],
                []]
        fam[1].append(f"{name}{_labels(**labels)} {value}")

    def render(self) -> str:
        lines: List[str] = []
        for header, samples in self._families.values():
            lines.extend(header)
            lines.extend(samples)
        return "\n".join(lines) + "\n"


def _engine_lines(w: _Writer, name: str, stats: Dict) -> None:
    lab = {"model": name}
    w.metric("dfu_requests_total", "counter",
             "Requests answered by the predict path", stats["requests"],
             **lab)
    w.metric("dfu_errors_total", "counter",
             "Requests failed (predict or explain)", stats["errors"],
             **lab)
    w.metric("dfu_rejected_total", "counter",
             "Requests rejected with backpressure (503)",
             stats["rejected"], **lab)
    w.metric("dfu_explains_total", "counter",
             "Grad-CAM explanations served", stats.get("explains", 0),
             **lab)
    w.metric("dfu_queue_depth", "gauge",
             "Requests waiting in the engine queue",
             stats["queue_depth"], **lab)
    lat = stats.get("latency_ms")
    if lat:
        for q, key in (("0.5", "p50"), ("0.9", "p90"), ("0.99", "p99")):
            w.metric("dfu_request_latency_ms", "gauge",
                     "End-to-end request latency percentiles over the "
                     "bounded reservoir (not a streaming summary)",
                     lat[key], quantile=q, **lab)
    for size, count in stats.get("batch_size_hist", {}).items():
        w.metric("dfu_batches_total", "counter",
                 "Coalesced device batches by real (unpadded) size",
                 count, batch_size=size, **lab)
    drift = stats.get("drift")
    if isinstance(drift, dict):
        for modality, rep in drift.get("modalities", drift).items():
            if not isinstance(rep, dict):
                continue
            verdict = rep.get("verdict")
            if verdict is not None:
                for v in _DRIFT_VERDICTS:
                    w.metric("dfu_drift_verdict", "gauge",
                             "1 for the active drift verdict per "
                             "modality (PSI vs the training baseline)",
                             1 if v == verdict else 0,
                             modality=modality, verdict=v, **lab)
            if rep.get("psi_max") is not None:
                w.metric("dfu_drift_psi_max", "gauge",
                         "Largest per-channel Population Stability "
                         "Index vs the training baseline",
                         rep["psi_max"], modality=modality, **lab)
    shadow = stats.get("shadow")
    if shadow:
        slab = {"model": name, "shadow": shadow["model"]}
        w.metric("dfu_shadow_compared_total", "counter",
                 "Live requests scored by the shadow candidate",
                 shadow["compared"], **slab)
        w.metric("dfu_shadow_decision_flips_total", "counter",
                 "Shadow decisions differing from the primary",
                 shadow["decision_flips"], **slab)
        w.metric("dfu_shadow_flips_healthy_to_ulcer_total", "counter",
                 "Discordant cell: primary healthy, shadow ulcer",
                 shadow["flips_healthy_to_ulcer"], **slab)
        w.metric("dfu_shadow_flips_ulcer_to_healthy_total", "counter",
                 "Discordant cell: primary ulcer, shadow healthy",
                 shadow["flips_ulcer_to_healthy"], **slab)
        w.metric("dfu_shadow_skipped_total", "counter",
                 "Requests carrying none of the shadow's modalities",
                 shadow["skipped_no_input"], **slab)
        w.metric("dfu_shadow_dropped_total", "counter",
                 "Requests dropped by the shadow's bounded queue "
                 "(sampling, not failure)",
                 shadow.get("dropped_overloaded", 0), **slab)
        w.metric("dfu_shadow_errors_total", "counter",
                 "Shadow scoring failures", shadow["errors"], **slab)
        if shadow["agreement"] is not None:
            w.metric("dfu_shadow_agreement", "gauge",
                     "Fraction of compared decisions agreeing",
                     shadow["agreement"], **slab)
        if shadow["mean_abs_prob_delta"] is not None:
            w.metric("dfu_shadow_mean_abs_prob_delta", "gauge",
                     "Mean |P_shadow - P_primary| over compared "
                     "requests", shadow["mean_abs_prob_delta"], **slab)


def render_prometheus(router) -> str:
    """Router -> Prometheus text format 0.0.4 (one block per model)."""
    w = _Writer()
    for name, engine in router.engines.items():
        _engine_lines(w, name, engine.stats())
    return w.render()
