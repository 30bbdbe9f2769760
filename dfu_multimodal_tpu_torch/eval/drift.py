"""Input-distribution drift monitoring (counterpart of
``dfu_multimodal_tpu/eval/drift.py``).

- **Baseline**: every training run writes
  ``<checkpoint>/drift_baseline.json``: per modality, per channel, a
  32-bin intensity histogram and the channel means and standard
  deviations of the TRAINING split's raw uint8 images.  The file is the
  JAX package's, key for key, so either package's server reads the
  other's.
- **Live accumulation**: :class:`DriftMonitor` folds the same statistics
  over incoming requests on the serving batcher thread (stride-4 pixel
  subsampling, a rolling window of recent images).
- **Score**: the Population Stability Index per channel,
  ``PSI = Σ (pᵢ − qᵢ)·ln(pᵢ/qᵢ)`` over the bins, and the channel mean
  shift in baseline-σ units; PSI < 0.1 stable, < 0.25 moderate drift,
  ≥ 0.25 major drift.

``cli/serve.py`` loads the baseline next to each checkpoint and reports
the verdict on ``/metrics`` and ``/healthz``; ``cli/predict.py
--drift-check`` prints the same report for a directory.  All statistics
are on raw uint8 images, before normalisation.
"""

from __future__ import annotations

import collections
import json
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

N_BINS = 32                      # 256 / 32 = 8 intensity levels per bin
_EPS = 1e-4                      # PSI smoothing for empty bins

BASELINE_FILENAME = "drift_baseline.json"

PSI_MODERATE = 0.1               # rule-of-thumb thresholds
PSI_MAJOR = 0.25


def channel_histograms(u8: np.ndarray) -> np.ndarray:
    """(3, N_BINS) int64 counts over a ``(N, H, W, 3)`` or ``(H, W, 3)``
    uint8 image array; bins are fixed width-8 intensity ranges."""
    u8 = np.asarray(u8)
    if u8.dtype != np.uint8:
        raise ValueError(f"expected uint8 images, got {u8.dtype}")
    flat = u8.reshape(-1, u8.shape[-1])
    return np.stack([
        np.bincount(flat[:, c] >> 3, minlength=N_BINS).astype(np.int64)
        for c in range(flat.shape[-1])])


def _fine_counts_chunked(arr: np.ndarray, chunk: int = 256,
                         rows: Optional[np.ndarray] = None) -> np.ndarray:
    """(C, 256) per-channel full-resolution intensity counts, accumulated
    in row chunks — constant memory even over a memmap-backed cache
    array (data/cache.py) far larger than RAM.  ``rows``: optional row
    indices to count (the caller must NOT fancy-index the memmap up
    front — ``arr[rows]`` copies every selected row into RAM, defeating
    this function's whole point)."""
    arr = arr if arr.ndim == 4 else arr[None]
    nch = arr.shape[-1]
    counts = np.zeros((nch, 256), np.int64)
    n = arr.shape[0] if rows is None else len(rows)
    for lo in range(0, n, chunk):
        sel = (slice(lo, lo + chunk) if rows is None
               else rows[lo:lo + chunk])
        flat = np.asarray(arr[sel]).reshape(-1, nch)
        idx = (flat.astype(np.int32)
               + np.arange(nch, dtype=np.int32) * 256)
        counts += np.bincount(idx.ravel(),
                              minlength=nch * 256).reshape(nch, 256)
    return counts


def baseline_from_arrays(arrays: Dict[str, np.ndarray],
                         paths: Optional[Dict[str, list]] = None) -> Dict:
    """Build the drift baseline from ``{modality: (N, H, W, 3) uint8}``
    (the training split as the loader holds it).

    Statistics are exact moments/histograms derived from one chunked
    256-bin counting pass — no float64 materialization of the dataset,
    so memmap-cached splits larger than RAM stream through.

    ``paths``: the dataset's per-modality path lists when available.
    Rows with path ``None`` are EXCLUDED — those are the loader's black
    missing-modality placeholders (data/pairing.py aligned pairing), and
    serving deliberately never counts black fill-ins in live statistics
    (serve/engine.py), so baking them into the baseline would guarantee
    spurious drift verdicts.
    """
    out: Dict = {"bins": N_BINS, "modalities": {}}
    for mod, arr in arrays.items():
        arr4 = arr if arr.ndim == 4 else arr[None]
        mod_paths = (paths or {}).get(mod)
        rows = None
        n_images = arr4.shape[0]
        if mod_paths is not None and any(p is None for p in mod_paths):
            real = np.asarray([i for i, p in enumerate(mod_paths)
                               if p is not None], np.int64)
            if real.size == 0:
                continue
            # selected rows stream through the chunked pass — fancy-
            # indexing arr4[real] here would copy every real row of a
            # memmap-backed split into RAM before counting starts
            rows = real
            n_images = int(real.size)
        fine = _fine_counts_chunked(arr4, rows=rows)       # (C, 256)
        n_pix = fine.sum(axis=1)                           # per channel
        vals = np.arange(256, dtype=np.float64)
        mean = (fine @ vals) / n_pix
        var = (fine @ vals**2) / n_pix - mean**2
        counts = fine.reshape(fine.shape[0], N_BINS,
                              256 // N_BINS).sum(axis=2)
        out["modalities"][mod] = {
            "hist": (counts / counts.sum(axis=1, keepdims=True)).tolist(),
            "mean": mean.tolist(),
            "std": np.sqrt(np.maximum(var, 0.0)).tolist(),
            "n_images": n_images,
        }
    return out


def save_baseline(path, baseline: Dict) -> None:
    Path(path).write_text(json.dumps(baseline, indent=2))


def load_baseline(path) -> Optional[Dict]:
    p = Path(path)
    if not p.exists():
        return None
    return json.loads(p.read_text())


def psi(expected: np.ndarray, actual: np.ndarray) -> float:
    """Population Stability Index between two discrete distributions
    (probability vectors or count vectors; both are renormalized with
    ``_EPS`` smoothing so empty bins stay finite)."""
    p = np.asarray(expected, np.float64) + _EPS
    q = np.asarray(actual, np.float64) + _EPS
    p /= p.sum()
    q /= q.sum()
    return float(np.sum((q - p) * np.log(q / p)))


def _validate_baseline(baseline: Dict) -> None:
    """Reject malformed/incompatible baselines at CONSTRUCTION time — a
    bad file must fail server startup loudly, not crash every later
    ``/healthz``/``/metrics`` call once enough images accumulate."""
    bins = baseline.get("bins")
    if bins != N_BINS:
        raise ValueError(
            f"drift baseline has {bins} bins, this build uses {N_BINS} — "
            "regenerate it (re-run training, or baseline_from_arrays)")
    mods = baseline.get("modalities")
    if not isinstance(mods, dict) or not mods:
        raise ValueError("drift baseline has no 'modalities' entries")
    for mod, entry in mods.items():
        for key in ("hist", "mean", "std"):
            if key not in entry:
                raise ValueError(
                    f"drift baseline modality {mod!r} lacks {key!r}")
        hist = np.asarray(entry["hist"], np.float64)
        if hist.ndim != 2 or hist.shape[1] != N_BINS:
            raise ValueError(
                f"drift baseline modality {mod!r} hist shape "
                f"{hist.shape} != (channels, {N_BINS})")
        if len(entry["mean"]) != hist.shape[0] \
                or len(entry["std"]) != hist.shape[0]:
            raise ValueError(
                f"drift baseline modality {mod!r}: mean/std length "
                f"disagrees with {hist.shape[0]} hist channels")


def verdict_for(psi_max: float) -> str:
    if psi_max < PSI_MODERATE:
        return "stable"
    if psi_max < PSI_MAJOR:
        return "moderate_drift"
    return "major_drift"


def drift_report(baseline_mod: Dict, counts: np.ndarray,
                 mean: np.ndarray, n_images: int) -> Dict:
    """Compare accumulated stats against one modality's baseline entry."""
    base_hist = np.asarray(baseline_mod["hist"], np.float64)
    base_mean = np.asarray(baseline_mod["mean"], np.float64)
    base_std = np.maximum(np.asarray(baseline_mod["std"], np.float64), 1e-6)
    per_channel = [psi(base_hist[c], counts[c])
                   for c in range(base_hist.shape[0])]
    shift = (np.asarray(mean, np.float64) - base_mean) / base_std
    psi_max = max(per_channel)
    return {
        "n_images": int(n_images),
        "psi_per_channel": [round(v, 4) for v in per_channel],
        "psi_max": round(psi_max, 4),
        "mean_shift_sigma": [round(float(s), 3) for s in shift],
        "verdict": verdict_for(psi_max),
    }


class DriftMonitor:
    """Thread-safe accumulator of live input statistics per modality.

    ``update(modality, u8_image_or_batch)`` folds counts in; ``report()``
    scores the statistics against the baseline.  A monitor without a
    baseline still accumulates (reported as ``no_baseline``) so a
    baseline written later can be applied retroactively.

    Statistics are kept as a ROLLING WINDOW of the most recent
    ``window_images`` per modality (default 2000, chunk-granular): a
    lifetime accumulator would dilute a camera swap after weeks of
    stable uptime into undetectability — the verdict must track *recent*
    traffic, not the server's whole history.
    """

    def __init__(self, baseline: Optional[Dict] = None,
                 min_images: int = 20, window_images: int = 2000,
                 pixel_stride: int = 4):
        if baseline is not None:
            _validate_baseline(baseline)
        self.baseline = baseline
        # below this many accumulated images PSI is sampling noise;
        # report 'warming_up' instead of a verdict
        self.min_images = int(min_images)
        self.window_images = int(window_images)
        # Every pixel of every request is overkill for a distribution
        # estimate: stride-4 subsampling keeps ~3k pixels/image (PSI on
        # 32 bins is already stable at hundreds) and cuts the host cost
        # 16x, which matters because update() runs on the serving
        # batcher thread.
        self.pixel_stride = max(1, int(pixel_stride))
        self._lock = threading.Lock()
        # modality -> deque of (counts, channel_sum, n_pixels, n_images)
        # chunks; oldest chunks are evicted once the window overflows
        self._chunks: Dict[str, collections.deque] = {}

    def update(self, modality: str, u8: np.ndarray) -> None:
        u8 = np.asarray(u8)
        if u8.dtype != np.uint8:
            raise ValueError(f"expected uint8 images, got {u8.dtype}")
        s = self.pixel_stride
        sub = u8[..., ::s, ::s, :] if u8.ndim >= 3 else u8
        flat = sub.reshape(-1, sub.shape[-1])
        # one bincount over a combined (channel, bin) index instead of
        # one pass per channel
        nch = flat.shape[-1]
        idx = ((flat >> 3).astype(np.int32)
               + np.arange(nch, dtype=np.int32) * N_BINS)
        # flat index = ch*N_BINS + bin, so a C-order reshape is (ch, bin)
        counts = np.bincount(idx.ravel(),
                             minlength=nch * N_BINS).astype(np.int64)
        counts = counts.reshape(nch, N_BINS)
        csum = flat.sum(axis=0, dtype=np.int64)
        n_img = u8.shape[0] if u8.ndim == 4 else 1
        with self._lock:
            chunks = self._chunks.setdefault(modality, collections.deque())
            chunks.append((counts, csum, flat.shape[0], n_img))
            total = sum(c[3] for c in chunks)
            while len(chunks) > 1 and total - chunks[0][3] >= \
                    self.window_images:
                total -= chunks.popleft()[3]

    def reset(self) -> None:
        with self._lock:
            self._chunks.clear()

    def report(self) -> Dict:
        with self._lock:
            snapshot = {}
            for m, chunks in self._chunks.items():
                if not chunks:
                    continue
                snapshot[m] = (
                    np.sum([c[0] for c in chunks], axis=0),
                    np.sum([c[1] for c in chunks], axis=0),
                    sum(c[2] for c in chunks),
                    sum(c[3] for c in chunks))
        out: Dict = {"modalities": {}, "verdict": "no_data"}
        if not snapshot:
            return out
        base_mods = (self.baseline or {}).get("modalities", {})
        worst = -1.0
        verdicts = []
        for mod, (counts, csum, n_pix, n_img) in snapshot.items():
            mean = csum / max(1, n_pix)
            if mod not in base_mods:
                out["modalities"][mod] = {"n_images": n_img,
                                          "verdict": "no_baseline"}
                continue
            if n_img < self.min_images:
                out["modalities"][mod] = {"n_images": n_img,
                                          "verdict": "warming_up"}
                continue
            rep = drift_report(base_mods[mod], counts, mean, n_img)
            out["modalities"][mod] = rep
            worst = max(worst, rep["psi_max"])
            verdicts.append(rep["verdict"])
        if verdicts:
            out["verdict"] = verdict_for(worst)
            out["psi_max"] = round(worst, 4)
        elif any(v.get("verdict") == "warming_up"
                 for v in out["modalities"].values()):
            out["verdict"] = "warming_up"
        elif out["modalities"]:
            out["verdict"] = "no_baseline"
        return out
