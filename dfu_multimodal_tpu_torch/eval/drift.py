"""Input-distribution drift baseline (the baseline half of
``dfu_multimodal_tpu/eval/drift.py``).

Every training run writes ``<checkpoint>/drift_baseline.json``: per
modality, per channel, a 32-bin intensity histogram and the channel
means and standard deviations of the TRAINING split's raw uint8 images.
The serving-side monitor (``DriftMonitor``, the PSI score and its
verdicts) waits for the port's serving surface.  The file is the JAX
package's, key for key, so either package's server can read the other's.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np

N_BINS = 32                      # 256 / 32 = 8 intensity levels per bin

BASELINE_FILENAME = "drift_baseline.json"


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
