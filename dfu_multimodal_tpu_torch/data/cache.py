"""Persistent mmap-backed decode cache (the port's copy of
``dfu_multimodal_tpu/data/cache.py``: the same key, file format and build
safety, so the two packages can share a cache directory).

- The cache file is the raw (N, S, S, 3) uint8 block; readers get a
  read-only ``np.memmap``, so a batch slice touches only its own pages.
- The build is chunked (``chunk`` files decoded at a time, written
  straight into the memmap), so peak RAM during construction is
  ~chunk x S^2 x 3 bytes whatever the dataset's size.
- The key is a SHA-256 over (image_size, per-file absolute path + size +
  mtime_ns), so edits and replacements invalidate automatically and
  distinct pairings and orderings get distinct entries.
- Builds are crash- and race-safe: data is written to a pid-unique temp
  file and ``os.replace``d into place, the JSON sidecar last; a reader
  trusts only an entry whose sidecar exists and matches the file size.

Enable per call (``decode_all(..., cache_dir=...)``), per dataset
(``load_single_modality``/``load_paired`` ``cache_dir=``), or process-wide
with the ``DFU_CACHE_DIR`` environment variable (the ``--cache-dir`` CLI
flag sets it).
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_FORMAT = 1
_CHUNK = 256


def resolve_cache_dir(cache_dir: Optional[Path] = None) -> Optional[Path]:
    """Explicit argument wins; else the ``DFU_CACHE_DIR`` env var; else
    None (caching disabled)."""
    if cache_dir is not None:
        return Path(cache_dir)
    env = os.environ.get("DFU_CACHE_DIR")
    return Path(env) if env else None


def cache_key(paths: Sequence[Optional[Path]], image_size: int) -> str:
    """Content key: image size + every file's absolute path, byte size and
    mtime (ns).  ``None`` entries (missing-modality placeholders) key as a
    marker so paired and single-modality lists can't collide."""
    h = hashlib.sha256()
    h.update(f"v{_FORMAT}:{image_size}".encode())
    for p in paths:
        if p is None:
            h.update(b"|<none>")
        else:
            st = os.stat(p)
            h.update(f"|{os.path.abspath(p)}:{st.st_size}:"
                     f"{st.st_mtime_ns}".encode())
    return h.hexdigest()[:32]


def cached_decode(paths: Sequence[Optional[Path]], image_size: int,
                  cache_dir: Path, chunk: int = _CHUNK) -> np.ndarray:
    """Decode ``paths`` through the on-disk cache; returns a read-only
    ``np.memmap`` of shape (N, image_size, image_size, 3) uint8.

    Cache hit: zero decoding, the memmap opens instantly.  Miss: the block
    is built ``chunk`` files at a time (bounded RAM) and atomically
    installed.  Rows for ``None`` paths are zeros (the loader's
    missing-modality placeholder convention, loader.decode_all).
    """
    from dfu_multimodal_tpu_torch.data.loader import decode_raw

    n = len(paths)
    shape = (n, image_size, image_size, 3)
    if n == 0:
        return np.zeros(shape, np.uint8)

    cache_dir = Path(cache_dir)
    cache_dir.mkdir(parents=True, exist_ok=True)
    key = cache_key(paths, image_size)
    data_path = cache_dir / f"{key}.u8"
    meta_path = cache_dir / f"{key}.json"

    expected_bytes = int(np.prod(shape))
    if meta_path.exists() and data_path.exists():
        try:
            meta = json.loads(meta_path.read_text())
        except (OSError, ValueError):
            meta = None
        if (meta and meta.get("format") == _FORMAT
                and meta.get("n") == n
                and meta.get("image_size") == image_size
                and data_path.stat().st_size == expected_bytes):
            return np.memmap(data_path, np.uint8, mode="r", shape=shape)

    tmp = cache_dir / f"{key}.u8.tmp{os.getpid()}"
    try:
        mm = np.memmap(tmp, np.uint8, mode="w+", shape=shape)
        try:
            for lo in range(0, n, chunk):
                hi = min(lo + chunk, n)
                mm[lo:hi] = decode_raw(list(paths[lo:hi]), image_size)
            mm.flush()
        finally:
            del mm                              # close before replace
        os.replace(tmp, data_path)
    except BaseException:
        # a failed/interrupted build must not leak a dataset-sized tmp
        # file into the cache dir (they would accumulate unbounded)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    meta_path.write_text(json.dumps(
        {"format": _FORMAT, "n": n, "image_size": image_size}))
    return np.memmap(data_path, np.uint8, mode="r", shape=shape)
