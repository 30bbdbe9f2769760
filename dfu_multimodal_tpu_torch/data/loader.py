"""Host half of the data path (counterpart of
``dfu_multimodal_tpu/data/loader.py``): decode from disk once into an
in-memory (or memmap-cached) uint8 dataset, weighted-with-replacement
epoch sampling, fixed-shape masked batches, and a double-buffered
host->device copy.

Decoding: a JPEG goes through the native decoder (``native/``: libjpeg,
bit-equal to PIL, or nvJPEG on a GPU host without libjpeg), a PNG
through the port's own reader (``data/png.py``), and both are resized
with the PIL-exact BILINEAR resampler (torchvision's ``Resize((S, S))``
after ``convert('RGB')``, reference train_rgb_only.py:91, 102-103).
There is no PIL fallback: a file of another format (BMP, TIFF, GIF), a
CMYK JPEG, a 16-bit or interlaced PNG and a corrupt file each raise an
error that names the file and its format.
"""

from __future__ import annotations

import collections
import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import (Dict, Iterator, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from dfu_multimodal_tpu_torch import native
from dfu_multimodal_tpu_torch.data import pairing as pairing_mod
from dfu_multimodal_tpu_torch.data.layout import SplitIndex, scan_split
from dfu_multimodal_tpu_torch.data.png import SIGNATURE as PNG_SIGNATURE
from dfu_multimodal_tpu_torch.data.png import decode_png, read_png

_JPEG_STATUS = {1: "cannot be opened", 2: "is corrupt or not a baseline/"
                "progressive JPEG", 3: "is a CMYK/YCCK JPEG, which the "
                "port's decoder does not convert", 4: "failed on the GPU "
                "decoder (nvJPEG)"}


@dataclass
class ArrayDataset:
    """Fully-decoded in-memory dataset: ``arrays[modality]`` is
    (N, S, S, 3) uint8; one shared label vector."""

    arrays: Dict[str, np.ndarray]
    labels: np.ndarray
    paths: Dict[str, List[Optional[Path]]] = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.labels)

    @property
    def modalities(self) -> List[str]:
        return list(self.arrays)

    @property
    def class_counts(self) -> np.ndarray:
        return np.bincount(self.labels, minlength=2)


def image_format(path) -> str:
    """The file's format from its first bytes: ``"jpeg"``, ``"png"``,
    ``"bmp"``, ``"tiff"``, ``"gif"`` or ``"unknown"``."""
    with open(path, "rb") as f:
        return bytes_format(f.read(8))


def bytes_format(head: bytes) -> str:
    """:func:`image_format` of an image's first bytes."""
    if head.startswith(b"\xff\xd8"):
        return "jpeg"
    if head.startswith(PNG_SIGNATURE):
        return "png"
    if head.startswith(b"BM"):
        return "bmp"
    if head[:4] in (b"II*\x00", b"MM\x00*"):
        return "tiff"
    if head.startswith(b"GIF8"):
        return "gif"
    return "unknown"


class DecodeError(ValueError):
    """A file the port cannot decode (its format is named)."""


# PIL's PNG modes by (bit depth, colour type) (PngImagePlugin._MODES)
_PNG_MODES = {(1, 0): "1", (2, 0): "L", (4, 0): "L", (8, 0): "L",
              (16, 0): "I;16", (8, 2): "RGB", (16, 2): "RGB", (1, 3): "P",
              (2, 3): "P", (4, 3): "P", (8, 3): "P", (8, 4): "LA",
              (16, 4): "RGBA", (8, 6): "RGBA", (16, 6): "RGBA"}
_JPEG_MODES = {1: "L", 3: "RGB", 4: "CMYK"}
# start-of-frame markers (baseline, extended, progressive, lossless,
# arithmetic): not DHT C4, JPG C8 or DAC CC
_SOF = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD,
        0xCE, 0xCF}


def _jpeg_info(path, f) -> Tuple[int, int, str]:
    """Walk a JPEG's marker segments to its start-of-frame header."""
    f.seek(2)
    while True:
        b = f.read(1)
        if not b:
            break
        if b != b"\xff":
            continue
        marker = f.read(1)
        while marker == b"\xff":                  # fill bytes
            marker = f.read(1)
        if not marker:
            break
        m = marker[0]
        if m == 0x01 or 0xD0 <= m <= 0xD8:          # no length
            continue
        if m in (0xD9, 0xDA):                       # EOI, or scan data
            break
        head = f.read(2)
        if len(head) < 2:
            break
        length = int.from_bytes(head, "big")
        if m in _SOF:
            s = f.read(length - 2)
            if len(s) < 6:
                break
            bits, h, w, layers = (s[0], int.from_bytes(s[1:3], "big"),
                                  int.from_bytes(s[3:5], "big"), s[5])
            if bits != 8 or layers not in _JPEG_MODES:
                raise DecodeError(f"{path}: jpeg image with {bits}-bit "
                                  f"samples and {layers} components")
            return w, h, _JPEG_MODES[layers]
        f.seek(length - 2, 1)
    raise DecodeError(f"{path}: jpeg image without a frame header")


def image_info(path) -> Tuple[int, int, str, str]:
    """``(width, height, mode, format)`` of a JPEG or PNG from its header
    alone (no decode), as PIL's ``Image.open`` reports ``size``, ``mode``
    and ``format``: JPEG ``L`` / ``RGB`` / ``CMYK`` by component count,
    PNG by bit depth and colour type.  Any other format, or a header that
    cannot be read, raises :class:`DecodeError` naming the file."""
    with open(path, "rb") as f:
        head = f.read(8)
        if head.startswith(b"\xff\xd8"):
            return (*_jpeg_info(path, f), "JPEG")
        if head.startswith(PNG_SIGNATURE):
            ihdr = f.read(25)
            if len(ihdr) == 25 and ihdr[4:8] == b"IHDR":
                w, h, depth, colour = struct.unpack(">IIBB", ihdr[8:18])
                mode = _PNG_MODES.get((depth, colour))
                if mode is not None:
                    return w, h, mode, "PNG"
            raise DecodeError(f"{path}: png image with an unreadable "
                              "header")
    raise DecodeError(f"{path}: {image_format(path)} image — the port "
                      "reads JPEG and PNG only (no PIL fallback)")


def load_image(path: Path, size: native.Size) -> np.ndarray:
    """Decode -> RGB -> PIL-exact bilinear resize to ``size`` (an int S for
    S x S, or ``(width, height)``), uint8: the JAX package's
    ``load_image`` (PIL's ``convert('RGB')`` + ``resize(BILINEAR)``) for
    the formats the port decodes."""
    return decode_raw([Path(path)], size)[0]


def decode_bytes(data: bytes, size: native.Size) -> np.ndarray:
    """:func:`load_image` of an image held in memory (an upload): a JPEG
    through the native decoder's in-memory entry, a PNG through
    ``data/png.py``, then the same PIL-exact resize.  Any other format
    raises :class:`DecodeError` naming it."""
    fmt = bytes_format(data[:8])
    if fmt == "jpeg":
        img, status = native.decode_jpeg_bytes_resized(data, size)
        if status:
            raise DecodeError(f"jpeg image {_JPEG_STATUS.get(status)} "
                              f"(status {status})")
        return img
    if fmt == "png":
        try:
            return native.resize_rgb(decode_png(data, "uploaded image"),
                                     size)
        except ValueError as e:
            raise DecodeError(str(e)) from e
    raise DecodeError(f"{fmt} image — the port decodes JPEG and PNG only "
                      "(no PIL fallback)")


def decode_all(paths: Sequence[Optional[Path]], image_size: int,
               cache_dir: Optional[Path] = None) -> np.ndarray:
    """Decode a path list into an (N, S, S, 3) uint8 array; ``None``
    entries are black placeholder rows (a missing modality).

    With a cache directory (``cache_dir=``, the ``DFU_CACHE_DIR``
    environment variable or the ``--cache-dir`` flag) decoding goes
    through the persistent mmap-backed cache (``data/cache.py``)."""
    from dfu_multimodal_tpu_torch.data import cache as cache_mod

    resolved = cache_mod.resolve_cache_dir(cache_dir)
    if resolved is not None:
        return cache_mod.cached_decode(paths, image_size, resolved)
    return decode_raw(paths, image_size)


def decode_raw(paths: Sequence[Optional[Path]],
               image_size: native.Size) -> np.ndarray:
    """The uncached decode behind :func:`decode_all` (and behind each chunk
    of the cache's build — it must never re-enter the cache).  JPEGs
    decode together on the native decoder's threads; PNGs one by one.
    ``image_size``: an int S (S x S) or ``(width, height)``."""
    w, h = native.target_size(image_size)
    out = np.zeros((len(paths), h, w, 3), np.uint8)
    jpegs: List[int] = []
    for i, p in enumerate(paths):
        if p is None:
            continue
        fmt = image_format(p)
        if fmt == "jpeg":
            jpegs.append(i)
        elif fmt == "png":
            try:
                img = read_png(p)
            except ValueError as e:
                raise DecodeError(str(e)) from e
            out[i] = native.resize_rgb(img, image_size)
        else:
            raise DecodeError(
                f"{p}: {fmt} image — the port decodes JPEG and PNG only "
                "(no PIL fallback)")
    if jpegs:
        imgs, status = native.decode_jpegs_resized(
            [str(paths[i]) for i in jpegs], image_size)
        for k, i in enumerate(jpegs):
            if status[k]:
                raise DecodeError(f"{paths[i]}: jpeg image "
                                  f"{_JPEG_STATUS.get(int(status[k]))} "
                                  f"(status {int(status[k])})")
        out[np.asarray(jpegs)] = imgs
    return out


def load_single_modality(modality_dir: Path, split: str,
                         image_size: int = 224,
                         modality: str = "rgb",
                         cache_dir: Optional[Path] = None) -> ArrayDataset:
    """Single-modality dataset (RGBDataset/ThermalDataset contract,
    train_rgb_only.py:55-97)."""
    index: SplitIndex = scan_split(Path(modality_dir), split)
    return ArrayDataset(
        arrays={modality: decode_all(index.paths, image_size,
                                     cache_dir=cache_dir)},
        labels=np.asarray(index.labels, np.int32),
        paths={modality: list(index.paths)},
    )


def load_paired(data_dir: Path, split: str, image_size: int = 224,
                strategy: str = "aligned",
                seed: Optional[int] = None,
                cache_dir: Optional[Path] = None) -> ArrayDataset:
    """Paired dataset. ``strategy='aligned'`` = DFUPairedDataset semantics
    (truncate-to-min); ``'pseudo'`` = MultimodalDataset modulo cycling;
    ``'random'`` = the early-files random label-matched pairing."""
    data_dir = Path(data_dir)
    rgb_by_class = scan_split(data_dir / "rgb", split).by_class()
    th_by_class = scan_split(data_dir / "thermal", split).by_class()
    rgb_counts = [len(rgb_by_class[c]) for c in (0, 1)]
    th_counts = [len(th_by_class[c]) for c in (0, 1)]

    if strategy == "aligned":
        pairs = pairing_mod.aligned_pairs(rgb_counts, th_counts)
    elif strategy == "pseudo":
        pairs = pairing_mod.pseudo_pairs(rgb_counts, th_counts, seed=seed)
    elif strategy == "random":
        pairs = pairing_mod.random_pairs(rgb_counts, th_counts, seed=seed)
    else:
        raise ValueError(f"unknown pairing strategy {strategy!r}")

    rgb_paths = [rgb_by_class[p.label][p.rgb] if p.rgb is not None else None
                 for p in pairs]
    th_paths = [th_by_class[p.label][p.thermal] if p.thermal is not None
                else None for p in pairs]
    labels = np.asarray([p.label for p in pairs], np.int32)

    return ArrayDataset(
        arrays={"rgb": decode_all(rgb_paths, image_size,
                                  cache_dir=cache_dir),
                "thermal": decode_all(th_paths, image_size,
                                      cache_dir=cache_dir)},
        labels=labels,
        paths={"rgb": rgb_paths, "thermal": th_paths},
    )


def get_dataloaders(data_dir: Path, batch_size: int = 12,
                    image_size: int = 224, strategy: str = "aligned",
                    seed: Optional[int] = None, modality: str = "both"):
    """Datasets + a batch-iterator factory per split — the reference's
    ``get_dataloaders`` contract (scripts/dataloader.py:203-244) as
    (datasets, make_batches(split, rng)).

    ``modality``: ``"both"`` (default) pairs the modalities;
    ``"rgb"``/``"thermal"`` return single-modality datasets, and — as in
    the early-files lineage — eval splits batch at
    ``max(16, batch_size // 2)``.  ``make_batches`` yields fixed-shape
    masked batch dicts; training splits shuffle (one generator across
    calls, so every epoch gets a new order), eval splits are
    sequential."""
    if modality not in ("rgb", "thermal", "both"):
        raise ValueError(f"Unknown modality: {modality}")
    if modality == "both":
        datasets = {split: load_paired(data_dir, split, image_size,
                                       strategy=strategy, seed=seed)
                    for split in ("train", "val", "test")}
    else:
        datasets = {split: load_single_modality(
            Path(data_dir) / modality, split, image_size, modality)
            for split in ("train", "val", "test")}

    default_rng = np.random.default_rng(seed)

    def make_batches(split: str, rng: Optional[np.random.Generator] = None):
        ds = datasets[split]
        bs = batch_size
        if split == "train":
            rng = rng or default_rng
            order = rng.permutation(len(ds))
        else:
            order = np.arange(len(ds))
            if modality != "both":
                bs = max(16, batch_size // 2)
        return batch_slices(ds, order, bs)

    return datasets, make_batches


def sample_weights(labels: np.ndarray) -> np.ndarray:
    """Per-sample inverse-class-frequency weights (the reference's
    WeightedRandomSampler input)."""
    counts = np.bincount(labels, minlength=2).astype(np.float64)
    w = np.zeros(len(labels), np.float64)
    for c, n in enumerate(counts):
        if n > 0:
            w[labels == c] = 1.0 / n
    return w


def epoch_indices(labels: np.ndarray, rng: np.random.Generator,
                  weighted: bool = True) -> np.ndarray:
    """One epoch's sample order: weighted-with-replacement (reference
    sampler semantics, num_samples=len) or a plain shuffle."""
    n = len(labels)
    if weighted:
        w = sample_weights(labels)
        total = w.sum()
        if n == 0 or total <= 0:
            raise ValueError(
                f"cannot draw an epoch from {n} samples (weight sum "
                f"{total}): the dataset directory is empty or every class "
                "count is zero")
        return rng.choice(n, size=n, replace=True, p=w / total)
    return rng.permutation(n)


def batch_slices(dataset: ArrayDataset, order: np.ndarray, batch_size: int,
                 pad_to_batch: bool = True
                 ) -> Iterator[Dict[str, np.ndarray]]:
    """Yield fixed-shape batch dicts with a ``valid`` mask: a ragged last
    batch is padded with row 0, masked out of loss and metrics."""
    n = len(order)
    for start in range(0, n, batch_size):
        idx = order[start:start + batch_size]
        valid_n = len(idx)
        if valid_n < batch_size and pad_to_batch:
            idx = np.concatenate([idx, np.zeros(batch_size - valid_n,
                                                idx.dtype)])
        batch = {m: arr[idx] for m, arr in dataset.arrays.items()}
        batch["label"] = dataset.labels[idx].astype(np.int32)
        valid = np.zeros(len(idx), np.float32)
        valid[:valid_n] = 1.0
        batch["valid"] = valid
        yield batch


def shard_batch(batch: Dict[str, Union[np.ndarray, torch.Tensor]],
                rank: int, world: int) -> Tuple[Dict, int, int]:
    """(this rank's rows of a global batch, lo, n): rank ``rank`` of
    ``world`` data-parallel ranks takes its ``process_shard`` slice of
    the n rows; every rank iterates the same batch stream (same dataset,
    same epoch order), as in JAX's multi-process loading."""
    n = len(next(iter(batch.values())))
    if n % world:
        raise ValueError(
            f"global batch size {n} must divide evenly over "
            f"{world} processes — pick a batch size "
            "divisible by process_count (pad_batch_to_mesh already "
            "rounds to the data axis)")
    from dfu_multimodal_tpu_torch.parallel.mesh import process_shard
    lo, hi = process_shard(n, rank, world)
    return {k: v[lo:hi] for k, v in batch.items()}, lo, n


def device_prefetch(batches: Iterator[Dict[str, np.ndarray]],
                    device: Union[str, torch.device], depth: int = 2
                    ) -> Iterator[Dict[str, torch.Tensor]]:
    """Keep ``depth`` batches in flight on ``device``: on a CUDA device
    each array is copied from pinned host memory with ``non_blocking``,
    so the copy overlaps the previous step's compute."""
    device = torch.device(device)
    pin = device.type == "cuda"
    queue: collections.deque = collections.deque()

    def put(batch):
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if pin:
                t = t.pin_memory()
            out[k] = t.to(device, non_blocking=pin)
        return out

    for batch in batches:
        queue.append(put(batch))
        if len(queue) > depth:
            yield queue.popleft()
    while queue:
        yield queue.popleft()
