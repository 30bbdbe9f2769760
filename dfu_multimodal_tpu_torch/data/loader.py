"""Host half of the data path (counterpart of
``dfu_multimodal_tpu/data/loader.py``): an in-memory uint8 dataset,
weighted-with-replacement epoch sampling, fixed-shape masked batches, and
a double-buffered host->device copy.  Decoding from disk is not ported
yet (the train CLIs need it; ROADMAP Queue A)."""

from __future__ import annotations

import collections
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Union

import numpy as np
import torch


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
