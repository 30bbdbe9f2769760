"""Throughput and profiling for training runs (counterpart of
``dfu_multimodal_tpu/utils/logging.py``).

- :class:`ThroughputMeter`: steps/s and images/s on the host clock,
  updated by ``Trainer.run_train_epoch`` after every step;
- :func:`profile_trace`: a ``torch.profiler`` trace (host and, on a card,
  device activity) written as a Chrome trace under a directory.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator, Optional

import torch

TRACE_NAME = "trace.json"


@dataclass
class ThroughputMeter:
    """Windowed steps/s and images/s of the global batches, and per chip
    over ``n_chips`` (the ranks of a data-parallel run; 1 alone).  The
    step's work is asynchronous on a card: read the meter after something
    has waited for the device (the epoch's metrics reduction does)."""

    n_chips: int = 1
    start_time: float = field(default_factory=time.perf_counter)
    steps: int = 0
    images: int = 0

    def update(self, batch_size: int, metrics=None) -> None:
        self.steps += 1
        self.images += batch_size

    def reset(self) -> None:
        self.start_time = time.perf_counter()
        self.steps = 0
        self.images = 0

    @property
    def elapsed(self) -> float:
        return max(time.perf_counter() - self.start_time, 1e-9)

    @property
    def steps_per_sec(self) -> float:
        return self.steps / self.elapsed

    @property
    def images_per_sec(self) -> float:
        return self.images / self.elapsed

    @property
    def images_per_sec_per_chip(self) -> float:
        return self.images_per_sec / max(self.n_chips, 1)

    def summary(self) -> str:
        return (f"{self.steps_per_sec:.2f} steps/s, "
                f"{self.images_per_sec:.1f} img/s "
                f"({self.images_per_sec_per_chip:.1f} img/s/chip)")


@contextlib.contextmanager
def profile_trace(trace_dir: Optional[Path]) -> Iterator[None]:
    """``torch.profiler`` over the block, its Chrome trace written to
    ``trace_dir/trace.json``; CUDA activity is traced when a card is
    there.  A no-op when ``trace_dir`` is None."""
    if trace_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    trace_dir = Path(trace_dir)
    trace_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(trace_dir / TRACE_NAME))
