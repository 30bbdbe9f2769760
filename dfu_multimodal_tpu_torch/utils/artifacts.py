"""Result-artifact IO in the reference's formats (counterpart of
``dfu_multimodal_tpu/utils/artifacts.py``).

The reference persists results as ``torch.save`` dicts
(``test_results.pt``, ``results.pt``, ``tta_results.pt`` — reference
notebooks/train_rgb_only.py:372-379); the same file names and keys are
kept, with numpy arrays and plain Python values inside, so the JAX
package's ``load_pt`` and the port's read each other's files.  Files
written as raw pickles before the JAX package adopted torch's container
are read too.
"""

from __future__ import annotations

import pickle
import zipfile
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch


def _to_saveable(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_saveable(v) for v in obj)
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if hasattr(obj, "__array__") and not np.isscalar(obj):
        return np.asarray(obj)
    return obj


def save_pt(payload: Dict, path: Path) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(_to_saveable(payload), path)
    return path


def load_pt(path: Path) -> Dict:
    # raw-pickle files (no ZIP container) make torch.load raise an
    # invalid-magic error: route by container format first
    if not zipfile.is_zipfile(path):
        with open(path, "rb") as f:
            return pickle.load(f)
    return torch.load(path, map_location="cpu", weights_only=False)
