"""Persisted deployment configuration: tune once, serve everywhere.
(The port's copy of ``dfu_multimodal_tpu/eval/deployment.py``.)

The clinical operating point (eval/threshold.py) and calibration
temperature (eval/calibration.py) are fitted on a VALIDATION split at
evaluation time — but they are only useful if inference actually applies
them. This module stores them next to the checkpoint they were tuned for
(``<checkpoint_dir>/deployment.json``), and ``predict`` / ``serve`` load
them by default (explicit ``--threshold`` / ``--temperature`` flags
override; ``--ignore-deployment`` opts out), so a deployment can't silently
drop its tuning. Written by ``extended_metrics --save-deployment``;
``export_model`` copies it into frozen serving bundles.  (The port writes
the file with its ``extended_metrics`` and reads it in its ``predict`` and
``serve``, shadows included; ``export_model`` is not ported yet,
``serve/export.py``.)

No reference analogue: the reference hard-codes argmax-0.5 and has no
calibration concept (notebooks/extended_metrics.py:592-593).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Tuple

DEPLOYMENT_NAME = "deployment.json"


def save_deployment(checkpoint_dir: Path, *,
                    threshold: Optional[float] = None,
                    temperature: Optional[float] = None,
                    operating_point: Optional[Dict] = None,
                    temperature_info: Optional[Dict] = None,
                    source: str = "") -> Path:
    """Write ``deployment.json``. ``operating_point`` /
    ``temperature_info`` carry the selection diagnostics (strategy,
    selection-split sens/spec, before/after NLL+ECE) for auditability.
    When a temperature is present, ``threshold`` must have been selected
    on temperature-SCALED probabilities — inference applies T first."""
    checkpoint_dir = Path(checkpoint_dir)
    checkpoint_dir.mkdir(parents=True, exist_ok=True)
    payload = {
        "threshold": None if threshold is None else float(threshold),
        "temperature": None if temperature is None else float(temperature),
        "operating_point": operating_point,
        "temperature_info": temperature_info,
        "source": source,
    }
    path = checkpoint_dir / DEPLOYMENT_NAME
    path.write_text(json.dumps(payload, indent=2))
    return path


def load_deployment(checkpoint_dir: Path) -> Dict:
    path = Path(checkpoint_dir) / DEPLOYMENT_NAME
    if not path.exists():
        return {}
    return json.loads(path.read_text())


def resolve_deployment(checkpoint_dir: Optional[Path],
                       threshold: Optional[float],
                       temperature: Optional[float],
                       ignore: bool = False
                       ) -> Tuple[Optional[float], Optional[float], str]:
    """Merge explicit CLI values with the checkpoint's deployment.json:
    explicit flags win per-field; ``ignore`` skips the file entirely.
    Returns ``(threshold, temperature, note)`` where ``note`` says what
    was loaded (empty if nothing came from the file)."""
    if ignore or checkpoint_dir is None:
        return threshold, temperature, ""
    dep = load_deployment(checkpoint_dir)
    if not dep:
        return threshold, temperature, ""
    loaded = []
    if threshold is None and dep.get("threshold") is not None:
        threshold = float(dep["threshold"])
        loaded.append(f"threshold={threshold:.4f}")
    if temperature is None and dep.get("temperature") is not None:
        temperature = float(dep["temperature"])
        loaded.append(f"temperature={temperature:.4f}")
    note = (f"deployment.json: {', '.join(loaded)}" if loaded else "")
    return threshold, temperature, note
