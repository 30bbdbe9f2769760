"""Split pipelines: the legacy random split and the patient-level
(grouped) split (the port's copy of ``dfu_multimodal_tpu/tools/splits.py``).

Counterparts of reference scripts/prepare_datasets.py (legacy 70/15/15
random split; thermal test carved 85/15 from its train pool, SURVEY.md §2
#3) and scripts/patient_level_split.py (pseudo-patient grouping
``img_num // 5`` and group-level splitting to prevent within-patient
leakage, :35-58, :147-190).

Every split goes through :func:`train_test_split`, numpy's statement of
scikit-learn's ``train_test_split(items, test_size=t, random_state=s)``
(the reference's call): one route, so the port splits as the reference
does on a host without scikit-learn.
"""

from __future__ import annotations

import math
import re
import shutil
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

RANDOM_SEED = 42
Item = Tuple[Path, str]            # (path, class_name)


def train_test_split(items: Sequence, test_size: float,
                     seed: int) -> Tuple[List, List]:
    """scikit-learn's ``train_test_split(items, test_size=test_size,
    random_state=seed)`` for a float ``test_size`` in (0, 1): the test side
    takes the first ``ceil(test_size * n)`` of
    ``RandomState(seed).permutation(n)``, the train side the rest, each in
    permutation order.  An empty train side raises ``ValueError``, as
    scikit-learn does."""
    items = list(items)
    n = len(items)
    n_test = math.ceil(test_size * n)
    n_train = n - n_test
    if n_train <= 0:
        raise ValueError(
            f"With n_samples={n}, test_size={test_size} and "
            "train_size=None, the resulting train set will be empty. "
            "Adjust any of the aforementioned parameters.")
    perm = np.random.RandomState(seed).permutation(n)
    return ([items[i] for i in perm[n_test:]],
            [items[i] for i in perm[:n_test]])


# --------------------------------------------------------- legacy pipeline

def random_split_70_15_15(items: Sequence, seed: int = RANDOM_SEED):
    """The legacy prepare_datasets split: 70 train / 15 val / 15 test."""
    train, temp = train_test_split(items, 0.3, seed)
    val, test = train_test_split(temp, 0.5, seed)
    return train, val, test


def carve_test_from_train(train_items: Sequence, fraction: float = 0.15,
                          seed: int = RANDOM_SEED):
    """Thermal quirk of the legacy pipeline: the raw dataset has no test
    split, so 15% of train becomes test (prepare_datasets.py thermal path)."""
    remaining, test = train_test_split(train_items, fraction, seed)
    return remaining, test


# --------------------------------------------------- patient-level pipeline

def pseudo_patient_id(filename: str, group_size: int = 5,
                      prefix: str = "group") -> str:
    """``img_num // group_size`` pseudo-patient grouping from the first
    number in the filename (patient_level_split.py:35-58)."""
    match = re.search(r"(\d+)", filename)
    num = int(match.group(1)) if match else 0
    return f"{prefix}_{num // group_size}"


def group_items(items: Sequence[Item], group_size: int = 5,
                prefix: str = "group") -> Dict[str, List[Item]]:
    groups: Dict[str, List[Item]] = defaultdict(list)
    for path, cls in items:
        groups[pseudo_patient_id(Path(path).name, group_size,
                                 prefix)].append((path, cls))
    return dict(groups)


def patient_level_split(groups: Dict[str, List[Item]],
                        test_size: float = 0.3, val_size: float = 0.5,
                        seed: int = RANDOM_SEED
                        ) -> Tuple[List[Item], List[Item], List[Item]]:
    """Split at the GROUP level so one pseudo-patient's images can never
    straddle splits (:147-190)."""
    patient_ids = sorted(groups)
    train_p, temp_p = train_test_split(patient_ids, test_size, seed)
    val_p, test_p = train_test_split(temp_p, val_size, seed)

    def collect(pids):
        out: List[Item] = []
        for pid in pids:
            out.extend(groups[pid])
        return out

    return collect(train_p), collect(val_p), collect(test_p)


def materialize_split(split_items: Dict[str, List[Item]], out_dir: Path,
                      copy: bool = True) -> Dict[str, Dict[str, int]]:
    """Write ``out_dir/{split}/{class}/`` from {'train': [(path, cls)...]}.
    Returns per-split per-class counts."""
    counts: Dict[str, Dict[str, int]] = {}
    for split, items in split_items.items():
        counts[split] = defaultdict(int)
        for path, cls in items:
            dst = Path(out_dir) / split / cls
            dst.mkdir(parents=True, exist_ok=True)
            target = dst / Path(path).name
            if copy:
                shutil.copy2(path, target)
            counts[split][cls] += 1
        counts[split] = dict(counts[split])
    return counts


def leakage_check_groups(split_items: Dict[str, List[Item]],
                         group_size: int = 5) -> int:
    """Number of pseudo-patient groups appearing in more than one split."""
    seen: Dict[str, set] = defaultdict(set)
    for split, items in split_items.items():
        for path, _ in items:
            seen[pseudo_patient_id(Path(path).name, group_size)].add(split)
    return sum(1 for splits in seen.values() if len(splits) > 1)
