"""K-fold cross-validation for the single-modality classifiers (the port's
counterpart of ``dfu_multimodal_tpu/cli/cross_validate.py``).

Beyond-reference, opt-in surface.  The reference trains and reports on ONE
fixed 70/15/15 split (reference scripts/organize_clean_dataset.py:217-227);
at its dataset scale (~130-280 test images) single-split metrics carry
several points of split-assignment noise on top of binomial noise.  This
harness pools the train+val rows (the test split stays untouched), trains K
models on stratified — or pseudo-patient-grouped, reusing the reference's
``img_num // 5`` grouping (patient_level_split.py:35-58) — folds, and
reports per-fold metrics with mean ± std:

    python -m dfu_multimodal_tpu_torch.cli.cross_validate \\
        --data-dir data --modality rgb --folds 5 [--group-by-patient]

Each fold is a full Trainer run (same engine, same reference hyperparameter
defaults as the train CLIs); fold models are NOT checkpointed — the output
is the estimate (``cross_validation_<modality>/cv_results.pt`` + printed
table), not a deployable artifact.  Folds are deterministic in ``--seed``.
Each fold trains on ``--device`` (default ``cuda``; ``cpu`` asks for the
host) from weights drawn by ``zoo.init_model`` from ``--seed``, as the
train CLIs draw them; its model and optimizer are released before the
next fold starts.
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

import torch

from dfu_multimodal_tpu_torch import config as cfg_mod
from dfu_multimodal_tpu_torch.cli._train_common import (VIT_MODELS,
                                                        resolve_device)
from dfu_multimodal_tpu_torch.config import TrainConfig
from dfu_multimodal_tpu_torch.data import pairing as pairing_mod
from dfu_multimodal_tpu_torch.data.loader import (ArrayDataset,
                                                  load_single_modality)
from dfu_multimodal_tpu_torch.eval import metrics as metrics_mod
from dfu_multimodal_tpu_torch.models import zoo
from dfu_multimodal_tpu_torch.tools.splits import pseudo_patient_id
from dfu_multimodal_tpu_torch.train.engine import (Trainer,
                                                   class_weights_from_labels)
from dfu_multimodal_tpu_torch.utils.artifacts import save_pt

SUMMARY_KEYS = ("accuracy", "f1", "sensitivity", "specificity", "auc_roc")


def stratified_folds(labels: np.ndarray, k: int,
                     rng: np.random.Generator) -> List[np.ndarray]:
    """K disjoint index sets covering every row, each with ~1/k of every
    class (shuffle within class, deal round-robin)."""
    labels = np.asarray(labels)
    if k < 2:
        raise ValueError(f"need at least 2 folds, got {k}")
    folds: List[List[int]] = [[] for _ in range(k)]
    for cls in np.unique(labels):
        idx = np.flatnonzero(labels == cls)
        rng.shuffle(idx)
        for j, i in enumerate(idx):
            folds[j % k].append(int(i))
    counts = [len(f) for f in folds]
    if min(counts) == 0:
        raise ValueError(f"{k} folds over {len(labels)} rows leaves an "
                         "empty fold — lower --folds")
    return [np.sort(np.asarray(f)) for f in folds]


def grouped_folds(labels: np.ndarray, groups: List[str], k: int,
                  rng: np.random.Generator) -> List[np.ndarray]:
    """Group-level K folds: every row of a group lands in the same fold
    (no pseudo-patient straddles a train/val boundary), dealt in two
    greedy passes for CLASS balance as well as size balance: groups
    containing the minority class go first (largest minority count onto
    the fold with the fewest minority rows, ties by size), then the
    remaining groups largest-first onto the smallest fold.  A fold can
    still end up single-class when the minority class lives in fewer
    than k groups — that is a property of the data; the caller warns."""
    labels = np.asarray(labels)
    if k < 2:
        raise ValueError(f"need at least 2 folds, got {k}")
    by_group: Dict[str, List[int]] = {}
    for i, g in enumerate(groups):
        by_group.setdefault(g, []).append(i)
    names = sorted(by_group)
    rng.shuffle(names)
    names.sort(key=lambda g: -len(by_group[g]))   # stable: keeps shuffle ties
    classes, counts = np.unique(labels, return_counts=True)
    minority = classes[int(np.argmin(counts))] if len(classes) > 1 else None
    g_min = {g: (int(np.sum(labels[by_group[g]] == minority))
                 if minority is not None else 0) for g in names}
    first = sorted((g for g in names if g_min[g] > 0),
                   key=lambda g: -g_min[g])       # stable over names order
    rest = [g for g in names if g_min[g] == 0]
    sizes, mins = [0] * k, [0] * k
    folds: List[List[int]] = [[] for _ in range(k)]
    for g in first:
        j = min(range(k), key=lambda j: (mins[j], sizes[j]))
        folds[j].extend(by_group[g])
        sizes[j] += len(by_group[g])
        mins[j] += g_min[g]
    for g in rest:
        j = int(np.argmin(sizes))
        folds[j].extend(by_group[g])
        sizes[j] += len(by_group[g])
    if min(sizes) == 0:
        raise ValueError(f"{k} folds over {len(names)} groups leaves an "
                         "empty fold — lower --folds or --group-size")
    return [np.sort(np.asarray(f)) for f in folds]


def _subset(ds: ArrayDataset, idx: np.ndarray) -> ArrayDataset:
    return ArrayDataset(
        arrays={m: a[idx] for m, a in ds.arrays.items()},
        labels=ds.labels[idx],
        paths={m: [p[i] for i in idx] for m, p in ds.paths.items()})


def pair_pools(rgb_ds: ArrayDataset, th_ds: ArrayDataset,
               rgb_idx: np.ndarray, th_idx: np.ndarray,
               seed: Optional[int]) -> ArrayDataset:
    """Pseudo-pair (modulo cycling, reference
    train_multimodal_fusion.py:114-137) the selected rows of two
    single-modality pools into a paired dataset — the per-fold analogue
    of ``load_paired(strategy='pseudo')``, operating on already-decoded
    arrays so each CV fold re-pairs its own rows."""
    rgb_by_class = {c: rgb_idx[rgb_ds.labels[rgb_idx] == c] for c in (0, 1)}
    th_by_class = {c: th_idx[th_ds.labels[th_idx] == c] for c in (0, 1)}
    pairs = pairing_mod.pseudo_pairs(
        [len(rgb_by_class[c]) for c in (0, 1)],
        [len(th_by_class[c]) for c in (0, 1)], seed=seed)
    rgb_rows = np.asarray([rgb_by_class[p.label][p.rgb] for p in pairs])
    th_rows = np.asarray([th_by_class[p.label][p.thermal] for p in pairs])
    return ArrayDataset(
        arrays={"rgb": rgb_ds.arrays["rgb"][rgb_rows],
                "thermal": th_ds.arrays["thermal"][th_rows]},
        labels=np.asarray([p.label for p in pairs], np.int32))


def _pool(parts: List[ArrayDataset]) -> ArrayDataset:
    mods = parts[0].modalities
    return ArrayDataset(
        arrays={m: np.concatenate([p.arrays[m] for p in parts])
                for m in mods},
        labels=np.concatenate([p.labels for p in parts]),
        paths={m: sum((list(p.paths.get(m, [None] * len(p)))
                       for p in parts), [])
               for m in mods})


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="K-fold cross-validation (beyond-reference)")
    cfg_mod.add_common_args(parser)
    parser.add_argument("--modality",
                        choices=["rgb", "thermal", "multimodal"],
                        default="rgb")
    parser.add_argument("--model", default=None,
                        help="model-zoo override (default: rgb_only / "
                             "thermal_only / multimodal per --modality; "
                             "tiny_rgb for smoke runs)")
    parser.add_argument("--folds", type=int, default=5)
    parser.add_argument("--group-by-patient", action="store_true",
                        help="group-level folds via the reference's "
                             "img_num // group-size pseudo-patient ids — "
                             "no patient straddles a fold boundary")
    parser.add_argument("--group-size", type=int, default=5)
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--attention-impl", default="auto",
                        choices=["auto", "xla", "pallas"])
    return parser


def main(argv=None) -> Dict[str, Dict]:
    args = build_parser().parse_args(argv)
    data_cfg = cfg_mod.data_config_from_args(args)
    device = resolve_device(args.device)

    if args.modality == "rgb":
        zoo_name = args.model or "rgb_only"
        modalities = {"rgb": cfg_mod.rgb_modality()}
        defaults = TrainConfig()                       # batch 32 (reference)
    elif args.modality == "thermal":
        zoo_name = args.model or "thermal_only"
        modalities = {"thermal": cfg_mod.thermal_modality()}
        defaults = TrainConfig(batch_size=16)          # reference thermal
    else:                                              # multimodal
        zoo_name = args.model or "multimodal"
        modalities = {"rgb": cfg_mod.rgb_modality(),
                      "thermal": cfg_mod.thermal_modality()}
        defaults = TrainConfig(batch_size=6)           # reference fusion
    cfg = cfg_mod.train_config_from_args(args, defaults)

    print("=" * 70)
    print(f"{args.folds}-FOLD CROSS-VALIDATION — {args.modality.upper()} "
          f"({zoo_name})")
    print("=" * 70)

    def load_pool(modality: str) -> ArrayDataset:
        mod_dir = Path(data_cfg.data_dir) / modality
        pool = _pool([load_single_modality(mod_dir, split, args.image_size,
                                           modality,
                                           cache_dir=data_cfg.cache_dir)
                      for split in ("train", "val")])
        print(f"Pooled {modality} train+val: {len(pool)} rows "
              f"(healthy {pool.class_counts[0]}, "
              f"ulcer {pool.class_counts[1]}); test split untouched")
        return pool

    rng = np.random.default_rng(cfg.seed)

    def make_folds(pool: ArrayDataset, modality: str) -> List[np.ndarray]:
        if args.group_by_patient:
            names = [(p.name if p is not None else str(i))
                     for i, p in enumerate(pool.paths[modality])]
            groups = [pseudo_patient_id(n, args.group_size) for n in names]
            print(f"Group-level {modality} folds over {len(set(groups))} "
                  f"pseudo-patients (group size {args.group_size})")
            return grouped_folds(pool.labels, groups, args.folds, rng)
        return stratified_folds(pool.labels, args.folds, rng)

    pools = {m: load_pool(m) for m in modalities}
    fold_sets = {m: make_folds(pools[m], m) for m in modalities}

    fold_metrics: List[Dict] = []
    for i in range(1, args.folds + 1):
        if args.modality == "multimodal":
            # fold each modality pool independently, pseudo-pair within
            # the fold (the multimodal data is unpaired by nature —
            # SURVEY.md §0; each fold re-pairs its own rows)
            tr, va = {}, {}
            for m in pools:
                va[m] = fold_sets[m][i - 1]
                tr[m] = np.setdiff1d(np.arange(len(pools[m])), va[m])
            train_ds = pair_pools(pools["rgb"], pools["thermal"],
                                  tr["rgb"], tr["thermal"],
                                  seed=cfg.seed + i)
            val_ds = pair_pools(pools["rgb"], pools["thermal"],
                                va["rgb"], va["thermal"],
                                seed=cfg.seed + 1000 + i)
        else:
            pool = pools[args.modality]
            val_idx = fold_sets[args.modality][i - 1]
            train_idx = np.setdiff1d(np.arange(len(pool)), val_idx)
            train_ds = _subset(pool, train_idx)
            val_ds = _subset(pool, val_idx)
        print(f"\n--- Fold {i}/{args.folds}: train {len(train_ds)} / "
              f"val {len(val_ds)} "
              f"(val ulcer {int(val_ds.class_counts[1])}) ---")
        if 0 in (int(val_ds.class_counts[0]), int(val_ds.class_counts[1])):
            # possible under --group-by-patient when the minority class
            # lives in fewer groups than folds: the fold's sens/spec/F1
            # degenerate and drop out of the NaN-filtered summary — say
            # so instead of silently averaging fewer folds than claimed
            print("  WARNING: single-class val fold — sensitivity/"
                  "specificity/F1 are degenerate here and excluded from "
                  "the summary means")
        # per-fold steps_per_epoch (ceil, matching run_train_epoch) so
        # --lr-schedule cosine/--warmup-epochs work exactly as in the
        # train CLIs (_train_common.py) instead of raising
        fold_cfg = dataclasses.replace(
            cfg, steps_per_epoch=max(
                1, -(-len(train_ds) // cfg.batch_size)))
        kwargs = ({"attention_impl": args.attention_impl}
                  if zoo_name in VIT_MODELS else {})
        trainer = Trainer(zoo_name, fold_cfg, modalities,
                          class_weights=class_weights_from_labels(
                              train_ds.labels),
                          device=device, image_size=args.image_size,
                          **kwargs)
        zoo.init_model(trainer.module, torch.Generator(
            device=device).manual_seed(fold_cfg.seed))
        trainer.fit(train_ds, val_ds, checkpoint_dir=None)
        # score the weights a deployment would serve: with --ema-decay
        # the trainer validated (and would checkpoint) the EMA weights,
        # so the fold metric must use them too, not the raw final params
        with trainer.ema_weights():
            _, arrays = trainer.run_eval_epoch(val_ds)
        del trainer                  # this fold's model and optimizer
        m = metrics_mod.compute_all_metrics(arrays["y_true"],
                                            arrays["y_pred"],
                                            arrays["y_probs"])
        fold_metrics.append(m)
        print(f"Fold {i}: acc={m['accuracy']:.4f} f1={m['f1']:.4f} "
              f"sens={m['sensitivity']:.4f} spec={m['specificity']:.4f}")

    summary: Dict[str, Dict] = {}
    print("\n" + "=" * 70)
    print(f"CROSS-VALIDATION SUMMARY ({args.folds} folds)")
    print("=" * 70)
    for key in SUMMARY_KEYS:
        vals = np.asarray([float(m[key]) for m in fold_metrics
                           if m[key] is not None], np.float64)
        vals = vals[~np.isnan(vals)]
        if vals.size == 0:
            continue
        summary[key] = {"mean": float(vals.mean()),
                        "std": float(vals.std(ddof=1)) if vals.size > 1
                        else 0.0,
                        "min": float(vals.min()), "max": float(vals.max()),
                        "folds": vals.tolist()}
        s = summary[key]
        print(f"  {key:14s} {s['mean']:.4f} ± {s['std']:.4f}  "
              f"[{s['min']:.4f}, {s['max']:.4f}]")

    out_dir = (Path(data_cfg.checkpoint_root)
               / f"cross_validation_{args.modality}")
    out_dir.mkdir(parents=True, exist_ok=True)
    save_pt({"fold_metrics": fold_metrics, "summary": summary,
             "folds": {m: [f.tolist() for f in fs]
                       for m, fs in fold_sets.items()},
             "config": {"folds": args.folds, "modality": args.modality,
                        "model": zoo_name, "seed": cfg.seed,
                        "group_by_patient": bool(args.group_by_patient),
                        "epochs": cfg.num_epochs}},
            out_dir / "cv_results.pt")
    print(f"\nSaved to {out_dir / 'cv_results.pt'}")
    return summary


if __name__ == "__main__":
    main()
