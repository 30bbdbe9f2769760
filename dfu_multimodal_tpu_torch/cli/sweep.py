"""Hyperparameter sweep harness: grid and random search over TrainConfig
(the port's counterpart of ``dfu_multimodal_tpu/cli/sweep.py``).

Beyond-reference, opt-in surface.  The reference explores hyperparameters
by editing module constants and re-running scripts by hand ("CHANGE THESE"
comments are its config UX — reference notebooks/train_rgb_only.py:32-46);
its one systematic comparison is the fixed two-arm ablation harness
(notebooks/ablation_study.py).  This CLI makes the search a first-class,
resumable tool over the same Trainer engine::

    # grid: cartesian product of discrete value lists
    python -m dfu_multimodal_tpu_torch.cli.sweep --data-dir data \\
        --modality rgb --param lr=1e-4,3e-4,1e-3 \\
        --param weight_decay=1e-4,1e-5

    # random search: sample 16 trials from continuous/discrete spaces
    python -m dfu_multimodal_tpu_torch.cli.sweep --data-dir data \\
        --modality thermal --random 16 \\
        --param 'lr=log(1e-5,1e-3)' --param 'ema_decay=uniform(0,0.999)' \\
        --param lr_schedule=constant,cosine

Each trial is a full ``Trainer.fit`` on the standard train/val splits (the
test split is never touched — model selection on test is leakage), scored
by best validation F1 (the same criterion the trainers checkpoint on).
Trials stream to ``sweep_<modality>/trials.jsonl`` as they finish; re-running
the same command with ``--resume`` skips every trial already recorded, so a
preempted sweep continues where it stopped.  ``--replicates K`` re-runs each
configuration under K seeds and ranks by mean score — at reference dataset
scale (~150-400 val rows) single-run scores carry points of seed noise.
Every trial trains on ``--device`` (default ``cuda``; ``cpu`` asks for
the host) from weights drawn by ``zoo.init_model`` from its seed, as the
train CLIs draw them.  The resume key hashes the JAX package's context
keys (the device is not one), so the two packages key a trial alike.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import itertools
import json
import re
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from dfu_multimodal_tpu_torch import config as cfg_mod
from dfu_multimodal_tpu_torch.cli._train_common import (VIT_MODELS,
                                                        resolve_device)
from dfu_multimodal_tpu_torch.config import TrainConfig
from dfu_multimodal_tpu_torch.data.loader import (load_paired,
                                                  load_single_modality)
from dfu_multimodal_tpu_torch.models import zoo
from dfu_multimodal_tpu_torch.train.engine import (Trainer,
                                                   class_weights_from_labels)
from dfu_multimodal_tpu_torch.utils.artifacts import save_pt

# CLI spelling -> TrainConfig field.  Only fields that are safe to vary per
# trial are exposed; anything else errors loudly instead of silently doing
# nothing.
PARAM_FIELDS = {
    "lr": "learning_rate",
    "learning_rate": "learning_rate",
    "weight_decay": "weight_decay",
    "batch_size": "batch_size",
    "epochs": "num_epochs",
    "num_epochs": "num_epochs",
    "drop_rate": "drop_rate",
    "ema_decay": "ema_decay",
    "warmup_epochs": "warmup_epochs",
    "lr_schedule": "lr_schedule",
    "grad_accum": "grad_accum",
    "early_stop_patience": "early_stop_patience",
    "loss": "loss",
    "focal_gamma": "focal_gamma",
    "mixup_alpha": "mixup_alpha",
}
INT_FIELDS = {"batch_size", "num_epochs", "grad_accum",
              "early_stop_patience"}

_DIST_RE = re.compile(r"^(log|uniform)\(([^,]+),([^)]+)\)$")


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One --param axis: either a discrete value list or a continuous
    distribution (``log``/``uniform``, random mode only)."""

    field: str                       # TrainConfig field name
    values: Optional[Tuple] = None   # discrete choices
    dist: Optional[str] = None       # 'log' | 'uniform'
    lo: float = 0.0
    hi: float = 0.0

    def sample(self, rng: np.random.Generator):
        if self.values is not None:
            return self.values[int(rng.integers(len(self.values)))]
        if self.dist == "log":
            return float(np.exp(rng.uniform(np.log(self.lo),
                                            np.log(self.hi))))
        return float(rng.uniform(self.lo, self.hi))


def _parse_value(field: str, text: str):
    text = text.strip()
    if field in INT_FIELDS:
        return int(text)
    try:
        return float(text)
    except ValueError:
        return text                   # e.g. lr_schedule=cosine


def parse_param(spec: str) -> ParamSpec:
    """``name=v1,v2`` | ``name=log(a,b)`` | ``name=uniform(a,b)``."""
    if "=" not in spec:
        raise ValueError(f"--param needs name=values, got {spec!r}")
    name, _, rhs = spec.partition("=")
    name = name.strip()
    if name not in PARAM_FIELDS:
        raise ValueError(
            f"unknown sweep parameter {name!r}; supported: "
            + ", ".join(sorted(set(PARAM_FIELDS))))
    field = PARAM_FIELDS[name]
    m = _DIST_RE.match(rhs.strip())
    if m:
        dist, lo, hi = m.group(1), float(m.group(2)), float(m.group(3))
        if not 0 <= lo < hi:
            raise ValueError(f"need 0 <= lo < hi in {spec!r}")
        if dist == "log" and lo <= 0:
            raise ValueError(f"log-uniform needs lo > 0 in {spec!r}")
        return ParamSpec(field, dist=dist, lo=lo, hi=hi)
    values = tuple(_parse_value(field, v) for v in rhs.split(",") if v.strip())
    if not values:
        raise ValueError(f"--param {spec!r} has no values")
    return ParamSpec(field, values=values)


def enumerate_trials(specs: Sequence[ParamSpec], random_n: int,
                     seed: int) -> List[Dict]:
    """Grid (cartesian product; all axes discrete) or ``random_n`` sampled
    configurations.  Deterministic in ``seed``; random mode dedupes exact
    repeats (possible with discrete axes) while preserving sample count
    intent."""
    if random_n <= 0:
        cont = [s.field for s in specs if s.values is None]
        if cont:
            raise ValueError(
                f"continuous spaces ({', '.join(cont)}) need --random N")
        return [dict(zip([s.field for s in specs], combo))
                for combo in itertools.product(*(s.values for s in specs))]
    rng = np.random.default_rng(seed)
    trials, seen = [], set()
    for _ in range(random_n * 20):            # cap resampling of dupes
        t = {s.field: s.sample(rng) for s in specs}
        key = trial_key(t)
        if key not in seen:
            seen.add(key)
            trials.append(t)
        if len(trials) == random_n:
            break
    return trials


def trial_key(params: Dict, context: Optional[Dict] = None) -> str:
    """Stable identity of a configuration (resume key): canonical JSON of
    the sorted params PLUS the non-swept context (model, base config,
    image size, replicates), hashed.  Without the context, re-running a
    widened sweep with e.g. a different --epochs or --model would match
    stale records and silently reuse their scores.  Floats round-trip
    through repr, so the same sampled value always maps to the same
    key."""
    canon = json.dumps({"params": {k: params[k] for k in sorted(params)},
                        "context": context or {}},
                       sort_keys=True, default=repr)
    return hashlib.sha256(canon.encode()).hexdigest()[:16]


def _completed_keys(jsonl: Path) -> Dict[str, Dict]:
    done = {}
    if jsonl.exists():
        for line in jsonl.read_text().splitlines():
            if not line.strip():
                continue
            rec = json.loads(line)
            done[rec["key"]] = rec
    return done


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Hyperparameter sweep: grid / random search "
                    "(beyond-reference)")
    cfg_mod.add_common_args(parser)
    parser.add_argument("--modality",
                        choices=["rgb", "thermal", "multimodal"],
                        default="rgb")
    parser.add_argument("--model", default=None,
                        help="model-zoo override (tiny_rgb for smoke runs)")
    parser.add_argument("--param", action="append", default=[],
                        metavar="NAME=SPEC",
                        help="sweep axis: name=v1,v2,... (discrete), or "
                             "name=log(a,b) / name=uniform(a,b) "
                             "(continuous; --random mode). Repeatable. "
                             "Names: " + ", ".join(sorted(set(PARAM_FIELDS))))
    parser.add_argument("--random", type=int, default=0, metavar="N",
                        help="sample N random configurations instead of "
                             "the full grid")
    parser.add_argument("--replicates", type=int, default=1,
                        help="train each configuration under this many "
                             "seeds (seed, seed+1, ...) and rank by mean "
                             "best-val-F1 — separates config signal from "
                             "seed noise")
    parser.add_argument("--resume", action="store_true",
                        help="skip configurations already recorded in "
                             "trials.jsonl (continue a preempted sweep)")
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--attention-impl", default="auto",
                        choices=["auto", "xla", "pallas"])
    parser.add_argument("--pairing", default="pseudo",
                        choices=["pseudo", "aligned"],
                        help="multimodal pairing strategy")
    return parser


def _train_command(args, data_dir, params: Dict) -> str:
    """The exact single-run CLI reproducing a trial's configuration."""
    cmd = {"rgb": "train-rgb-only", "thermal": "train-thermal-only",
           "multimodal": "train-multimodal-fusion"}[args.modality]
    flag = {"learning_rate": "--lr", "weight_decay": "--weight-decay",
            "batch_size": "--batch-size", "num_epochs": "--epochs",
            "ema_decay": "--ema-decay", "warmup_epochs": "--warmup-epochs",
            "lr_schedule": "--lr-schedule", "grad_accum": "--grad-accum",
            "early_stop_patience": "--early-stop-patience",
            "loss": "--loss", "focal_gamma": "--focal-gamma",
            "mixup_alpha": "--mixup-alpha",
            "drop_rate": None}
    parts = [f"dfu {cmd}", f"--data-dir {data_dir}"]
    notes = []
    for k, v in sorted(params.items()):
        f = flag.get(k)
        if f:
            parts.append(f"{f} {v}")
        else:
            # collected and appended AFTER every flag: a mid-line '#'
            # would comment out the remaining flags when the printed
            # command is pasted into a shell
            notes.append(f"{k}={v}: no single-run flag")
    cmd_line = " ".join(parts)
    if notes:
        cmd_line += "  # (" + "; ".join(notes) + ")"
    return cmd_line


def main(argv=None) -> Dict:
    args = build_parser().parse_args(argv)
    if not args.param:
        raise SystemExit("sweep needs at least one --param axis")
    specs = [parse_param(p) for p in args.param]
    fields = [s.field for s in specs]
    if len(set(fields)) != len(fields):
        raise SystemExit(f"duplicate --param axes: {fields}")
    data_cfg = cfg_mod.data_config_from_args(args)
    device = resolve_device(args.device)

    if args.modality == "rgb":
        zoo_name = args.model or "rgb_only"
        modalities = {"rgb": cfg_mod.rgb_modality()}
        defaults = TrainConfig()
    elif args.modality == "thermal":
        zoo_name = args.model or "thermal_only"
        modalities = {"thermal": cfg_mod.thermal_modality()}
        defaults = TrainConfig(batch_size=16)
    else:
        zoo_name = args.model or "multimodal"
        modalities = {"rgb": cfg_mod.rgb_modality(),
                      "thermal": cfg_mod.thermal_modality()}
        defaults = TrainConfig(batch_size=6)
    base_cfg = cfg_mod.train_config_from_args(args, defaults)

    trials = enumerate_trials(specs, args.random, base_cfg.seed)
    if not trials:
        raise SystemExit("empty trial list")
    # resume identity: swept params + everything else that shapes a
    # trial's score — swept fields excluded so explicit base flags don't
    # double in (they're overridden per trial anyway)
    context = {k: v for k, v in dataclasses.asdict(base_cfg).items()
               if k not in set(fields)}
    context.update(model=zoo_name, image_size=args.image_size,
                   replicates=args.replicates, modality=args.modality,
                   # everything else that shapes a trial's score: a
                   # resumed sweep with a different dataset, pairing
                   # strategy, or kernel impl must NOT reuse old scores
                   data_dir=str(data_cfg.data_dir),
                   pairing=(args.pairing
                            if args.modality == "multimodal" else None),
                   attention_impl=args.attention_impl)

    out_dir = Path(data_cfg.checkpoint_root) / f"sweep_{args.modality}"
    out_dir.mkdir(parents=True, exist_ok=True)
    jsonl = out_dir / "trials.jsonl"
    done = _completed_keys(jsonl) if args.resume else {}

    print("=" * 70)
    print(f"HYPERPARAMETER SWEEP — {args.modality.upper()} ({zoo_name}): "
          f"{len(trials)} configs × {args.replicates} seed(s)"
          + (f", {len(done)} already recorded" if done else ""))
    print("=" * 70)

    def load(split: str):
        if args.modality == "multimodal":
            return load_paired(Path(data_cfg.data_dir), split,
                               args.image_size, strategy=args.pairing,
                               seed=base_cfg.seed,
                               cache_dir=data_cfg.cache_dir)
        mod_dir = Path(data_cfg.data_dir) / args.modality
        return load_single_modality(mod_dir, split, args.image_size,
                                    args.modality,
                                    cache_dir=data_cfg.cache_dir)

    train_ds, val_ds = load("train"), load("val")
    print(f"train {len(train_ds)} / val {len(val_ds)} rows "
          f"(test split untouched)")
    class_weights = class_weights_from_labels(train_ds.labels)
    kwargs = ({"attention_impl": args.attention_impl}
              if zoo_name in VIT_MODELS else {})

    # only records matching THIS sweep's trial identities participate in
    # the ranking — trials.jsonl may hold runs under other configs
    # (different epochs/model/replicates), which must re-run, not rank
    keys = [trial_key(p, context) for p in trials]
    records: List[Dict] = [done[k] for k in keys if k in done]
    for i, (params, key) in enumerate(zip(trials, keys), 1):
        desc = ", ".join(f"{k}={v:.3g}" if isinstance(v, float)
                         else f"{k}={v}" for k, v in sorted(params.items()))
        if key in done:
            print(f"[{i}/{len(trials)}] {desc}  — already recorded, skip")
            continue
        cfg = dataclasses.replace(base_cfg, **params)
        if cfg.lr_schedule != "constant" or cfg.warmup_epochs:
            spe = -(-len(train_ds) // cfg.batch_size)
            cfg = dataclasses.replace(cfg, steps_per_epoch=spe)
        scores, seconds = [], []
        for rep in range(args.replicates):
            rep_cfg = dataclasses.replace(cfg, seed=cfg.seed + rep)
            trainer = Trainer(zoo_name, rep_cfg, modalities,
                              class_weights=class_weights, device=device,
                              image_size=args.image_size, **kwargs)
            zoo.init_model(trainer.module, torch.Generator(
                device=device).manual_seed(rep_cfg.seed))
            t0 = time.perf_counter()
            _, best_f1 = trainer.fit(train_ds, val_ds, checkpoint_dir=None,
                                     log=lambda s: None)
            seconds.append(time.perf_counter() - t0)
            scores.append(float(best_f1))
            del trainer              # this run's model and optimizer
        rec = {
            "key": key, "params": params,
            "best_val_f1_mean": float(np.mean(scores)),
            "best_val_f1_std": (float(np.std(scores, ddof=1))
                                if len(scores) > 1 else 0.0),
            "scores": scores, "seconds": [round(s, 2) for s in seconds],
            "replicates": args.replicates, "model": zoo_name,
            "base_seed": base_cfg.seed,
        }
        with jsonl.open("a") as fh:
            fh.write(json.dumps(rec) + "\n")
        records.append(rec)
        print(f"[{i}/{len(trials)}] {desc}  "
              f"best_val_f1={rec['best_val_f1_mean']:.4f}"
              + (f" ± {rec['best_val_f1_std']:.4f}"
                 if args.replicates > 1 else "")
              + f"  ({sum(seconds):.1f}s)")

    records.sort(key=lambda r: -r["best_val_f1_mean"])
    print("\n" + "=" * 70)
    print(f"SWEEP RANKING (top {min(10, len(records))} of {len(records)})")
    print("=" * 70)
    for rank, rec in enumerate(records[:10], 1):
        desc = ", ".join(f"{k}={v:.3g}" if isinstance(v, float)
                         else f"{k}={v}"
                         for k, v in sorted(rec["params"].items()))
        print(f"  {rank:2d}. {rec['best_val_f1_mean']:.4f}"
              + (f" ± {rec['best_val_f1_std']:.4f}"
                 if rec.get("replicates", 1) > 1 else "")
              + f"  {desc}")
    best = records[0]
    print("\nBest configuration reproduces as:")
    print(f"  {_train_command(args, data_cfg.data_dir, best['params'])}")

    save_pt({"records": records, "best": best,
             "axes": [dataclasses.asdict(s) for s in specs],
             "config": {"modality": args.modality, "model": zoo_name,
                        "random": args.random,
                        "replicates": args.replicates,
                        "seed": base_cfg.seed}},
            out_dir / "sweep_results.pt")
    print(f"\nSaved to {out_dir / 'sweep_results.pt'} "
          f"(stream: {jsonl})")
    return {"best": best, "n_trials": len(records)}


if __name__ == "__main__":
    main()
