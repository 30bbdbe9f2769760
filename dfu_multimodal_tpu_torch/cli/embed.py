"""Embedding extraction, similar-case retrieval, uncertainty triage (the
port's counterpart of ``dfu_multimodal_tpu/cli/embed.py``).

Beyond-reference, opt-in surface (no reference counterpart — the reference
discards its trunk features after the classifier head).  Three workflows:

1. **Build an index** from a labeled split (decode → trunk forward → .npz)::

       python -m dfu_multimodal_tpu_torch.cli.embed \\
           --checkpoint logs/checkpoints_rgb_only \\
           --data-dir data --split train --output train_index.npz

2. **Retrieve similar known cases** for new images — for each input, the
   top-k nearest index rows by cosine similarity in embedding space, with
   their labels, so a clinician can ground a probability in precedent::

       python -m dfu_multimodal_tpu_torch.cli.embed \\
           --checkpoint logs/checkpoints_rgb_only \\
           --images new_cases/ --index train_index.npz --neighbors 5

3. **Active-learning triage**: rank unlabeled images most-uncertain first
   (|P(ulcer) − 0.5| ascending) to spend labeling budget where the model
   is least sure::

       python -m dfu_multimodal_tpu_torch.cli.embed --checkpoint ... \\
           --images pool/ --rank-uncertainty

Outputs: ``.npz`` (``--output``) with per-trunk ``feat_*`` arrays +
probs/preds/paths (+labels in split mode), and/or a CSV (``--csv``) of the
retrieval / triage table.  The forward runs on ``--device`` (default
``cuda``; ``cpu`` asks for the host).
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path

import numpy as np

from dfu_multimodal_tpu_torch import config as cfg_mod
from dfu_multimodal_tpu_torch.cli._train_common import (VIT_MODELS,
                                                        resolve_device)
from dfu_multimodal_tpu_torch.config import TrainConfig
from dfu_multimodal_tpu_torch.data.layout import list_images
from dfu_multimodal_tpu_torch.data.loader import (ArrayDataset, decode_all,
                                                  load_paired,
                                                  load_single_modality)
from dfu_multimodal_tpu_torch.eval import embed as embed_mod
from dfu_multimodal_tpu_torch.eval.calibration import apply_temperature
from dfu_multimodal_tpu_torch.eval.deployment import resolve_deployment
from dfu_multimodal_tpu_torch.eval.threshold import apply_threshold
from dfu_multimodal_tpu_torch.train.engine import Trainer
from dfu_multimodal_tpu_torch.utils import checkpoint as ckpt_mod


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Trunk embeddings: extraction, similar-case retrieval, "
                    "uncertainty triage (beyond-reference)")
    parser.add_argument("--checkpoint", type=Path, required=True)
    parser.add_argument("--model", default=None,
                        help="zoo name; default: checkpoint metadata")
    src = parser.add_argument_group("input source (one of)")
    src.add_argument("--images", type=Path, default=None,
                     help="directory of images (RGB modality for "
                          "multimodal models)")
    src.add_argument("--thermal-images", type=Path, default=None,
                     help="paired thermal directory (multimodal; paired "
                          "by sorted filename order)")
    src.add_argument("--data-dir", type=Path, default=None,
                     help="labeled dataset root (embeds --split with "
                          "labels — index-building mode)")
    parser.add_argument("--split", default="train",
                        choices=["train", "val", "test"])
    parser.add_argument("--embedding", default=None,
                        help="which feature space for retrieval: rgb / "
                             "thermal / fused (default: fused when "
                             "available, else the model's single trunk)")
    parser.add_argument("--index", type=Path, default=None,
                        help="previously written .npz to retrieve "
                             "neighbors from")
    parser.add_argument("--neighbors", type=int, default=5, metavar="K",
                        help="top-k similar index rows per input")
    parser.add_argument("--rank-uncertainty", action="store_true",
                        help="order the report most-uncertain first "
                             "(active-learning triage)")
    parser.add_argument("--near-dup-check", action="store_true",
                        help="leakage audit (needs --data-dir): embed all "
                             "three splits and report cross-split pairs "
                             "above --near-dup-threshold cosine "
                             "similarity — catches re-encoded/resized "
                             "copies the SHA-256 gate cannot see")
    parser.add_argument("--near-dup-threshold", type=float, default=0.99)
    parser.add_argument("--ignore-deployment", action="store_true",
                        help="do not apply <checkpoint>/deployment.json "
                             "(val-tuned threshold/temperature) to the "
                             "reported probs/preds — by default embed "
                             "agrees with predict/serve")
    parser.add_argument("--output", type=Path, default=None,
                        help="write embeddings + probs to this .npz")
    parser.add_argument("--csv", type=Path, default=None,
                        help="write the retrieval/triage table as CSV")
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--compute-dtype", default="bfloat16",
                        choices=["bfloat16", "float32"])
    parser.add_argument("--attention-impl", default="auto",
                        choices=["auto", "xla", "pallas"])
    parser.add_argument("--cache-dir", type=Path, default=None,
                        help="persistent decode cache (data/cache.py)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda, the card); 'cpu' "
                             "runs on the host")
    return parser


def _load_split(trainer, data_dir: Path, split: str, image_size: int,
                cache_dir, seed: int = 0):
    """``(ArrayDataset, {modality: [path str]})`` for one labeled split —
    shared by index-building mode and the near-dup audit (multimodal
    splits are pseudo-paired, the model's input contract)."""
    if len(trainer.spec.inputs) > 1:
        ds = load_paired(Path(data_dir), split, image_size,
                         strategy="pseudo", seed=seed, cache_dir=cache_dir)
    else:
        mod = trainer.spec.inputs[0]
        ds = load_single_modality(Path(data_dir) / mod, split, image_size,
                                  mod, cache_dir=cache_dir)
    paths = {m: [str(p) if p is not None else f"{split}[{i}]"
                 for i, p in enumerate(
                     ds.paths.get(m, [None] * len(ds)))]
             for m in trainer.spec.inputs}
    return ds, paths


def _apply_deployment(out, checkpoint: Path, ignore: bool):
    """Apply the checkpoint's persisted val-tuned deployment config to the
    reported probs/preds, exactly like predict/serve do — embed's triage
    ranking and printed predictions must agree with the deployed system,
    not with raw argmax-at-0.5.  Returns the applied threshold (None when
    argmax), which is also the triage-ranking center."""
    threshold, temperature, note = resolve_deployment(
        checkpoint, None, None, ignore)
    if note:
        print(f"Loaded {note}")
    if temperature is not None:
        out["probs"] = apply_temperature(out["probs"], temperature)
    if threshold is not None:
        out["preds"] = apply_threshold(out["probs"], threshold)
    return threshold


def _pick_embedding(out, requested):
    keys = [k[5:] for k in out if k.startswith("feat_")]
    if requested:
        if f"feat_{requested}" not in out:
            raise SystemExit(f"--embedding {requested!r} not available; "
                             f"have: {sorted(keys)}")
        return requested
    return "fused" if "fused" in keys else keys[0]


def _near_dup_check(args, trainer):
    """Embed every split, report cross-split near-duplicate pairs (the
    leakage the exact-hash gate cannot see).  Audited PER TRUNK SPACE
    (rgb / thermal separately, never the fused concat): in the fused
    space a duplicated RGB image gets a *different* pseudo-paired thermal
    partner per split, diluting its cosine similarity below any sane
    threshold — exactly the duplicate this audit exists to catch.
    Advisory: prints + optional CSV; returns the hit list."""
    per_mod_feats = {m: {} for m in trainer.spec.inputs}
    per_mod_paths = {m: {} for m in trainer.spec.inputs}
    for split in ("train", "val", "test"):
        ds, paths = _load_split(trainer, args.data_dir, split,
                                args.image_size, args.cache_dir)
        out = embed_mod.extract_features(trainer, ds)
        for m in trainer.spec.inputs:
            per_mod_feats[m][split] = out[f"feat_{m}"]
            per_mod_paths[m][split] = paths[m]
        print(f"  {split}: {len(ds)} images embedded "
              f"({', '.join(trainer.spec.inputs)})")

    hits = []
    for m in trainer.spec.inputs:
        for h in embed_mod.cross_split_near_duplicates(
                per_mod_feats[m], per_mod_paths[m],
                args.near_dup_threshold):
            hits.append({**h, "embedding": m})
    hits.sort(key=lambda h: -h["sim"])
    spaces = "/".join(trainer.spec.inputs)
    print(f"\nNEAR-DUPLICATE LEAKAGE AUDIT "
          f"(cosine >= {args.near_dup_threshold}, per-trunk {spaces} "
          f"space{'s' if len(trainer.spec.inputs) > 1 else ''}): "
          f"{len(hits)} cross-split pair(s)")
    for h in hits[:25]:
        print(f"  {h['sim']:.4f}  [{h['embedding']}]  {h['split_a']}/"
              f"{Path(h['path_a']).name}  ~  {h['split_b']}/"
              f"{Path(h['path_b']).name}")
    if len(hits) > 25:
        print(f"  ... {len(hits) - 25} more (see --csv)")
    if not hits:
        print("  no cross-split near-duplicates — splits look clean "
              "beyond the exact-hash gate")
    if args.csv:
        with open(args.csv, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["sim", "embedding", "split_a", "path_a",
                        "split_b", "path_b"])
            for h in hits:
                w.writerow([f"{h['sim']:.6f}", h["embedding"],
                            h["split_a"], h["path_a"],
                            h["split_b"], h["path_b"]])
        print(f"Wrote {args.csv}")
    return {"near_duplicates": hits, "threshold": args.near_dup_threshold,
            "embedding": spaces}


def main(argv=None):
    args = build_parser().parse_args(argv)
    if (args.images is None) == (args.data_dir is None):
        raise SystemExit("give exactly one of --images or --data-dir")
    device = resolve_device(args.device)
    model_name = args.model or ckpt_mod.load_meta(args.checkpoint).get(
        "model", "rgb_only")
    embed_mod.trunk_features(model_name)

    cfg = TrainConfig(batch_size=args.batch_size,
                      eval_batch_size=args.batch_size,
                      compute_dtype=args.compute_dtype,
                      mesh=cfg_mod.MeshConfig(data=-1))
    modalities = {"rgb": cfg_mod.rgb_modality(),
                  "thermal": cfg_mod.thermal_modality()}
    kwargs = ({"attention_impl": args.attention_impl}
              if model_name in VIT_MODELS else {})
    trainer = Trainer(model_name, cfg, modalities, device=device,
                      image_size=args.image_size, **kwargs)
    trainer.restore(args.checkpoint)

    if args.near_dup_check:
        if args.data_dir is None:
            raise SystemExit("--near-dup-check needs --data-dir (it "
                             "audits the train/val/test splits)")
        return _near_dup_check(args, trainer)

    labels = None
    if args.data_dir is not None:
        ds, split_paths = _load_split(trainer, args.data_dir, args.split,
                                      args.image_size, args.cache_dir,
                                      seed=cfg.seed)
        paths = split_paths[trainer.spec.inputs[0]]
        labels = np.asarray(ds.labels)
    else:
        paths = [str(p) for p in list_images(args.images)]
        if not paths:
            raise SystemExit(f"No images found under {args.images}")
        primary = trainer.spec.inputs[0]
        arrays = {primary: decode_all(paths, args.image_size)}
        if len(trainer.spec.inputs) > 1:
            th_paths = ([str(p) for p in list_images(args.thermal_images)]
                        if args.thermal_images else paths)
            n = min(len(paths), len(th_paths))
            paths = paths[:n]
            arrays = {primary: arrays[primary][:n],
                      "thermal": decode_all(th_paths[:n], args.image_size)}
        ds = ArrayDataset(arrays=arrays,
                          labels=np.zeros(len(paths), np.int32))

    print(f"Embedding {len(ds)} images with {model_name} "
          f"({args.compute_dtype})")
    out = embed_mod.extract_features(trainer, ds)
    threshold = _apply_deployment(out, args.checkpoint,
                                  args.ignore_deployment)
    emb_name = _pick_embedding(out, args.embedding)
    feats = out[f"feat_{emb_name}"]
    print(f"Feature spaces: "
          + ", ".join(f"{k[5:]} ({out[k].shape[1]}d)"
                      for k in sorted(out) if k.startswith("feat_"))
          + f"; retrieval space: {emb_name}")

    rows = []          # (path, prob, pred, [neighbors...])
    header = ["path", "prob_ulcer", "prediction"]
    neighbor_cols = 0
    if args.index is not None:
        idx = embed_mod.load_embeddings(args.index)
        idx_emb = str(idx.get("embedding", ""))
        key = f"feat_{idx_emb}" if idx_emb and f"feat_{idx_emb}" in idx \
            else f"feat_{emb_name}"
        if key not in idx:
            raise SystemExit(
                f"index {args.index} has no {key}; it stores "
                f"{[k for k in idx if k.startswith('feat_')]}")
        if idx_emb and idx_emb != emb_name:
            emb_name = idx_emb
            feats = out.get(f"feat_{emb_name}")
            if feats is None:
                raise SystemExit(f"index was built in {emb_name!r} space, "
                                 f"which {model_name} does not produce")
        index_feats = idx[key]
        if index_feats.shape[1] != feats.shape[1]:
            raise SystemExit(
                f"dimension mismatch: inputs {feats.shape[1]}d vs index "
                f"{index_feats.shape[1]}d — was the index built with a "
                "different model/embedding?")
        top, sims = embed_mod.cosine_topk(feats, index_feats,
                                          args.neighbors)
        neighbor_cols = top.shape[1]
        idx_paths = idx.get("paths")
        idx_labels = idx.get("labels")
        for q in range(len(ds)):
            neigh = []
            for j, s in zip(top[q], sims[q]):
                name = (Path(str(idx_paths[j])).name
                        if idx_paths is not None else f"row{j}")
                lab = ("?" if idx_labels is None
                       else ("ulcer" if int(idx_labels[j]) else "healthy"))
                neigh.append((name, lab, float(s)))
            rows.append([paths[q], float(out["probs"][q]),
                         int(out["preds"][q]), neigh])
        for k in range(neighbor_cols):
            header += [f"nn{k+1}_path", f"nn{k+1}_label", f"nn{k+1}_sim"]
    else:
        for q in range(len(ds)):
            rows.append([paths[q], float(out["probs"][q]),
                         int(out["preds"][q]), []])

    if args.rank_uncertainty:
        center = 0.5 if threshold is None else threshold
        order = embed_mod.uncertainty_order(out["probs"], center=center)
        rows = [rows[i] for i in order]
        print(f"\nTriage ranking (most uncertain first; decision "
              f"boundary {center}):")
    print(f"{'image':44s}  P(ulcer)  pred     "
          + ("nearest index cases" if neighbor_cols else ""))
    for path, prob, pred, neigh in rows[:40]:
        line = (f"{Path(path).name:44s}  {prob:8.4f}  "
                f"{'ulcer' if pred else 'healthy':8s}")
        if neigh:
            line += "  " + "; ".join(f"{n}({l},{s:.3f})"
                                     for n, l, s in neigh[:3])
        print(line)
    if len(rows) > 40:
        print(f"... {len(rows) - 40} more (see --csv)")

    if args.csv:
        with open(args.csv, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(header)
            for path, prob, pred, neigh in rows:
                row = [path, f"{prob:.6f}", "ulcer" if pred else "healthy"]
                for n, l, s in neigh:
                    row += [n, l, f"{s:.4f}"]
                w.writerow(row)
        print(f"Wrote {args.csv}")

    if args.output:
        embed_mod.save_embeddings(args.output, out, paths=paths,
                                  labels=labels, model=model_name,
                                  embedding=emb_name)
        print(f"Wrote {args.output} "
              f"({feats.shape[0]} × {feats.shape[1]}d {emb_name})")
    return {"n": len(ds), "embedding": emb_name,
            "dims": int(feats.shape[1])}


if __name__ == "__main__":
    main()
