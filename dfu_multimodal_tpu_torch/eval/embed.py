"""Trunk-embedding extraction and nearest-neighbor case retrieval (the
port's counterpart of ``dfu_multimodal_tpu/eval/embed.py``).

Beyond-reference, opt-in surface (``dfu embed``).  The reference's models
compute 2048-d ResNet / 768-d ViT feature vectors on every forward pass but
throw them away after the classifier head (reference
notebooks/train_multimodal_fusion.py:285-326 keeps only the logits); the
features themselves are clinically useful:

- **Similar-case retrieval**: for a new image, show the most similar
  training cases (cosine similarity in trunk-embedding space) so a
  clinician can ground the model's probability in precedent.
- **Active-learning triage**: rank unlabeled images by decision-boundary
  proximity to spend labeling budget where the model is least certain.
- **Dataset auditing**: near-duplicate detection beyond exact SHA-256
  (the organizer's dedup — tools/organize.py — catches only bit-identical
  files), outlier screening, embedding-space visualization.

The extraction step is the eval forward once a batch on the trainer's
device (on the card: the ViT blocks on K1/K2, the fusion head on K3), the
model recording the head's input in its ``features`` record (``trunk``
for a one-trunk classifier, ``rgb_branch`` / ``thermal_branch`` for the
fusion models): no second forward.  The features are cast to fp32 and
the rows padded to the eval batch dropped.  Retrieval is exact cosine
top-k: at reference scale (≤ a few thousand rows × ≤ 2816 dims) one
matmul, milliseconds on host.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dfu_multimodal_tpu_torch.data import loader as data_loader
from dfu_multimodal_tpu_torch.data.loader import ArrayDataset

# zoo model name -> {embedding name: the model's features record entry},
# the (B, D) feature vector feeding the classifier head
TRUNK_FEATURES: Dict[str, Dict[str, str]] = {
    "rgb_only": {"rgb": "trunk"},                          # (B, 2048)
    "resnet18_rgb": {"rgb": "trunk"},                      # (B, 512)
    "resnet18_thermal": {"thermal": "trunk"},              # (B, 512)
    "thermal_only": {"thermal": "trunk"},                  # (B, 768)
    "multimodal": {"rgb": "rgb_branch",                    # (B, 2048)
                   "thermal": "thermal_branch"},           # (B, 768)
    "tiny_rgb": {"rgb": "trunk"},                          # (B, 32)
    "tiny_thermal": {"thermal": "trunk"},
    "tiny_fusion": {"rgb": "rgb_branch",                   # (B, 32) each
                    "thermal": "thermal_branch"},
}


def trunk_features(model_name: str) -> Dict[str, str]:
    """The features-record entries of ``model_name``; ``ValueError``
    naming it for a zoo model whose features the port does not record
    (the legacy lineage's)."""
    if model_name not in TRUNK_FEATURES:
        raise ValueError(
            f"no trunk-feature mapping for model {model_name!r} (its "
            f"features are not recorded in the port); supported: "
            f"{sorted(TRUNK_FEATURES)}")
    return TRUNK_FEATURES[model_name]


@torch.inference_mode()
def embed_step(trainer, batch: Dict[str, torch.Tensor]
               ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                          torch.Tensor]:
    """One eval forward of ``batch`` (on the trainer's device) ->
    ({modality: (B, D) fp32 features}, probs, preds)."""
    names = trunk_features(trainer.spec.name)
    trainer.module.eval()
    record: Dict[str, torch.Tensor] = {}
    logits = trainer._forward(*trainer._preprocess_eval(batch),
                              features=record).float()
    feats = {m: record[name].float() for m, name in names.items()}
    return (feats, torch.softmax(logits, dim=-1)[:, 1],
            torch.argmax(logits, dim=-1))


def extract_features(trainer, dataset: ArrayDataset
                     ) -> Dict[str, np.ndarray]:
    """Run the model over ``dataset`` capturing trunk embeddings.

    Returns float32 arrays: ``feat_<name>`` per trunk (``(N, D)``),
    ``feat_fused`` (concat over trunks, the fusion head's input layout for
    multimodal models), ``probs`` (``(N,)`` P(ulcer)) and ``preds``.
    """
    if len(dataset) == 0:
        # informative failure like Trainer.run_eval_epoch
        raise ValueError(
            "cannot embed an empty dataset: the split directory has no "
            "images (check the data-dir layout)")
    feat_parts: Dict[str, List[torch.Tensor]] = {}
    prob_parts, pred_parts = [], []
    for batch in data_loader.device_prefetch(
            data_loader.batch_slices(dataset, np.arange(len(dataset)),
                                     trainer.cfg.eval_bs), trainer.device):
        feats, probs, preds = embed_step(trainer, batch)
        for k, v in feats.items():
            feat_parts.setdefault(k, []).append(v)
        prob_parts.append(probs)
        pred_parts.append(preds)

    n = len(dataset)
    out: Dict[str, np.ndarray] = {
        "probs": torch.cat(prob_parts)[:n].cpu().numpy(),
        "preds": torch.cat(pred_parts)[:n].cpu().numpy(),
    }
    names = sorted(feat_parts)
    for k in names:
        out[f"feat_{k}"] = torch.cat(feat_parts[k])[:n].cpu().numpy()
    if len(names) > 1:
        # trunk-concat order matches the fusion head's input layout
        # (models/fusion.py: [rgb | thermal])
        order = [m for m in trainer.spec.inputs if m in feat_parts]
        out["feat_fused"] = np.concatenate(
            [out[f"feat_{m}"] for m in order], axis=1)
    return out


def l2_normalize(x: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    x = np.asarray(x, np.float32)
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), eps)


def cosine_topk(queries: np.ndarray, index: np.ndarray, k: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact cosine top-k: ``(indices, sims)`` each ``(Q, k)``, most
    similar first.  One (Q, D) @ (D, N) matmul."""
    k = min(int(k), index.shape[0])
    sims = l2_normalize(queries) @ l2_normalize(index).T       # (Q, N)
    top = np.argsort(-sims, axis=1)[:, :k]
    return top, np.take_along_axis(sims, top, axis=1)


def cross_split_near_duplicates(
        feats: Dict[str, np.ndarray],
        paths: Dict[str, List[str]],
        threshold: float = 0.99) -> List[Dict]:
    """Embedding-space leakage audit: pairs of images in DIFFERENT splits
    whose trunk embeddings exceed ``threshold`` cosine similarity.

    The SHA-256 leakage gate (data/leakage.py, mirroring reference
    notebooks/train_rgb_only.py:138-165) catches only bit-identical
    files; a re-encoded, resized, or lightly cropped copy of a training
    image sitting in the test split passes it and silently inflates every
    test metric.  Near-identical trunk embeddings are the standard signal
    for that.  Returns ``[{split_a, path_a, split_b, path_b, sim}]``
    sorted most-similar first; splits are compared pairwise in the given
    key order.

    Rows whose path is None (the aligned-pairing loader's black
    missing-modality placeholders, data/pairing.py) are excluded: every
    placeholder embeds to the same fixed vector, so any two splits
    containing one would otherwise report a meaningless sim=1.0
    "leak" between two images that don't exist.
    """
    names = list(feats)

    def real_rows(split):
        return np.array([p is not None and str(p) != "None"
                         for p in paths[split]], bool)

    keep = {split: real_rows(split) for split in names}
    feats = {split: np.asarray(feats[split])[keep[split]]
             for split in names}
    paths = {split: [p for p, k in zip(paths[split], keep[split]) if k]
             for split in names}
    best: Dict[tuple, Dict] = {}
    for ai in range(len(names)):
        for bi in range(ai + 1, len(names)):
            a, b = names[ai], names[bi]
            if not len(feats[a]) or not len(feats[b]):
                continue
            sims = l2_normalize(feats[a]) @ l2_normalize(feats[b]).T
            ii, jj = np.nonzero(sims >= threshold)
            for i, j in zip(ii, jj):
                # dedupe by path pair (pseudo-paired datasets repeat rows
                # via modulo cycling), keeping the max similarity
                key = (a, str(paths[a][i]), b, str(paths[b][j]))
                s = float(sims[i, j])
                if key not in best or s > best[key]["sim"]:
                    best[key] = {"split_a": a, "path_a": key[1],
                                 "split_b": b, "path_b": key[3], "sim": s}
    hits = sorted(best.values(), key=lambda h: -h["sim"])
    return hits


def uncertainty_order(probs: np.ndarray, center: float = 0.5) -> np.ndarray:
    """Indices sorted most-uncertain first (|P(ulcer) − center|
    ascending) — the active-learning triage ranking.  ``center`` is the
    operating decision boundary: 0.5 for argmax, the deployed threshold
    when one is configured (cases nearest the boundary that actually
    decides are the ones worth review)."""
    return np.argsort(np.abs(np.asarray(probs) - float(center)),
                      kind="stable")


def save_embeddings(path, out: Dict[str, np.ndarray], *,
                    paths: Optional[List[str]] = None,
                    labels: Optional[np.ndarray] = None,
                    model: str = "", embedding: str = "") -> None:
    """Write an ``.npz`` embedding index: features + probs/preds (+ paths,
    + labels when embedding a labeled split) + provenance strings."""
    arrays = dict(out)
    if paths is not None:
        arrays["paths"] = np.asarray([str(p) for p in paths])
    if labels is not None:
        arrays["labels"] = np.asarray(labels, np.int32)
    arrays["model"] = np.asarray(model)
    arrays["embedding"] = np.asarray(embedding)
    np.savez_compressed(path, **arrays)


def load_embeddings(path) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}
