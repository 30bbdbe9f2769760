"""Semi-supervised self-training: confident pseudo-labels over an
unlabelled pool (counterpart of ``dfu_multimodal_tpu/train/self_train.py``).

A clinic with few labelled images and a directory of unlabelled ones
iterates

    train on labelled -> predict the pool -> adopt the confident
    predictions as pseudo-labels -> retrain on labelled + pseudo -> ...

Each round refits from the same initialisation rather than continuing, so
early mistakes are not fine-tuned into the model; the round with the best
val F1 wins and its checkpoint is promoted to ``checkpoint_dir``.  Every
fit and the pool's prediction run on the trainer's device (the card
unless the caller asks for the CPU).
"""

from __future__ import annotations

import dataclasses
import shutil
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from dfu_multimodal_tpu_torch.config import ModalityConfig, TrainConfig
from dfu_multimodal_tpu_torch.data.loader import ArrayDataset
from dfu_multimodal_tpu_torch.data.transforms import eval_normalize
from dfu_multimodal_tpu_torch.models import zoo
from dfu_multimodal_tpu_torch.train.engine import (Trainer,
                                                   class_weights_from_labels)
from dfu_multimodal_tpu_torch.utils import checkpoint as ckpt_mod


@dataclass(frozen=True)
class SelfTrainConfig:
    rounds: int = 3
    # adopt a pool image when its max-class probability >= threshold
    threshold: float = 0.9
    # per-round, per-class cap on adopted pseudo-labels; None = no cap
    max_per_class: Optional[int] = None
    # adopt min(healthy, ulcer) of each: guards against the majority
    # class snowballing on an imbalanced pool
    balance: bool = True


@torch.inference_mode()
def predict_pool_probs(trainer: Trainer, images_u8: np.ndarray,
                       modality: ModalityConfig,
                       batch_size: int = 64) -> np.ndarray:
    """(n, 2) softmax probabilities of a uint8 pool on the trainer's
    device, in fixed-shape batches (the last padded with repeats of its
    last image, sliced back)."""
    trainer.module.eval()
    outs = []
    n = len(images_u8)
    for s in range(0, n, batch_size):
        chunk = images_u8[s:s + batch_size]
        valid = len(chunk)
        if valid < batch_size:
            chunk = np.concatenate(
                [chunk, np.repeat(chunk[-1:], batch_size - valid, axis=0)])
        x = torch.from_numpy(np.ascontiguousarray(chunk)).to(trainer.device)
        logits = trainer._forward(eval_normalize(x, modality,
                                                 trainer.compute_dtype))
        outs.append(torch.softmax(logits.float(), dim=-1)[:valid].cpu())
    return torch.cat(outs).numpy()[:n]


def select_confident(probs: np.ndarray, threshold: float,
                     max_per_class: Optional[int] = None,
                     balance: bool = True
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(indices, labels) of the pool rows whose max-class probability
    clears ``threshold``, most confident first within each class,
    optionally capped and class-balanced."""
    preds = probs.argmax(axis=-1)
    conf = probs.max(axis=-1)
    per_class = []
    for c in (0, 1):
        idx = np.where((preds == c) & (conf >= threshold))[0]
        idx = idx[np.argsort(-conf[idx])]
        if max_per_class is not None:
            idx = idx[:max_per_class]
        per_class.append(idx)
    if balance:
        k = min(len(per_class[0]), len(per_class[1]))
        per_class = [idx[:k] for idx in per_class]
    indices = np.concatenate(per_class)
    return indices.astype(np.int64), preds[indices].astype(np.int32)


def combine(labeled: ArrayDataset, pool_images: Dict[str, np.ndarray],
            pool_paths: Dict[str, List], indices: np.ndarray,
            labels: np.ndarray) -> ArrayDataset:
    """The labelled set plus the adopted pool rows with their
    pseudo-labels."""
    if len(indices) == 0:
        return labeled
    arrays = {m: np.concatenate([labeled.arrays[m], pool_images[m][indices]])
              for m in labeled.arrays}
    paths = {m: list(labeled.paths.get(m, [])) +
             [pool_paths.get(m, [None] * (indices.max() + 1))[i]
              for i in indices]
             for m in labeled.arrays}
    return ArrayDataset(
        arrays=arrays,
        labels=np.concatenate([labeled.labels, labels]).astype(np.int32),
        paths=paths)


def self_train(model_name: str, st_cfg: SelfTrainConfig,
               train_cfg: TrainConfig,
               modalities: Dict[str, ModalityConfig],
               labeled: ArrayDataset, pool: ArrayDataset,
               val_ds: ArrayDataset, checkpoint_dir: Path,
               init_from: Optional[Path] = None, image_size: int = 224,
               log: Callable[[str], None] = print,
               device: Union[str, torch.device] = "cuda"
               ) -> Tuple[Trainer, List[Dict]]:
    """The self-training loop for a single-modality model; ``pool``'s
    labels are ignored.  Every round draws the same weights from
    ``train_cfg.seed`` (or loads ``init_from``) and fits on the grown set,
    its checkpoints under ``round_{r}``.  Returns (the best round's
    trainer, with its best weights, and the per-round report); the best
    round's ``best_model.pt`` and meta are copied to ``checkpoint_dir``
    (a round that never passed the best-save gate saves its final state
    there instead)."""
    if len(labeled.modalities) != 1:
        raise ValueError("self_train supports single-modality models "
                         f"(got modalities {labeled.modalities})")
    mod_key = labeled.modalities[0]
    modality = modalities[mod_key]
    checkpoint_dir = Path(checkpoint_dir)

    report: List[Dict] = []
    current = labeled
    best = (-1.0, None, None)          # (val_f1, round, trainer)
    for rnd in range(1, st_cfg.rounds + 1):
        cw = class_weights_from_labels(current.labels)
        # ceil, as the epoch's step count: floor would hand the cosine
        # schedule a short horizon and the round's tail would train at 0
        cfg = dataclasses.replace(
            train_cfg, steps_per_epoch=max(
                1, -(-len(current) // train_cfg.batch_size)))
        trainer = Trainer(model_name, cfg, modalities, class_weights=cw,
                          device=device, image_size=image_size)
        zoo.init_model(trainer.module, torch.Generator(
            device=trainer.device).manual_seed(cfg.seed))
        rdir = checkpoint_dir / f"round_{rnd}"
        _, val_f1 = trainer.fit(current, val_ds, checkpoint_dir=rdir,
                                log=lambda s: None, init_from=init_from)
        if ckpt_mod.best_checkpoint_exists(rdir):
            trainer.restore(rdir)        # evaluate the round's best save
        n_pseudo = len(current) - len(labeled)
        log(f"[self-train round {rnd}/{st_cfg.rounds}] "
            f"trained on {len(labeled)} labeled + {n_pseudo} pseudo "
            f"-> val F1 {val_f1:.4f}")
        report.append({"round": rnd, "n_labeled": int(len(labeled)),
                       "n_pseudo": int(n_pseudo),
                       "val_f1": float(val_f1)})
        if val_f1 > best[0]:
            best = (val_f1, rnd, trainer)
        if rnd == st_cfg.rounds:
            break
        probs = predict_pool_probs(trainer, pool.arrays[mod_key], modality)
        idx, pseudo = select_confident(probs, st_cfg.threshold,
                                       st_cfg.max_per_class,
                                       st_cfg.balance)
        report[-1]["adopted"] = {"healthy": int(np.sum(pseudo == 0)),
                                 "ulcer": int(np.sum(pseudo == 1))}
        log(f"  adopted {len(idx)} pseudo-labels "
            f"(h {int(np.sum(pseudo == 0))} / u {int(np.sum(pseudo == 1))}"
            f", threshold {st_cfg.threshold})")
        current = combine(labeled, pool.arrays, pool.paths, idx, pseudo)

    val_f1, rnd, trainer = best
    log(f"[self-train] best round: {rnd} (val F1 {val_f1:.4f})")
    src = checkpoint_dir / f"round_{rnd}"
    promoted = False
    for name in ("best_model.pt", "best_model.meta.json"):
        if (src / name).exists():
            shutil.copy2(src / name, checkpoint_dir / name)
            promoted = True
    if not promoted:
        # a degenerate winning round (val F1 0.0 every epoch) never
        # passed fit's best-save gate; best_model must exist all the same
        # for predict / serve on this directory
        ckpt_mod.save_checkpoint(
            checkpoint_dir, epoch=train_cfg.num_epochs,
            model_state=trainer.module.state_dict(), opt_state={},
            val_f1=float(val_f1), history={},
            extra_meta={"model": model_name, "self_train_round": rnd,
                        "degenerate_round": True})
        log("  (round never beat F1 0.0 — saved its final state as "
            "best_model)")
    return trainer, report
