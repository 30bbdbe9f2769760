"""Test-time augmentation: every image of a batch repeated T times,
augmented, and forwarded as one (B·T) batch on the trainer's device (the
port's counterpart of ``dfu_multimodal_tpu/eval/tta.py``).

The reference runs a triple loop: batches × samples × 5 augs, one
single-image forward per iteration with host-side PIL augmentation
(reference notebooks/test_time_augmentation.py:191-258).  Here each test
batch is expanded to (B·T) images (each image's T copies consecutive),
augmented by ``data/transforms.py::augment_and_normalize`` and forwarded
in one eval step, so on the card the ViT blocks run on K1/K2 and the
fusion head on K3 at B·T rows.

TTA augmentation parameters match ``get_light_augmentation_transforms``
(:145-167): rotation ±15°, h/v flip p=0.5, affine ±10°/translate 0.05
(always applied, no scale), no colour jitter and no blur.

Random streams: batch ``b``'s input ``i`` (the model's ``i``-th modality)
draws from its own ``torch.Generator`` on the trainer's device, seeded
with ``SeedSequence([seed, b, i])`` — the JAX package folds ``b`` and then
``i`` into ``PRNGKey(seed)`` (``fold_in``), a stream torch cannot
reproduce, so the two packages' augmented passes agree in distribution
and are compared through the same injected matrices, not through seeds.
The same seed gives the same result; another seed another draw.

Aggregation parity (:212-237): per-aug pred = prob > 0.5; final pred =
majority (mean of per-aug preds > 0.5); final prob = mean of per-aug probs.
Note the reference's TTA file uses 1-logit sigmoid heads, inconsistent with
the 2-class softmax used everywhere else in the reference (SURVEY.md §2 #15);
we standardize on the 2-class contract and use softmax P(ulcer).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from dfu_multimodal_tpu_torch.config import AugmentConfig, ModalityConfig
from dfu_multimodal_tpu_torch.data import loader as data_loader
from dfu_multimodal_tpu_torch.data.loader import ArrayDataset
from dfu_multimodal_tpu_torch.data.transforms import (augment_and_normalize,
                                                      eval_normalize)
from dfu_multimodal_tpu_torch.eval import metrics as metrics_mod


def tta_augment_config() -> AugmentConfig:
    """Light TTA augmentation (reference :145-167)."""
    return AugmentConfig(
        horizontal_flip_prob=0.5, vertical_flip_prob=0.5,
        rotation_degrees=15.0,
        aug_prob=1.0,                      # affine is unconditional in TTA
        color_jitter=False,
        affine=True, affine_degrees=10.0, affine_translate=0.05,
        affine_scale=(1.0, 1.0),
        gaussian_blur=False)


def tta_modality(base: ModalityConfig) -> ModalityConfig:
    return dataclasses.replace(base, augment=tta_augment_config())


def tta_generator(seed: int, batch_index: int, input_index: int,
                  device: torch.device) -> torch.Generator:
    """The stream of batch ``batch_index``'s input ``input_index``."""
    s = np.random.SeedSequence([seed, batch_index, input_index]
                               ).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(s))


def aggregate(probs: torch.Tensor, num_tta: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B·T,) P(ulcer), each image's T views consecutive -> (majority
    prediction (B,) int32, mean probability (B,))."""
    probs = probs.reshape(-1, num_tta)
    votes = (probs > 0.5).float().mean(dim=1)
    return (votes > 0.5).to(torch.int32), probs.mean(dim=1)


@torch.inference_mode()
def tta_probs(trainer, batch: Dict[str, torch.Tensor], num_tta: int,
              use_augmentation: bool, seed: int, batch_index: int
              ) -> torch.Tensor:
    """One batch through TTA: P(ulcer) of every view, (B·T,) on the
    trainer's device, each image's ``num_tta`` views consecutive."""
    tta_mods = {m: tta_modality(trainer.modalities[m])
                for m in trainer.spec.inputs}
    inputs = []
    for i, m in enumerate(trainer.spec.inputs):
        tiled = torch.repeat_interleave(batch[m], num_tta, dim=0)
        if use_augmentation:
            gen = tta_generator(seed, batch_index, i, trainer.device)
            x = augment_and_normalize(tiled, tta_mods[m],
                                      trainer.compute_dtype, gen)
        else:
            x = eval_normalize(tiled, tta_mods[m], trainer.compute_dtype)
        inputs.append(x)
    trainer.module.eval()
    logits = trainer.module(*inputs).float()
    return torch.softmax(logits, dim=-1)[:, 1]


def tta_predictions(trainer, dataset: ArrayDataset, num_tta: int = 5,
                    use_augmentation: bool = True, seed: int = 0
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """TTA inference core: ``(majority_preds, mean_probs)`` numpy arrays
    over ``dataset`` in ``eval_bs`` batches (a ragged last batch padded
    and cut), as :func:`evaluate_with_tta` uses them."""
    n = len(dataset)
    if n == 0:
        # same informative failure as Trainer.run_eval_epoch
        raise ValueError(
            "cannot run TTA on an empty dataset: the split directory "
            "has no images (check the data-dir layout)")
    T = num_tta if use_augmentation else 1
    bs = max(trainer.cfg.eval_bs, 1)
    preds, probs = [], []
    for bi, batch in enumerate(data_loader.device_prefetch(
            data_loader.batch_slices(dataset, np.arange(n), bs),
            trainer.device)):
        p, pr = aggregate(tta_probs(trainer, batch, T, use_augmentation,
                                    seed, bi), T)
        preds.append(p)
        probs.append(pr)
    return (torch.cat(preds)[:n].cpu().numpy(),
            torch.cat(probs)[:n].cpu().numpy())


def evaluate_with_tta(trainer, dataset: ArrayDataset, num_tta: int = 5,
                      use_augmentation: bool = True, seed: int = 0) -> Dict:
    """Returns the reference's TTA metrics dict (:241-258 keys)."""
    all_preds, all_probs = tta_predictions(
        trainer, dataset, num_tta=num_tta,
        use_augmentation=use_augmentation, seed=seed)
    all_labels = np.asarray(dataset.labels)

    cm = metrics_mod.binary_confusion(all_labels, all_preds)
    tn, fp, fn, tp = (float(x) for x in cm.ravel())
    return {
        "accuracy": metrics_mod.accuracy_from_counts(
            np.array([tn, fp, fn, tp])),
        "f1": metrics_mod.f1_from_counts(np.array([tn, fp, fn, tp])),
        "auc": metrics_mod.roc_auc_score(all_labels, all_probs),
        "sensitivity": tp / (tp + fn) if (tp + fn) > 0 else 0.0,
        "specificity": tn / (tn + fp) if (tn + fp) > 0 else 0.0,
        "confusion_matrix": cm,
        "predictions": all_preds,
        "probabilities": all_probs,
        "labels": all_labels,
    }


def print_tta_comparison(clean: Dict, tta: Dict, model_name: str) -> str:
    """Reference comparison report incl. robustness verdict (:404-441).
    Returns the verdict string."""
    print("\n" + "=" * 70)
    print(f"TEST-TIME AUGMENTATION EVALUATION: {model_name}")
    print("=" * 70)
    for title, m in (("CLEAN EVALUATION (No Augmentation)", clean),
                     ("TTA EVALUATION (5x Augmented)", tta)):
        print(f"\n{title}:")
        print(f"  Accuracy:    {m['accuracy']:.4f}")
        print(f"  F1-Score:    {m['f1']:.4f}")
        print(f"  AUC-ROC:     {m['auc']:.4f}")
        print(f"  Sensitivity: {m['sensitivity']:.4f}")
        print(f"  Specificity: {m['specificity']:.4f}")

    acc_drop = clean["accuracy"] - tta["accuracy"]
    f1_drop = clean["f1"] - tta["f1"]
    print("\nROBUSTNESS COMPARISON:")
    print(f"  Accuracy drop:  {acc_drop:.4f} ({acc_drop * 100:.2f}%)")
    print(f"  F1-Score drop:  {f1_drop:.4f}")
    if abs(acc_drop) < 0.05:
        verdict = "ROBUST"
        print("\n  ROBUST: Model generalizes well to variations")
    elif abs(acc_drop) < 0.15:
        verdict = "MODERATE"
        print("\n  MODERATE: Some performance drop with augmentation")
    else:
        verdict = "NOT ROBUST"
        print("\n  NOT ROBUST: Large performance drop suggests overfitting")
    print("\nCONFUSION MATRICES:")
    print("\nClean:")
    print(clean["confusion_matrix"])
    print("\nTTA:")
    print(tta["confusion_matrix"])
    return verdict
