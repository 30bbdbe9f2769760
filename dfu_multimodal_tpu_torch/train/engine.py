"""Train/eval engine on one explicit device (counterpart of
``dfu_multimodal_tpu/train/engine.py::Trainer``).

Eval step (the serving path):

    uint8 NHWC batch -> eval_normalize -> model -> softmax P(ulcer), argmax

Train step (the default path of the JAX ``train_step``), for the
BatchNorm-free ``thermal_only`` ViT:

    uint8 batch -> augment_and_normalize -> model (train mode, dropout)
      -> class-weighted CE over the valid rows -> backward -> AdamW

where the backward runs, on the card, the fused blocks' hand chain rules
(kernels K4/K5; ``block_impl="fused"``, the default) or, with
``block_impl="flax", attention_impl="pallas"``, PyTorch's autograd
through the flax blocks' LayerNorms and Linears with the packed-qkv
attention's own backward kernel (K6); ``attention_impl="xla"`` runs the
flax blocks' attention as plain PyTorch ops.  The int8 block impls are
serving-only.

with the reference's semantics: torch's weighted-mean reduction
Σ wᵢ·ceᵢ / Σ wᵢ with wᵢ = class_weight[yᵢ]·validᵢ, weighted-with-
replacement sampling per epoch, and per-step confusion counts reduced
once per epoch.  Randomness (augmentation, dropout) comes from an explicit
``torch.Generator`` on the device.

Not ported: mixup, grad_accum > 1, EMA, focal loss, QAT, non-constant
learning-rate schedules, the shard_map (``*_spmd``) steps and any mesh
but the single-device default — each raises ``NotImplementedError`` when
the train step is first built — and ``fit`` (it needs checkpoint restore,
ROADMAP Queue A1).  The multimodal and rgb_only train steps (cuDNN
ResNet training with BatchNorm) are not ported yet either; their eval
steps are (``rgb_only`` with ``block_impl="fused"`` runs each stride-1
bottleneck through the fused kernel).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from dfu_multimodal_tpu_torch.config import (  # noqa: F401  (re-exported)
    MeshConfig, ModalityConfig, TrainConfig, rgb_modality, thermal_modality)
from dfu_multimodal_tpu_torch.data import loader as data_loader
from dfu_multimodal_tpu_torch.data.loader import ArrayDataset
from dfu_multimodal_tpu_torch.data.transforms import (augment_and_normalize,
                                                      eval_normalize)
from dfu_multimodal_tpu_torch.eval import metrics as metrics_mod
from dfu_multimodal_tpu_torch.models import zoo
from dfu_multimodal_tpu_torch.models.common import canonical_dtype
from dfu_multimodal_tpu_torch.train.optim import AdamW, learning_rate_schedule

TRAINABLE_MODELS = ("thermal_only",)


def class_weights_from_labels(labels: np.ndarray) -> np.ndarray:
    """total/count_c per class, 0 for empty classes."""
    counts = np.bincount(labels, minlength=2).astype(np.float64)
    total = counts.sum() if counts.sum() > 0 else 1.0
    return np.where(counts > 0, total / np.maximum(counts, 1), 0.0).astype(
        np.float32)


def per_sample_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits.float(), labels.long(), reduction="none")


def weighted_mean(terms: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    return (weights * terms).sum() / weights.sum().clamp_min(1e-12)


def weighted_ce(logits: torch.Tensor, labels: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """torch ``CrossEntropyLoss(weight=w)`` semantics: Σ wᵢ·ceᵢ / Σ wᵢ."""
    return weighted_mean(per_sample_ce(logits, labels), weights)


@dataclass
class EpochMetrics:
    loss: float
    accuracy: float
    f1: float


def _check_train_config(cfg: TrainConfig) -> None:
    """Raise for every train option the port does not implement."""
    unported = {
        "mixup_alpha > 0": cfg.mixup_alpha > 0.0,
        "grad_accum > 1": cfg.grad_accum > 1,
        "ema_decay > 0": cfg.ema_decay > 0.0,
        f"loss={cfg.loss!r}": cfg.loss != "ce",
        "qat": cfg.qat,
        f"mesh={cfg.mesh}": (cfg.mesh.data not in (-1, 1)
                             or cfg.mesh.model != 1 or cfg.mesh.fsdp),
    }
    bad = [name for name, on in unported.items() if on]
    if bad:
        raise NotImplementedError(
            f"train options not ported yet: {', '.join(bad)} (the port "
            "trains the default single-device path)")


class Trainer:
    """Train/eval engine for one model-zoo entry on one device (the card
    unless the caller asks for the CPU).  Weights are the module's own:
    load them with ``module.load_state_dict`` (e.g. from
    ``tools.convert_jax.variables_to_state_dict``) or draw them with
    ``models.zoo.init_model``.  Extra keyword arguments go to the model
    class (e.g. ``depth`` for a cut-down trunk, ``block_impl`` for the
    ViT blocks, ``attention_impl`` for the flax block's attention, or the
    fused ResNet bottleneck)."""

    def __init__(self, model_name: str, cfg: TrainConfig,
                 modalities: Dict[str, ModalityConfig], *,
                 class_weights: Optional[np.ndarray] = None,
                 device: Union[str, torch.device] = "cuda",
                 image_size: int = 224, **model_kwargs):
        self.cfg = cfg
        self.device = torch.device(device)
        self.compute_dtype = canonical_dtype(cfg.compute_dtype)
        # the model class's arguments, so a rebuild (e.g. the int8 serving
        # trainer of serve/engine.py) gets the same architecture
        self.model_kwargs = dict(image_size=image_size, **model_kwargs)
        self.module, self.spec = zoo.build(
            model_name, drop_rate=cfg.drop_rate, dtype=self.compute_dtype,
            **self.model_kwargs)
        self.module.to(self.device)
        self.modalities = modalities
        self.class_weights = (None if class_weights is None else
                              torch.as_tensor(np.asarray(class_weights,
                                                         np.float32),
                                              device=self.device))
        self.optimizer: Optional[AdamW] = None

    def variables(self) -> Dict[str, torch.Tensor]:
        """The model's weights and BatchNorm statistics (the JAX
        ``variables`` tree, as a state_dict)."""
        return self.module.state_dict()

    # ------------------------------------------------------------- steps

    def _preprocess_eval(self, batch: Mapping[str, torch.Tensor]
                         ) -> Tuple[torch.Tensor, ...]:
        return tuple(
            eval_normalize(batch[m], self.modalities[m], self.compute_dtype)
            for m in self.spec.inputs)

    def _preprocess_train(self, batch: Mapping[str, torch.Tensor],
                          generator: torch.Generator
                          ) -> Tuple[torch.Tensor, ...]:
        return tuple(
            augment_and_normalize(batch[m], self.modalities[m],
                                  self.compute_dtype, generator)
            for m in self.spec.inputs)

    def _sample_weights(self, labels: torch.Tensor,
                        valid: torch.Tensor) -> torch.Tensor:
        if self.class_weights is not None and self.cfg.class_weighted_loss:
            return self.class_weights[labels.long()] * valid
        return valid

    def _build_optimizer(self) -> AdamW:
        if self.spec.name not in TRAINABLE_MODELS:
            raise NotImplementedError(
                f"the {self.spec.name!r} train step is not ported yet "
                f"(trainable: {TRAINABLE_MODELS}); the ResNet models "
                "(rgb_only, multimodal) need cuDNN ResNet training with "
                "live BatchNorm statistics, which has no kernel and is "
                "queued after the kernels")
        _check_train_config(self.cfg)
        return AdamW(self.module.parameters(),
                     lr=learning_rate_schedule(self.cfg),
                     weight_decay=self.cfg.weight_decay,
                     mu_dtype=canonical_dtype(self.cfg.optimizer_mu_dtype))

    def train_step(self, batch: Mapping[str, Union[np.ndarray, torch.Tensor]],
                   generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """One optimizer step.  ``batch``: {modality: (B, S, S, 3) uint8,
        "label": (B,) int, "valid": (B,) float} (numpy or tensors);
        ``generator`` on this trainer's device draws the augmentation and
        the dropout.  Returns device tensors ``loss`` (the weighted CE)
        and ``counts`` ([tn, fp, fn, tp] over the valid rows)."""
        if self.optimizer is None:
            self.optimizer = self._build_optimizer()
        batch = {k: torch.as_tensor(v).to(self.device)
                 for k, v in batch.items()}
        inputs = self._preprocess_train(batch, generator)
        labels, valid = batch["label"].long(), batch["valid"].float()
        weights = self._sample_weights(labels, valid)
        self.module.train()
        self.optimizer.zero_grad()
        logits = self.module(*inputs, generator=generator)
        loss = weighted_mean(per_sample_ce(logits, labels), weights)
        loss.backward()
        self.optimizer.step()
        counts = metrics_mod.confusion_counts(logits.detach().argmax(-1),
                                              labels, valid)
        return {"loss": loss.detach(), "counts": counts}

    @torch.inference_mode()
    def eval_step(self, batch: Mapping[str, Union[np.ndarray, torch.Tensor]]
                  ) -> Dict[str, torch.Tensor]:
        """``batch``: {modality: (B, S, S, 3) uint8} (numpy or tensors).
        Returns device tensors ``probs`` = softmax(logits)[:, 1] and
        ``preds`` = argmax(logits)."""
        self.module.eval()
        inputs = {m: torch.as_tensor(batch[m]).to(self.device)
                  for m in self.spec.inputs}
        logits = self.module(*self._preprocess_eval(inputs)).float()
        return {"probs": torch.softmax(logits, dim=-1)[:, 1],
                "preds": torch.argmax(logits, dim=-1)}

    # ------------------------------------------------------------- loops

    def run_train_epoch(self, dataset: ArrayDataset,
                        np_rng: np.random.Generator,
                        generator: torch.Generator,
                        meter=None) -> EpochMetrics:
        """One epoch: weighted-with-replacement order (or a shuffle),
        fixed-shape masked batches prefetched to the device, one
        ``train_step`` each.  ``meter.update(batch_size, step_metrics)``
        is called after every step when given."""
        order = data_loader.epoch_indices(
            dataset.labels, np_rng, weighted=self.cfg.weighted_sampling)
        bs = self.cfg.batch_size
        step_metrics = []
        for batch in data_loader.device_prefetch(
                data_loader.batch_slices(dataset, order, bs), self.device):
            m = self.train_step(batch, generator)
            step_metrics.append(m)
            if meter is not None:
                meter.update(bs, m)
        return self._reduce_epoch(step_metrics)

    def _reduce_epoch(self, step_metrics: List[Dict]) -> EpochMetrics:
        losses = torch.stack([m["loss"] for m in step_metrics]).cpu()
        counts = torch.stack([m["counts"] for m in step_metrics]).sum(0)
        counts = counts.cpu().numpy()
        return EpochMetrics(loss=float(losses.mean()),
                            accuracy=metrics_mod.accuracy_from_counts(counts),
                            f1=metrics_mod.f1_from_counts(counts))
