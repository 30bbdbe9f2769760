"""Knowledge distillation: a trained teacher into a smaller student
(counterpart of ``dfu_multimodal_tpu/train/distill.py``).

Same-modality compression (rgb_only -> resnet18_rgb, thermal_only ->
resnet18_thermal) or cross-modal: a multimodal teacher that saw RGB and
thermal teaches an RGB-only student, which deploys with one camera.

    loss = alpha·T²·KL(teacher_T || student_T) + (1 - alpha)·weighted CE

(Hinton et al.; T² keeps the soft-target gradient's scale independent of
the temperature).  The KL averages over the valid rows; the class weights
apply to the CE term only (the soft targets carry the teacher's balance).
The teacher is frozen, in eval mode and under ``no_grad``, computed in
the same step: for a modality the student also takes it sees the
student's own augmented view, for a teacher-only modality the
eval-normalised image.  On the card a ViT or multimodal teacher runs the
kernels' eval forwards (K1/K2, K3; K11 for a fused ResNet trunk).

The engine is the supervised ``Trainer``: the same epoch loop,
best-by-val-F1 checkpoints, evaluation (plain CE on the student, so
selection and test artifacts compare with a non-distilled run); only the
train step's loss changes.  ``cfg.qat`` trains the student through its
int8 serving grid (``train/qat.py``); the teacher runs at full fidelity.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from dfu_multimodal_tpu_torch.data.transforms import eval_normalize
from dfu_multimodal_tpu_torch.eval import metrics as metrics_mod
from dfu_multimodal_tpu_torch.models import zoo
from dfu_multimodal_tpu_torch.train.engine import Trainer, per_sample_ce


@dataclass(frozen=True)
class DistillConfig:
    alpha: float = 0.7            # weight of the soft-target KL term
    temperature: float = 4.0


def kd_numerators(student_logits: torch.Tensor,
                  teacher_logits: torch.Tensor, labels: torch.Tensor,
                  ce_weights: torch.Tensor, valid: torch.Tensor,
                  temperature: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two KD terms' numerators: (Σ vᵢ·klᵢ, Σ wᵢ·ceᵢ)."""
    t = temperature
    s = student_logits.float() / t
    p = torch.softmax(teacher_logits.float() / t, dim=-1)
    kl_rows = (p * (torch.log(p.clamp(1e-12, 1.0))
                    - torch.log_softmax(s, dim=-1))).sum(dim=-1)
    ce_rows = per_sample_ce(student_logits, labels)
    return (kl_rows * valid.float()).sum(), (ce_weights * ce_rows).sum()


def kd_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
            labels: torch.Tensor, ce_weights: torch.Tensor,
            valid: torch.Tensor, alpha: float,
            temperature: float) -> torch.Tensor:
    """alpha·T²·KL(p_T || q_T) over the valid rows + (1 - alpha)·the
    weighted CE."""
    t = temperature
    kl_num, ce_num = kd_numerators(student_logits, teacher_logits, labels,
                                   ce_weights, valid, t)
    kl = kl_num / valid.float().sum().clamp_min(1e-12)
    ce = ce_num / ce_weights.sum().clamp_min(1e-12)
    return alpha * (t * t) * kl + (1.0 - alpha) * ce


class DistillTrainer(Trainer):
    """The supervised ``Trainer`` whose train step adds the frozen
    teacher's forward and the KD loss.  ``teacher_model`` is the
    teacher's zoo name and ``teacher`` its module, weights loaded (e.g.
    by a teacher ``Trainer.load_weights`` from a port or JAX checkpoint),
    on this trainer's device; it is frozen here.  The student config must
    not use grad_accum, EMA, the focal loss or mixup (refused)."""

    def __init__(self, student_model: str, teacher_model: str,
                 teacher: torch.nn.Module, dcfg: DistillConfig, cfg,
                 modalities, class_weights: Optional[np.ndarray] = None,
                 **kwargs):
        if (int(cfg.grad_accum) > 1 or float(cfg.ema_decay) > 0.0
                or cfg.loss != "ce" or float(cfg.mixup_alpha) > 0.0):
            raise ValueError("distillation does not compose with "
                             "--grad-accum, --ema-decay, "
                             "--loss focal or --mixup-alpha")
        super().__init__(student_model, cfg, modalities,
                         class_weights=class_weights, **kwargs)
        self.teacher_spec = zoo.get(teacher_model)
        missing = [m for m in self.teacher_spec.inputs
                   if m not in modalities]
        if missing:
            raise ValueError(f"teacher consumes {self.teacher_spec.inputs} "
                             f"but modalities config lacks {missing}")
        self.teacher_module = teacher.eval().requires_grad_(False)
        self.dcfg = dcfg

    def _teacher_inputs(self, batch: Mapping[str, torch.Tensor],
                        views: Mapping[str, torch.Tensor]
                        ) -> Tuple[torch.Tensor, ...]:
        """The student's augmented view for a shared modality, the
        eval-normalised image for a teacher-only one."""
        return tuple(
            views[m] if m in views else
            eval_normalize(batch[m], self.modalities[m], self.compute_dtype)
            for m in self.teacher_spec.inputs)

    @torch.no_grad()
    def teacher_logits(self, batch: Mapping[str, torch.Tensor],
                       views: Mapping[str, torch.Tensor]) -> torch.Tensor:
        self.teacher_module.eval()
        return self.teacher_module(*self._teacher_inputs(batch,
                                                         views)).float()

    def train_step(self, batch: Mapping[str, Union[np.ndarray,
                                                   torch.Tensor]],
                   generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """One KD step: the student's views drawn from ``generator``
        (augmentation, then dropout in the forward)."""
        batch = {k: torch.as_tensor(v).to(self.device)
                 for k, v in batch.items()}
        views = dict(zip(self.spec.inputs,
                         self._preprocess_train(batch, generator)))
        return self.step_on_views(batch, views, generator)

    def step_on_views(self, batch: Mapping[str, torch.Tensor],
                      views: Mapping[str, torch.Tensor],
                      generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """The KD step after its augmentation: ``views`` {modality:
        normalised student input}; returns ``loss`` and ``counts``."""
        if self.optimizer is None:
            self.optimizer = self._build_optimizer()
        labels, valid = batch["label"].long(), batch["valid"].float()
        weights = self._sample_weights(labels, valid)
        t_logits = self.teacher_logits(batch, views)
        self.module.train()
        self.optimizer.zero_grad()
        logits = self._forward(*(views[m] for m in self.spec.inputs),
                               generator=generator)
        loss = kd_loss(logits, t_logits, labels, weights, valid,
                       self.dcfg.alpha, self.dcfg.temperature)
        loss.backward()
        self.optimizer.step()
        counts = metrics_mod.confusion_counts(logits.detach().argmax(-1),
                                              labels, valid)
        return {"loss": loss.detach(), "counts": counts}
