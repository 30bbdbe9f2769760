"""Train/eval engine on one explicit device (counterpart of
``dfu_multimodal_tpu/train/engine.py::Trainer``).

Eval step (the serving path):

    uint8 NHWC batch -> eval_normalize -> model -> softmax P(ulcer), argmax
      (+ the weighted CE and confusion counts when the batch has labels)

Train step (``train_step``) for all three models:

    uint8 batch -> augment_and_normalize [-> mixup] -> model (train mode:
      dropout from the step's generator, live BatchNorm statistics)
      -> class-weighted CE or focal loss over the valid rows -> backward
      [over grad_accum microbatches] -> AdamW [-> EMA of the parameters]

where the ViT's backward runs, on the card, the fused blocks' hand chain
rules (kernels K4/K5; ``block_impl="fused"``, the default) or, with
``block_impl="flax", attention_impl="pallas"``, PyTorch's autograd
through the flax blocks with the packed-qkv attention's own backward
kernel (K6); ``attention_impl="xla"`` runs the flax blocks' attention as
plain PyTorch ops.  The ResNet trains on cuDNN convolutions in
channels-last, as the JAX ResNet trains on XLA's (its fused bottleneck
is eval-only there too), with flax's BatchNorm statistics
(``models/resnet.py::BatchNorm2d``).  The int8 block impls are
serving-only.

The reference's semantics: torch's weighted-mean reduction
Σ wᵢ·ceᵢ / Σ wᵢ with wᵢ = class_weight[yᵢ]·validᵢ, weighted-with-
replacement sampling per epoch, and per-step confusion counts reduced
once per epoch.  Randomness (augmentation, mixup, dropout) comes from an
explicit ``torch.Generator`` on the device.

``fit`` runs the reference's epoch loop with its checkpoint contract
(``utils/checkpoint.py``): best-by-val-F1 saves, ``save_last``, resume,
``init_from``, EMA weights, early stopping and a metrics JSONL.

``cfg.qat`` computes the train and eval steps through the trunks' weights
snapped to their int8 serving grids (``train/qat.py``, straight-through
gradients; the optimizer and checkpoints keep the real weights).

Not ported: any mesh but the single-device default (the ``*_spmd``
steps) — it raises ``NotImplementedError`` when the train step is first
built.
"""

from __future__ import annotations

import contextlib
import functools
import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import (Callable, Dict, Iterator, List, Mapping, Optional,
                    Sequence, Tuple, Union)

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
from dfu_multimodal_tpu_torch.train import qat as qat_mod
from dfu_multimodal_tpu_torch.train.optim import AdamW, learning_rate_schedule
from dfu_multimodal_tpu_torch.utils import checkpoint as ckpt_mod
from dfu_multimodal_tpu_torch.utils.logging import (ThroughputMeter,
                                                    profile_trace)

TRAINABLE_MODELS = ("thermal_only", "rgb_only", "multimodal", "tiny_rgb",
                    "tiny_thermal", "tiny_fusion")


def class_weights_from_labels(labels: np.ndarray) -> np.ndarray:
    """total/count_c per class, 0 for empty classes."""
    counts = np.bincount(labels, minlength=2).astype(np.float64)
    total = counts.sum() if counts.sum() > 0 else 1.0
    return np.where(counts > 0, total / np.maximum(counts, 1), 0.0).astype(
        np.float32)


def per_sample_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits.float(), labels.long(), reduction="none")


def per_sample_focal(logits: torch.Tensor, labels: torch.Tensor,
                     gamma: float) -> torch.Tensor:
    """Focal loss (Lin et al. 2017): (1 - p_y)^gamma · CE with
    p_y = exp(-CE); gamma = 0 is CE.  The class weights carry alpha."""
    ce = per_sample_ce(logits, labels)
    return ce * (1.0 - torch.exp(-ce)) ** gamma


def weighted_mean(terms: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    return (weights * terms).sum() / weights.sum().clamp_min(1e-12)


def weighted_ce(logits: torch.Tensor, labels: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """torch ``CrossEntropyLoss(weight=w)`` semantics: Σ wᵢ·ceᵢ / Σ wᵢ."""
    return weighted_mean(per_sample_ce(logits, labels), weights)


def sample_mixup(generator: torch.Generator, alpha: float, batch: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One lam ~ Beta(alpha, alpha) for the batch, as G₁/(G₁ + G₂) of two
    Gamma(alpha) draws, and a partner permutation, both from
    ``generator`` (on its device)."""
    dev = generator.device
    g = torch._standard_gamma(torch.full((2,), alpha, device=dev),
                              generator=generator)
    lam = g[0] / (g[0] + g[1]).clamp_min(torch.finfo(torch.float32).tiny)
    return lam, torch.randperm(batch, generator=generator, device=dev)


def mixup_batch(inputs: Tuple[torch.Tensor, ...], valid: torch.Tensor,
                lam: torch.Tensor, perm: torch.Tensor
                ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """Mix each input with its permutation partner: x·lam + x[perm]·(1 -
    lam), with lam demoted to 1 on a row whose partner is padding, so
    padding never bleeds into a real sample.  Returns (mixed, lam_row)."""
    b = valid.shape[0]
    lam_row = torch.where(valid[perm] > 0, lam, 1.0).float()

    def mix(x):
        lr = lam_row.reshape((b,) + (1,) * (x.ndim - 1)).to(x.dtype)
        return x * lr + x[perm] * (1 - lr)

    return tuple(mix(x) for x in inputs), lam_row


def mixup_loss(per_sample: Callable, logits: torch.Tensor,
               labels: torch.Tensor, weights: torch.Tensor,
               valid: torch.Tensor, perm: torch.Tensor,
               lam_row: torch.Tensor) -> torch.Tensor:
    """lam-weighted two-target loss over the lam-weighted weight mass
    (``weighted_mean`` at lam = 1); both terms gated by the row's own
    validity."""
    la = per_sample(logits, labels)
    lb = per_sample(logits, labels[perm])
    v = valid.float()
    wa, wb = v * lam_row * weights, v * (1.0 - lam_row) * weights[perm]
    return (wa * la + wb * lb).sum() / (wa + wb).sum().clamp_min(1e-12)


def serving_outputs(forward: Callable[..., torch.Tensor],
                    batch: Mapping[str, torch.Tensor],
                    inputs: Sequence[str],
                    modalities: Dict[str, ModalityConfig],
                    compute_dtype: torch.dtype,
                    class_weights: Optional[torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
    """The eval step's tensor part, which :meth:`Trainer.eval_step` and
    the exported serving programs (``serve/export.py``) both run, so the
    two cannot drift: ``batch`` {modality: (B, S, S, 3) uint8 on the
    model's device[, "label", "valid"]} -> ``probs`` = softmax(logits)[:,
    1], ``preds`` = argmax(logits) and, with ``label``, ``loss`` (the CE
    over the valid rows, weighted by ``class_weights`` of each label when
    given) and ``counts``.  ``forward`` maps the normalised inputs, in
    ``inputs`` order, to logits."""
    logits = forward(*(eval_normalize(batch[m], modalities[m],
                                      compute_dtype)
                       for m in inputs)).float()
    out = {"probs": torch.softmax(logits, dim=-1)[:, 1],
           "preds": torch.argmax(logits, dim=-1)}
    if "label" in batch:
        labels = batch["label"].long()
        valid = (batch["valid"].float() if "valid" in batch
                 else torch.ones_like(logits[:, 0]))
        weights = (valid if class_weights is None
                   else class_weights[labels] * valid)
        out["loss"] = weighted_mean(per_sample_ce(logits, labels), weights)
        out["counts"] = metrics_mod.confusion_counts(out["preds"], labels,
                                                     valid)
    return out


@dataclass
class EpochMetrics:
    loss: float
    accuracy: float
    f1: float


def _check_train_config(cfg: TrainConfig) -> None:
    """Raise for the train options the port does not implement and for
    the combinations the JAX Trainer refuses."""
    if cfg.mesh.data not in (-1, 1) or cfg.mesh.model != 1 or cfg.mesh.fsdp:
        raise NotImplementedError(
            f"train options not ported yet: mesh={cfg.mesh} (the port "
            "trains on one device)")
    if cfg.loss not in ("ce", "focal"):
        raise ValueError(f"unknown loss {cfg.loss!r} (choose 'ce' or "
                         "'focal')")
    if cfg.mixup_alpha > 0.0 and cfg.grad_accum > 1:
        raise ValueError("mixup does not compose with grad_accum (mix "
                         "pairs would be confined to one microbatch); use "
                         "one or the other")


class Trainer:
    """Train/eval engine for one model-zoo entry on one device (the card
    unless the caller asks for the CPU).  Weights are the module's own:
    load them with ``module.load_state_dict`` (e.g. from
    ``tools.convert_jax.variables_to_state_dict``), :meth:`restore` them
    from a checkpoint, or draw them with ``models.zoo.init_model``.  Extra
    keyword arguments go to the model class (e.g. ``depth`` for a cut-down
    trunk, ``block_impl`` for the ViT blocks or the ResNet bottleneck,
    ``attention_impl`` for the flax block's attention).  ``token_merge``
    and ``tome_prop_attn`` select the ViT trunk's inference-only ToMe path
    (``models/vit.py``); a model without a ViT trunk refuses them.

    The optimizer (and, with ``ema_decay > 0``, the EMA copy of the
    parameters) is built at the first train step, or by :meth:`fit`."""

    def __init__(self, model_name: str, cfg: TrainConfig,
                 modalities: Dict[str, ModalityConfig], *,
                 class_weights: Optional[np.ndarray] = None,
                 device: Union[str, torch.device] = "cuda",
                 image_size: int = 224, token_merge=None,
                 tome_prop_attn: bool = False, **model_kwargs):
        if token_merge is not None:
            if model_name not in zoo.VIT_TRUNK_MODELS:
                raise ValueError(
                    f"token_merge applies to ViT-trunk models "
                    f"({sorted(zoo.VIT_TRUNK_MODELS)}), not {model_name!r}")
            model_kwargs.update(token_merge=tuple(token_merge),
                                tome_prop_attn=bool(tome_prop_attn))
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
        # the EMA of the parameters by name (ema_decay > 0): the JAX
        # TrainState's ema_params; BatchNorm buffers stay live
        self.ema_params: Optional[Dict[str, torch.Tensor]] = None

    def _forward(self, *inputs: torch.Tensor,
                 state: Optional[Mapping[str, torch.Tensor]] = None,
                 **kwargs) -> torch.Tensor:
        """The module on ``inputs``, on its own tensors or on ``state``
        (parameters and buffers by name: an exported program's inputs);
        with ``cfg.qat`` through its trunk weights snapped to the int8
        serving grids (``train/qat.py``), the tensors themselves
        untouched."""
        if state is None and not self.cfg.qat:
            return self.module(*inputs, **kwargs)
        if state is None:
            state = dict(self.module.named_parameters())
        if self.cfg.qat:
            state = qat_mod.fake_quant_trunks(state)
        return torch.func.functional_call(self.module, state, inputs,
                                          kwargs, strict=False)

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
        weights = self.loss_class_weights()
        return valid if weights is None else weights[labels.long()] * valid

    def _per_sample(self) -> Callable:
        if self.cfg.loss == "focal":
            return functools.partial(per_sample_focal,
                                     gamma=float(self.cfg.focal_gamma))
        return per_sample_ce

    def _build_optimizer(self) -> AdamW:
        """A fresh AdamW over the module's parameters (and a fresh EMA
        copy of them when ``ema_decay > 0``)."""
        if self.spec.name not in TRAINABLE_MODELS:
            raise NotImplementedError(
                f"the {self.spec.name!r} train step is not ported yet "
                f"(trainable: {TRAINABLE_MODELS})")
        _check_train_config(self.cfg)
        names, params = zip(*self.module.named_parameters())
        if self.cfg.ema_decay > 0.0:
            # copies, not aliases: the optimizer updates params in place
            self.ema_params = {n: p.detach().clone()
                               for n, p in zip(names, params)}
        return AdamW(params, lr=learning_rate_schedule(self.cfg),
                     weight_decay=self.cfg.weight_decay,
                     mu_dtype=canonical_dtype(self.cfg.optimizer_mu_dtype),
                     names=names)

    @torch.no_grad()
    def _ema_update(self) -> None:
        """ema = ema·decay + params·(1 - decay), after the step."""
        decay = float(self.cfg.ema_decay)
        ema = [self.ema_params[n] for n in self.optimizer.names]
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, self.optimizer.params, alpha=1.0 - decay)

    @contextlib.contextmanager
    def ema_weights(self) -> Iterator[None]:
        """The module runs on the EMA parameters inside the block (its
        BatchNorm buffers stay live); a no-op without EMA."""
        if self.ema_params is None:
            yield
            return
        params = dict(self.module.named_parameters())
        live = {n: p.data for n, p in params.items()}
        try:
            for n, p in params.items():
                p.data = self.ema_params[n]
            yield
        finally:
            for n, p in params.items():
                p.data = live[n]

    def train_step(self, batch: Mapping[str, Union[np.ndarray, torch.Tensor]],
                   generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """One optimizer step.  ``batch``: {modality: (B, S, S, 3) uint8,
        "label": (B,) int, "valid": (B,) float} (numpy or tensors);
        ``generator`` on this trainer's device draws the augmentation,
        mixup and dropout.  Returns device tensors ``loss`` (the weighted
        CE or focal loss) and ``counts`` ([tn, fp, fn, tp] over the valid
        rows)."""
        if self.optimizer is None:
            self.optimizer = self._build_optimizer()
        batch = {k: torch.as_tensor(v).to(self.device)
                 for k, v in batch.items()}
        inputs = self._preprocess_train(batch, generator)
        labels, valid = batch["label"].long(), batch["valid"].float()
        weights = self._sample_weights(labels, valid)
        per_sample = self._per_sample()
        self.module.train()
        self.optimizer.zero_grad()
        if self.cfg.grad_accum > 1:
            loss, counts = self._accumulate(inputs, labels, valid, weights,
                                            generator, per_sample)
        else:
            if self.cfg.mixup_alpha > 0.0:
                lam, perm = sample_mixup(generator, self.cfg.mixup_alpha,
                                         labels.shape[0])
                inputs, lam_row = mixup_batch(inputs, valid, lam, perm)
            logits = self._forward(*inputs, generator=generator)
            if self.cfg.mixup_alpha > 0.0:
                loss = mixup_loss(per_sample, logits, labels, weights, valid,
                                  perm, lam_row)
            else:
                loss = weighted_mean(per_sample(logits, labels), weights)
            loss.backward()
            counts = metrics_mod.confusion_counts(
                logits.detach().argmax(-1), labels, valid)
        self.optimizer.step()
        if self.ema_params is not None:
            self._ema_update()
        return {"loss": loss.detach(), "counts": counts}

    def _accumulate(self, inputs, labels, valid, weights, generator,
                    per_sample) -> Tuple[torch.Tensor, torch.Tensor]:
        """The full batch's gradient from ``grad_accum`` sequential
        microbatches: the numerator Σ wᵢ·lossᵢ and denominator Σ wᵢ
        accumulate apart and the summed gradient is divided once, since
        ∇(N/W) = (Σ ∇Nₖ)/W.  BatchNorm statistics move once per microbatch
        and each microbatch draws its own dropout, as in JAX's scan."""
        accum = self.cfg.grad_accum
        b = labels.shape[0]
        if b % accum:
            raise ValueError(f"batch {b} not divisible by "
                             f"grad_accum={accum}")
        mb = b // accum
        # each parameter accumulates into a buffer of its own: left to
        # itself autograd may hand two parameters views of one gradient
        # (a broadcast add that reduces nothing passes its gradient on
        # as it is, e.g. the one-row BatchNorm biases of a residual sum),
        # and every later += and the division below would then hit it
        # twice
        for p in self.optimizer.params:
            p.grad = torch.zeros_like(p)
        numer = torch.zeros((), device=self.device)
        counts = torch.zeros(4, device=self.device)
        for k in range(accum):
            rows = slice(k * mb, (k + 1) * mb)
            logits = self._forward(*(x[rows] for x in inputs),
                                   generator=generator)
            part = (weights[rows] * per_sample(logits, labels[rows])).sum()
            part.backward()
            numer += part.detach()
            counts += metrics_mod.confusion_counts(
                logits.detach().argmax(-1), labels[rows], valid[rows])
        wtotal = weights.sum().clamp_min(1e-12)
        grads = [p.grad for p in self.optimizer.params if p.grad is not None]
        torch._foreach_div_(grads, wtotal)
        return numer / wtotal, counts

    @torch.inference_mode()
    def eval_step(self, batch: Mapping[str, Union[np.ndarray, torch.Tensor]]
                  ) -> Dict[str, torch.Tensor]:
        """``batch``: {modality: (B, S, S, 3) uint8} (numpy or tensors).
        Returns device tensors ``probs`` = softmax(logits)[:, 1] and
        ``preds`` = argmax(logits); with ``label`` (and ``valid``, all rows
        by default) in the batch also ``loss`` (the weighted CE over the
        valid rows) and ``counts``, as the JAX eval step."""
        self.module.eval()
        tensors = {k: torch.as_tensor(batch[k]).to(self.device)
                   for k in (*self.spec.inputs, "label", "valid")
                   if k in batch}
        return serving_outputs(self._forward, tensors, self.spec.inputs,
                               self.modalities, self.compute_dtype,
                               self.loss_class_weights())

    def loss_class_weights(self) -> Optional[torch.Tensor]:
        """The class weights the loss applies (None: every row counts
        by its validity alone)."""
        if self.class_weights is not None and self.cfg.class_weighted_loss:
            return self.class_weights
        return None

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

    def run_eval_epoch(self, dataset: ArrayDataset
                       ) -> Tuple[EpochMetrics, Dict[str, np.ndarray]]:
        """The whole dataset in ``eval_bs`` batches.  Returns (metrics,
        {'y_true', 'y_pred', 'y_probs'}) with padding rows stripped."""
        if len(dataset) == 0:
            raise ValueError(
                "cannot evaluate an empty dataset: the split directory "
                "has no images (check the data-dir layout)")
        outs = []
        for batch in data_loader.device_prefetch(
                data_loader.batch_slices(dataset, np.arange(len(dataset)),
                                         self.cfg.eval_bs), self.device):
            outs.append(self.eval_step(batch))
        n = len(dataset)
        preds = torch.cat([o["preds"] for o in outs])[:n].cpu().numpy()
        probs = torch.cat([o["probs"] for o in outs])[:n].cpu().numpy()
        metrics = self._reduce_epoch(outs)
        return metrics, {"y_true": np.asarray(dataset.labels),
                         "y_pred": preds, "y_probs": probs}

    def _reduce_epoch(self, step_metrics: List[Dict]) -> EpochMetrics:
        losses = torch.stack([m["loss"] for m in step_metrics]).cpu()
        counts = torch.stack([m["counts"] for m in step_metrics]).sum(0)
        counts = counts.cpu().numpy()
        return EpochMetrics(loss=float(losses.mean()),
                            accuracy=metrics_mod.accuracy_from_counts(counts),
                            f1=metrics_mod.f1_from_counts(counts))

    # --------------------------------------------------------------- fit

    def _epoch_generator(self, epoch: int) -> torch.Generator:
        """The epoch's generator on this device, seeded from (seed, epoch)
        as JAX folds the epoch into its key."""
        seed = np.random.SeedSequence([self.cfg.seed, epoch]).generate_state(
            1, np.uint64)[0]
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def _model_state(self) -> Dict[str, torch.Tensor]:
        """What a checkpoint holds as the model: the EMA parameters when
        EMA is on (the weights a deployment serves), and the live
        BatchNorm buffers."""
        state = self.module.state_dict()
        if self.ema_params is not None:
            state.update(self.ema_params)
        return state

    def fit(self, train_ds: ArrayDataset, val_ds: ArrayDataset,
            checkpoint_dir: Optional[Path] = None,
            log: Callable[[str], None] = print,
            profile_dir: Optional[Path] = None,
            resume_from: Optional[Path] = None,
            init_from: Optional[Path] = None,
            metrics_jsonl: Optional[Path] = None
            ) -> Tuple[Dict[str, List[float]], float]:
        """A full training run with the reference's epoch loop contract.
        Returns (history, best_val_f1); the trained weights stay in
        ``self.module`` (and the optimizer in ``self.optimizer``).  The JAX
        ``fit`` returns (final_state, history, best_val_f1): its
        final_state is this trainer's module and optimizer.

        The run starts from the module's weights as they stand (JAX's
        ``fit`` draws them from ``cfg.seed``: draw them with
        ``zoo.init_model`` for the same start) and a fresh optimizer.
        ``resume_from`` (a checkpoint directory of the port or of the JAX
        package) restores the model and optimizer from whichever of
        ``last_model`` and ``best_model`` is newer and continues at its
        epoch + 1 with its history and best F1; ``init_from`` loads the
        weights only (fresh optimizer, epoch 1).  The best checkpoint is
        saved from epoch ``save_best_after_epoch`` on, when the val F1
        strictly improves; ``save_last`` also saves every epoch as
        ``last_model``; with ``ema_decay > 0`` validation and checkpoints
        use the EMA weights and the checkpoints carry ``raw_params``;
        ``early_stop_patience`` stops after that many epochs without a
        better val F1; ``async_checkpoint`` writes on a background thread,
        joined before ``fit`` returns.  ``metrics_jsonl`` gets one JSON
        object per epoch (the JAX package's keys), appended;
        ``profile_dir`` a ``torch.profiler`` trace of epoch 2."""
        cfg = self.cfg
        np_rng = np.random.default_rng(cfg.seed)
        history: Dict[str, List[float]] = {
            "train_loss": [], "train_acc": [], "train_f1": [],
            "val_loss": [], "val_acc": [], "val_f1": []}
        best_val_f1 = 0.0
        start_epoch = 1
        self.optimizer = self._build_optimizer()

        resume_base = (ckpt_mod.resume_basename(resume_from)
                       if resume_from is not None else None)
        if init_from is not None and resume_base is None:
            self.restore(init_from, with_opt_state=False)
            log(f"Initialized model weights from {init_from}")
        if resume_base is not None:
            self.restore(resume_from, with_opt_state=True,
                         basename=resume_base)
            meta = ckpt_mod.load_meta(resume_from, resume_base)
            start_epoch = int(meta.get("epoch", 0)) + 1
            best_val_f1 = float(meta.get("val_f1", 0.0))
            saved_history = meta.get("history", {})
            for key in history:
                history[key] = list(saved_history.get(key, []))
            log(f"Resumed from {resume_from} ({resume_base}) at epoch "
                f"{start_epoch} (best val F1 {best_val_f1:.4f})")

        use_ema = self.ema_params is not None
        ema_meta = {"ema_decay": cfg.ema_decay} if use_ema else {}
        patience = int(cfg.early_stop_patience)
        best_seen, epochs_since_best = -1.0, 0
        saver = ckpt_mod.AsyncCheckpointer() if cfg.async_checkpoint else None
        save_fn = saver.save if saver is not None else ckpt_mod.save_checkpoint
        meter = ThroughputMeter()
        try:
            for epoch in range(start_epoch, cfg.num_epochs + 1):
                t0 = time.perf_counter()
                meter.reset()
                with profile_trace(profile_dir if epoch == 2 else None):
                    train_m = self.run_train_epoch(
                        train_ds, np_rng, self._epoch_generator(epoch),
                        meter=meter)
                throughput = meter.summary()
                train_rate = meter.images_per_sec_per_chip
                with self.ema_weights():
                    val_m, _ = self.run_eval_epoch(val_ds)
                dt = time.perf_counter() - t0
                for split, m in (("train", train_m), ("val", val_m)):
                    history[f"{split}_loss"].append(m.loss)
                    history[f"{split}_acc"].append(m.accuracy)
                    history[f"{split}_f1"].append(m.f1)
                log(f"[Epoch {epoch}/{cfg.num_epochs}] "
                    f"Train Loss: {train_m.loss:.4f}, Acc: "
                    f"{train_m.accuracy:.4f}, F1: {train_m.f1:.4f} | "
                    f"Val Loss: {val_m.loss:.4f}, Acc: {val_m.accuracy:.4f},"
                    f" F1: {val_m.f1:.4f} ({dt:.1f}s, {throughput})")
                if metrics_jsonl is not None:
                    rec = {"epoch": epoch, "model": self.spec.name,
                           "train_loss": train_m.loss,
                           "train_acc": train_m.accuracy,
                           "train_f1": train_m.f1,
                           "val_loss": val_m.loss, "val_acc": val_m.accuracy,
                           "val_f1": val_m.f1, "seconds": round(dt, 3),
                           "images_per_sec_per_chip": round(train_rate, 2)}
                    path = Path(metrics_jsonl)
                    path.parent.mkdir(parents=True, exist_ok=True)
                    with path.open("a") as f:
                        f.write(json.dumps(rec) + "\n")

                if checkpoint_dir is not None:
                    raw = ({"raw_params": dict(self.module.named_parameters())}
                           if use_ema else None)
                    if (epoch >= cfg.save_best_after_epoch
                            and val_m.f1 > best_val_f1):
                        best_val_f1 = val_m.f1
                        save_fn(checkpoint_dir, epoch=epoch,
                                model_state=self._model_state(),
                                opt_state=self.optimizer.state_dict(),
                                val_f1=val_m.f1, history=history,
                                extra_meta={"model": self.spec.name,
                                            **ema_meta},
                                extra_state=raw)
                        log(f"  Saved BEST model (Val F1: {val_m.f1:.4f})")
                    if cfg.save_last:
                        # meta val_f1 carries the running best, so a
                        # resumed run keeps the best-save threshold
                        save_fn(checkpoint_dir, epoch=epoch,
                                model_state=self._model_state(),
                                opt_state=self.optimizer.state_dict(),
                                val_f1=best_val_f1, history=history,
                                extra_meta={"model": self.spec.name,
                                            "last_val_f1": val_m.f1,
                                            **ema_meta},
                                extra_state=raw,
                                basename=ckpt_mod.LAST_BASENAME)

                if val_m.f1 > best_seen + 1e-12:
                    best_seen, epochs_since_best = val_m.f1, 0
                else:
                    epochs_since_best += 1
                if patience and epochs_since_best >= patience:
                    log(f"Early stopping at epoch {epoch}: no val-F1 "
                        f"improvement in {patience} epoch(s) "
                        f"(best {best_seen:.4f})")
                    break
        finally:
            if saver is not None:
                saver.wait()                 # the last checkpoint on disk
        return history, best_val_f1

    # ------------------------------------------------------------- load

    def restore(self, checkpoint_dir: Path, with_opt_state: bool = False,
                basename: str = "best_model") -> None:
        """Load a checkpoint of the port (``{basename}.pt``) or of the JAX
        package (``{basename}.msgpack``) into this trainer, flexibly (keys
        absent or of another shape keep their current values).  Builds a
        fresh optimizer if there is none; ``with_opt_state`` also loads
        its state (a failure is reported and the optimizer stays as it
        was).  With EMA on, the EMA restarts at the loaded weights, and a
        checkpoint's ``raw_params`` (an EMA run's) become the live
        parameters, so a resume continues both exactly."""
        payload, _ = ckpt_mod.load_checkpoint(checkpoint_dir, basename,
                                              self.spec.name)
        merged, _, _ = ckpt_mod.load_flexible(self.module.state_dict(),
                                              payload["model_state_dict"])
        self.module.load_state_dict(merged)
        if self.optimizer is None:
            self.optimizer = self._build_optimizer()
        saved_opt = payload.get("optimizer_state_dict")
        if with_opt_state and saved_opt:
            try:
                self.optimizer.load_state_dict(saved_opt)
            except (KeyError, ValueError, TypeError) as e:
                print(f"  (optimizer state not restored: {e})")
        if self.ema_params is not None:
            params = dict(self.module.named_parameters())
            self.ema_params = {n: p.detach().clone()
                               for n, p in params.items()}
            if payload.get("raw_params"):
                raw, _, _ = ckpt_mod.load_flexible(
                    {n: p.detach() for n, p in params.items()},
                    payload["raw_params"], verbose=False)
                with torch.no_grad():
                    for n, p in params.items():
                        p.copy_(raw[n])
