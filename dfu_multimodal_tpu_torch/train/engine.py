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

On a mesh (``mesh=``, or ``cfg.mesh`` under a process group:
``parallel/mesh.py``) every rank runs the same steps on the same global
batches and takes its rows of each (``data/loader.py::shard_batch``);
the augmentation draws are the global batch's (``rows=``), so the views
are the single device's.  The reduction is the JAX ``*_spmd`` steps':
the weight mass Σ wᵢ is all-reduced first, each rank back-propagates its
rows' Σ wᵢ·lossᵢ over it and the gradients are summed (not averaged, as
DDP would: DDP's mean equals this only when every rank holds the same
weight mass, which class weights and padded rows break).  BatchNorm
statistics are the global batch's (``models/resnet.py::BatchNorm2d``'s
``group``).  ``cfg.mesh.fsdp`` shards the parameters with FSDP2 and
``cfg.mesh.model > 1`` splits the ViT blocks' Linears Megatron-style
(``parallel/sharding.py``, JAX's rules); both run the flax blocks, as
JAX does.  Evaluation splits each batch the same way and gathers the
probabilities in row order.  Every collective is an ``all_reduce``, so
gloo ranks sharing one card compute what NCCL ranks do.

Refused on a mesh, with the JAX package's words where it has them: int8
blocks for training (any mesh), fused or int8 blocks under FSDP or
tensor parallelism, FSDP with a model axis, and, over more than one data
rank, mixup (its partner permutation is batch-global) and grad-accum for
a BatchNorm model or one whose per-rank batch it does not divide (JAX
runs both as one global program; microbatch statistics and pairs would
differ here).  Under FSDP or tensor parallelism also EMA and QAT (both
swap whole parameters in).  Checkpoints hold whole tensors: a sharded
trainer gathers them to save and shards them again to load.
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
from dfu_multimodal_tpu_torch.models.resnet import BatchNorm2d
from dfu_multimodal_tpu_torch.parallel import mesh as mesh_mod
from dfu_multimodal_tpu_torch.parallel import sharding
from dfu_multimodal_tpu_torch.train import qat as qat_mod
from dfu_multimodal_tpu_torch.train.optim import AdamW, learning_rate_schedule
from dfu_multimodal_tpu_torch.utils import checkpoint as ckpt_mod
from dfu_multimodal_tpu_torch.utils.logging import (ThroughputMeter,
                                                    profile_trace)

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
                    class_weights: Optional[torch.Tensor] = None,
                    group=None) -> Dict[str, torch.Tensor]:
    """The eval step's tensor part, which :meth:`Trainer.eval_step` and
    the exported serving programs (``serve/export.py``) both run, so the
    two cannot drift: ``batch`` {modality: (B, S, S, 3) uint8 on the
    model's device[, "label", "valid"]} -> ``probs`` = softmax(logits)[:,
    1], ``preds`` = argmax(logits) and, with ``label``, ``loss`` (the CE
    over the valid rows, weighted by ``class_weights`` of each label when
    given) and ``counts``.  ``forward`` maps the normalised inputs, in
    ``inputs`` order, to logits.  With a data-parallel ``group`` the loss
    and counts are those of every rank's rows together."""
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
        num = (weights * per_sample_ce(logits, labels)).sum()
        den = weights.sum()
        counts = metrics_mod.confusion_counts(out["preds"], labels, valid)
        if group is not None:
            num, den, counts = (mesh_mod.sum_(t, group)
                                for t in (num, den, counts))
        out["loss"] = num / den.clamp_min(1e-12)        # weighted_mean's
        out["counts"] = counts
    return out


def epoch_generator(seed: int, epoch: int,
                    device: torch.device) -> torch.Generator:
    """An epoch's generator on ``device``, seeded from (seed, epoch) as
    JAX folds the epoch into its key."""
    state = np.random.SeedSequence([seed, epoch]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def set_batchnorm_group(module: torch.nn.Module, group) -> None:
    """Give every BatchNorm of ``module`` the global batch's statistics
    over ``group`` (``models/resnet.py::BatchNorm2d``)."""
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.group = group


@dataclass
class EpochMetrics:
    loss: float
    accuracy: float
    f1: float


def _check_train_config(cfg: TrainConfig) -> None:
    """Raise for the combinations the JAX Trainer refuses."""
    if cfg.loss not in ("ce", "focal"):
        raise ValueError(f"unknown loss {cfg.loss!r} (choose 'ce' or "
                         "'focal')")
    if cfg.mixup_alpha > 0.0 and cfg.grad_accum > 1:
        raise ValueError("mixup does not compose with grad_accum (mix "
                         "pairs would be confined to one microbatch); use "
                         "one or the other")


class Trainer:
    """Train/eval engine for one model-zoo entry on one device (the card
    unless the caller asks for the CPU), or on this rank's device of a
    ``mesh`` (``parallel/mesh.py``; by default ``cfg.mesh``'s under a
    process group, none without one).  Weights are the module's own:
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
                 tome_prop_attn: bool = False, mesh=None, **model_kwargs):
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
        self.mesh = (mesh if mesh is not None
                     else mesh_mod.trainer_mesh(cfg.mesh, self.device))
        self._sharded = self.fsdp = self._tp = False
        self._tp_plan: Dict[str, str] = {}
        if self.mesh is not None:
            self._parallel_kwargs(model_name, model_kwargs)
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

    # --------------------------------------------------------- the mesh

    def _parallel_kwargs(self, model_name: str, model_kwargs: Dict) -> None:
        """The mesh's axes, JAX's refusals of its layouts, and the flax
        blocks that FSDP and tensor parallelism run on."""
        self._data = mesh_mod.axis(self.mesh, mesh_mod.DATA_AXIS)
        model = self.mesh[mesh_mod.MODEL_AXIS].size()
        self.fsdp = bool(self.cfg.mesh.fsdp)
        self._tp = model > 1
        if self.fsdp and self._tp:
            raise ValueError(
                "fsdp=True combined with a model axis > 1 is not supported: "
                "pick ZeRO-3 param sharding (fsdp) OR Megatron tensor "
                "parallelism (--mesh model axis), not both.")
        if not (self.fsdp or self._tp) or zoo.get(model_name).name not in (
                "thermal_only", "multimodal"):
            return
        block_impl = model_kwargs.get("block_impl", "auto")
        if block_impl not in ("auto", "flax"):
            mode = ("fsdp" if self.fsdp else
                    f"tensor parallelism (model axis {model} > 1)")
            raise ValueError(
                f"block_impl={block_impl!r} is incompatible with "
                f"{mode}: the fused Pallas kernels are opaque to "
                "the XLA partitioner. Use block_impl='flax'/'auto' "
                "or disable the sharded-param mode.")
        model_kwargs["block_impl"] = "flax"

    def _check_mesh_step(self) -> None:
        """Refuse the train configurations the data-parallel step cannot
        compute as the single global program would."""
        if self.mesh is None:
            return
        if (self.fsdp or self._tp) and (self.cfg.ema_decay > 0.0
                                        or self.cfg.qat):
            raise ValueError("ema_decay and qat are not supported with "
                             "fsdp or tensor parallelism")
        size = self._data[1]
        if size == 1:
            return
        reason = None
        accum = int(self.cfg.grad_accum)
        per_dev = mesh_mod.pad_batch_to_mesh(self.cfg.batch_size,
                                             size) // size
        if self.cfg.mixup_alpha > 0.0:
            reason = "mixup pairs rows across the whole batch"
        elif accum > 1 and any(isinstance(m, BatchNorm2d)
                               for m in self.module.modules()):
            reason = "BatchNorm statistics of global microbatches"
        elif accum > 1 and per_dev % accum:
            reason = (f"grad_accum={accum} does not divide the per-device "
                      f"batch {per_dev}")
        if reason:
            raise ValueError(
                f"this configuration cannot run the data-parallel train "
                f"step over {size} ranks (no mixup; grad-accum only for "
                "the BN-free model and only when it divides the "
                f"per-device batch): {reason}")

    def _shard(self) -> None:
        """Put FSDP or tensor parallelism on the module (once, before the
        optimizer takes its parameters)."""
        if self.mesh is None or self._sharded:
            return
        if self.fsdp:
            sharding.apply_fsdp(self.module, self.mesh)
        elif self._tp:
            self._tp_plan = sharding.apply_tp(self.module, self.mesh)
        self._sharded = self.fsdp or self._tp

    def _local(self, batch: Mapping) -> Tuple[Dict, Optional[Tuple[int,
                                                                   int]]]:
        """This rank's rows of a global batch and their place, (lo, n);
        the batch itself and None off a mesh."""
        if self.mesh is None:
            return dict(batch), None
        local, lo, n = data_loader.shard_batch(dict(batch), self._data[0],
                                               self._data[1])
        return local, (lo, n)

    def _dropout_generator(self, generator: torch.Generator
                           ) -> torch.Generator:
        """The generator dropout draws from: the step's own on one data
        rank; over several, one seeded from (seed, step, data rank), so
        each rank's rows get their own masks (the JAX spmd steps fold the
        axis index into the dropout key) and the shared stream the
        augmentation draws from stays in step on every rank."""
        if self.mesh is None or self._data[1] == 1:
            return generator
        state = np.random.SeedSequence(
            [self.cfg.seed, self.optimizer.count, self._data[0]]
        ).generate_state(1, np.uint64)[0]
        return torch.Generator(device=self.device).manual_seed(int(state))

    def _checkpoint_state(self) -> Tuple[Dict, Dict, Optional[Dict]]:
        """(model state, optimizer state, raw parameters or None) as a
        checkpoint holds them: whole tensors, gathered from their shards
        under FSDP or tensor parallelism (a collective every rank
        joins)."""
        model = self._model_state()
        opt = self.optimizer.state_dict()
        raw = (dict(self.module.named_parameters())
               if self.ema_params is not None else None)
        if self._sharded:
            full = functools.partial(sharding.full_state,
                                     module=self.module, plan=self._tp_plan)
            model = full(model)
            opt = {**opt, "mu": full(opt["mu"]), "nu": full(opt["nu"])}
        return model, opt, raw

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
                          generator: torch.Generator,
                          rows: Optional[Tuple[int, int]] = None
                          ) -> Tuple[torch.Tensor, ...]:
        return tuple(
            augment_and_normalize(batch[m], self.modalities[m],
                                  self.compute_dtype, generator, rows)
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
        _check_train_config(self.cfg)
        block_impl = str(self.model_kwargs.get("block_impl", ""))
        if block_impl.startswith("fused_q8"):
            raise ValueError(
                f"training with block_impl={block_impl!r} is not supported: "
                "the int8 kernels are serving-only (no VJP). Train bf16/fp32 "
                "and quantize at deployment (serve/predict --int8, or "
                "--qat to train through the serving grid).")
        self._check_mesh_step()
        if self.mesh is not None and self._data[1] > 1:
            set_batchnorm_group(self.module, self._data[2])
        self._shard()
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
        batch, rows = self._local(batch)
        batch = {k: torch.as_tensor(v).to(self.device)
                 for k, v in batch.items()}
        inputs = self._preprocess_train(batch, generator, rows)
        labels, valid = batch["label"].long(), batch["valid"].float()
        weights = self._sample_weights(labels, valid)
        per_sample = self._per_sample()
        self.module.train()
        self.optimizer.zero_grad()
        loss, counts = self._backward(inputs, labels, valid, weights,
                                      generator, per_sample)
        self.optimizer.step()
        if self.ema_params is not None:
            self._ema_update()
        return {"loss": loss, "counts": counts}

    def _sum(self, t: torch.Tensor) -> torch.Tensor:
        """Σ of ``t`` over the data ranks (``t`` itself off a mesh)."""
        return t if self.mesh is None else mesh_mod.sum_(t, self._data[2])

    def _backward(self, inputs, labels, valid, weights, generator,
                  per_sample) -> Tuple[torch.Tensor, torch.Tensor]:
        """The step's gradient.  The weight mass W = Σ wᵢ first (the
        global batch's on a mesh), then each of ``grad_accum`` sequential
        microbatches back-propagates Σ wᵢ·lossᵢ / W, since ∇(N/W) =
        (Σ ∇Nₖ)/W; on a mesh the gradients are then summed over the data
        ranks (FSDP's reduce-scatter sums them itself), as the JAX
        ``*_spmd`` steps psum theirs.  BatchNorm statistics move once a
        microbatch and each draws its own dropout, as in JAX's scan; with
        mixup (no grad_accum; one data rank) the loss is the mixed pairs'.
        Returns the (global) loss and confusion counts."""
        accum = int(self.cfg.grad_accum)
        b = labels.shape[0]
        if b % accum:
            raise ValueError(
                f"{'per-device ' if self.mesh is not None else ''}batch {b} "
                f"not divisible by grad_accum={accum}")
        mb = b // accum
        if accum > 1:
            # each parameter accumulates into a buffer of its own: left to
            # itself autograd may hand two parameters views of one
            # gradient (a broadcast add that reduces nothing passes its
            # gradient on as it is, e.g. the one-row BatchNorm biases of a
            # residual sum), and every later += would then hit it twice
            for p in self.optimizer.params:
                p.grad = torch.zeros_like(p)
        wtotal = self._sum(weights.sum()).clamp_min(1e-12)
        dropout_gen = self._dropout_generator(generator)
        loss = torch.zeros((), device=self.device)
        counts = torch.zeros(4, device=self.device)
        for k in range(accum):
            rows = slice(k * mb, (k + 1) * mb)
            x, y, w = tuple(t[rows] for t in inputs), labels[rows], weights[rows]
            if self.cfg.mixup_alpha > 0.0:
                lam, perm = sample_mixup(generator, self.cfg.mixup_alpha, b)
                x, lam_row = mixup_batch(x, valid, lam, perm)
            logits = self._forward(*x, generator=dropout_gen)
            if self.cfg.mixup_alpha > 0.0:
                part = mixup_loss(per_sample, logits, y, w, valid, perm,
                                  lam_row)
            else:
                part = (w * per_sample(logits, y)).sum() / wtotal
            part.backward()
            loss += part.detach()
            counts += metrics_mod.confusion_counts(
                logits.detach().argmax(-1), y, valid[rows])
        if self.mesh is not None and self._data[1] > 1 and not self.fsdp:
            mesh_mod.sum_grads(self.optimizer.params, self._data[2])
        return self._sum(loss), self._sum(counts)

    @torch.inference_mode()
    def eval_step(self, batch: Mapping[str, Union[np.ndarray, torch.Tensor]]
                  ) -> Dict[str, torch.Tensor]:
        """``batch``: {modality: (B, S, S, 3) uint8} (numpy or tensors).
        Returns device tensors ``probs`` = softmax(logits)[:, 1] and
        ``preds`` = argmax(logits); with ``label`` (and ``valid``, all rows
        by default) in the batch also ``loss`` (the weighted CE over the
        valid rows) and ``counts``, as the JAX eval step."""
        self.module.eval()
        batch, rows = self._local({k: batch[k] for k in (
            *self.spec.inputs, "label", "valid") if k in batch})
        tensors = {k: torch.as_tensor(v).to(self.device)
                   for k, v in batch.items()}
        group = None if self.mesh is None else self._data[2]
        out = serving_outputs(self._forward, tensors, self.spec.inputs,
                              self.modalities, self.compute_dtype,
                              self.loss_class_weights(), group)
        if rows is not None:
            for k in ("probs", "preds"):
                out[k] = mesh_mod.gather_rows(out[k], *rows, group)
        return out

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
        bs = self._global_batch(self.cfg.batch_size)
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
                                         self._global_batch(
                                             self.cfg.eval_bs)),
                self.device):
            outs.append(self.eval_step(batch))
        n = len(dataset)
        preds = torch.cat([o["preds"] for o in outs])[:n].cpu().numpy()
        probs = torch.cat([o["probs"] for o in outs])[:n].cpu().numpy()
        metrics = self._reduce_epoch(outs)
        return metrics, {"y_true": np.asarray(dataset.labels),
                         "y_pred": preds, "y_probs": probs}

    def _global_batch(self, batch_size: int) -> int:
        """The batch rounded up to a multiple of the data ranks."""
        if self.mesh is None:
            return batch_size
        return mesh_mod.pad_batch_to_mesh(batch_size, self._data[1])

    def _reduce_epoch(self, step_metrics: List[Dict]) -> EpochMetrics:
        losses = torch.stack([m["loss"] for m in step_metrics]).cpu()
        counts = torch.stack([m["counts"] for m in step_metrics]).sum(0)
        counts = counts.cpu().numpy()
        return EpochMetrics(loss=float(losses.mean()),
                            accuracy=metrics_mod.accuracy_from_counts(counts),
                            f1=metrics_mod.f1_from_counts(counts))

    # --------------------------------------------------------------- fit

    def _epoch_generator(self, epoch: int) -> torch.Generator:
        return epoch_generator(self.cfg.seed, epoch, self.device)

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
        ``profile_dir`` a ``torch.profiler`` trace of epoch 2.

        On a process group every rank runs the loop and only rank 0
        writes checkpoints and the JSONL; a save of sharded parameters
        gathers them with a collective every rank joins; asynchronous
        saves are refused (synchronous, logged) over more than one rank,
        as in JAX."""
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
        rank, world = mesh_mod.world()
        use_async = cfg.async_checkpoint and world == 1
        if cfg.async_checkpoint and world > 1:
            log("async checkpointing is single-process only; saving "
                "synchronously")
        saver = ckpt_mod.AsyncCheckpointer() if use_async else None
        base_save = (saver.save if saver is not None
                     else ckpt_mod.save_checkpoint)
        # one writer: two ranks racing on the same files could leave a
        # truncated checkpoint and the JSONL duplicate lines
        is_writer = rank == 0
        if not is_writer:
            metrics_jsonl = None

        def save_fn(*args, **kwargs):
            if is_writer:
                base_save(*args, **kwargs)

        meter = ThroughputMeter(n_chips=world)
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
                    model_state = opt_state = raw = None
                    saving = ((epoch >= cfg.save_best_after_epoch
                               and val_m.f1 > best_val_f1) or cfg.save_last)
                    # gathered on every rank (the same decision on each)
                    if saving and (is_writer or self._sharded):
                        model_state, opt_state, raw = (
                            self._checkpoint_state())
                    raw = {"raw_params": raw} if use_ema else None
                    if (epoch >= cfg.save_best_after_epoch
                            and val_m.f1 > best_val_f1):
                        best_val_f1 = val_m.f1
                        save_fn(checkpoint_dir, epoch=epoch,
                                model_state=model_state,
                                opt_state=opt_state,
                                val_f1=val_m.f1, history=history,
                                extra_meta={"model": self.spec.name,
                                            **ema_meta},
                                extra_state=raw)
                        if is_writer:
                            log(f"  Saved BEST model (Val F1: "
                                f"{val_m.f1:.4f})")
                    if cfg.save_last:
                        # meta val_f1 carries the running best, so a
                        # resumed run keeps the best-save threshold
                        save_fn(checkpoint_dir, epoch=epoch,
                                model_state=model_state,
                                opt_state=opt_state,
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
        if self.mesh is not None and world > 1:
            mesh_mod.barrier()                # rank 0's files on disk
        return history, best_val_f1

    # ------------------------------------------------------------- load

    def load_weights(self, checkpoint_dir: Path,
                     basename: str = "best_model") -> Dict:
        """Load a checkpoint's model weights (the port's or the JAX
        package's) into the module, flexibly, and nothing else (no
        optimizer is built); returns the checkpoint's payload."""
        if not self._sharded:
            payload, _ = ckpt_mod.load_weights(self.module, checkpoint_dir,
                                               basename, self.spec.name)
            return payload
        # FSDP / tensor parallelism: merged into the gathered state, then
        # sharded back (collectives every rank joins)
        payload, _ = ckpt_mod.load_checkpoint(checkpoint_dir, basename,
                                              self.spec.name)
        full = sharding.full_state(self.module.state_dict(), self.module,
                                   self._tp_plan)
        merged, _, _ = ckpt_mod.load_flexible(full,
                                              payload["model_state_dict"])
        sharding.load_full_state(self.module, merged, self._tp_plan)
        return payload

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
        payload = self.load_weights(checkpoint_dir, basename)
        if self.optimizer is None:
            self.optimizer = self._build_optimizer()
        saved_opt = payload.get("optimizer_state_dict")
        if with_opt_state and saved_opt:
            try:
                if self._sharded:         # whole moments -> this shard
                    own = self.optimizer.state_dict()
                    saved_opt = {**saved_opt, **{
                        key: sharding.shard_like(saved_opt[key], own[key],
                                                 self.module, self._tp_plan)
                        for key in ("mu", "nu")}}
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
