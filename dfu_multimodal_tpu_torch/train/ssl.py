"""Self-supervised pretraining: SimCLR and MAE for the two trunk families
(counterpart of ``dfu_multimodal_tpu/train/ssl.py``).

With ~1k labelled images a trunk trained from scratch cannot reach the
reference's pretrained-backbone accuracies, and in a deployment with no
network the torchvision / timm weights are out of reach, so the
unlabelled training images make the initialisation:

- **SimCLR** (any trunk): two independently augmented views of every
  image, a two-layer projection head and the NT-Xent loss over the 2B
  views.  A BatchNorm trunk (ResNet-50, the tiny trunk) runs one train
  forward per view, view 1 then view 2, so its statistics move as in
  JAX; the BN-free ViT runs one forward over the 2B concatenated views
  (row-wise the same math).  On the card the ViT's blocks are the fused
  kernels K1/K2 forward and K4/K5 backward.
- **MAE** (the ViT trunk): 75% of the patches masked, the encoder run on
  the visible ones (``ViT(keep_ids=..., return_tokens=True)``), a small
  ViT decoder (``decoder_depth`` flax-style blocks with plain attention,
  as JAX pins them) predicting every patch, the MSE over the masked
  patches' normalised pixels.

Checkpoints have the supervised format (``utils/checkpoint.py``) with the
trunk under its classifier's keys and its fusion branch's
(:data:`SCOPE_ALIASES`), so ``--init-from`` of every train CLI warm-starts
from them through the flexible restore (the projection and decoder keys
are skipped).

Randomness (views, masks) comes from an explicit ``torch.Generator`` on
the device.

On a data-parallel mesh (``cfg.mesh`` under a process group,
``parallel/mesh.py``) each rank takes its rows of every global batch and
the views and masks drawn for the whole batch (the JAX ``*_spmd``
recipe).  SimCLR gathers z1, z2 and the validity mask over the ranks
with autograd (an all-reduce of zero-padded rows), weighs only its own
rows as anchors, divides by the global anchor count and the gradients
are summed over the ranks: the single device's loss and gradient.  MAE
divides its rows' masked-patch sum by the all-reduced patch count.  A
BatchNorm trunk keeps its two passes with the global batch's statistics.
Pretraining shards no parameters: a model axis or FSDP is refused.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dfu_multimodal_tpu_torch.config import (AugmentConfig, MeshConfig,
                                             ModalityConfig)
from dfu_multimodal_tpu_torch.data import loader as data_loader
from dfu_multimodal_tpu_torch.data.loader import ArrayDataset
from dfu_multimodal_tpu_torch.data.transforms import augment_and_normalize
from dfu_multimodal_tpu_torch.models import zoo
from dfu_multimodal_tpu_torch.models.common import canonical_dtype
from dfu_multimodal_tpu_torch.models.resnet import ResNet50
from dfu_multimodal_tpu_torch.models.tiny import TinyTrunk
from dfu_multimodal_tpu_torch.models.vit import (LN_EPS, ViT, EncoderBlock,
                                                 _layer_norm, _linear)
from dfu_multimodal_tpu_torch.parallel import mesh as mesh_mod
from dfu_multimodal_tpu_torch.train.engine import (epoch_generator,
                                                   set_batchnorm_group)
from dfu_multimodal_tpu_torch.train.optim import AdamW, warmup_cosine_schedule
from dfu_multimodal_tpu_torch.utils import checkpoint as ckpt_mod

# trunk prefix -> the fusion branch's: the pretrained trunk is saved under
# both, so one checkpoint warm-starts the unimodal classifiers and the
# fusion model
SCOPE_ALIASES = {"resnet.": "rgb_branch.", "vit.": "thermal_branch."}


@dataclass(frozen=True)
class PretrainConfig:
    """The JAX package's fields and defaults (small-data SSL practice)."""

    method: str = "simclr"              # 'simclr' | 'mae'
    batch_size: int = 64
    num_epochs: int = 100
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    warmup_epochs: float = 5.0
    seed: int = 42
    compute_dtype: str = "bfloat16"
    save_every: int = 0                 # also checkpoint every N epochs
    # SimCLR
    temperature: float = 0.2
    proj_hidden: int = 512
    proj_dim: int = 128
    # colour jitter makes the features colour-invariant: off for domains
    # whose class signal is chromatic (ulcer redness)
    simclr_color_jitter: bool = True
    # MAE
    mask_ratio: float = 0.75
    norm_pix: bool = True
    decoder_dim: int = 256
    decoder_depth: int = 2
    decoder_heads: int = 8
    # ViT trunk (defaults = ViT-B/16)
    vit_patch: int = 16
    vit_hidden: int = 768
    vit_depth: int = 12
    vit_heads: int = 12
    mesh: Any = None                    # MeshConfig or None (this device)


# --------------------------------------------------------------- augment


def simclr_augment(base: AugmentConfig,
                   color_jitter: bool = True) -> AugmentConfig:
    """Harder positives than supervised training: a wider affine crop /
    scale range and jitter; flips and rotation stay."""
    return dataclasses.replace(
        base, aug_prob=1.0, affine=True, affine_degrees=30.0,
        affine_translate=0.2, affine_scale=(0.4, 1.0),
        color_jitter=base.color_jitter and color_jitter,
        brightness=0.4, contrast=0.4, saturation=0.4)


def mae_augment(base: AugmentConfig) -> AugmentConfig:
    """Light augmentation (crop and flip; the masking is the
    augmentation): no photometric change of the reconstruction target."""
    return dataclasses.replace(
        base, aug_prob=1.0, rotation_degrees=0.0, color_jitter=False,
        gaussian_blur=False, affine=True, affine_degrees=0.0,
        affine_translate=0.1, affine_scale=(0.6, 1.0))


def ssl_modality(modality: ModalityConfig, method: str,
                 color_jitter: bool = True) -> ModalityConfig:
    if method == "simclr":
        aug = simclr_augment(modality.augment, color_jitter)
    else:
        aug = mae_augment(modality.augment)
    return dataclasses.replace(modality, augment=aug)


# ----------------------------------------------------------------- losses


def nt_xent_row_losses(z1: torch.Tensor, z2: torch.Tensor,
                       valid: torch.Tensor, temperature: float = 0.2
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-anchor NT-Xent losses over the 2B projected views and the
    doubled validity mask, (2B,) each.  Padded rows are neither anchors
    (the caller weights them 0) nor negatives (their column is masked).
    The mask is a large finite negative, not -inf: an all -inf row gives
    NaN, which would leak through its zero weight's gradient."""
    b = z1.shape[0]
    z = torch.cat([z1, z2]).float()
    z = z / torch.linalg.vector_norm(z, dim=-1,
                                     keepdim=True).clamp_min(1e-12)
    sim = (z @ z.T) / temperature                          # (2B, 2B)
    v2 = torch.cat([valid, valid]).float()
    eye = torch.eye(2 * b, dtype=torch.bool, device=z.device)
    sim = sim.masked_fill(eye | (v2[None, :] < 0.5), -1e9)
    rows = torch.arange(2 * b, device=z.device)
    pos = torch.cat([rows[b:], rows[:b]])
    return -torch.log_softmax(sim, dim=-1)[rows, pos], v2


def nt_xent_loss(z1: torch.Tensor, z2: torch.Tensor, valid: torch.Tensor,
                 temperature: float = 0.2) -> torch.Tensor:
    """The mean NT-Xent loss over the valid anchors."""
    losses, v2 = nt_xent_row_losses(z1, z2, valid, temperature)
    return (losses * v2).sum() / v2.sum().clamp_min(1e-12)


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, gh·gw, p·p·C), each patch flattened as
    (p, p, C): the patch embedding's layout, so ``keep_ids`` and the
    reconstruction targets name the same patches."""
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    x = images.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)


def random_keep_ids(generator: torch.Generator, batch: int,
                    num_patches: int, keep: int) -> torch.Tensor:
    """(B, keep) visible-patch indices, per row uniform without
    replacement (the first ``keep`` of a random permutation), drawn from
    ``generator`` on its device."""
    u = torch.rand(batch, num_patches, generator=generator,
                   device=generator.device)
    return u.argsort(dim=-1)[:, :keep]


def keep_mask_from_ids(keep_ids: torch.Tensor,
                       num_patches: int) -> torch.Tensor:
    """(B, K) indices -> (B, num_patches) {0, 1} mask of visible patches."""
    mask = torch.zeros(keep_ids.shape[0], num_patches,
                       device=keep_ids.device)
    return mask.scatter_(1, keep_ids.long(), 1.0)


def masked_pixel_loss(pred: torch.Tensor, target: torch.Tensor,
                      keep_ids: torch.Tensor, valid: torch.Tensor,
                      norm_pix: bool = True) -> torch.Tensor:
    """MSE over the masked patches of the valid rows; ``norm_pix``
    normalises each target patch to zero mean and unit variance."""
    numer, count = masked_pixel_terms(pred, target, keep_ids, valid,
                                      norm_pix)
    return numer / count.clamp_min(1e-12)


def masked_pixel_terms(pred: torch.Tensor, target: torch.Tensor,
                       keep_ids: torch.Tensor, valid: torch.Tensor,
                       norm_pix: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`masked_pixel_loss`'s numerator and masked-patch count."""
    if norm_pix:
        mean = target.mean(dim=-1, keepdim=True)
        var = target.var(dim=-1, keepdim=True, unbiased=False)
        target = (target - mean) / torch.sqrt(var + 1e-6)
    per_patch = ((pred.float() - target.float()) ** 2).mean(dim=-1)
    masked = 1.0 - keep_mask_from_ids(keep_ids, target.shape[1])
    w = masked * valid[:, None].float()
    return (per_patch * w).sum(), w.sum()


# ----------------------------------------------------------------- models


class SimCLRModel(nn.Module):
    """trunk -> features -> Linear, ReLU, Linear (no bias) -> (B,
    proj_dim) fp32.  The trunk sits under its classifier's attribute
    (``resnet``, ``vit``; ``trunk`` for the tiny smoke trunk), so its keys
    are the classifier's.  ``block_impl`` / ``attention_impl`` go to the
    trunk as in JAX (the ViT's blocks; the ResNet takes ``"auto"``,
    ``"flax"`` or ``"fused"``, whose kernel is eval-only)."""

    def __init__(self, trunk: str = "resnet", proj_hidden: int = 512,
                 proj_dim: int = 128,
                 dtype: Union[str, torch.dtype] = torch.float32,
                 block_impl: str = "auto", attention_impl: str = "auto",
                 vit_cfg: Tuple[int, int, int, int] = (16, 768, 12, 12),
                 image_size: int = 224):
        super().__init__()
        self.dtype = canonical_dtype(dtype)
        # the trunk's attribute: its keys are the classifier's
        self.trunk_name = {"tiny": "trunk"}.get(trunk, trunk)
        if trunk == "resnet":
            self.resnet = ResNet50(self.dtype, block_impl=block_impl)
            feats = 2048
        elif trunk == "vit":
            p, hid, depth, heads = vit_cfg
            self.vit = ViT(image_size=image_size, patch_size=p,
                           hidden_dim=hid, depth=depth, num_heads=heads,
                           dtype=self.dtype, block_impl=block_impl,
                           attention_impl=attention_impl)
            feats = hid
        elif trunk == "tiny":
            self.trunk = TinyTrunk(self.dtype)
            feats = 32
        else:
            raise ValueError(f"unknown trunk {trunk!r}")
        self.proj_fc1 = nn.Linear(feats, proj_hidden)
        self.proj_fc2 = nn.Linear(proj_hidden, proj_dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = getattr(self, self.trunk_name)(x)
        dt = self.dtype
        z = F.relu(_linear(feats.to(dt), self.proj_fc1, dt))
        return F.linear(z, self.proj_fc2.weight.to(dt)).float()


class MAEModel(nn.Module):
    """ViT encoder on the visible tokens + a small ViT decoder that
    predicts every patch: (B, num_patches, p·p·3) fp32.  The encoder and
    the decoder run the flax-style blocks with plain attention (JAX pins
    them: the masked 1+K sequences are not the kernels' shapes)."""

    def __init__(self, dtype: Union[str, torch.dtype] = torch.float32,
                 vit_cfg: Tuple[int, int, int, int] = (16, 768, 12, 12),
                 decoder_dim: int = 256, decoder_depth: int = 2,
                 decoder_heads: int = 8, image_size: int = 224):
        super().__init__()
        self.dtype = canonical_dtype(dtype)
        p, hid, depth, heads = vit_cfg
        self.patch = p
        num_patches = (image_size // p) ** 2
        self.vit = ViT(image_size=image_size, patch_size=p, hidden_dim=hid,
                       depth=depth, num_heads=heads, dtype=self.dtype,
                       block_impl="flax", attention_impl="xla")
        self.dec_embed = nn.Linear(hid, decoder_dim)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, decoder_dim))
        self.dec_pos_embed = nn.Parameter(
            torch.zeros(1, num_patches + 1, decoder_dim))
        self.dec_blocks = nn.ModuleList(
            EncoderBlock(decoder_dim, decoder_heads, 4, self.dtype, "xla")
            for _ in range(decoder_depth))
        self.dec_norm = nn.LayerNorm(decoder_dim, eps=LN_EPS)
        self.dec_pred = nn.Linear(decoder_dim, p * p * 3)

    def forward(self, x: torch.Tensor,
                keep_ids: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = x.shape[0]
        tokens = self.vit(x, keep_ids=keep_ids, return_tokens=True)
        z = _linear(tokens.to(dt), self.dec_embed, dt)
        full = self.mask_token.to(dt).expand(
            b, self.dec_pos_embed.shape[1] - 1, -1)
        # the encoded visible tokens back to their patch slots
        idx = keep_ids.long()[:, :, None].expand(-1, -1, z.shape[-1])
        full = full.scatter(1, idx, z[:, 1:])
        seq = torch.cat([z[:, :1], full], dim=1) + self.dec_pos_embed.to(dt)
        for block in self.dec_blocks:
            seq = block(seq)
        seq = _layer_norm(seq, self.dec_norm, dt)
        return _linear(seq[:, 1:], self.dec_pred, dt).float()


@torch.no_grad()
def init_ssl_model(module: nn.Module,
                   generator: torch.Generator) -> nn.Module:
    """``zoo.init_model``'s initialisers (the JAX package's), and the MAE
    decoder's mask token and position embedding from N(0, 0.02)."""
    zoo.init_model(module, generator)
    if isinstance(module, MAEModel):
        module.mask_token.normal_(0.0, 0.02, generator=generator)
        module.dec_pos_embed.normal_(0.0, 0.02, generator=generator)
    return module


def alias_state(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Every trunk key also under its fusion-branch alias
    (:data:`SCOPE_ALIASES`), so one checkpoint warm-starts every model
    family."""
    out = dict(state)
    for canon, alias in SCOPE_ALIASES.items():
        out.update({alias + k[len(canon):]: v for k, v in state.items()
                    if k.startswith(canon)})
    return out


# ----------------------------------------------------------------- engine


def ssl_schedule(cfg: PretrainConfig, steps_per_epoch: int):
    """Warm-up cosine over the run, the warm-up clamped strictly below
    the horizon (optax needs decay steps past the warm-up, so a one-step
    run is pure cosine)."""
    total = max(1, steps_per_epoch * cfg.num_epochs)
    warm = max(0, min(int(round(cfg.warmup_epochs * steps_per_epoch)),
                      total - 1))
    return warmup_cosine_schedule(float(cfg.learning_rate), warm, total)


class SSLTrainer:
    """Pretraining engine on one device (the card unless the caller asks
    for the CPU): warm-up-cosine AdamW with a bf16 first moment, the epoch
    loop over unlabelled images, checkpoints with the trunk aliases.  The
    weights are the module's: :meth:`fit` draws them from ``cfg.seed``
    (:func:`init_ssl_model`) before it trains."""

    def __init__(self, trunk: str, cfg: PretrainConfig,
                 modality: ModalityConfig, image_size: int = 224,
                 block_impl: str = "auto", attention_impl: str = "auto",
                 device: Union[str, torch.device] = "cuda", mesh=None):
        if cfg.method not in ("simclr", "mae"):
            raise ValueError(f"unknown SSL method {cfg.method!r}")
        if cfg.method == "mae" and trunk != "vit":
            raise ValueError("MAE pretrains the ViT trunk only "
                             "(masked patch tokens); use --method simclr "
                             f"for trunk {trunk!r}")
        wants_kernels = (str(block_impl).startswith("fused")
                         or attention_impl == "pallas")
        if cfg.method == "mae" and (wants_kernels or block_impl == "int8"):
            raise ValueError(
                "MAE encodes masked 1+K-token sequences — the fused "
                "kernels are tuned for the 197-token production "
                "shape, so MAE impls are fixed to the XLA blocks "
                f"(got block_impl={block_impl!r})")
        self.cfg = cfg
        self.trunk = trunk
        self.image_size = image_size
        self.device = torch.device(device)
        mesh_cfg = cfg.mesh if cfg.mesh is not None else MeshConfig()
        self.mesh = (mesh if mesh is not None
                     else mesh_mod.trainer_mesh(mesh_cfg, self.device))
        if self.mesh is not None:
            if mesh_cfg.fsdp or self.mesh[mesh_mod.MODEL_AXIS].size() > 1:
                raise ValueError(
                    f"pretraining on mesh={mesh_cfg}: pretraining shards "
                    "no parameters (fsdp and the model axis are for the "
                    "supervised trainers)")
            self._data = mesh_mod.axis(self.mesh, mesh_mod.DATA_AXIS)
        self.compute_dtype = canonical_dtype(cfg.compute_dtype)
        self.modality = ssl_modality(modality, cfg.method,
                                     cfg.simclr_color_jitter)
        vit_cfg = (cfg.vit_patch, cfg.vit_hidden, cfg.vit_depth,
                   cfg.vit_heads)
        if cfg.method == "simclr":
            self.module = SimCLRModel(
                trunk, cfg.proj_hidden, cfg.proj_dim, self.compute_dtype,
                block_impl, attention_impl, vit_cfg, image_size)
        else:
            self.module = MAEModel(
                self.compute_dtype, vit_cfg, cfg.decoder_dim,
                cfg.decoder_depth, cfg.decoder_heads, image_size)
        self.module.to(self.device)
        self.num_patches = (image_size // cfg.vit_patch) ** 2
        self.keep = max(1, int(round(
            self.num_patches * (1.0 - cfg.mask_ratio))))
        self.optimizer: Optional[AdamW] = None

    def build_optimizer(self, steps_per_epoch: int) -> AdamW:
        if self.mesh is not None and self._data[1] > 1:
            set_batchnorm_group(self.module, self._data[2])
        names, params = zip(*self.module.named_parameters())
        self.optimizer = AdamW(params, lr=ssl_schedule(self.cfg,
                                                       steps_per_epoch),
                               weight_decay=self.cfg.weight_decay,
                               mu_dtype=torch.bfloat16, names=names)
        return self.optimizer

    def _has_batchnorm(self) -> bool:
        return any(isinstance(m, nn.BatchNorm2d)
                   for m in self.module.modules())

    def project_views(self, v1: torch.Tensor, v2: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(z1, z2) of the two views in train mode: a BatchNorm trunk runs
        view 1 then view 2 (its statistics move twice, in that order);
        a BN-free trunk one forward over the 2B concatenated views."""
        self.module.train()
        if self._has_batchnorm():
            return self.module(v1), self.module(v2)
        z = self.module(torch.cat([v1, v2]))
        return z[:v1.shape[0]], z[v1.shape[0]:]

    def loss_on_views(self, views: Tuple[torch.Tensor, ...],
                      valid: torch.Tensor,
                      keep_ids: Optional[torch.Tensor] = None,
                      rows: Optional[Tuple[int, int]] = None
                      ) -> torch.Tensor:
        """The loss of normalised views (SimCLR: two, MAE: one, with its
        ``keep_ids``) in train mode, differentiable in the module.  On a
        mesh the views are rows ``lo:lo + B`` of an n-row batch (``rows``)
        and the result is this rank's share of the global loss (the
        shares sum to it)."""
        if self.cfg.method == "simclr":
            z = self.project_views(*views)
            b = valid.shape[0]
            lo, n = rows if rows is not None else (0, b)
            z1, z2, valid = (
                (z[0], z[1], valid) if rows is None else
                (mesh_mod.gather_rows(t, lo, n, self._data[2])
                 for t in (*z, valid)))
            losses, v2 = nt_xent_row_losses(z1, z2, valid,
                                            self.cfg.temperature)
            # this rank's rows are its anchors; every row is a negative
            mine = torch.zeros(n, device=v2.device)
            mine[lo:lo + b] = 1.0
            anchors = v2 * torch.cat([mine, mine])
            return (losses * anchors).sum() / v2.sum().clamp_min(1e-12)
        (x,) = views
        self.module.train()
        target = patchify(x.float(), self.cfg.vit_patch)
        pred = self.module(x, keep_ids)
        numer, count = masked_pixel_terms(pred, target, keep_ids, valid,
                                          self.cfg.norm_pix)
        if rows is not None:
            count = mesh_mod.sum_(count, self._data[2])
        return numer / count.clamp_min(1e-12)

    def step_on_views(self, views: Tuple[torch.Tensor, ...],
                      valid: torch.Tensor,
                      keep_ids: Optional[torch.Tensor] = None,
                      rows: Optional[Tuple[int, int]] = None
                      ) -> torch.Tensor:
        """One AdamW step on given views (and mask): the train step after
        its draws.  Returns the loss (a device tensor); on a mesh
        (``rows``, see :meth:`loss_on_views`) the global one."""
        if self.optimizer is None:
            raise RuntimeError("build_optimizer first (fit does)")
        self.optimizer.zero_grad()
        loss = self.loss_on_views(views, valid, keep_ids, rows)
        loss.backward()
        if rows is not None:
            if self._data[1] > 1:
                mesh_mod.sum_grads(self.optimizer.params, self._data[2])
            loss = mesh_mod.sum_(loss, self._data[2])
        self.optimizer.step()
        return loss.detach()

    def draw_views(self, images: torch.Tensor, generator: torch.Generator,
                   rows: Optional[Tuple[int, int]] = None
                   ) -> Tuple[Tuple[torch.Tensor, ...],
                              Optional[torch.Tensor]]:
        """The step's draws from ``generator``: SimCLR's two augmented
        views, or MAE's view and its visible-patch ids (``rows``: the
        images' place in the global batch, whose draws are made)."""
        aug = lambda: augment_and_normalize(images, self.modality,
                                            self.compute_dtype, generator,
                                            rows)
        if self.cfg.method == "simclr":
            return (aug(), aug()), None
        x = aug()
        lo, n = rows if rows is not None else (0, x.shape[0])
        return (x,), random_keep_ids(generator, n, self.num_patches,
                                     self.keep)[lo:lo + x.shape[0]]

    def train_step(self, batch: Dict[str, torch.Tensor],
                   generator: torch.Generator) -> torch.Tensor:
        """``batch``: {modality: (B, S, S, 3) uint8, "valid": (B,)} on the
        device (on a mesh the global batch: this rank takes its rows)."""
        rows = None
        if self.mesh is not None:
            batch, lo, n = data_loader.shard_batch(dict(batch),
                                                   *self._data[:2])
            rows = (lo, n)
        views, keep_ids = self.draw_views(batch[self.modality.name],
                                          generator, rows)
        return self.step_on_views(views, batch["valid"].float(), keep_ids,
                                  rows)

    # --------------------------------------------------------------- fit

    def save(self, directory: Path, epoch: int,
             history: Dict[str, List[float]]) -> None:
        """Write the checkpoint (rank 0 alone on a process group)."""
        if mesh_mod.world()[0] != 0:
            return
        ckpt_mod.save_checkpoint(
            Path(directory), epoch=epoch,
            model_state=alias_state(self.module.state_dict()),
            opt_state=self.optimizer.state_dict(), val_f1=0.0,
            history=history,
            extra_meta={"ssl_method": self.cfg.method, "trunk": self.trunk,
                        "image_size": self.image_size,
                        "pretrain": dataclasses.asdict(
                            dataclasses.replace(self.cfg, mesh=None))})

    def restore(self, directory: Path) -> Tuple[int, Dict[str, List[float]]]:
        """Resume: the model and optimizer state; returns (epoch,
        history)."""
        payload, meta = ckpt_mod.load_weights(self.module, Path(directory),
                                              verbose=False)
        if payload.get("optimizer_state_dict"):
            try:
                self.optimizer.load_state_dict(
                    payload["optimizer_state_dict"])
            except (KeyError, ValueError, TypeError) as e:
                print(f"  (optimizer state not restored: {e})")
        history = {k: list(v) for k, v in meta.get("history", {}).items()}
        return int(meta.get("epoch", 0)), history

    def fit(self, dataset: ArrayDataset, checkpoint_dir: Path,
            log: Callable[[str], None] = print,
            resume: bool = False) -> Dict[str, List[float]]:
        cfg = self.cfg
        bs = (cfg.batch_size if self.mesh is None else
              mesh_mod.pad_batch_to_mesh(cfg.batch_size, self._data[1]))
        n = len(dataset)
        steps_per_epoch = max(1, -(-n // bs))
        init_ssl_model(self.module, torch.Generator(
            device=self.device).manual_seed(cfg.seed))
        self.build_optimizer(steps_per_epoch)
        np_rng = np.random.default_rng(cfg.seed)
        history: Dict[str, List[float]] = {"loss": []}
        start_epoch = 1
        if resume and ckpt_mod.best_checkpoint_exists(checkpoint_dir):
            last_epoch, history = self.restore(checkpoint_dir)
            history.setdefault("loss", [])
            start_epoch = last_epoch + 1
            # the host shuffle stream stays aligned with a fresh run
            for _ in range(last_epoch):
                np_rng.permutation(n)
            log(f"Resumed pretraining at epoch {start_epoch}")

        for epoch in range(start_epoch, cfg.num_epochs + 1):
            t0 = time.perf_counter()
            order = np_rng.permutation(n)
            gen = epoch_generator(cfg.seed, epoch, self.device)
            losses = [self.train_step(batch, gen)
                      for batch in data_loader.device_prefetch(
                          data_loader.batch_slices(dataset, order, bs),
                          self.device)]
            mean_loss = float(torch.stack(losses).float().mean())
            history["loss"].append(mean_loss)
            dt = time.perf_counter() - t0
            log(f"[Pretrain {cfg.method} {epoch}/{cfg.num_epochs}] "
                f"loss {mean_loss:.4f} ({dt:.1f}s, "
                f"{n / max(dt, 1e-9) / mesh_mod.world()[1]:.0f} "
                "img/s/chip)")
            if cfg.save_every and epoch % cfg.save_every == 0:
                self.save(checkpoint_dir, epoch, history)
        self.save(checkpoint_dir, cfg.num_epochs, history)
        log(f"Saved pretrained trunk to {checkpoint_dir} "
            f"(use --init-from with any train CLI)")
        return history
