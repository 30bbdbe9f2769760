"""ViT-B/16 in PyTorch, timm key layout, blocks on the port's kernels.

Counterpart of ``dfu_multimodal_tpu/models/vit.py`` (``ViT`` with the fused
block path, and ``ViTClassifier``): 224x224 -> 14x14 patches + CLS = 197
tokens, 12 pre-LN encoder blocks, 12 heads, MLP ratio 4, CLS-token
features.  Each block runs the trainable ``ops.vit_block.AttnBlock`` and
``MlpBlock`` (forward kernels K1/K2; backward K5/K4 in the hand chain
rules, rematerialised from the block inputs).

Parameters are fp32 in timm's layout (``patch_embed.proj`` conv-shaped,
``blocks.{i}.norm1/attn.qkv/attn.proj/norm2/mlp.fc1/mlp.fc2``, ``norm``);
compute runs in ``dtype``.  Every forward transposes the Linear weights to
the kernels' (in, out) layout and casts them to the compute dtype — one
copy of the trunk's weights per call.  The copy is differentiable (JAX's
``astype`` VJP): a weight gradient computed in the compute dtype reaches
the fp32 parameter through it, so a bf16 step rounds weight gradients to
bf16 first, as the JAX package does.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from dfu_multimodal_tpu_torch.models.common import canonical_dtype
from dfu_multimodal_tpu_torch.ops.vit_block import AttnBlock, MlpBlock

LN_EPS = 1e-6


def _in_out(linear: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """A Linear's (out, in) weight as a contiguous (in, out) ``dtype``
    tensor (one copy; gradients flow back through it)."""
    w = linear.weight
    return torch.empty((w.shape[1], w.shape[0]), dtype=dtype,
                       device=w.device).copy_(w.t())


class Attention(nn.Module):
    """Parameter holder with timm's ``attn.qkv`` / ``attn.proj`` keys."""

    def __init__(self, dim: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class Mlp(nn.Module):
    """Parameter holder with timm's ``mlp.fc1`` / ``mlp.fc2`` keys."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class EncoderBlock(nn.Module):
    """Pre-LN encoder block computed by the attn/mlp block kernels."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int,
                 dtype: torch.dtype):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, mlp_ratio * dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = AttnBlock.apply(x, self.norm1.weight, self.norm1.bias,
                            _in_out(self.attn.qkv, dt), self.attn.qkv.bias,
                            _in_out(self.attn.proj, dt), self.attn.proj.bias,
                            self.num_heads)
        return MlpBlock.apply(x, self.norm2.weight, self.norm2.bias,
                              _in_out(self.mlp.fc1, dt), self.mlp.fc1.bias,
                              _in_out(self.mlp.fc2, dt), self.mlp.fc2.bias)


class PatchEmbed(nn.Module):
    """timm's ``patch_embed.proj`` conv parameters, applied as ONE matmul
    over (row, col, channel)-flattened patches, as the JAX trunk does."""

    def __init__(self, patch_size: int, dim: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(3, dim, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C) NHWC in the compute dtype -> (B, gh·gw, dim)."""
        b, h, w, c = x.shape
        p = self.patch_size
        gh, gw = h // p, w // p
        x = x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, gh * gw, p * p * c)
        kernel = self.proj.weight.permute(2, 3, 1, 0).reshape(p * p * c, -1)
        return (torch.matmul(x, kernel.to(x.dtype))
                + self.proj.bias.to(x.dtype))


class ViT(nn.Module):
    """ViT trunk returning fp32 CLS features (B, hidden_dim).  The
    position-embedding length is fixed by ``image_size`` here (JAX infers
    it from the init input)."""

    def __init__(self, image_size: int = 224, patch_size: int = 16,
                 hidden_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: int = 4,
                 dtype: Union[str, torch.dtype] = torch.float32):
        super().__init__()
        self.dtype = canonical_dtype(dtype)
        tokens = (image_size // patch_size) ** 2 + 1
        self.patch_embed = PatchEmbed(patch_size, hidden_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, hidden_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, hidden_dim))
        self.blocks = nn.ModuleList(
            EncoderBlock(hidden_dim, num_heads, mlp_ratio, self.dtype)
            for _ in range(depth))
        self.norm = nn.LayerNorm(hidden_dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = self.patch_embed(x.to(dt))
        cls = self.cls_token.to(dt).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)
        for block in self.blocks:
            x = block(x)
        # LayerNorm is per token: normalising only the CLS row is the
        # same as normalising all and taking row 0.
        cls = F.layer_norm(x[:, 0].float(), x.shape[-1:], self.norm.weight,
                           self.norm.bias, LN_EPS)
        return cls.to(dt).float()


def ViTBase16(dtype: Union[str, torch.dtype] = torch.float32,
              image_size: int = 224) -> ViT:
    return ViT(image_size=image_size, dtype=dtype)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout drawn from an explicit generator (on x's device):
    keep with probability 1 - rate and scale by 1/(1 - rate), as flax's
    ``nn.Dropout``."""
    if rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return x * keep.to(x.dtype) / (1.0 - rate)


class ViTClassifier(nn.Module):
    """ViT-B/16 trunk + Dropout + Linear(768 -> num_classes) head in fp32:
    the reference's ``ThermalOnlyModel``.  The trunk's keys carry the
    ``vit.`` prefix, which the JAX package's torch converter strips; the
    head is ``head``.  Dropout is active in train mode and draws from the
    ``generator`` given to forward (required then)."""

    def __init__(self, num_classes: int = 2, drop_rate: float = 0.5,
                 dtype: Union[str, torch.dtype] = torch.float32,
                 image_size: int = 224, **vit_kwargs):
        super().__init__()
        self.drop_rate = drop_rate
        self.vit = ViT(image_size=image_size, dtype=dtype, **vit_kwargs)
        hidden = self.vit.pos_embed.shape[-1]
        self.head = nn.Linear(hidden, num_classes)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        feats = self.vit(x)
        if self.training and self.drop_rate > 0.0:
            if generator is None:
                raise ValueError("ViTClassifier in train mode draws its "
                                 "dropout from an explicit generator")
            feats = dropout(feats, self.drop_rate, generator)
        return self.head(feats.float())
