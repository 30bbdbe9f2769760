"""ViT-B/16 in PyTorch, timm key layout, blocks on the port's kernels.

Counterpart of ``dfu_multimodal_tpu/models/vit.py`` (``ViT`` with the flax
and fused block paths, ``ViTClassifier`` and the int8 converters):
224x224 -> 14x14 patches + CLS = 197 tokens, 12 pre-LN encoder blocks, 12
heads, MLP ratio 4, CLS-token features.

``block_impl`` picks the encoder block (``"auto"`` resolves to
``"fused"``, as the JAX ``ViT._resolve_block`` does where the kernels
run: here the kernels always run on the card and their plain versions on
the CPU):

- ``"fused"`` (default): the trainable ``ops.vit_block.AttnBlock`` and
  ``MlpBlock`` (forward kernels K1/K2; backward K5/K4 in the hand chain
  rules, rematerialised from the block inputs);
- ``"flax"``: the unfused block (:class:`EncoderBlock`): LayerNorm and
  the Linears as PyTorch ops, attention by ``attention_impl`` —
  ``"pallas"`` (what ``"auto"`` resolves to) runs the trainable packed-qkv
  kernel ``ops.attention.qkv_attention`` (K6 forward and backward),
  ``"xla"`` plain softmax attention in PyTorch ops (:func:`xla_attention`);
- ``"fused_q8"``: the serving-only int8 blocks of ``ops.vit_block_q8``
  with dynamic per-row activation scales (K7);
- ``"fused_q8s"``: the same with calibrated static activation scales (K8).

``token_merge=(merge_at, keep)`` (serving only, ToMe: Bolya et al.
ICLR'23) runs blocks ``[:merge_at]`` on all N tokens, merges them once down
to ``keep`` (``ops/token_merge.py::bipartite_merge``) and runs blocks
``[merge_at:]`` on ``keep`` tokens; with ``tome_prop_attn`` those blocks
add log(token size) to each key's attention scores (proportional
attention), an operand every block family takes (the fused and int8
blocks inside their attention kernel).  The blocks keep their
``blocks.{i}`` keys: a token-merged model loads the same ``state_dict``
as the plain one (the JAX package splits its scanned stack into
``encoder`` / ``encoder2`` instead, ``split_encoder_variables``, which
``tools/convert_jax.py`` maps both ways).

Every block declares the same keys: fp32 parameters in timm's layout
(``patch_embed.proj`` conv-shaped, ``blocks.{i}.norm1/attn.qkv/attn.proj/
norm2/mlp.fc1/mlp.fc2``, ``norm``; the int8 blocks hold ``kernel_q8`` and
``scale`` for a Linear's ``weight``), so one checkpoint loads into the
flax and the fused blocks alike.  Compute runs in ``dtype``.  The fused
and flax forwards cast the Linear weights to the compute dtype per call
(the fused one also transposes them to the kernels' (in, out) layout) —
one copy of the trunk's weights per call.  The copy is differentiable
(JAX's ``astype`` VJP): a weight gradient computed in the compute dtype
reaches the fp32 parameter through it, so a bf16 step rounds weight
gradients to bf16 first, as the JAX package does.  The int8 blocks hold
their weights as buffers already in the kernels' (in, out) int8 layout,
quantised once at load (:func:`quantize_variables`), and copy nothing per
call.
"""

from __future__ import annotations

from typing import (Dict, Iterable, List, Mapping, Optional, Sequence,
                    Tuple, Union)

import torch
import torch.nn.functional as F
from torch import nn

from dfu_multimodal_tpu_torch.models.common import (Taps, canonical_dtype,
                                                    dropout, tap)
from dfu_multimodal_tpu_torch.ops.attention import qkv_attention
from dfu_multimodal_tpu_torch.ops.token_merge import bipartite_merge
from dfu_multimodal_tpu_torch.ops.vit_block import AttnBlock, MlpBlock
from dfu_multimodal_tpu_torch.ops.vit_block_q8 import (
    attn_block_q8, attn_block_q8s, mlp_block_q8, mlp_block_q8s, over_qmax,
    quantize_weight)

LN_EPS = 1e-6
# the calibration point whose absmax scales each dense layer's input
CALIBRATION_POINTS = ("ln1_out", "proj_in", "ln2_out", "gelu_out")
# a forward's calibration record: max|·| of each point, one entry a block
Calibration = Dict[str, List[torch.Tensor]]


def _in_out(linear: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """A Linear's (out, in) weight as a contiguous (in, out) ``dtype``
    tensor (one copy; gradients flow back through it)."""
    w = linear.weight
    return torch.empty((w.shape[1], w.shape[0]), dtype=dtype,
                       device=w.device).copy_(w.t())


def _linear(x: torch.Tensor, linear: nn.Linear,
            dtype: torch.dtype) -> torch.Tensor:
    """A Linear in the compute dtype (weights cast per call, as flax's
    ``nn.Dense(dtype=...)`` does)."""
    return F.linear(x, linear.weight.to(dtype), linear.bias.to(dtype))


def _layer_norm(x: torch.Tensor, norm: nn.LayerNorm,
                dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm with fp32 statistics, output in the compute dtype."""
    return F.layer_norm(x.float(), x.shape[-1:], norm.weight, norm.bias,
                        LN_EPS).to(dtype)


def _tap(calibration: Optional[Calibration], point: str,
         t: torch.Tensor) -> torch.Tensor:
    if calibration is not None:
        calibration[point].append(t.float().abs().amax())
    return t


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain softmax attention in PyTorch ops, the JAX ``xla_attention``:
    q, k, v (B, H, N, D) -> (B, H, N, D).  q is scaled in the compute
    dtype, the scores accumulate in fp32, plus ``bias`` (B, N), ToMe's
    per-key score bias, the softmax is fp32 and P is cast to the compute
    dtype before P·V.  JAX runs this outside Pallas, so it is no kernel's
    plain version and runs on any device."""
    logits = torch.matmul((q * q.shape[-1] ** -0.5).float(),
                          k.float().transpose(-1, -2))
    if bias is not None:
        logits = logits + bias.float()[:, None, None, :]
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


def resolve_block_impl(impl: str) -> str:
    """``"auto"`` -> ``"fused"`` (the JAX ``ViT._resolve_block`` where
    the kernels run); the others pass through, an unknown one raises."""
    impl = "fused" if impl == "auto" else impl
    if impl not in BLOCK_IMPLS:
        raise ValueError(f"unknown block impl: {impl!r}")
    return impl


def resolve_attention_impl(impl: str) -> str:
    """``"auto"`` -> ``"pallas"`` (the port has no partitioner to keep a
    kernel from); ``"xla"`` and ``"pallas"`` pass through."""
    if impl == "auto":
        return "pallas"
    if impl not in ("xla", "pallas"):
        raise ValueError(f"unknown attention impl: {impl!r}")
    return impl


class Attention(nn.Module):
    """Parameter holder with timm's ``attn.qkv`` / ``attn.proj`` keys."""

    def __init__(self, dim: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class MultiHeadAttention(Attention):
    """The flax block's attention (the JAX ``MultiHeadAttention``): the qkv
    Linear, attention by ``attention_impl``, the output projection.
    ``"pallas"`` runs the packed-qkv kernel on the (B, N, 3C) qkv output;
    ``"xla"``, and any call with ToMe's key ``bias`` (as in JAX, whose
    packed-qkv kernel takes none), splits the heads and runs
    :func:`xla_attention`."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype,
                 attention_impl: str = "auto"):
        super().__init__(dim)
        self.num_heads = num_heads
        self.dtype = dtype
        self.attention_impl = resolve_attention_impl(attention_impl)

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                calibration: Optional[Calibration] = None) -> torch.Tensor:
        b, n, c = x.shape
        qkv = _linear(x, self.qkv, self.dtype)
        if self.attention_impl == "pallas" and bias is None:
            out = qkv_attention(qkv, self.num_heads)
        else:
            q, k, v = qkv.reshape(b, n, 3, self.num_heads,
                                  c // self.num_heads).permute(2, 0, 3, 1, 4)
            out = xla_attention(q, k, v, bias).transpose(1, 2).reshape(
                b, n, c)
        return _linear(_tap(calibration, "proj_in", out), self.proj,
                       self.dtype)


class Mlp(nn.Module):
    """Parameter holder with timm's ``mlp.fc1`` / ``mlp.fc2`` keys."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class EncoderBlock(nn.Module):
    """The flax pre-LN encoder block (the JAX ``EncoderBlock``): LN1,
    :class:`MultiHeadAttention`, residual, LN2, fc1, exact-erf GELU, fc2,
    residual.  ``calibration`` records max|·| at the four int8
    quantisation points (:data:`CALIBRATION_POINTS`); ``bias`` is ToMe's
    (B, N) key bias for the attention (every block family takes it)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int,
                 dtype: torch.dtype, attention_impl: str = "auto"):
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = MultiHeadAttention(dim, num_heads, dtype, attention_impl)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, mlp_ratio * dim)

    def forward(self, x: torch.Tensor,
                calibration: Optional[Calibration] = None,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = self.dtype
        y = _tap(calibration, "ln1_out", _layer_norm(x, self.norm1, dt))
        x = x + self.attn(y, bias, calibration=calibration)
        y = _tap(calibration, "ln2_out", _layer_norm(x, self.norm2, dt))
        y = _tap(calibration, "gelu_out",
                 F.gelu(_linear(y, self.mlp.fc1, dt)))
        return x + _linear(y, self.mlp.fc2, dt)


class FusedEncoderBlock(nn.Module):
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

    def forward(self, x: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = self.dtype
        x = AttnBlock.apply(x, self.norm1.weight, self.norm1.bias,
                            _in_out(self.attn.qkv, dt), self.attn.qkv.bias,
                            _in_out(self.attn.proj, dt), self.attn.proj.bias,
                            self.num_heads, bias)
        return MlpBlock.apply(x, self.norm2.weight, self.norm2.bias,
                              _in_out(self.mlp.fc1, dt), self.mlp.fc1.bias,
                              _in_out(self.mlp.fc2, dt), self.mlp.fc2.bias)


class QDense(nn.Module):
    """An int8 dense layer's tensors (the JAX ``_QDenseParams`` tree):
    ``kernel_q8`` int8 (in, out) in the kernels' layout, the per-output-
    channel ``scale`` and the ``bias``, fp32.  Buffers, not parameters: a
    serving block has nothing to train.

    ``kernel_kmajor`` is ``kernel_q8``'s (out, in) copy, which the card's
    int8 products read (wgmma takes 8-bit operands K-major only).  It is
    made once per weight version: a non-persistent buffer (not in
    ``state_dict``, so the JAX bridge and the converters see the JAX
    layout alone) that ``load_state_dict`` refreshes."""

    def __init__(self, din: int, dout: int):
        super().__init__()
        self.register_buffer("kernel_q8",
                             torch.zeros(din, dout, dtype=torch.int8))
        self.register_buffer("scale", torch.ones(dout))
        self.register_buffer("bias", torch.zeros(dout))
        self.register_buffer("kernel_kmajor",
                             torch.zeros(dout, din, dtype=torch.int8),
                             persistent=False)
        self.register_load_state_dict_post_hook(QDense._refresh_kmajor)

    @staticmethod
    def _refresh_kmajor(module: "QDense", incompatible_keys) -> None:
        with torch.no_grad():
            module.kernel_kmajor = module.kernel_q8.t().contiguous()


class QAttention(nn.Module):
    """``attn.qkv`` / ``attn.proj`` int8 holders."""

    def __init__(self, dim: int):
        super().__init__()
        self.qkv = QDense(dim, 3 * dim)
        self.proj = QDense(dim, dim)


class QMlp(nn.Module):
    """``mlp.fc1`` / ``mlp.fc2`` int8 holders."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = QDense(dim, hidden)
        self.fc2 = QDense(hidden, dim)


class QuantizedEncoderBlock(nn.Module):
    """Serving-only int8 encoder block (``ops.vit_block_q8``, K7): dynamic
    per-row activation scales; attention stays in the compute dtype.  Its
    tensors come from a trained fp32 block through
    :func:`quantize_encoder_params`."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int,
                 dtype: torch.dtype):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = QAttention(dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = QMlp(dim, mlp_ratio * dim)

    def _operands(self):
        qkv, proj = self.attn.qkv, self.attn.proj
        fc1, fc2 = self.mlp.fc1, self.mlp.fc2
        return ((self.norm1.weight, self.norm1.bias, qkv.kernel_q8,
                 qkv.scale, qkv.bias, proj.kernel_q8, proj.scale, proj.bias),
                (self.norm2.weight, self.norm2.bias, fc1.kernel_q8,
                 fc1.scale, fc1.bias, fc2.kernel_q8, fc2.scale, fc2.bias))

    def _kmajor(self):
        """The K-major copies of (qkv, proj) and of (fc1, fc2)."""
        return ((self.attn.qkv.kernel_kmajor, self.attn.proj.kernel_kmajor),
                (self.mlp.fc1.kernel_kmajor, self.mlp.fc2.kernel_kmajor))

    def forward(self, x: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        attn, mlp = self._operands()
        attn_t, mlp_t = self._kmajor()
        x = attn_block_q8(x, *attn, self.num_heads, bias, kmajor=attn_t)
        return mlp_block_q8(x, *mlp, kmajor=mlp_t)


class StaticQuantizedEncoderBlock(QuantizedEncoderBlock):
    """Int8 encoder block with CALIBRATED static activation scales
    (``ops.vit_block_q8`` q8s kernels, K8): the act scales are folded into
    the weight scales at conversion time, and the (4,) ``act_scales``
    buffer = [s_ln1, s_attn, s_ln2, s_gelu] gives the quantisation
    reciprocals."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int,
                 dtype: torch.dtype):
        super().__init__(dim, num_heads, mlp_ratio, dtype)
        self.register_buffer("act_scales", torch.ones(4))

    def forward(self, x: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        attn, mlp = self._operands()
        attn_t, mlp_t = self._kmajor()
        a = self.act_scales
        x = attn_block_q8s(x, *attn, 1.0 / a[:2], self.num_heads, bias,
                           kmajor=attn_t)
        return mlp_block_q8s(x, *mlp, 1.0 / a[2:], kmajor=mlp_t)


# block_impl -> encoder block class (the JAX ``ViT._resolve_block``)
BLOCK_IMPLS = {"flax": EncoderBlock, "fused": FusedEncoderBlock,
               "fused_q8": QuantizedEncoderBlock,
               "fused_q8s": StaticQuantizedEncoderBlock}


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
    it from the init input).  ``block_impl``: ``"auto"`` (``"fused"``),
    ``"fused"``, ``"flax"``, ``"fused_q8"`` or ``"fused_q8s"``;
    ``attention_impl`` (``"auto"``, ``"pallas"``, ``"xla"``) is taken for
    every block impl, as in JAX, and used by the flax block only (module
    docstring).  ``token_merge=(merge_at, keep)`` and ``tome_prop_attn``:
    the inference-only ToMe path (module docstring), with JAX's checks:
    ``merge_at`` in (0, depth), ``keep`` at most the token count."""

    def __init__(self, image_size: int = 224, patch_size: int = 16,
                 hidden_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: int = 4,
                 dtype: Union[str, torch.dtype] = torch.float32,
                 block_impl: str = "fused", attention_impl: str = "auto",
                 token_merge: Optional[Tuple[int, int]] = None,
                 tome_prop_attn: bool = False):
        super().__init__()
        block_impl = resolve_block_impl(block_impl)
        attention_impl = resolve_attention_impl(attention_impl)
        self.dtype = canonical_dtype(dtype)
        tokens = (image_size // patch_size) ** 2 + 1
        if token_merge is not None:
            merge_at, keep = token_merge
            if not 0 < merge_at < depth:
                raise ValueError(f"merge_at must be in (0, {depth})")
            if keep > tokens:
                raise ValueError(f"keep={keep} exceeds the {tokens} tokens")
            token_merge = (merge_at, keep)
        self.token_merge = token_merge
        self.tome_prop_attn = bool(tome_prop_attn)
        self.patch_embed = PatchEmbed(patch_size, hidden_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, hidden_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, hidden_dim))
        extra = ({"attention_impl": attention_impl}
                 if block_impl == "flax" else {})
        self.blocks = nn.ModuleList(
            BLOCK_IMPLS[block_impl](hidden_dim, num_heads, mlp_ratio,
                                    self.dtype, **extra)
            for _ in range(depth))
        self.norm = nn.LayerNorm(hidden_dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor,
                calibration: Optional[Calibration] = None,
                taps: Taps = None, keep_ids: Optional[torch.Tensor] = None,
                return_tokens: bool = False) -> torch.Tensor:
        """x (B, H, W, 3) NHWC.  ``calibration`` (flax blocks only): a
        record of :data:`CALIBRATION_POINTS` to lists, to which every block
        appends its max|·| at each point.  ``taps`` records ``blocks``, the
        (B, N, C) tokens after the last block, before the final norm (with
        ``token_merge``, the ``keep`` merged tokens, as in JAX).

        ``keep_ids`` (B, K) patch indices (the masked-autoencoder path,
        ``train/ssl.py``): after the position embedding only those patch
        tokens go on, CLS always first.  ``return_tokens`` returns the
        whole post-norm sequence (B, 1+K, C) in fp32 instead of the CLS
        features.  Both off, the classifier forward is unchanged."""
        dt = self.dtype
        x = self.patch_embed(x.to(dt))
        cls = self.cls_token.to(dt).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)
        if keep_ids is not None:
            idx = keep_ids.long()[:, :, None].expand(-1, -1, x.shape[-1])
            x = torch.cat([x[:, :1], torch.gather(x[:, 1:], 1, idx)], dim=1)
        merge_at, keep = self.token_merge or (len(self.blocks), None)
        for block in self.blocks[:merge_at]:
            x = _block(block, x, calibration)
        if self.token_merge is not None:
            sizes = torch.ones(x.shape[:2], dtype=torch.float32,
                               device=x.device)
            x, sizes = bipartite_merge(x, sizes, x.shape[1] - keep)
            # proportional attention: each key's scores + log(its size)
            bias = torch.log(sizes) if self.tome_prop_attn else None
            for block in self.blocks[merge_at:]:
                x = _block(block, x, calibration, bias)
        x = tap(taps, "blocks", x)
        if return_tokens:
            return F.layer_norm(x.float(), x.shape[-1:], self.norm.weight,
                                self.norm.bias, LN_EPS).to(dt).float()
        # LayerNorm is per token: normalising only the CLS row is the
        # same as normalising all and taking row 0.
        cls = F.layer_norm(x[:, 0].float(), x.shape[-1:], self.norm.weight,
                           self.norm.bias, LN_EPS)
        return cls.to(dt).float()


def _block(block: nn.Module, x: torch.Tensor,
           calibration: Optional[Calibration],
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One encoder block with ToMe's key bias (None for none) and the
    calibration record (flax blocks only) where given."""
    if calibration is None:
        return block(x, bias=bias)
    return block(x, calibration, bias=bias)


def ViTBase16(dtype: Union[str, torch.dtype] = torch.float32,
              image_size: int = 224, block_impl: str = "fused",
              attention_impl: str = "auto",
              token_merge: Optional[Tuple[int, int]] = None,
              tome_prop_attn: bool = False) -> ViT:
    return ViT(image_size=image_size, dtype=dtype, block_impl=block_impl,
               attention_impl=attention_impl, token_merge=token_merge,
               tome_prop_attn=tome_prop_attn)


class ViTClassifier(nn.Module):
    """ViT-B/16 trunk + Dropout + Linear(768 -> num_classes) head in fp32:
    the reference's ``ThermalOnlyModel``.  The trunk's keys carry the
    ``vit.`` prefix, which the JAX package's torch converter strips; the
    head is ``head``.  Dropout is active in train mode and draws from the
    ``generator`` given to forward (required then).  ``block_impl`` picks
    the trunk's encoder block, and ``token_merge`` / ``tome_prop_attn``
    (among ``vit_kwargs``) its ToMe serving path (``ViT``)."""

    def __init__(self, num_classes: int = 2, drop_rate: float = 0.5,
                 dtype: Union[str, torch.dtype] = torch.float32,
                 image_size: int = 224, block_impl: str = "fused",
                 **vit_kwargs):
        super().__init__()
        self.drop_rate = drop_rate
        self.vit = ViT(image_size=image_size, dtype=dtype,
                       block_impl=block_impl, **vit_kwargs)
        hidden = self.vit.pos_embed.shape[-1]
        self.head = nn.Linear(hidden, num_classes)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                taps: Taps = None, features: Taps = None) -> torch.Tensor:
        """``taps`` records the trunk's ``blocks``; ``features`` records
        ``trunk``, its (B, C) fp32 CLS features: the head's input."""
        feats = tap(features, "trunk", self.vit(x, taps=taps))
        if self.training and self.drop_rate > 0.0:
            if generator is None:
                raise ValueError("ViTClassifier in train mode draws its "
                                 "dropout from an explicit generator")
            feats = dropout(feats, self.drop_rate, generator)
        return self.head(feats.float())


# ------------------------------------------------------- int8 converters
#
# They work on a trunk's fp32 state_dict (keys without the trunk prefix,
# e.g. ``blocks.0.attn.qkv.weight``) and return new dicts: the fp32
# original is left as it is.  Tensors stay on their device, so a trunk on
# the card is calibrated and quantised on the card.

_DENSES = ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2")

StateDict = Dict[str, torch.Tensor]


def _block_ids(trunk: Mapping[str, torch.Tensor]) -> Sequence[int]:
    return sorted({int(k.split(".")[1]) for k in trunk
                   if k.startswith("blocks.")})


def vit_config_from_params(trunk: Mapping[str, torch.Tensor],
                           num_heads: Optional[int] = None) -> Dict[str, int]:
    """Derive the ViT architecture from a trunk state_dict so calibration
    and conversion never assume ViT-B/16: ``hidden_dim`` and
    ``patch_size`` from the patch-embedding conv, ``depth`` from the
    ``blocks.{i}``, ``mlp_ratio`` from fc1, and (the port's ViT fixes its
    token count; JAX infers it from the input) ``image_size`` from the
    position embedding.  ``num_heads`` is not recoverable from shapes —
    defaults to hidden_dim // 64 (the universal ViT head size) unless
    given."""
    hidden, cin, patch, patch_w = trunk["patch_embed.proj.weight"].shape
    if cin != 3 or patch != patch_w:
        raise ValueError(f"patch_embed input dim {cin * patch * patch_w} "
                         "is not p*p*3")
    ids = _block_ids(trunk)
    if not ids:
        raise ValueError("no blocks.N entries in the ViT trunk state_dict")
    mlp_hidden = trunk[f"blocks.{ids[0]}.mlp.fc1.weight"].shape[0]
    grid = round((trunk["pos_embed"].shape[1] - 1) ** 0.5)
    return dict(patch_size=patch, hidden_dim=hidden, depth=len(ids),
                num_heads=num_heads or max(hidden // 64, 1),
                mlp_ratio=mlp_hidden // hidden, image_size=grid * patch)


def quantize_encoder_params(trunk: Mapping[str, torch.Tensor],
                            act_absmax: Optional[Mapping] = None
                            ) -> StateDict:
    """fp32 ViT-trunk state_dict -> the int8 state_dict of a
    ``QuantizedEncoderBlock`` trunk (or, with ``act_absmax`` calibration,
    a ``StaticQuantizedEncoderBlock`` one): every block's four Linear
    ``weight``/``bias`` become ``kernel_q8`` int8 (in, out), ``scale`` fp32
    (per output channel) and ``bias``.  Run ONCE at load time.

    ``act_absmax``: :func:`calibrate_vit_absmax`'s (depth,) absmax per
    calibration point.  When given, the act scale a = max(absmax, 1e-6) /
    127 of each layer's input is folded into its weight scale and each
    block gets ``act_scales`` = [ln1, attn, ln2, gelu] — the static
    kernels then skip all dynamic absmax work."""
    ids = _block_ids(trunk)
    if not ids:
        raise ValueError("no blocks.N entries in the ViT trunk state_dict")
    acts = None if act_absmax is None else {
        p: over_qmax(torch.clamp_min(act_absmax[p], 1e-6))
        for p in CALIBRATION_POINTS}
    out = dict(trunk)
    for i in ids:
        for dense, point in zip(_DENSES, CALIBRATION_POINTS):
            base = f"blocks.{i}.{dense}"
            kernel_q8, scale = quantize_weight(out.pop(f"{base}.weight").t())
            if acts is not None:
                scale = scale * acts[point][i]
            out[f"{base}.kernel_q8"] = kernel_q8
            out[f"{base}.scale"] = scale
        if acts is not None:
            out[f"blocks.{i}.act_scales"] = torch.stack(
                [acts[p][i] for p in CALIBRATION_POINTS])
    return out


def calibrate_vit_absmax(trunk: Mapping[str, torch.Tensor],
                         batches: Iterable[torch.Tensor],
                         dtype: Union[str, torch.dtype] = torch.float32,
                         num_heads: Optional[int] = None) -> StateDict:
    """Run NORMALIZED image batches (B, H, W, 3) through the float trunk
    — ``ViT(block_impl="flax", attention_impl="xla")`` on the trunk's
    device, with a calibration record, as the JAX package does — and
    return the running max of each calibration point, (depth,) fp32 each,
    which :func:`quantize_encoder_params` consumes as ``act_absmax``.  The
    architecture is derived from ``trunk`` (any depth/width/patch size)."""
    with torch.device("meta"):
        vit = ViT(dtype=dtype, block_impl="flax", attention_impl="xla",
                  **vit_config_from_params(trunk, num_heads))
    vit.to_empty(device=trunk["pos_embed"].device)
    vit.load_state_dict(trunk, strict=True)
    merged = None
    for x in batches:
        record: Calibration = {pt: [] for pt in CALIBRATION_POINTS}
        with torch.no_grad():
            vit(x, calibration=record)
        cal = {pt: torch.stack(v) for pt, v in record.items()}
        merged = cal if merged is None else {
            pt: torch.maximum(merged[pt], cal[pt]) for pt in cal}
    if merged is None:
        # an empty (or exhausted) iterable would otherwise build the
        # DYNAMIC tree when static calibration was requested
        raise ValueError(
            "calibrate_vit_absmax got zero calibration batches "
            "(empty or exhausted iterable)")
    return merged


def quantize_variables(state_dict: Mapping[str, torch.Tensor],
                       trunk_prefixes: Sequence[str] = ("vit.",
                                                        "thermal_branch."),
                       calib_batches: Optional[Iterable[torch.Tensor]] = None,
                       dtype: Union[str, torch.dtype] = torch.float32
                       ) -> StateDict:
    """Quantize every ViT trunk of a model's state_dict for the int8
    serving path (trunks under ``vit.`` in ``thermal_only``,
    ``thermal_branch.`` in ``multimodal``).  Returns a new state_dict; the
    fp32 original is untouched.

    Without ``calib_batches``: dynamic per-row activation quantization
    (``block_impl="fused_q8"``).  With ``calib_batches`` (normalized image
    batches): static calibrated activation scales (``block_impl=
    "fused_q8s"`` — no absmax work in the kernels; the calibration takes
    the head count :func:`vit_config_from_params` defaults to)."""
    batches = None if calib_batches is None else list(calib_batches)
    new = dict(state_dict)
    for prefix in trunk_prefixes:
        trunk = {k[len(prefix):]: v for k, v in state_dict.items()
                 if k.startswith(prefix)}
        if not _block_ids(trunk):
            continue
        absmax = (None if batches is None
                  else calibrate_vit_absmax(trunk, batches, dtype))
        for k in trunk:
            del new[prefix + k]
        new.update((prefix + k, v) for k, v in
                   quantize_encoder_params(trunk, absmax).items())
    return new
