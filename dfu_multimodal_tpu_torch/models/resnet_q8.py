"""Int8 ResNet-50 and ResNet-18 serving trunks on the card's int8
convolution (counterpart of ``dfu_multimodal_tpu/models/resnet_q8.py``).

Scheme (post-training quantisation, the JAX package's):

- weights: BatchNorm folded, then per-output-channel symmetric int8
  (:func:`quantize_conv_weight`), once at load
  (:func:`quantize_resnet_params`);
- activations: per-tensor symmetric int8 with static scales from a
  calibration pass (:func:`calibrate_resnet`: the float trunk records the
  absmax of every conv input, ``models/resnet.py``), act_scale = absmax /
  127;
- every stage conv runs on ``ops/conv_q8.py`` (int8 × int8 → int32, then
  float(acc)·(act_scale·scale) + bias in fp32, cast to the compute dtype);
  the projection shortcut reads the block input with conv1's scale, so the
  block input is quantised once for both (bottleneck and basic blocks);
- the stem stays in the compute dtype: a convolution of the bf16-valued
  input and kernel whose products accumulate in fp32 (an fp32 conv on the
  rounded operands; exact products, since bf16 values fit fp32 and TF32),
  then the fp32 bias, ReLU, the cast, and the max pool.

Activations run NHWC contiguous; the taps ``stage1``..``stage4`` record
each stage's (B, H, W, C) output, as the float trunk's.  Serving only:
no backward.  Keys: ``stem_kernel`` (64, 3, 7, 7) OIHW fp32 (the folded
stem), ``stem_bias``, and per conv ``layer{s}.{i}.{conv1,conv2,conv3,
down}.{kernel_q8, scale, bias, act_scale}`` (the ResNet-18 student's
basic blocks: ``{conv1,conv2,proj}``) with ``kernel_q8`` HWIO int8, the
JAX layout.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from dfu_multimodal_tpu_torch.models.common import Taps, canonical_dtype
from dfu_multimodal_tpu_torch.ops.conv_q8 import conv_q8, quantize_act_q8
from dfu_multimodal_tpu_torch.ops.vit_block_q8 import Q_MAX, over_qmax

StateDict = Dict[str, torch.Tensor]
BN_EPS = 1e-5


def quantize_conv_weight(w: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of an HWIO kernel: (int8 HWIO,
    fp32 (Cout,) scale), scale = max(absmax over (H, W, I) / 127, 1e-12)."""
    w = w.float()
    s = over_qmax(w.abs().amax(dim=(0, 1, 2))).clamp_min(1e-12)
    q = torch.round(w / s).clamp(-Q_MAX, Q_MAX).to(torch.int8)
    return q.contiguous(), s


class QConv(nn.Module):
    """One int8 conv with a folded-BN bias (the JAX ``_QConv`` tree):
    ``kernel_q8`` HWIO int8, ``scale`` and ``bias`` (Cout,) fp32,
    ``act_scale`` () fp32.  Buffers: nothing to train.

    ``kernel_kmajor`` ((Cout, k·k·Cin) int8, columns (dy, dx, cin)) and
    ``col_scale`` (act_scale·scale, fp32, JAX's rounding) are what the
    kernel reads; non-persistent buffers made once per weight version,
    refreshed by ``load_state_dict``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__()
        self.k, self.stride = k, stride
        self.register_buffer("kernel_q8",
                             torch.zeros(k, k, cin, cout, dtype=torch.int8))
        self.register_buffer("scale", torch.ones(cout))
        self.register_buffer("bias", torch.zeros(cout))
        self.register_buffer("act_scale", torch.ones(()))
        self.register_buffer("kernel_kmajor",
                             torch.zeros(cout, k * k * cin, dtype=torch.int8),
                             persistent=False)
        self.register_buffer("col_scale", torch.ones(cout), persistent=False)
        self.register_load_state_dict_post_hook(QConv._refresh)

    @staticmethod
    def _refresh(module: "QConv", incompatible_keys) -> None:
        with torch.no_grad():
            k = module.kernel_q8
            module.kernel_kmajor = k.reshape(-1, k.shape[-1]).t().contiguous()
            module.col_scale = module.act_scale * module.scale

    def forward(self, x: torch.Tensor, relu: bool = False,
                resid: Optional[torch.Tensor] = None,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        return conv_q8(x, self.kernel_kmajor, self.col_scale, self.bias,
                       self.act_scale, self.k, self.stride, relu, resid,
                       dtype)


class Int8Bottleneck(nn.Module):
    """Serving-only int8 bottleneck: relu(conv1), relu(conv2 (stride)),
    conv3 + shortcut then ReLU; the projection ``down`` when the shape
    changes.  Residual math in the compute dtype."""

    expansion = 4

    def __init__(self, cin: int, width: int, stride: int = 1):
        super().__init__()
        cout = 4 * width
        self.conv1 = QConv(cin, width, 1)
        self.conv2 = QConv(width, width, 3, stride)
        self.conv3 = QConv(width, cout, 1)
        self.down = (QConv(cin, cout, 1, stride)
                     if stride != 1 or cin != cout else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C) NHWC contiguous in the compute dtype."""
        shortcut = x
        if self.down is not None:
            # the projection reads the block input with conv1's scale:
            # quantise it once for both
            x = quantize_act_q8(x, self.conv1.act_scale)
            shortcut = self.down(x, dtype=shortcut.dtype)
        y = self.conv1(x, relu=True, dtype=shortcut.dtype)
        y = self.conv2(y, relu=True)
        return self.conv3(y, relu=True, resid=shortcut)


class Int8BasicBlock(nn.Module):
    """Serving-only int8 ResNet-18 block (the JAX ``Int8BasicBlock``):
    relu(conv1 3x3 (stride)), conv2 3x3 + shortcut then ReLU; the 1x1
    projection ``proj`` (stride) when the shape changes, which reads the
    block input with conv1's scale, so the input is quantised once for
    both.  Residual math in the compute dtype."""

    expansion = 1

    def __init__(self, cin: int, width: int, stride: int = 1):
        super().__init__()
        self.conv1 = QConv(cin, width, 3, stride)
        self.conv2 = QConv(width, width, 3)
        self.proj = (QConv(cin, width, 1, stride)
                     if stride != 1 or cin != width else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C) NHWC contiguous in the compute dtype."""
        shortcut = x
        if self.proj is not None:
            x = quantize_act_q8(x, self.conv1.act_scale)
            shortcut = self.proj(x, dtype=shortcut.dtype)
        y = self.conv1(x, relu=True, dtype=shortcut.dtype)
        return self.conv2(y, relu=True, resid=shortcut)


INT8_BLOCK_TYPES = {"bottleneck": Int8Bottleneck, "basic": Int8BasicBlock}


class Int8ResNet(nn.Module):
    """Int8 serving twin of ``models/resnet.py::ResNet`` (bottleneck or
    basic blocks): weights from :func:`quantize_resnet_params`, the same
    tap points, pooled fp32 features (B, widths[-1] x the expansion)."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 widths: Sequence[int] = (64, 128, 256, 512),
                 dtype: Union[str, torch.dtype] = torch.bfloat16,
                 block_type: str = "bottleneck"):
        super().__init__()
        block_cls = INT8_BLOCK_TYPES[block_type]
        self.dtype = canonical_dtype(dtype)
        self.register_buffer("stem_kernel", torch.zeros(64, 3, 7, 7))
        self.register_buffer("stem_bias", torch.zeros(64))
        cin = 64
        for i, (blocks, width) in enumerate(zip(stage_sizes, widths),
                                            start=1):
            layer = []
            for j in range(blocks):
                layer.append(block_cls(cin, width,
                                       2 if i > 1 and j == 0 else 1))
                cin = block_cls.expansion * width
            self.add_module(f"layer{i}", nn.Sequential(*layer))
        self.num_stages = len(stage_sizes)

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> the max-pooled (B, H/4, W/4, 64) NHWC in the
        compute dtype: the conv's products of the dtype-rounded operands
        summed in fp32, + the fp32 bias, ReLU, cast, pool."""
        dt = self.dtype
        xs = x.to(dt).float().permute(0, 3, 1, 2)
        w = self.stem_kernel.to(dt).float()
        y = F.conv2d(xs, w, None, 2, 3)
        y = F.relu(y + self.stem_bias[:, None, None]).to(dt)
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        return y.permute(0, 2, 3, 1).contiguous()

    def forward(self, x: torch.Tensor, taps: Taps = None) -> torch.Tensor:
        """x (B, H, W, 3) NHWC -> (B, C) fp32; ``taps`` records
        ``stage1``..``stage4`` as (B, H, W, C)."""
        x = self.stem(x)
        for i in range(1, self.num_stages + 1):
            for block in getattr(self, f"layer{i}"):
                x = block(x)
            if taps is not None:
                taps[f"stage{i}"] = x
        return x.mean(dim=(1, 2)).float()


def Int8ResNet50(dtype: Union[str, torch.dtype] = torch.bfloat16
                 ) -> Int8ResNet:
    return Int8ResNet((3, 4, 6, 3), (64, 128, 256, 512), dtype=dtype)


def Int8ResNet18(dtype: Union[str, torch.dtype] = torch.bfloat16
                 ) -> Int8ResNet:
    """Int8 twin of the ResNet-18 student."""
    return Int8ResNet((2, 2, 2, 2), (64, 128, 256, 512), dtype=dtype,
                      block_type="basic")


# ------------------------------------------------------------- conversion


def _fold(weight: torch.Tensor, bn: Mapping[str, torch.Tensor],
          eps: float = BN_EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """(OIHW conv weight, BN tensors) -> (folded OIHW, fp32 bias)."""
    s = bn["weight"] * torch.rsqrt(bn["running_var"] + eps)
    return weight * s[:, None, None, None], bn["bias"] - bn["running_mean"] * s


def calibrate_resnet(trunk: nn.Module, batches: Iterable[torch.Tensor]
                     ) -> Dict[str, Dict[str, float]]:
    """Run ``batches`` (normalised NHWC, on the trunk's device) through a
    float ``models/resnet.py::ResNet`` in eval mode with its calibration
    record and return {block: {"conv1_in": absmax, ...}}, the running max
    over the batches (JAX ``calibrate_resnet``'s values, keyed by the JAX
    block scope ``stage{s}_block{i}``)."""
    trunk.eval()
    record: Dict[str, Dict[str, torch.Tensor]] = {}
    with torch.no_grad():
        for x in batches:
            trunk(x, calibration=record)
    return {blk: {k: float(v) for k, v in convs.items()}
            for blk, convs in record.items()}


def _sub(state: Mapping[str, torch.Tensor], prefix: str
         ) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in state.items()
            if k.startswith(prefix)}


def trunk_architecture(trunk: Mapping[str, torch.Tensor]
                       ) -> Tuple[Tuple[int, ...], Tuple[int, ...], str]:
    """(stage_sizes, widths, block_type) of a float ResNet trunk's
    state_dict (the JAX ``_trunk_architecture``)."""
    sizes, widths = [], []
    for s in range(1, 99):
        n = 0
        while f"layer{s}.{n}.conv1.weight" in trunk:
            n += 1
        if n == 0:
            break
        sizes.append(n)
        widths.append(trunk[f"layer{s}.0.conv1.weight"].shape[0])
    if not sizes:
        raise ValueError("not a ResNet state_dict (no layer{s}.{i} keys)")
    block_type = ("bottleneck" if "layer1.0.conv3.weight" in trunk
                  else "basic")
    return tuple(sizes), tuple(widths), block_type


def quantize_resnet_params(trunk: Mapping[str, torch.Tensor],
                           act_absmax: Mapping[str, Mapping[str, float]],
                           stage_sizes: Sequence[int] = (3, 4, 6, 3),
                           block_type: str = "bottleneck") -> StateDict:
    """A float trunk's state_dict (weights and BN buffers) and the
    calibration absmaxes -> the :class:`Int8ResNet` state_dict: BN folded
    in fp32 (eps 1e-5), per-channel int8 kernels (HWIO), act_scale =
    float32(max(absmax, 1e-6) / 127) as JAX's Python arithmetic gives it.
    The projection (``down`` of a bottleneck, ``proj`` of a basic block)
    takes conv1's scale."""
    def bn(key):
        return {n: trunk[f"{key}.{n}"] for n in ("weight", "bias",
                                                  "running_mean",
                                                  "running_var")}

    def absmax_for(block, conv):
        try:
            return max(float(act_absmax[block][f"{conv}_in"]), 1e-6)
        except KeyError:
            raise KeyError(f"no calibration entry for {block}/{conv}") \
                from None

    out: StateDict = {}

    def qconv(base, conv_key, bn_key, block, cal_conv):
        w, b = _fold(trunk[f"{base}.{conv_key}.weight"].float(),
                     bn(f"{base}.{bn_key}"))
        kq, ws = quantize_conv_weight(w.permute(2, 3, 1, 0))
        name = f"{base}.{proj if conv_key == 'downsample.0' else conv_key}"
        out[f"{name}.kernel_q8"] = kq
        out[f"{name}.scale"] = ws
        out[f"{name}.bias"] = b.float().contiguous()
        out[f"{name}.act_scale"] = torch.tensor(
            absmax_for(block, cal_conv) / 127.0, dtype=torch.float32)

    convs, proj = ((1, 2, 3), "down") if block_type == "bottleneck" else (
        (1, 2), "proj")
    stem_w, stem_b = _fold(trunk["conv1.weight"].float(), bn("bn1"))
    out["stem_kernel"], out["stem_bias"] = (stem_w.contiguous(),
                                            stem_b.float().contiguous())
    for s, blocks in enumerate(stage_sizes, start=1):
        for i in range(blocks):
            base, block = f"layer{s}.{i}", f"stage{s}_block{i}"
            for c in convs:
                qconv(base, f"conv{c}", f"bn{c}", block, f"conv{c}")
            if f"{base}.downsample.0.weight" in trunk:
                qconv(base, "downsample.0", "downsample.1", block, "conv1")
    return out


TRUNK_PREFIXES = ("rgb_branch.", "resnet.")


def quantize_rgb_trunks(state_dict: Mapping[str, torch.Tensor],
                        calib_batches: Iterable[torch.Tensor],
                        dtype: Union[str, torch.dtype] = torch.bfloat16,
                        trunk_prefixes: Sequence[str] = TRUNK_PREFIXES
                        ) -> StateDict:
    """Quantise every float ResNet trunk of a model's state_dict for the
    int8 serving path (``rgb_only``'s ``resnet.``, ``multimodal``'s
    ``rgb_branch.``): calibrate the activation scales on ``calib_batches``
    (normalised NHWC batches, on the weights' device) through the float
    trunk in ``dtype`` with cuDNN blocks, fold BN, quantise the weights.
    Returns a new state_dict with the trunk's keys replaced by the
    :class:`Int8ResNet` keys (its BN buffers dropped); the original is
    untouched.  The architecture (ResNet-50 or the ResNet-18 student)
    comes from the state_dict's keys."""
    from dfu_multimodal_tpu_torch.models.resnet import ResNet

    batches = list(calib_batches)
    new = dict(state_dict)
    found = False
    for prefix in trunk_prefixes:
        trunk = _sub(state_dict, prefix)
        if "conv1.weight" not in trunk or "layer1.0.conv1.weight" not in trunk:
            continue
        found = True
        sizes, widths, block_type = trunk_architecture(trunk)
        device = trunk["conv1.weight"].device
        calib = ResNet(sizes, widths, dtype=dtype, block_impl="flax",
                       block_type=block_type).to(device)
        calib.load_state_dict(trunk, strict=True)
        absmax = calibrate_resnet(calib, batches)
        for k in trunk:
            del new[prefix + k]
        new.update((prefix + k, v) for k, v in quantize_resnet_params(
            trunk, absmax, sizes, block_type).items())
    if not found:
        raise ValueError(f"no ResNet trunk found under {trunk_prefixes}")
    return new
