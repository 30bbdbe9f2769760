"""JAX -> port weight bridge: the inverse of
``dfu_multimodal_tpu/tools/convert_torch.py``.

:func:`variables_to_state_dict` takes a JAX variables tree of numpy
arrays (``params`` and ``batch_stats`` as ``zoo.init_model`` or a
checkpoint restore produce them) and returns the port model's
``state_dict``:

- the scanned ViT ``encoder`` leaves (depth, ...) are un-stacked into
  ``blocks.{i}``; a token-merge tree (``models/vit.py::
  split_encoder_variables``: ``encoder`` [:merge_at] and ``encoder2``
  [merge_at:]) is joined along depth, since the port's token-merged ViT
  keeps the plain model's keys (:func:`vit_params` writes either tree
  back, float or int8);
- conv kernels HWIO -> OIHW, dense kernels (in, out) -> (out, in);
- an int8 dense (``models/vit.py::quantize_variables`` trees) keeps its
  ``kernel_q8`` int8 (in, out) as it is, beside its ``scale`` and
  ``bias``, and a static block's ``act_scales`` (4,) comes along;
- the patch-embed dense kernel (P·P·C, O) -> the conv (O, C, P, P);
- BatchNorm ``scale``/``bias`` -> ``weight``/``bias``, ``batch_stats``
  ``mean``/``var`` -> ``running_mean``/``running_var``;
- a ResNet trunk's bottlenecks (``conv1..3``, ``bn1..3``, ``down_*``)
  or the ResNet-18 student's basic blocks (``conv1``, ``bn1``, ``conv2``,
  ``bn2``, ``proj_*``) map to torchvision's keys
  (:func:`resnet_state_dict`; :func:`resnet_params` goes back);
- an int8 ResNet trunk (``models/resnet_q8.py::quantize_rgb_trunks``
  trees: ``stem_kernel``, ``stem_bias`` and ``_QConv`` scopes, the
  student's too) maps to the port's ``models/resnet_q8.py`` keys
  (:func:`int8_resnet_state_dict`; :func:`int8_resnet_params` goes back).

Models: ``multimodal`` (``rgb_branch`` / ``thermal_branch`` / ``fusion``),
``thermal_only`` (the JAX trunk scope ``ViT_0`` -> ``vit.``, the ``head``
Dense -> ``head``), ``rgb_only`` (``ResNet_0`` params and batch stats
-> ``resnet.``, ``head`` -> ``head``; the students ``resnet18_rgb`` /
``resnet18_thermal`` likewise), and the smoke models ``tiny_rgb``
/ ``tiny_thermal`` (``conv0``, ``bn0``, ``conv1``, ``bn1``, ``head`` at
the top level) and ``tiny_fusion`` (those layers under ``rgb_branch`` /
``thermal_branch``, and ``head``); the legacy lineage's
``efficientnet_rgb`` / ``efficientnet_thermal`` (torchvision's
``efficientnet_b0`` keys under ``encoder.``) and ``legacy_gated_fusion``
/ ``legacy_rgb_resnet_fusion`` (:func:`legacy_variables` goes back); and
``"pretrain"``, a pretraining checkpoint's tree
(:func:`pretrain_state_dict`).  A tree without ``batch_stats``
(the optimizer's moments) gives the parameters' keys only.

:func:`adamw_state_from_optax` carries an ``optax.adamw`` chain state
(its moments through the same key map) into ``train.optim.AdamW``, and
:func:`port_payload` a whole JAX checkpoint (``utils/checkpoint.py``'s
msgpack payload) into the port's checkpoint keys.

No jax import: a leaf is a numpy array or a torch tensor (the port's
msgpack reader gives tensors, which hold bfloat16 where numpy cannot).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, dtype=np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(_f32(a), order="C"))


def _conv(kernel) -> torch.Tensor:
    """HWIO -> OIHW."""
    return _t(_f32(kernel).transpose(3, 2, 0, 1))


def _dense(kernel) -> torch.Tensor:
    """(in, out) -> (out, in)."""
    return _t(_f32(kernel).T)


def _vit_dense(out: StateDict, key: str, params: Mapping) -> None:
    """A ViT block's dense layer: fp32 ``weight`` (out, in), or the int8
    ``kernel_q8`` in the kernels' own (in, out) layout plus ``scale``."""
    if "kernel_q8" in params:
        out[f"{key}.kernel_q8"] = torch.from_numpy(
            np.array(params["kernel_q8"], dtype=np.int8, order="C"))
        out[f"{key}.scale"] = _t(params["scale"])
    else:
        out[f"{key}.weight"] = _dense(params["kernel"])
    out[f"{key}.bias"] = _t(params["bias"])


def _batchnorm(out: StateDict, key: str, params: Mapping,
               stats: Optional[Mapping]) -> None:
    out[f"{key}.weight"] = _t(params["scale"])
    out[f"{key}.bias"] = _t(params["bias"])
    if stats is None:
        return
    out[f"{key}.running_mean"] = _t(stats["mean"])
    out[f"{key}.running_var"] = _t(stats["var"])
    out[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _block_convs(block: Mapping) -> tuple:
    """(conv count, shortcut scope prefix) of a JAX ResNet block: a
    bottleneck (conv1..3, ``down_``) or a basic block (conv1..2,
    ``proj_``)."""
    return (3, "down_") if "conv3" in block else (2, "proj_")


def resnet_state_dict(params: Mapping, stats: Optional[Mapping],
                      prefix: str = "") -> StateDict:
    """JAX ResNet trunk subtree (bottleneck or basic blocks) ->
    torchvision-layout keys (no running statistics when ``stats`` is
    None)."""
    out: StateDict = {}
    out[f"{prefix}conv1.weight"] = _conv(params["stem_conv"]["kernel"])
    _batchnorm(out, f"{prefix}bn1", params["stem_bn"],
               None if stats is None else stats["stem_bn"])
    for scope in sorted(k for k in params if k.startswith("stage")):
        stage, block = scope[len("stage"):].split("_block")
        base = f"{prefix}layer{stage}.{block}"
        p, s = params[scope], None if stats is None else stats[scope]
        convs, short = _block_convs(p)
        for i in range(1, convs + 1):
            out[f"{base}.conv{i}.weight"] = _conv(p[f"conv{i}"]["kernel"])
            _batchnorm(out, f"{base}.bn{i}", p[f"bn{i}"],
                       None if s is None else s[f"bn{i}"])
        if f"{short}conv" in p:
            out[f"{base}.downsample.0.weight"] = _conv(
                p[f"{short}conv"]["kernel"])
            _batchnorm(out, f"{base}.downsample.1", p[f"{short}bn"],
                       None if s is None else s[f"{short}bn"])
    return out


def resnet_params(state_dict: Mapping[str, torch.Tensor],
                  prefix: str = "") -> tuple:
    """The inverse of :func:`resnet_state_dict`: the port's float ResNet
    trunk keys under ``prefix`` -> the JAX trunk's (params, batch_stats)
    trees of numpy arrays (OIHW -> HWIO; bottleneck or basic blocks, as
    the keys show; no batch_stats entries without running statistics)."""
    sub = {k[len(prefix):]: v.detach().cpu() for k, v in state_dict.items()
           if k.startswith(prefix)}

    def conv(name):
        return {"kernel": _f32(sub[f"{name}.weight"]).transpose(
            2, 3, 1, 0).copy()}

    def bn(p, st, key, name):
        p[key] = {"scale": _f32(sub[f"{name}.weight"]),
                  "bias": _f32(sub[f"{name}.bias"])}
        if f"{name}.running_mean" in sub:
            st[key] = {"mean": _f32(sub[f"{name}.running_mean"]),
                       "var": _f32(sub[f"{name}.running_var"])}

    params: Dict[str, Any] = {"stem_conv": conv("conv1")}
    stats: Dict[str, Any] = {}
    bn(params, stats, "stem_bn", "bn1")
    basic = "layer1.0.conv3.weight" not in sub
    short = "proj_" if basic else "down_"
    for layer, block in sorted({tuple(k.split(".")[:2]) for k in sub
                                if k.startswith("layer")}):
        scope, base = f"stage{layer[len('layer'):]}_block{block}", \
            f"{layer}.{block}"
        p, st = params.setdefault(scope, {}), stats.setdefault(scope, {})
        for i in range(1, 3 if basic else 4):
            p[f"conv{i}"] = conv(f"{base}.conv{i}")
            bn(p, st, f"bn{i}", f"{base}.bn{i}")
        if f"{base}.downsample.0.weight" in sub:
            p[f"{short}conv"] = conv(f"{base}.downsample.0")
            bn(p, st, f"{short}bn", f"{base}.downsample.1")
    return params, {k: v for k, v in stats.items() if v}


_QCONV_KEYS = ("kernel_q8", "scale", "bias", "act_scale")


def int8_resnet_state_dict(params: Mapping, prefix: str = "") -> StateDict:
    """A JAX ``Int8ResNet`` trunk subtree (``models/resnet_q8.py::
    quantize_rgb_trunks``'s) -> the port's ``models/resnet_q8.py`` keys:
    ``stem_kernel`` HWIO -> OIHW, each ``_QConv`` (``kernel_q8`` int8
    HWIO as it is, ``scale``, ``bias``, ``act_scale``) under
    ``layer{s}.{i}.{conv1,conv2,conv3,down}`` (a basic block's
    ``{conv1,conv2,proj}``)."""
    out: StateDict = {f"{prefix}stem_kernel": _conv(params["stem_kernel"]),
                      f"{prefix}stem_bias": _t(params["stem_bias"])}
    for scope in sorted(k for k in params if k.startswith("stage")):
        stage, block = scope[len("stage"):].split("_block")
        base = f"{prefix}layer{stage}.{block}"
        for conv, p in params[scope].items():
            out[f"{base}.{conv}.kernel_q8"] = torch.from_numpy(
                np.array(p["kernel_q8"], dtype=np.int8, order="C"))
            for key in _QCONV_KEYS[1:]:
                out[f"{base}.{conv}.{key}"] = _t(p[key])
    return out


def int8_resnet_params(state_dict: Mapping[str, torch.Tensor],
                       prefix: str = "") -> Dict[str, Any]:
    """The inverse of :func:`int8_resnet_state_dict`: the port's int8
    trunk keys under ``prefix`` -> a JAX ``Int8ResNet`` param tree of
    numpy arrays (``stem_kernel`` OIHW -> HWIO)."""
    sub = {k[len(prefix):]: v.detach().cpu() for k, v in state_dict.items()
           if k.startswith(prefix)}
    tree: Dict[str, Any] = {
        "stem_kernel": sub["stem_kernel"].float().numpy().transpose(
            2, 3, 1, 0).copy(),
        "stem_bias": sub["stem_bias"].float().numpy()}
    for key, v in sub.items():
        if not key.startswith("layer"):
            continue
        layer, block, conv, leaf = key.split(".")
        scope = f"stage{layer[len('layer'):]}_block{block}"
        tree.setdefault(scope, {}).setdefault(conv, {})[leaf] = (
            v.numpy() if leaf == "kernel_q8" else v.float().numpy())
    return tree


def _resnet_trunk(params: Mapping, stats: Optional[Mapping],
                  prefix: str) -> StateDict:
    """A float (``stem_conv``) or int8 (``stem_kernel``) ResNet trunk."""
    if "stem_kernel" in params:
        return int8_resnet_state_dict(params, prefix)
    return resnet_state_dict(params, stats, prefix)


def tiny_state_dict(params: Mapping, stats: Optional[Mapping],
                    prefix: str = "") -> StateDict:
    """A JAX TinyCNN / TinyTrunk subtree -> the port's keys (conv biases
    included)."""
    out: StateDict = {}
    for i in (0, 1):
        out[f"{prefix}conv{i}.weight"] = _conv(params[f"conv{i}"]["kernel"])
        out[f"{prefix}conv{i}.bias"] = _t(params[f"conv{i}"]["bias"])
        _batchnorm(out, f"{prefix}bn{i}", params[f"bn{i}"],
                   None if stats is None else stats[f"bn{i}"])
    return out


def vit_state_dict(params: Mapping, prefix: str = "") -> StateDict:
    """JAX ViT trunk subtree (fp32, or int8 from ``quantize_variables``)
    -> timm-layout keys."""
    out: StateDict = {}
    out[f"{prefix}cls_token"] = _t(params["cls_token"])
    out[f"{prefix}pos_embed"] = _t(params["pos_embed"])
    kernel = _f32(params["patch_embed"]["kernel"])          # (P·P·C, O)
    patch = int(round((kernel.shape[0] / 3) ** 0.5))
    out[f"{prefix}patch_embed.proj.weight"] = _t(
        kernel.reshape(patch, patch, 3, -1).transpose(3, 2, 0, 1))
    out[f"{prefix}patch_embed.proj.bias"] = _t(params["patch_embed"]["bias"])

    # the scanned (depth, ...) stack, or a token-merge tree's two stacks
    blocks = [_index_tree(enc, i)
              for enc in (params[s] for s in ("encoder", "encoder2")
                          if s in params)
              for i in range(enc["norm1"]["scale"].shape[0])]
    for i, blk in enumerate(blocks):
        _vit_block(out, f"{prefix}blocks.{i}", blk)
    _layernorm(out, f"{prefix}norm", params["norm"])
    return out


def _layernorm(out: StateDict, key: str, params: Mapping) -> None:
    out[f"{key}.weight"] = _t(params["scale"])
    out[f"{key}.bias"] = _t(params["bias"])


def _vit_block(out: StateDict, base: str, blk: Mapping) -> None:
    """One encoder block's subtree (an unstacked slice of the scanned
    ``encoder``, or a flax ``EncoderBlock`` scope) -> timm's keys."""
    for norm in ("norm1", "norm2"):
        _layernorm(out, f"{base}.{norm}", blk[norm])
    for ours, theirs in (("attn.qkv", blk["attn"]["qkv"]),
                         ("attn.proj", blk["attn"]["proj"]),
                         ("mlp.fc1", blk["mlp_fc1"]),
                         ("mlp.fc2", blk["mlp_fc2"])):
        _vit_dense(out, f"{base}.{ours}", theirs)
    if "act_scales" in blk:
        out[f"{base}.act_scales"] = _t(blk["act_scales"])


def _index_tree(tree: Mapping, i: int) -> Dict[str, Any]:
    return {k: (_index_tree(v, i) if isinstance(v, Mapping) else v[i])
            for k, v in tree.items()}


def _stack_trees(trees) -> Dict[str, Any]:
    return {k: (_stack_trees([t[k] for t in trees])
                if isinstance(trees[0][k], Mapping)
                else np.stack([t[k] for t in trees]))
            for k in trees[0]}


def _vit_dense_params(sub: Mapping[str, torch.Tensor], key: str) -> Dict:
    if f"{key}.kernel_q8" in sub:
        return {"kernel_q8": sub[f"{key}.kernel_q8"].numpy(),
                "scale": _f32(sub[f"{key}.scale"]),
                "bias": _f32(sub[f"{key}.bias"])}
    return {"kernel": _f32(sub[f"{key}.weight"]).T.copy(),
            "bias": _f32(sub[f"{key}.bias"])}


def vit_params(state_dict: Mapping[str, torch.Tensor], prefix: str = "",
               merge_at: Optional[int] = None) -> Dict[str, Any]:
    """The inverse of :func:`vit_state_dict`: the port's ViT trunk keys
    under ``prefix`` (fp32, or int8 from ``quantize_variables``) -> a JAX
    ViT trunk param tree of numpy arrays, the blocks stacked as the
    scanned ``encoder`` (depth, ...), or with ``merge_at`` split as
    ``split_encoder_variables`` splits it: ``encoder`` [:merge_at] and
    ``encoder2`` [merge_at:], the tree of a ``token_merge`` model."""
    sub = {k[len(prefix):]: v.detach().cpu() for k, v in state_dict.items()
           if k.startswith(prefix)}
    weight = _f32(sub["patch_embed.proj.weight"])          # (O, C, P, P)
    tree: Dict[str, Any] = {
        "cls_token": _f32(sub["cls_token"]),
        "pos_embed": _f32(sub["pos_embed"]),
        "patch_embed": {
            "kernel": weight.transpose(2, 3, 1, 0).reshape(
                -1, weight.shape[0]).copy(),
            "bias": _f32(sub["patch_embed.proj.bias"])},
        "norm": {"scale": _f32(sub["norm.weight"]),
                 "bias": _f32(sub["norm.bias"])}}
    ids = sorted({int(k.split(".")[1]) for k in sub
                  if k.startswith("blocks.")})
    blocks = []
    for i in ids:
        base = f"blocks.{i}"
        blk = {norm: {"scale": _f32(sub[f"{base}.{norm}.weight"]),
                      "bias": _f32(sub[f"{base}.{norm}.bias"])}
               for norm in ("norm1", "norm2")}
        blk["attn"] = {d: _vit_dense_params(sub, f"{base}.attn.{d}")
                       for d in ("qkv", "proj")}
        for ours, theirs in (("mlp.fc1", "mlp_fc1"), ("mlp.fc2", "mlp_fc2")):
            blk[theirs] = _vit_dense_params(sub, f"{base}.{ours}")
        if f"{base}.act_scales" in sub:
            blk["act_scales"] = _f32(sub[f"{base}.act_scales"])
        blocks.append(blk)
    if merge_at is None:
        tree["encoder"] = _stack_trees(blocks)
    else:
        if not 0 < merge_at < len(blocks):
            raise ValueError(f"merge_at={merge_at} outside "
                             f"(0, {len(blocks)})")
        tree["encoder"] = _stack_trees(blocks[:merge_at])
        tree["encoder2"] = _stack_trees(blocks[merge_at:])
    return tree


def _linear(out: StateDict, key: str, params: Mapping) -> None:
    """A flax Dense (kernel (in, out), bias when it has one)."""
    out[f"{key}.weight"] = _dense(params["kernel"])
    if "bias" in params:
        out[f"{key}.bias"] = _t(params["bias"])


def _linear_params(sub: Mapping[str, torch.Tensor], key: str) -> Dict:
    p = {"kernel": _f32(sub[f"{key}.weight"]).T.copy()}
    if f"{key}.bias" in sub:
        p["bias"] = _f32(sub[f"{key}.bias"])
    return p


def efficientnet_state_dict(params: Mapping, stats: Optional[Mapping],
                            prefix: str = "") -> StateDict:
    """A JAX ``EfficientNetB0`` subtree -> torchvision's
    ``efficientnet_b0`` keys (``models/efficientnet.py``): ``stem_*`` ->
    ``features.0``, ``stage{s}_block{i}`` -> ``features.{s+1}.{i}.block``
    (``expand_*``, ``dw_*``, ``se`` ``reduce`` / ``expand`` -> ``fc1`` /
    ``fc2``, ``project_*``), ``head_*`` -> the last ``features`` entry.
    Depthwise kernels (k, k, 1, C) become (C, 1, k, k) like any HWIO."""
    out: StateDict = {}

    def pair(key, p, s, conv, bn):
        out[f"{key}.0.weight"] = _conv(p[conv]["kernel"])
        _batchnorm(out, f"{key}.1", p[bn], None if s is None else s[bn])

    pair(f"{prefix}features.0", params, stats, "stem_conv", "stem_bn")
    stages = 0
    for scope in sorted(k for k in params if k.startswith("stage")):
        si, bi = (int(v) for v in scope[len("stage"):].split("_block"))
        stages = max(stages, si + 1)
        p, st = params[scope], None if stats is None else stats[scope]
        base = f"{prefix}features.{si + 1}.{bi}.block"
        j = int("expand_conv" in p)
        if j:
            pair(f"{base}.0", p, st, "expand_conv", "expand_bn")
        pair(f"{base}.{j}", p, st, "dw_conv", "dw_bn")
        for ours, theirs in (("fc1", "reduce"), ("fc2", "expand")):
            out[f"{base}.{j + 1}.{ours}.weight"] = _conv(
                p["se"][theirs]["kernel"])
            out[f"{base}.{j + 1}.{ours}.bias"] = _t(p["se"][theirs]["bias"])
        pair(f"{base}.{j + 2}", p, st, "project_conv", "project_bn")
    pair(f"{prefix}features.{stages + 1}", params, stats, "head_conv",
         "head_bn")
    return out


def efficientnet_params(state_dict: Mapping[str, torch.Tensor],
                        prefix: str = "") -> tuple:
    """The inverse of :func:`efficientnet_state_dict`: (params,
    batch_stats) trees of numpy arrays (no batch_stats entries without
    running statistics)."""
    sub = {k[len(prefix):]: v.detach().cpu() for k, v in state_dict.items()
           if k.startswith(prefix)}

    def pair(p, st, key, conv, bn):
        p[conv] = {"kernel": _f32(sub[f"{key}.0.weight"]).transpose(
            2, 3, 1, 0).copy()}
        p[bn] = {"scale": _f32(sub[f"{key}.1.weight"]),
                 "bias": _f32(sub[f"{key}.1.bias"])}
        if f"{key}.1.running_mean" in sub:
            st[bn] = {"mean": _f32(sub[f"{key}.1.running_mean"]),
                      "var": _f32(sub[f"{key}.1.running_var"])}

    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    pair(params, stats, "features.0", "stem_conv", "stem_bn")
    blocks = sorted({tuple(int(v) for v in k.split(".")[1:3]) for k in sub
                     if ".block." in k})
    for s, i in blocks:
        scope, base = f"stage{s - 1}_block{i}", f"features.{s}.{i}.block"
        p, st = params.setdefault(scope, {}), stats.setdefault(scope, {})
        j = int(f"{base}.3.0.weight" in sub)
        if j:
            pair(p, st, f"{base}.0", "expand_conv", "expand_bn")
        pair(p, st, f"{base}.{j}", "dw_conv", "dw_bn")
        p["se"] = {theirs: {
            "kernel": _f32(sub[f"{base}.{j + 1}.{ours}.weight"]).transpose(
                2, 3, 1, 0).copy(),
            "bias": _f32(sub[f"{base}.{j + 1}.{ours}.bias"])}
            for ours, theirs in (("fc1", "reduce"), ("fc2", "expand"))}
        pair(p, st, f"{base}.{j + 2}", "project_conv", "project_bn")
    pair(params, stats, f"features.{blocks[-1][0] + 1}", "head_conv",
         "head_bn")
    return params, {k: v for k, v in stats.items() if v}


EFFICIENTNETS = ("efficientnet_rgb", "efficientnet_thermal")
LEGACY_FUSIONS = ("legacy_gated_fusion", "legacy_rgb_resnet_fusion")
_LEGACY_DENSES = (("fusion.gate_fc1", ("fusion", "gate_fc1")),
                  ("fusion.gate_fc2", ("fusion", "gate_fc2")),
                  ("cls_fc1", ("cls_fc1",)), ("head", ("head",)))


def _legacy_state_dict(model_name: str, params: Mapping,
                       stats: Optional[Mapping]) -> StateDict:
    """An EfficientNet classifier (trunk scope ``EfficientNetB0_0`` ->
    ``encoder.``) or a legacy fusion classifier (``rgb_encoder`` — an
    EfficientNet, or the ResNet-50 with ``rgb_proj`` —,
    ``thermal_encoder``, ``fusion/gate_fc{1,2}``, ``cls_fc1``, ``head``)."""
    stat = lambda scope: None if stats is None else stats.get(scope)
    if model_name in EFFICIENTNETS:
        out = efficientnet_state_dict(params["EfficientNetB0_0"],
                                      stat("EfficientNetB0_0"), "encoder.")
        _linear(out, "head", params["head"])
        return out
    rgb = (resnet_state_dict if model_name == "legacy_rgb_resnet_fusion"
           else efficientnet_state_dict)
    out = rgb(params["rgb_encoder"], stat("rgb_encoder"), "rgb_encoder.")
    out.update(efficientnet_state_dict(params["thermal_encoder"],
                                       stat("thermal_encoder"),
                                       "thermal_encoder."))
    if "rgb_proj" in params:
        _linear(out, "rgb_proj", params["rgb_proj"])
    for key, path in _LEGACY_DENSES:
        node = params
        for p in path:
            node = node[p]
        _linear(out, key, node)
    return out


def legacy_variables(model_name: str,
                     state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The inverse of the legacy models' bridge: the port's state_dict of
    an EfficientNet or legacy fusion classifier -> the JAX variables
    (``params``, and ``batch_stats`` when the running statistics are
    there) of numpy arrays."""
    sub = {k: v.detach().cpu() for k, v in state_dict.items()}
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    if model_name in EFFICIENTNETS:
        trunks = (("EfficientNetB0_0", "encoder.", efficientnet_params),)
        denses = (("head", ("head",)),)
    elif model_name in LEGACY_FUSIONS:
        rgb = (resnet_params if model_name == "legacy_rgb_resnet_fusion"
               else efficientnet_params)
        trunks = (("rgb_encoder", "rgb_encoder.", rgb),
                  ("thermal_encoder", "thermal_encoder.",
                   efficientnet_params))
        denses = _LEGACY_DENSES + ((("rgb_proj", ("rgb_proj",)),)
                                   if "rgb_proj.weight" in sub else ())
    else:
        raise ValueError(f"{model_name!r} is not a legacy model")
    for scope, prefix, fn in trunks:
        params[scope], st = fn(sub, prefix)
        if st:
            stats[scope] = st
    for key, path in denses:
        node = params
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = _linear_params(sub, key)
    return {"params": params, **({"batch_stats": stats} if stats else {})}


def pretrain_state_dict(params: Mapping,
                        stats: Optional[Mapping]) -> StateDict:
    """A JAX pretraining tree (``train/ssl.py``'s SimCLR or MAE model,
    with the trunk's aliases) -> the port's ``train/ssl.py`` keys:
    ``ResNet_0`` / ``rgb_branch`` -> ``resnet.`` / ``rgb_branch.``,
    ``ViT_0`` / ``thermal_branch`` -> ``vit.`` / ``thermal_branch.``, the
    tiny ``trunk``, ``proj_fc1`` / ``proj_fc2``, and MAE's decoder
    (``dec_embed``, ``mask_token``, ``dec_pos_embed``, ``dec_block{i}``
    -> ``dec_blocks.{i}``, ``dec_norm``, ``dec_pred``).  Scopes absent
    from the tree (an optimizer moment has no aliases) are skipped."""
    stat = lambda scope: None if stats is None else stats.get(scope)
    out: StateDict = {}
    for scope, prefix in (("ResNet_0", "resnet."),
                          ("rgb_branch", "rgb_branch.")):
        if scope in params:
            out.update(resnet_state_dict(params[scope], stat(scope), prefix))
    for scope, prefix in (("ViT_0", "vit."),
                          ("thermal_branch", "thermal_branch.")):
        if scope in params:
            out.update(vit_state_dict(params[scope], prefix))
    if "trunk" in params:
        out.update(tiny_state_dict(params["trunk"], stat("trunk"), "trunk."))
    for dense in ("proj_fc1", "proj_fc2", "dec_embed", "dec_pred"):
        if dense in params:
            _linear(out, dense, params[dense])
    for leaf in ("mask_token", "dec_pos_embed"):
        if leaf in params:
            out[leaf] = _t(params[leaf])
    for scope in sorted(k for k in params if k.startswith("dec_block")):
        _vit_block(out, f"dec_blocks.{scope[len('dec_block'):]}",
                   params[scope])
    if "dec_norm" in params:
        _layernorm(out, "dec_norm", params["dec_norm"])
    return out


def variables_to_state_dict(model_name: str,
                            variables: Mapping) -> StateDict:
    """JAX variables of zoo model ``model_name`` -> the port model's
    state_dict (load with ``load_state_dict(..., strict=True)``).  Without
    ``batch_stats`` only the parameters' keys come out.  ``"pretrain"``
    names a pretraining tree of any method or trunk
    (:func:`pretrain_state_dict`)."""
    params = variables["params"]
    stats = variables.get("batch_stats")
    if model_name == "pretrain":
        return pretrain_state_dict(params, stats)
    if model_name in EFFICIENTNETS + LEGACY_FUSIONS:
        return _legacy_state_dict(model_name, params, stats)
    if model_name.startswith("tiny_"):
        if model_name == "tiny_fusion":
            out = {}
            for branch in ("rgb_branch", "thermal_branch"):
                out.update(tiny_state_dict(
                    params[branch], None if stats is None else stats[branch],
                    f"{branch}."))
        else:
            out = tiny_state_dict(params, stats)
        out["head.weight"] = _dense(params["head"]["kernel"])
        out["head.bias"] = _t(params["head"]["bias"])
        return out
    if model_name in ("thermal_only", "rgb_only", "resnet18_rgb",
                      "resnet18_thermal"):
        if model_name == "thermal_only":
            out = vit_state_dict(params["ViT_0"], "vit.")
        else:
            out = _resnet_trunk(
                params["ResNet_0"],
                None if stats is None else stats.get("ResNet_0"),
                "resnet.")
        out["head.weight"] = _dense(params["head"]["kernel"])
        out["head.bias"] = _t(params["head"]["bias"])
        return out
    if model_name != "multimodal":
        raise ValueError(f"no bridge for model {model_name!r} yet")
    out = _resnet_trunk(params["rgb_branch"],
                        None if stats is None else stats.get("rgb_branch"),
                        "rgb_branch.")
    out.update(vit_state_dict(params["thermal_branch"], "thermal_branch."))
    # fusion/fc{1,2,3} -> the Sequential's Linear layers at 0, 3, 6
    for idx, name in (("0", "fc1"), ("3", "fc2"), ("6", "fc3")):
        out[f"fusion.{idx}.weight"] = _dense(params["fusion"][name]["kernel"])
        out[f"fusion.{idx}.bias"] = _t(params["fusion"][name]["bias"])
    return out


def _adam_state(opt_state: Mapping) -> Mapping:
    """The ``ScaleByAdamState`` (count, mu, nu) of an adamw chain state in
    flax's state-dict form: element "0" of the chain, whose other elements
    are the decay's empty state and the learning rate's (empty, or a
    schedule's own count)."""
    adam = opt_state["0"] if "0" in opt_state else opt_state
    if not {"count", "mu", "nu"} <= set(adam):
        raise KeyError("not an optax.adamw state: its first element has "
                       f"{sorted(adam)}")
    return adam


def adamw_state_from_optax(model_name: str, opt_state: Mapping) -> Dict:
    """An ``optax.adamw`` state (flax ``to_state_dict`` form, as a JAX
    checkpoint holds it) -> ``AdamW.load_state_dict``'s dict: the count,
    and mu (fp32 here; the optimizer casts it to its own dtype) and nu
    keyed as the port model's parameters."""
    adam = _adam_state(opt_state)
    count = adam["count"]
    return {"count": int(count.item() if hasattr(count, "item") else count),
            "mu": variables_to_state_dict(model_name, {"params": adam["mu"]}),
            "nu": variables_to_state_dict(model_name, {"params": adam["nu"]})}


def port_payload(model_name: str, payload: Mapping) -> Dict:
    """A JAX checkpoint payload (``model_state``, ``opt_state`` and, from
    an EMA run, ``raw_params``) -> the port's checkpoint keys
    (``model_state_dict``, ``optimizer_state_dict``, ``raw_params``)."""
    out = {"model_state_dict": variables_to_state_dict(
        model_name, payload["model_state"])}
    if payload.get("opt_state"):
        out["optimizer_state_dict"] = adamw_state_from_optax(
            model_name, payload["opt_state"])
    if payload.get("raw_params"):
        out["raw_params"] = variables_to_state_dict(
            model_name, {"params": payload["raw_params"]})
    return out
