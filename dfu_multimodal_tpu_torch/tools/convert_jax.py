"""JAX -> port weight bridge: the inverse of
``dfu_multimodal_tpu/tools/convert_torch.py``.

:func:`variables_to_state_dict` takes a JAX variables tree of numpy
arrays (``params`` and ``batch_stats`` as ``zoo.init_model`` or a
checkpoint restore produce them) and returns the port model's
``state_dict``:

- the scanned ViT ``encoder`` leaves (depth, ...) are un-stacked into
  ``blocks.{i}``;
- conv kernels HWIO -> OIHW, dense kernels (in, out) -> (out, in);
- an int8 dense (``models/vit.py::quantize_variables`` trees) keeps its
  ``kernel_q8`` int8 (in, out) as it is, beside its ``scale`` and
  ``bias``, and a static block's ``act_scales`` (4,) comes along;
- the patch-embed dense kernel (P·P·C, O) -> the conv (O, C, P, P);
- BatchNorm ``scale``/``bias`` -> ``weight``/``bias``, ``batch_stats``
  ``mean``/``var`` -> ``running_mean``/``running_var``.

Models: ``multimodal`` (``rgb_branch`` / ``thermal_branch`` / ``fusion``),
``thermal_only`` (the JAX trunk scope ``ViT_0`` -> ``vit.``, the ``head``
Dense -> ``head``), ``rgb_only`` (``ResNet_0`` params and batch stats
-> ``resnet.``, ``head`` -> ``head``), and the smoke models ``tiny_rgb``
/ ``tiny_thermal`` (``conv0``, ``bn0``, ``conv1``, ``bn1``, ``head`` at
the top level) and ``tiny_fusion`` (those layers under ``rgb_branch`` /
``thermal_branch``, and ``head``).  A tree without ``batch_stats``
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


def resnet_state_dict(params: Mapping, stats: Optional[Mapping],
                      prefix: str = "") -> StateDict:
    """JAX ResNet trunk subtree -> torchvision-layout keys (no running
    statistics when ``stats`` is None)."""
    out: StateDict = {}
    out[f"{prefix}conv1.weight"] = _conv(params["stem_conv"]["kernel"])
    _batchnorm(out, f"{prefix}bn1", params["stem_bn"],
               None if stats is None else stats["stem_bn"])
    for scope in sorted(k for k in params if k.startswith("stage")):
        stage, block = scope[len("stage"):].split("_block")
        base = f"{prefix}layer{stage}.{block}"
        p, s = params[scope], None if stats is None else stats[scope]
        for i in (1, 2, 3):
            out[f"{base}.conv{i}.weight"] = _conv(p[f"conv{i}"]["kernel"])
            _batchnorm(out, f"{base}.bn{i}", p[f"bn{i}"],
                       None if s is None else s[f"bn{i}"])
        if "down_conv" in p:
            out[f"{base}.downsample.0.weight"] = _conv(
                p["down_conv"]["kernel"])
            _batchnorm(out, f"{base}.downsample.1", p["down_bn"],
                       None if s is None else s["down_bn"])
    return out


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

    enc = params["encoder"]                        # scanned (depth, ...) stack
    depth = enc["norm1"]["scale"].shape[0]
    for i in range(depth):
        blk = _index_tree(enc, i)
        base = f"{prefix}blocks.{i}"
        for norm in ("norm1", "norm2"):
            out[f"{base}.{norm}.weight"] = _t(blk[norm]["scale"])
            out[f"{base}.{norm}.bias"] = _t(blk[norm]["bias"])
        for ours, theirs in (("attn.qkv", blk["attn"]["qkv"]),
                             ("attn.proj", blk["attn"]["proj"]),
                             ("mlp.fc1", blk["mlp_fc1"]),
                             ("mlp.fc2", blk["mlp_fc2"])):
            _vit_dense(out, f"{base}.{ours}", theirs)
        if "act_scales" in blk:
            out[f"{base}.act_scales"] = _t(blk["act_scales"])
    out[f"{prefix}norm.weight"] = _t(params["norm"]["scale"])
    out[f"{prefix}norm.bias"] = _t(params["norm"]["bias"])
    return out


def _index_tree(tree: Mapping, i: int) -> Dict[str, Any]:
    return {k: (_index_tree(v, i) if isinstance(v, Mapping) else v[i])
            for k, v in tree.items()}


def variables_to_state_dict(model_name: str,
                            variables: Mapping) -> StateDict:
    """JAX variables of zoo model ``model_name`` -> the port model's
    state_dict (load with ``load_state_dict(..., strict=True)``).  Without
    ``batch_stats`` only the parameters' keys come out."""
    params = variables["params"]
    stats = variables.get("batch_stats")
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
    if model_name in ("thermal_only", "rgb_only"):
        if model_name == "thermal_only":
            out = vit_state_dict(params["ViT_0"], "vit.")
        else:
            out = resnet_state_dict(
                params["ResNet_0"],
                None if stats is None else stats["ResNet_0"], "resnet.")
        out["head.weight"] = _dense(params["head"]["kernel"])
        out["head.bias"] = _t(params["head"]["bias"])
        return out
    if model_name != "multimodal":
        raise ValueError(f"no bridge for model {model_name!r} yet")
    out = resnet_state_dict(params["rgb_branch"],
                            None if stats is None else stats["rgb_branch"],
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
