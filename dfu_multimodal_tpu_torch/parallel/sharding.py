"""Tensor-parallel and fully-sharded parameter layouts (counterpart of
``dfu_multimodal_tpu/parallel/sharding.py``).

The JAX package states its layouts as PartitionSpecs over flax paths and
lets XLA insert the collectives.  Here the same rules are pure functions
over the port's parameter names (torchvision / timm keys) returning, per
name, a spec: a tuple with the mesh axis name at the sharded dimension
(``()`` replicated).  A Linear weight is (out, in) where the flax kernel
is (in, out), so JAX's column split (the kernel's last dimension) is the
weight's dimension 0 and its row split dimension 1.

- TP (:func:`tp_param_specs`, :data:`DEFAULT_TP_RULES`): Megatron's
  column split of ``attn.qkv`` and ``mlp.fc1`` (and the fusion head's
  first Linear, ``fusion.0``) and row split of ``attn.proj`` and
  ``mlp.fc2`` (``fusion.3``), with JAX's guard: a dimension not
  divisible by the model axis stays replicated.  :func:`apply_tp` puts
  it on the module with ``parallelize_module`` (``ColwiseParallel`` /
  ``RowwiseParallel``); the flax blocks compute on the local shards
  (``models/common.py::dense``).  A plain column split of the fused qkv
  weight (3·C outputs, q then k then v) would give rank 0 all of q and
  half of k, so the rows are regrouped first, ``[q_h, k_h, v_h]`` for
  each rank's heads (:func:`qkv_rank_order`): each rank then holds whole
  heads and attends over them alone.  :func:`full_state` gathers a
  sharded state and undoes the regrouping.
- FSDP (:func:`fsdp_param_specs`): each parameter of at least
  ``min_size`` elements shards its largest data-divisible dimension over
  the data axis, ties broken in the flax layout's order, as JAX's rule
  picks.  :func:`apply_fsdp` puts it on the module with FSDP2's
  ``fully_shard`` (``shard_placement_fn``).  FSDP2 shards every
  parameter, so a leaf JAX replicates (smaller than ``min_size``, or no
  divisible dimension) is split on dimension 0 here; the results are
  the same, only the memory layout differs.  The ViT's patch embedding
  is one (p·p·C, hidden) kernel in JAX and an OIHW conv here, so its
  split differs as well (JAX's p·p·C, here the largest conv dimension).
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Sequence, Tuple

import torch

from dfu_multimodal_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS

Spec = Tuple

# (name regex, kind) over the port's parameter names.  Like JAX's
# ``.*/fusion/fc1/kernel$``, each needs a parent scope: the multimodal
# classifier's own head (``fusion.0``, JAX's top-level ``fusion/fc1``)
# matches none and stays replicated, as in JAX
DEFAULT_TP_RULES: List[Tuple[str, str]] = [
    (r".*\.(mlp\.fc1|attn\.qkv)\.weight$", "col"),
    (r".*\.(mlp\.fc1|attn\.qkv)\.bias$", "col_bias"),
    (r".*\.(mlp\.fc2|attn\.proj)\.weight$", "row"),
    (r".*\.fusion\.0\.weight$", "col"),
    (r".*\.fusion\.0\.bias$", "col_bias"),
    (r".*\.fusion\.3\.weight$", "row"),
]


def _spec_for(kind: str, ndim: int) -> Spec:
    if kind == "col":
        return (MODEL_AXIS,) + (None,) * (ndim - 1)
    if kind == "row":
        return (None, MODEL_AXIS) if ndim >= 2 else ()
    if kind == "col_bias":
        return (None,) * (ndim - 1) + (MODEL_AXIS,)
    raise ValueError(kind)


def _shapes(params: Mapping) -> Dict[str, Tuple[int, ...]]:
    return {k: tuple(getattr(v, "shape", v)) for k, v in params.items()}


def tp_param_specs(params: Mapping, rules=None) -> Dict[str, Spec]:
    """name -> spec under the TP rules (``params``: name -> tensor or
    shape)."""
    rules = rules if rules is not None else DEFAULT_TP_RULES
    specs = {}
    for name, shape in _shapes(params).items():
        spec: Spec = ()
        for pattern, kind in rules:
            if re.match(pattern, name):
                spec = _spec_for(kind, len(shape))
                break
        specs[name] = spec
    return specs


def tp_shardings(params: Mapping, model_size: int, rules=None
                 ) -> Dict[str, Spec]:
    """:func:`tp_param_specs` with JAX's guard: a sharded dimension not
    divisible by ``model_size`` falls back to replication."""
    shapes = _shapes(params)
    out = {}
    for name, spec in tp_param_specs(params, rules).items():
        if any(a == MODEL_AXIS and shapes[name][i] % model_size
               for i, a in enumerate(spec)):
            spec = ()
        out[name] = spec
    return out


def _flax_order(name: str, ndim: int) -> Sequence[int]:
    """The port's dimensions in the flax leaf's order: a Linear's (out,
    in) weight is the kernel (in, out), a conv's OIHW is HWIO."""
    if name.endswith("weight") and ndim == 2:
        return (1, 0)
    if ndim == 4:
        return (2, 3, 1, 0)
    return tuple(range(ndim))


def fsdp_param_specs(params: Mapping, data_size: int,
                     min_size: int = 1024) -> Dict[str, Spec]:
    """name -> spec: the largest ``data_size``-divisible dimension of a
    parameter of at least ``min_size`` elements over the data axis."""
    specs = {}
    for name, shape in _shapes(params).items():
        size = 1
        for d in shape:
            size *= d
        spec: Spec = ()
        if data_size > 1 and size >= min_size:
            divisible = [i for i in _flax_order(name, len(shape))
                         if shape[i] and shape[i] % data_size == 0]
            if divisible:
                axis = max(divisible, key=lambda i: shape[i])
                parts = [None] * len(shape)
                parts[axis] = DATA_AXIS
                spec = tuple(parts)
        specs[name] = spec
    return specs


def sharded_dim(spec: Spec, axis_name: str):
    return spec.index(axis_name) if axis_name in spec else None


# ------------------------------------------------------------------ FSDP


def apply_fsdp(module: torch.nn.Module, mesh, min_size: int = 1024) -> None:
    """Shard ``module``'s parameters over the mesh's data axis with FSDP2,
    each on the dimension :func:`fsdp_param_specs` picks (dimension 0
    where JAX replicates).  Gradients are reduce-scattered as sums:
    the steps divide by the global weight before the backward."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    data = mesh[DATA_AXIS]
    by_param = {}
    specs = fsdp_param_specs(dict(module.named_parameters()), data.size(),
                             min_size)
    for name, p in module.named_parameters():
        dim = sharded_dim(specs[name], DATA_AXIS)
        by_param[id(p)] = Shard(0 if dim is None else dim)
    fully_shard(module, mesh=data,
                shard_placement_fn=lambda p: by_param[id(p)])
    # sum, not average: the method's name differs across FSDP2 releases
    divide = (getattr(module, "set_gradient_divide_factor", None)
              or module.set_reduce_scatter_divide_factor)
    divide(1.0)
    # a plain SUM reduce-scatter (gloo has no PREMUL_SUM); older FSDP2s
    # without the switch premultiply by 1, on NCCL
    if hasattr(module, "set_force_sum_reduction_for_comms"):
        module.set_force_sum_reduction_for_comms(True)


# -------------------------------------------------------------------- TP


def qkv_rank_order(dim: int, ranks: int) -> torch.Tensor:
    """The row order of a fused (3·dim) qkv weight that gives rank ``r``
    of ``ranks`` the contiguous block ``[q, k, v]`` of its heads."""
    per = dim // ranks
    order = [part * dim + r * per + i
             for r in range(ranks) for part in range(3) for i in range(per)]
    return torch.tensor(order)


def _qkv_heads(module: torch.nn.Module) -> Dict[str, int]:
    """Fused-qkv Linear name (``....attn.qkv``) -> its block's heads."""
    out = {}
    for name, sub in module.named_modules():
        if hasattr(sub, "num_heads") and hasattr(sub, "qkv"):
            out[f"{name}.qkv" if name else "qkv"] = sub.num_heads
    return out


# (row-split Linear, its column-split partner): the pair shares the
# activation split, so one is sharded only with the other
_TP_PAIRS = (("attn.proj", "attn.qkv"), ("mlp.fc2", "mlp.fc1"),
             ("fusion.3", "fusion.0"))


def tp_plan(module: torch.nn.Module, model_size: int, rules=None
            ) -> Dict[str, str]:
    """Linear name -> "col" or "row" for :func:`apply_tp`: every Linear
    whose weight :func:`tp_shardings` splits, a qkv only where its heads
    divide over the model axis, each with its partner of the pair."""
    specs = tp_shardings(dict(module.named_parameters()), model_size, rules)
    heads = _qkv_heads(module)
    plan = {}
    for name, spec in specs.items():
        if not name.endswith(".weight") or not spec:
            continue
        linear = name[:-len(".weight")]
        if linear in heads and heads[linear] % model_size:
            continue
        plan[linear] = "col" if spec[0] == MODEL_AXIS else "row"
    paired = {}
    for linear, kind in plan.items():
        for row, col in _TP_PAIRS:
            mine, other = (row, col) if kind == "row" else (col, row)
            if linear.endswith(mine) and (
                    linear[:-len(mine)] + other) in plan:
                paired[linear] = kind
    return paired


@torch.no_grad()
def apply_tp(module: torch.nn.Module, mesh, rules=None) -> Dict[str, str]:
    """Megatron tensor parallelism over the mesh's model axis: the qkv
    rows regrouped by rank (:func:`qkv_rank_order`), then
    ``parallelize_module`` with ``ColwiseParallel`` / ``RowwiseParallel``
    on :func:`tp_plan`'s Linears.  Returns the plan."""
    from torch.distributed.tensor.parallel import (ColwiseParallel,
                                                   RowwiseParallel,
                                                   parallelize_module)

    tp = mesh[MODEL_AXIS]
    plan = tp_plan(module, tp.size(), rules)
    for linear in plan:
        if linear.endswith("attn.qkv"):
            lin = module.get_submodule(linear)
            order = qkv_rank_order(lin.in_features,
                                   tp.size()).to(lin.weight.device)
            lin.weight.copy_(lin.weight[order])
            lin.bias.copy_(lin.bias[order])
    styles = {"col": ColwiseParallel, "row": RowwiseParallel}
    parallelize_module(module, tp, {k: styles[v]() for k, v in plan.items()})
    return plan


def _qkv_order(name: str, module: torch.nn.Module,
               plan: Mapping[str, str]):
    """The rank order of the rows of ``name`` (a parameter, or a moment
    of one) when it belongs to a split qkv Linear, else None."""
    owner = name.rsplit(".", 1)[0]
    if owner not in plan or not owner.endswith("attn.qkv"):
        return None
    lin = module.get_submodule(owner)
    return qkv_rank_order(lin.in_features, lin.weight.device_mesh.size())


def full_state(state: Mapping[str, torch.Tensor], module: torch.nn.Module,
               plan: Mapping[str, str]) -> Dict[str, torch.Tensor]:
    """``state`` (names of ``module``'s parameters and buffers, e.g. its
    state_dict or an optimizer moment) with every sharded tensor gathered
    whole and the qkv rows back in q, k, v order: a collective every rank
    joins, the same tensors on every rank."""
    out = {}
    for name, t in state.items():
        if hasattr(t, "full_tensor"):
            t = t.full_tensor()
        order = _qkv_order(name, module, plan)
        if order is not None:
            t = torch.empty_like(t).index_copy_(0, order.to(t.device), t)
        out[name] = t
    return out


@torch.no_grad()
def shard_like(state: Mapping[str, torch.Tensor],
               like: Mapping[str, torch.Tensor], module: torch.nn.Module,
               plan: Mapping[str, str]) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`full_state`: each whole tensor of ``state``
    laid out as ``like``'s tensor of its name (the qkv rows regrouped by
    rank, a DTensor's placements; this rank's shard), on its device and
    in its dtype."""
    from torch.distributed.tensor import distribute_tensor

    out = {}
    for name, t in state.items():
        dst = like[name]
        t = t.to(dst.device, dst.dtype)
        order = _qkv_order(name, module, plan)
        if order is not None:
            t = t[order.to(t.device)]
        if hasattr(dst, "device_mesh"):
            t = distribute_tensor(t, dst.device_mesh, dst.placements)
        out[name] = t
    return out


@torch.no_grad()
def load_full_state(module: torch.nn.Module,
                    state: Mapping[str, torch.Tensor],
                    plan: Mapping[str, str]) -> None:
    """Copy whole tensors (``module.state_dict()`` names) into a module
    sharded by :func:`apply_fsdp` or :func:`apply_tp`, in place."""
    own = module.state_dict()
    for name, t in shard_like(state, own, module, plan).items():
        own[name].copy_(t)
