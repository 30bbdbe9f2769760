"""Process groups and the ``(data, model)`` device mesh (counterpart of
``dfu_multimodal_tpu/parallel/mesh.py``).

One process per device, launched by ``torchrun``: :func:`init_from_env`
reads ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``, joins the process
group (NCCL for CUDA, gloo for the CPU, or the backend the caller names;
the library never switches by itself) and returns the rank's device,
``cuda:LOCAL_RANK``.  A rank whose device is missing fails.

:func:`make_mesh` builds the JAX package's 2-D mesh as a
``torch.distributed.device_mesh.DeviceMesh`` with the axes
:data:`DATA_AXIS` (the batch is split over it) and :data:`MODEL_AXIS`
(tensor parallelism, ``parallel/sharding.py``), with JAX's ``data = -1``
rule (every rank ÷ ``model``) and its "needs N devices, have M" error.
Unlike a JAX mesh, which may take the first devices of a larger set,
every rank of the group belongs to the mesh.

The collectives of the data-parallel steps all reduce by sum, through
``all_reduce`` alone (with autograd where a gradient flows through it):
gloo runs nothing else on CUDA tensors, so two ranks sharing one card
run the same arithmetic as NCCL ranks.  :func:`gather_rows` is an
all-gather written as the sum of zero-padded slices.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Iterable, Optional, Tuple, Union

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
# a collective that waits longer than this fails the rank
DEFAULT_TIMEOUT = timedelta(seconds=120)


def backend_for(device: Union[str, torch.device]) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_from_env(device: Union[str, torch.device] = "cuda",
                  backend: Optional[str] = None,
                  timeout: timedelta = DEFAULT_TIMEOUT) -> torch.device:
    """This process's device.  Outside ``torchrun`` (no ``WORLD_SIZE``)
    that is ``device`` itself and no group is made; under it the process
    group is initialised from the environment (``backend``, by default
    NCCL for a CUDA ``device`` and gloo for the CPU) and a CUDA rank gets
    ``cuda:LOCAL_RANK`` as its current device."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this rank cannot run "
                           "(pass --device cpu to run on the host)")
    if "WORLD_SIZE" not in os.environ:
        return device
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {local} but only "
                               f"{torch.cuda.device_count()} CUDA devices")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend or backend_for(device),
                                timeout=timeout,
                                **({"device_id": device}
                                   if device.type == "cuda" else {}))
    return device


def world() -> Tuple[int, int]:
    """(rank, world size) of the default group; (0, 1) without one."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def mesh_shape(cfg, n: int) -> Tuple[int, int]:
    """JAX's rule: ``data = -1`` takes every device ÷ ``model``."""
    data = cfg.data if cfg.data > 0 else max(1, n // cfg.model)
    used = data * cfg.model
    if used > n:
        raise ValueError(f"mesh {data}x{cfg.model} needs {used} devices, "
                         f"have {n}")
    return data, cfg.model


def make_mesh(cfg, device_type: str = "cuda"):
    """The ``(data, model)`` DeviceMesh over every rank of the default
    group (``cfg`` a ``MeshConfig``)."""
    from torch.distributed.device_mesh import init_device_mesh

    n = world()[1]
    data, model = mesh_shape(cfg, n)
    if not dist.is_initialized():
        raise ValueError(f"mesh {data}x{model} needs a process group: "
                         "launch under torchrun (parallel.mesh."
                         "init_from_env)")
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} uses {data * model} of the "
                         f"{n} ranks: every rank must belong to the mesh")
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def trainer_mesh(cfg, device: torch.device):
    """The mesh a trainer of ``cfg`` (a ``MeshConfig``) runs on, or None
    for one device of its own: without a process group only a 1x1 mesh
    exists (anything larger raises JAX's error); with one, ``data = 1,
    model = 1`` still means this rank alone, anything else the mesh over
    every rank."""
    single = cfg.data == 1 and cfg.model == 1 and not cfg.fsdp
    if dist.is_initialized():
        return None if single else make_mesh(cfg, device.type)
    mesh_shape(cfg, 1)
    if cfg.fsdp:
        raise ValueError("fsdp needs a process group: launch under "
                         "torchrun (parallel.mesh.init_from_env)")
    return None


def barrier() -> None:
    dist.barrier()


def axis(mesh, name: str) -> Tuple[int, int, Optional[dist.ProcessGroup]]:
    """(this rank's coordinate, size, group) of a mesh axis."""
    sub = mesh[name]
    return sub.get_local_rank(), sub.size(), sub.get_group()


def pad_batch_to_mesh(batch_size: int, data) -> int:
    """Smallest batch size >= requested that divides evenly over the
    data axis (``data``: its size, or the mesh)."""
    d = data if isinstance(data, int) else data[DATA_AXIS].size()
    return ((batch_size + d - 1) // d) * d


def process_shard(n: int, rank: Optional[int] = None,
                  world_size: Optional[int] = None) -> Tuple[int, int]:
    """(start, stop) of this rank's slice of a length-``n`` batch (by
    default the default group's rank and size): equal slices, the last
    rank takes the rest."""
    if rank is None or world_size is None:
        rank, world_size = world()
    per = n // world_size
    return rank * per, (rank + 1) * per if rank < world_size - 1 else n


# ------------------------------------------------------------ collectives


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Σ over ``group`` of ``t``, differentiable (the gradient of each
    rank's input is the sum of every rank's output gradient)."""
    from torch.distributed.nn.functional import all_reduce as ar
    return ar(t, group=group)


def sum_(t: torch.Tensor, group) -> torch.Tensor:
    """Σ over ``group`` of a tensor that carries no gradient (a copy)."""
    t = t.detach().clone()
    dist.all_reduce(t, group=group)
    return t


def gather_rows(x: torch.Tensor, lo: int, n: int, group) -> torch.Tensor:
    """The (n, ...) concatenation of every rank's rows, this rank's ``x``
    at rows ``lo:lo + len(x)``, differentiable: an all-gather as the sum
    of zero-padded slices."""
    full = x.new_zeros((n,) + tuple(x.shape[1:]))
    return all_reduce(torch.cat([full[:lo], x, full[lo + x.shape[0]:]]),
                      group)


def sum_grads(params: Iterable[torch.Tensor], group) -> None:
    """Σ over ``group`` of every parameter's gradient, in one flat
    all-reduce per dtype (a DTensor contributes its local shard)."""
    grads = []
    for p in params:
        g = p.grad
        if g is None:
            g = p.grad = torch.zeros_like(p)
        grads.append(g.to_local() if hasattr(g, "to_local") else g)
    by_dtype = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for gs in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in gs])
        dist.all_reduce(flat, group=group)
        parts = flat.split([g.numel() for g in gs])
        torch._foreach_copy_(gs, [v.view_as(g) for v, g in zip(parts, gs)])
