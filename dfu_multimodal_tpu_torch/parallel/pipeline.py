"""GPipe pipeline parallelism over the ViT encoder depth (counterpart of
``dfu_multimodal_tpu/parallel/pipeline.py``).

A ``(data, stage)`` mesh (:func:`make_pp_mesh`): the batch is split over
``data``, the encoder blocks into ``stage`` contiguous slices, one a
rank.  :func:`gpipe` runs JAX's schedule: ``M + S - 1`` ticks, stage
``s`` takes microbatch ``t - s`` at tick ``t`` (stage 0 from the input,
the others from their left neighbour by ``recv``), hands its output to
the right by ``send``, and the last stage's outputs go to every stage
(a ``broadcast``).  Bubble ticks compute nothing.

It is differentiable: ``send`` and ``recv`` are autograd functions whose
backwards pass the gradient the other way, and the broadcast's backward
keeps the last stage's own gradient (every stage computes the same loss
from the same output).  The autograd engine runs a rank's backward
nodes from the newest, so each stage walks its microbatches from the
last to the first and the ranks' sends and receives pair up: the
reversed pipeline.  After the backward each rank holds the gradients of
its own blocks (and stage 0 those of the patch embedding); every rank
holds the final LayerNorm's.  :func:`sync_pipeline_grads` sums the rest
over the stage group so every rank holds the whole gradient, as JAX's
``jax.grad`` returns it.

Point-to-point ``send``/``recv`` run on gloo (CPU) and NCCL; gloo has
none on CUDA tensors, so a pipeline of more than one stage on one card
needs NCCL ranks on separate cards.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from dfu_multimodal_tpu_torch.parallel import mesh as mesh_mod
from dfu_multimodal_tpu_torch.parallel.mesh import DATA_AXIS

STAGE_AXIS = "stage"


def make_pp_mesh(data: int, stage: int, device_type: str = "cuda"):
    """The ``(data, stage)`` DeviceMesh over every rank of the default
    group; stage neighbours are adjacent ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    n = mesh_mod.world()[1]
    if data * stage > n:
        raise ValueError(f"mesh {data}x{stage} needs {data * stage} "
                         f"devices, have {n}")
    if data * stage != n:
        raise ValueError(f"mesh {data}x{stage} uses {data * stage} of the "
                         f"{n} ranks: every rank must belong to the mesh")
    return init_device_mesh(device_type, (data, stage),
                            mesh_dim_names=(DATA_AXIS, STAGE_AXIS))


class _Recv(torch.autograd.Function):
    """Forward: receive a tensor from ``src``; backward: send its gradient
    back.  ``anchor`` (an empty tensor that requires grad) puts the node
    in the graph."""

    @staticmethod
    def forward(ctx, anchor, like, src, group):
        ctx.src, ctx.group = src, group
        buf = torch.empty_like(like)
        dist.recv(buf, src=src, group=group)
        return buf

    @staticmethod
    def backward(ctx, grad):
        dist.send(grad.contiguous(), dst=ctx.src, group=ctx.group)
        return None, None, None, None


class _Send(torch.autograd.Function):
    """Forward: send ``y`` to ``dst`` and return an empty token; backward:
    receive ``y``'s gradient from ``dst``."""

    @staticmethod
    def forward(ctx, y, dst, group):
        ctx.dst, ctx.group = dst, group
        ctx.like = (y.shape, y.dtype, y.device)
        dist.send(y.contiguous(), dst=dst, group=group)
        return y.new_empty(0)

    @staticmethod
    def backward(ctx, _):
        shape, dtype, device = ctx.like
        buf = torch.empty(shape, dtype=dtype, device=device)
        dist.recv(buf, src=ctx.dst, group=ctx.group)
        return buf, None, None


class _Broadcast(torch.autograd.Function):
    """Forward: the last stage's ``out`` on every stage; backward: the
    gradient of ``out`` on the last stage (the other stages' copies of the
    same gradient are dropped), and empty gradients for the send tokens,
    which starts each stage's backward."""

    @staticmethod
    def forward(ctx, out, src, group, *tokens):
        ctx.is_src = dist.get_rank() == src
        ctx.n_tokens = len(tokens)
        out = out.clone()
        dist.broadcast(out, src=src, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        tokens = tuple(grad.new_empty(0) for _ in range(ctx.n_tokens))
        return (grad if ctx.is_src else None, None, None) + tokens


def gpipe(stage_apply: Callable[[torch.Tensor], torch.Tensor],
          microbatches: torch.Tensor, *, stage: int, num_stages: int,
          group) -> torch.Tensor:
    """Run ``microbatches`` (M, mb, ...) through a ``num_stages``-deep
    pipeline; this rank is stage ``stage`` of ``group`` and applies
    ``stage_apply`` (its layer slice, shape-preserving).  Only stage 0
    reads ``microbatches``; the result (M, mb, ...) is on every stage."""
    num_mb = microbatches.shape[0]
    ranks = dist.get_process_group_ranks(group)
    anchor = microbatches.new_empty(0, requires_grad=True)
    outs: List[torch.Tensor] = []
    tokens = []
    for t in range(num_mb + num_stages - 1):
        m = t - stage
        if not 0 <= m < num_mb:
            continue                                   # a bubble tick
        if stage == 0:
            x = microbatches[m]
        else:
            x = _Recv.apply(anchor, microbatches[0], ranks[stage - 1], group)
        y = stage_apply(x)
        if stage < num_stages - 1:
            tokens.append(_Send.apply(y, ranks[stage + 1], group))
        else:
            outs.append(y)
    out = (torch.stack(outs) if outs else torch.zeros_like(microbatches))
    return _Broadcast.apply(out, ranks[-1], group, *tokens)


def stage_blocks(depth: int, num_stages: int, stage: int) -> range:
    """The contiguous block indices of ``stage``."""
    if depth % num_stages:
        raise ValueError(f"depth {depth} not divisible by "
                         f"{num_stages} pipeline stages")
    per = depth // num_stages
    return range(stage * per, (stage + 1) * per)


def vit_pipeline_fn(mesh, *, depth: int,
                    num_microbatches: int = 2) -> Callable:
    """``f(vit, images) -> cls_features``: the port ViT (``models/vit.py``,
    any block impl) with its ``depth`` blocks pipelined over the mesh's
    ``stage`` axis and the batch split over ``data``.  ``images`` (B, H,
    W, 3) is the global batch, on every rank; each data rank takes its
    rows.  Patch embedding and the final LayerNorm run outside the
    pipeline on the ViT's own modules, as its forward does; the result is
    the global batch's fp32 CLS features on every rank, differentiable
    (then :func:`sync_pipeline_grads`)."""
    stage, num_stages, group = mesh_mod.axis(mesh, STAGE_AXIS)
    d_rank, d_size, d_group = mesh_mod.axis(mesh, DATA_AXIS)
    blocks = stage_blocks(depth, num_stages, stage)

    def fn(vit, images: torch.Tensor) -> torch.Tensor:
        dt = vit.dtype
        n = images.shape[0]
        lo, hi = mesh_mod.process_shard(n, d_rank, d_size)
        x = vit.patch_embed(images[lo:hi].to(dt))
        cls = vit.cls_token.to(dt).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + vit.pos_embed.to(dt)
        b = x.shape[0]
        if b % num_microbatches:
            raise ValueError(f"local batch {b} not divisible by "
                             f"{num_microbatches} microbatches")

        def stage_apply(h):
            for i in blocks:
                h = vit.blocks[i](h)
            return h

        mb = x.reshape(num_microbatches, b // num_microbatches,
                       *x.shape[1:])
        x = gpipe(stage_apply, mb, stage=stage, num_stages=num_stages,
                  group=group).reshape(x.shape)
        feats = F.layer_norm(x[:, 0].float(), x.shape[-1:], vit.norm.weight,
                             vit.norm.bias, vit.norm.eps).to(dt).float()
        if d_size == 1:
            return feats
        return mesh_mod.gather_rows(feats, lo, n, d_group)

    return fn


def sync_pipeline_grads(vit, mesh) -> None:
    """Sum every ViT gradient but the final LayerNorm's over the stage
    group (each stage holds only its own blocks'), so every rank holds
    the whole gradient."""
    _, _, group = mesh_mod.axis(mesh, STAGE_AXIS)
    params: Sequence[torch.Tensor] = [
        p for name, p in vit.named_parameters()
        if not name.startswith("norm.")]
    mesh_mod.sum_grads(params, group)
