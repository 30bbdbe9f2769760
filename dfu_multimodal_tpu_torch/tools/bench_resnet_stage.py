"""Time the whole-stage ResNet kernel (K12) against the K11 chain and
cuDNN on one card.

    python -m dfu_multimodal_tpu_torch.tools.bench_resnet_stage
        [--batch 128 8] [--dtype bfloat16|float32] [--iters 20]

The port of ``scripts_dev/bench_resnet_stage.py``.  For each stride-1
stage tail of ResNet-50 (the identity blocks after each stage's first:
56x56x256 x2, 28x28x512 x3, 14x14x1024 x5, 7x7x2048 x2) at each batch, on
seeded BN-folded weights, it prints: the cuDNN chain of the same folded
blocks (``F.conv2d`` channels-last with the bias fused, ReLU, the
residual add; the counterpart of the JAX script's XLA conv chain), the
chain of K11 launches (``fused_bottleneck``), K12 (``fused_stage``, one
launch), the stage's bound (the larger of the operations over the card's
peak for the dtype and one read of x, one write of the output and each
block's weights and biases over 3.35 TB/s), and K12's relative error
against the cuDNN chain (max|d| / max|cuDNN|).  Times are CUDA events
over ``--iters`` calls after three warm-up calls, taken in turns (cuDNN,
K11 chain, K12, K12, K11 chain, cuDNN) and averaged.  Prints the card's
name and power limit first and one JSON line of every number last.
Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch
import torch.nn.functional as F

from dfu_multimodal_tpu_torch.ops.resnet_block import (fused_bottleneck,
                                                       fused_stage)

# (H = W, C, Cmid, identity blocks) of ResNet-50's four stage tails
STAGES = ((56, 256, 64, 2), (28, 512, 128, 3), (14, 1024, 256, 5),
          (7, 2048, 512, 2))
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12


def stage_bound_ms(b, h, c, cmid, n, dtype) -> tuple:
    """(bound ms, "bytes" or "operations") of one stage call."""
    rows, size = b * h * h, torch.finfo(dtype).bits // 8
    weights = n * (2 * c * cmid + 9 * cmid * cmid)
    t_ops = 2 * rows * weights / PEAK_FLOPS[dtype]
    t_bytes = (size * (2 * rows * c + weights)
               + 4 * n * (2 * cmid + c)) / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def make_stage(dev, b, h, c, cmid, n, dtype, seed=0):
    """x (B, H, W, C) and n folded (w1, b1, w2, b2, w3, b3), drawn as the
    JAX script draws them: weights normal with std fan_in^-0.5 in
    ``dtype``, biases (fp32) and x normal with std 0.1."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale, dt=torch.float32):
        return (scale * torch.randn(*shape, generator=g, device=dev)).to(dt)

    blocks = [(randn(c, cmid, scale=c ** -0.5, dt=dtype),
               randn(cmid, scale=0.1),
               randn(9 * cmid, cmid, scale=(9 * cmid) ** -0.5, dt=dtype),
               randn(cmid, scale=0.1),
               randn(cmid, c, scale=cmid ** -0.5, dt=dtype),
               randn(c, scale=0.1)) for _ in range(n)]
    return randn(b, h, h, c, scale=0.1, dt=dtype), blocks


def cudnn_weights(blocks, dtype) -> list:
    """The folded blocks as channels-last OIHW conv weights and biases in
    ``dtype`` (cuDNN adds a bias of the input's dtype)."""
    out = []
    for w1, b1, w2, b2, w3, b3 in blocks:
        cmid = w1.shape[1]
        ws = (w1.t()[:, :, None, None],
              w2.reshape(3, 3, cmid, cmid).permute(3, 2, 0, 1),
              w3.t()[:, :, None, None])
        out.append([(w.contiguous(memory_format=torch.channels_last),
                     bias.to(dtype)) for w, bias in zip(ws, (b1, b2, b3))])
    return out


def cudnn_chain(x, convs):
    """The eval bottleneck chain as cuDNN runs it, on x's channels-last
    NCHW view: relu(x + conv3(relu(conv3x3(relu(conv1 x)))))."""
    h = x.permute(0, 3, 1, 2)
    for (w1, b1), (w2, b2), (w3, b3) in convs:
        y = F.relu(F.conv2d(h, w1, b1))
        y = F.relu(F.conv2d(y, w2, b2, padding=1))
        h = F.relu(h + F.conv2d(y, w3, b3))
    return h.permute(0, 2, 3, 1)


def k11_chain(x, blocks):
    for blk in blocks:
        x = fused_bottleneck(x, *blk)
    return x


def cuda_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bench_stage(dev, b, h, c, cmid, n, dtype, iters) -> dict:
    x, blocks = make_stage(dev, b, h, c, cmid, n, dtype)
    convs = cudnn_weights(blocks, dtype)
    fns = {"cudnn_ms": lambda: cudnn_chain(x, convs),
           "k11_chain_ms": lambda: k11_chain(x, blocks),
           "k12_ms": lambda: fused_stage(x, blocks)}
    order = list(fns) + list(fns)[::-1]
    times = {k: 0.0 for k in fns}
    for k in order:
        times[k] += cuda_ms(fns[k], iters) / 2
    ref = fns["cudnn_ms"]().float()
    err = float((fns["k12_ms"]().float() - ref).abs().max()
                / ref.abs().max().clamp_min(1e-6))
    bound, by = stage_bound_ms(b, h, c, cmid, n, dtype)
    row = {"stage": f"{h}x{h}x{c}", "cmid": cmid, "blocks": n, "batch": b,
           **times, "bound_ms": bound, "bound_by": by,
           "rel_err_k12_vs_cudnn": err}
    print(f"stage {h}x{h}x{c} cmid={cmid} x{n} identity blocks, b={b}, "
          f"{str(dtype).split('.')[1]}:\n"
          f"  bound {bound * 1e3:.2f} us ({by})\n"
          f"  cuDNN chain     {times['cudnn_ms']:.4f} ms\n"
          f"  K11 chain       {times['k11_chain_ms']:.4f} ms\n"
          f"  K12 (one launch){times['k12_ms']:.4f} ms "
          f"({times['k12_ms'] / times['k11_chain_ms']:.3f}x the K11 chain, "
          f"{times['k12_ms'] / bound:.1f}x its bound)\n"
          f"  rel err K12 vs cuDNN: {err:.2e}", flush=True)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[128, 8])
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_resnet_stage: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    dtype = getattr(torch, args.dtype)
    rows = [bench_stage(dev, b, *stage, dtype, args.iters)
            for b in args.batch for stage in STAGES]
    print(json.dumps({"card": card, "dtype": args.dtype, "stages": rows}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
