"""Time the kernels of two checkouts on one card, in turns, and compare
their outputs bit for bit.

    python -m dfu_multimodal_tpu_torch.tools.ab_kernels PARENT_DIR

Runs ``chip_smoke.py``'s kernel phases 3, 3b, 3c, 3d, 3e and, where the
checkout has them, 3f and 3g (K1-K12 against their plain versions, CUDA
events) from PARENT_DIR, from
this checkout twice, then from PARENT_DIR again — parent, change,
change, parent — each in a process of its own, which builds its
checkout's kernels into that checkout's ``build/``.  Each turn also
hashes the outputs of K1, K2, K4, K5 (alone and in the chain rule
``attn_block_bwd``), K6, K7 and K8 (attention and MLP blocks), K9 and,
where the checkout has it, K10 (all seven results, and each alone)
at ViT-B/16's attention (N = 197, B = 16, seeded inputs, fp32 and bf16),
of K11 at ResNet-50's stage 3 identity block and stage 1 projection
block and, where the checkout has it, of K12 at stage 3's tail (B = 8)
through the public entry points, of the K6 and K9 forwards at N = 577
and of K3 (the fusion head, B = 8) as well (:data:`BITS`), and runs
phase 6 (int8 serving, its card vs CPU
checks)
with this checkout's ``zoo.init_model`` in both checkouts, so that a
change of the int8 path shows apart from a change of the initial weights
(:data:`INT8`; a failed check there is printed, not fatal).  Prints the
card's name and power limit, each kernel, attention and int8 line
prefixed by its turn, and whether every turn's hash of each output is
the same.  Two versions are compared only within one run: two runs may
land on two cards.  Needs a CUDA device; exits non-zero without one.

Against a parent whose int8 K7/K8 products run the int8 WMMA kernel and
whose bf16 K7/K8 attention runs the SIMT core (``csrc/attention_core.cuh``),
only the bf16 K7 and K8 attention-block lines change (their attention
sums in another order, with the ex2 exponential) and must agree across
the two change turns; the MLP blocks' lines (bf16 and fp32) and the fp32
attention blocks' stay equal when the wgmma products equal the WMMA
kernel's bit for bit, and every other line is held equal.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
PHASES = ("import torch, chip_smoke as cs; dev = torch.device('cuda', 0); "
          "cs.phase_kernels(dev); cs.phase_backward_kernels(dev); "
          "cs.phase_q8_kernels(dev); cs.phase_resnet_kernels(dev); "
          "cs.phase_attention_kernels(dev); "
          "[phase(dev) for phase in (getattr(cs, 'phase_k10', None), "
          "getattr(cs, 'phase_stage', None)) if phase]")
# phase 6 of the checkout in the working directory, with the weights
# drawn by this checkout's initialiser (zoo.py at ZOO)
INT8 = """
import importlib.util, sys, torch, chip_smoke as cs
from dfu_multimodal_tpu_torch.models import zoo
spec = importlib.util.spec_from_file_location("zoo_of_change", {zoo!r})
mod = sys.modules[spec.name] = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
zoo.init_model = mod.init_model
cs.phase_int8(torch.device("cuda", 0))
"""
ZOO = ROOT / "dfu_multimodal_tpu_torch" / "models" / "zoo.py"
# sha1 of each kernel's outputs on seeded inputs at N = 197
BITS = r"""
import hashlib
import torch
from dfu_multimodal_tpu_torch.ops import attention as at
from dfu_multimodal_tpu_torch.ops import fused_mlp as fm
from dfu_multimodal_tpu_torch.ops import resnet_block as rb
from dfu_multimodal_tpu_torch.ops import vit_block as vb
from dfu_multimodal_tpu_torch.ops import vit_block_q8 as q8
dev = torch.device("cuda", 0)
b, n, c, heads = 16, 197, 768, 12


def sha(*ts):
    m = hashlib.sha1()
    for t in ts:
        m.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy())
    return m.hexdigest()[:16]


for dt in (torch.float32, torch.bfloat16):
    g = torch.Generator(device=dev).manual_seed(0)

    def r(*shape, s=1.0, o=0.0, dtype=dt):
        return (o + s * torch.randn(*shape, generator=g, device=dev)).to(dtype)

    x, do, qkv = r(b, n, c), r(b, n, c), r(b, n, 3 * c)
    q, k, v, d9 = (r(b, heads, n, c // heads) for _ in range(4))
    ln = (r(c, s=0.1, o=1.0, dtype=torch.float32),
          r(c, s=0.1, dtype=torch.float32))
    w = (r(c, 3 * c, s=c ** -0.5), r(3 * c, s=0.1, dtype=torch.float32),
         r(c, c, s=c ** -0.5), r(c, s=0.1, dtype=torch.float32))
    wq = (*q8.quantize_weight(w[0].float()), w[1],
          *q8.quantize_weight(w[2].float()), w[3])
    act = (4.5 / 127, 1.5 / 127)       # K8's calibrated act scales
    wqs = (wq[0], wq[1] * act[0], wq[2], wq[3], wq[4] * act[1], wq[5],
           torch.tensor([1 / a for a in act], device=dev))
    mlp = (r(c, 4 * c, s=c ** -0.5), r(4 * c, s=0.1, dtype=torch.float32),
           r(4 * c, c, s=(4 * c) ** -0.5))
    b2b = r(c, s=0.1, dtype=torch.float32)
    wm = (*q8.quantize_weight(mlp[0].float()), mlp[1],
          *q8.quantize_weight(mlp[2].float()), b2b)
    wms = (wm[0], wm[1] * act[0], wm[2], wm[3], wm[4] * act[1], wm[5],
           wqs[-1])

    def bottleneck(cin, cmid, cout):       # BN-folded, fused_bottleneck's
        return [r(cin, cmid, s=cin ** -0.5),   # layouts
                r(cmid, s=0.1, dtype=torch.float32),
                r(9 * cmid, cmid, s=(9 * cmid) ** -0.5),
                r(cmid, s=0.1, dtype=torch.float32),
                r(cmid, cout, s=cmid ** -0.5),
                r(cout, s=0.1, dtype=torch.float32)]

    x3 = r(8, 14, 14, 1024)                   # stage 3, B = 8
    stage3 = [bottleneck(1024, 256, 1024) for _ in range(5)]
    x1 = r(8, 56, 56, 64)                     # stage 1's projection block
    proj = bottleneck(64, 64, 256) + [r(64, 256, s=0.125),
                                      r(256, s=0.1, dtype=torch.float32)]
    outs = {
        "K1 attn_block": (vb.attn_block(x, *ln, *w, heads),),
        "K2 mlp_block": (vb.mlp_block(x, *ln, *mlp, b2b),),
        "K4 mlp_block_bwd": vb.mlp_block_bwd(x, do, *ln, *mlp),
        "K5 chain attn_block_bwd": vb.attn_block_bwd(x, do, *ln, *w[:3],
                                                     heads),
        "K5 qkv_attention_fwdbwd": at.qkv_attention_fwdbwd(qkv, do, heads),
        "K6 qkv_attention_fwd": (at.qkv_attention_fwd(qkv, heads),),
        "K6 qkv_attention_bwd": (at.qkv_attention_bwd(qkv, do, heads),),
        "K7 attn_block_q8": (q8.attn_block_q8(x, *ln, *wq, heads),),
        "K7 mlp_block_q8": (q8.mlp_block_q8(x, *ln, *wm),),
        "K8 attn_block_q8s": (q8.attn_block_q8s(x, *ln, *wqs, heads),),
        "K8 mlp_block_q8s": (q8.mlp_block_q8s(x, *ln, *wms),),
        "K9 flash_attention_fwd": (at.flash_attention_fwd(q, k, v),),
        "K9 flash_attention_bwd": at.flash_attention_bwd(q, k, v, d9)}
    qkv_l = r(2, 577, 3 * c)                  # a 384² image's tokens
    q_l, k_l, v_l = (r(2, heads, 577, c // heads) for _ in range(3))
    outs["K6 qkv_attention_fwd N=577"] = (at.qkv_attention_fwd(qkv_l,
                                                               heads),)
    outs["K9 flash_attention_fwd N=577"] = (at.flash_attention_fwd(
        q_l, k_l, v_l),)
    if hasattr(vb, "attn_block_bwd_fused"):
        outs["K10 attn_block_bwd_fused"] = vb.attn_block_bwd_fused(
            x, do, *ln, *w, heads)
        for name, t in zip(("dx", "dg1", "db1", "dwqkv", "dbqkv", "dwproj",
                            "dbproj"), outs["K10 attn_block_bwd_fused"]):
            outs[f"K10 attn_block_bwd_fused {name}"] = (t,)
    outs["K11 fused_bottleneck stage3"] = (rb.fused_bottleneck(
        x3, *stage3[0]),)
    outs["K11 fused_bottleneck proj"] = (rb.fused_bottleneck(x1, *proj),)
    h = x3
    for blk in stage3:
        h = rb.fused_bottleneck(h, *blk)
    outs["K11 chain stage3"] = (h,)
    if hasattr(rb, "fused_stage"):
        outs["K12 fused_stage stage3"] = (rb.fused_stage(x3, stage3),)
    head = [r(8, 2816)]                       # the fusion head, B = 8
    for din, dout in ((2816, 512), (512, 256), (256, 2)):
        head += [r(din, dout, s=din ** -0.5),
                 r(dout, s=0.1, dtype=torch.float32)]
    outs["K3 fused_mlp"] = (fm.fused_mlp(*head),)
    for name, ts in outs.items():
        print(f"[bits] {name} {str(dt).split('.')[1]} {sha(*ts)}")
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path,
                    help="root of the other checkout (e.g. a git archive "
                         "of the parent commit)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    parent = args.parent.resolve()
    hashes = {}
    int8 = INT8.format(zoo=str(ZOO))
    for turn, (tag, tree) in enumerate((("parent", parent), ("change", ROOT),
                                        ("change", ROOT), ("parent", parent)),
                                       start=1):
        for code in (PHASES, BITS, int8):
            proc = subprocess.run([sys.executable, "-c", code], cwd=tree,
                                  capture_output=True, text=True)
            if proc.returncode != 0 and code is not int8:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                return proc.returncode
            for line in proc.stdout.splitlines():
                if line.startswith(("[kernel]", "[split]", "[int8", "[k10]",
                                    "[stage]", "[attention]")):
                    print(f"[turn {turn} {tag}] {line}", flush=True)
                if line.startswith("[bits]"):
                    key, digest = line.rsplit(" ", 1)
                    hashes.setdefault(key, []).append(digest)
            if code is int8:
                print(f"[turn {turn} {tag}] phase 6 exit code "
                      f"{proc.returncode}", flush=True)
                if proc.returncode != 0:
                    print(proc.stderr[-600:], flush=True)
    for key, digests in hashes.items():
        print(f"{key}: {' '.join(digests)}; equal in all "
              f"{len(digests)} turns: {len(set(digests)) == 1}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
