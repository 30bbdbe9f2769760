"""Tile widths of the bf16 and int8 ViT-block products
(``ops/csrc/gemm_sm90.cuh``) on one card.

    python -m dfu_multimodal_tpu_torch.tools.bench_vit_fwd [--iters 20]
        [--products all|bf16|int8]

Times each bf16 product of ViT-B/16's blocks (C = 768, hidden 3072) on the
TMA + wgmma GEMM at every tile width it is built for (BN = 64, 96, 128,
192), names the width its launcher picks (``pick_bn``, "auto"), at 197,
1576, 3152 and 25216 rows (B = 1, 8, 16 and 128 images of 197 tokens),
beside cuBLAS's ``torch.matmul`` on the same operands (bf16 result, no
epilogue: a yardstick, never called by the port):

- K1's qkv (EPI_BIAS) and proj (EPI_BIAS_RESID), K2's fc1 (EPI_BIAS_GELU)
  and fc2 (EPI_BIAS_RESID): B read as stored (MN-major);
- the attention-block chain rule's dattn = g·wprojᵀ (EPI_NONE) and
  dy = dqkv·wqkvᵀ (EPI_F32): B read transposed (K-major).

The int8 products of K7/K8 (the GEMM's int8 modes, ``csrc/vit_block_q8.cu``
launches them) likewise, bf16 compute dtype: qkv (QEPI_OUT), proj and fc2
(QEPI_RESID; fc2 in its four K groups of 768, widths 64-128), fc1 with
dynamic row scales (QEPI_GELU_F32) and static (QEPI_GELU_Q8), on seeded
int8 operands and scales, beside ``torch._int_mm`` (cuBLASLt s8·s8→s32,
no dequantisation: a yardstick, never called by the port).

Every width, and the launcher's own pick, must give the same bits (the k
sums run in one order at every width) and agree with the product in fp32
within the bf16 budget (int8: equal the plain integer arithmetic,
``vit_block_q8.gemm_q8_ref``, bit for bit, GELU_F32 within 1e-6 of it):
each line says so, and a mismatch exits non-zero.  Times are the
profiler's device ms per call over ``--iters`` calls, one profiler window
per product and row count holding every width and cuBLAS (or
``torch._int_mm``; the kernels told apart by name; a process that opens
many windows can lose the device's records late in its life).  Prints
the card's name and power limit first.  Needs a CUDA device and nvcc;
exits non-zero without them.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from dfu_multimodal_tpu_torch.ops import _build
from dfu_multimodal_tpu_torch.ops import vit_block as vb
from dfu_multimodal_tpu_torch.ops import vit_block_q8 as q8

C, HIDDEN = 768, 3072
ROWS = (197, 1576, 3152, 25216)
WIDTHS = (64, 96, 128, 192)
# name: (epilogue, B read transposed, n, k)
PRODUCTS = {
    "qkv": (vb._EPI_BIAS, False, 3 * C, C),
    "proj": (vb._EPI_BIAS_RESID, False, C, C),
    "fc1": (vb._EPI_BIAS_GELU, False, HIDDEN, C),
    "fc2": (vb._EPI_BIAS_RESID, False, C, HIDDEN),
    "dattn": (vb._EPI_NONE, True, C, C),
    "dy": (vb._EPI_F32, True, C, 3 * C),
}
BF16_TOL = 2e-2                         # tol·(1 + |ref|), as the kernels'
# name: (epilogue, dynamic row scales, n, k, K groups)
Q8_PRODUCTS = {
    "qkv": (q8.QEPI_OUT, True, 3 * C, C, 1),
    "proj": (q8.QEPI_RESID, True, C, C, 1),
    "fc1": (q8.QEPI_GELU_F32, True, HIDDEN, C, 1),
    "fc1_static": (q8.QEPI_GELU_Q8, False, HIDDEN, C, 1),
    "fc2": (q8.QEPI_RESID, True, C, HIDDEN, 4),
}
Q8_ERF_TOL = 1e-6               # GELU_F32: erf's last bits, tol·(1 + |ref|)


def _device_ms(fns: dict, iters: int) -> dict:
    """Profiler device ms per call of each of ``fns`` (BN: one width's
    product; "cuBLAS": the matmul), in one window: the GEMM kernels by
    their width, every other kernel cuBLAS's.  None where the window
    recorded nothing."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn in fns.values():
            for _ in range(iters):
                fn()
        torch.cuda.synchronize()
    ms = dict.fromkeys(fns, 0.0)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        width = re.search(r"gemm_kernel<(\d+), \d+>", e.key)
        key = int(width.group(1)) if width else "cuBLAS"
        ms[key] += e.self_device_time_total / 1e3 / iters
    return {k: v or None for k, v in ms.items()}


def _ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def _reference(epi, a, b, bias, aux):
    """The product and its epilogue in fp32 (gemm_tile.cuh's store_out)."""
    acc = a.float() @ b.float()
    if epi == vb._EPI_F32:
        return acc
    v = acc if epi == vb._EPI_NONE else acc + bias
    if epi == vb._EPI_BIAS_GELU:
        v = torch.nn.functional.gelu(v)
    v = v.to(torch.bfloat16)
    if epi == vb._EPI_BIAS_RESID:
        v = (aux.float() + v.float()).to(torch.bfloat16)
    return v


def run_int8(iters: int) -> bool:
    """The int8 products at every width and row count; see the module
    docstring."""
    lib, dev = q8._lib(), torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    inv = torch.tensor([127 / 1.5], device=dev)
    ok = True
    for name, (epi, dynamic, n, k, groups) in Q8_PRODUCTS.items():
        w = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                          dtype=torch.int8)
        w_t = w.t().contiguous()
        col = torch.rand(n, generator=gen, device=dev) * 2e-3 + 1e-4
        if not dynamic:
            col = col * 0.02
        bias = 0.1 * torch.randn(n, generator=gen, device=dev)
        widths = [bn for bn in WIDTHS if groups == 1 or bn <= 128]
        for rows in ROWS:
            a_q = torch.randint(-127, 128, (rows, k), generator=gen,
                                device=dev, dtype=torch.int8)
            row_scale = (torch.rand(rows, groups, generator=gen, device=dev)
                         * 0.02 + 1e-3) if dynamic else None
            resid = torch.randn(rows, n, generator=gen, device=dev).to(
                torch.bfloat16)
            out_dtype = {q8.QEPI_GELU_F32: torch.float32,
                         q8.QEPI_GELU_Q8: torch.int8}.get(epi, torch.bfloat16)
            outs = {}

            def product(bn, out):       # bn 0: the launcher's pick
                q8._gemm(lib, torch.bfloat16, epi, a_q, w_t, row_scale, col,
                         bias, resid, inv.data_ptr(), out, k // groups,
                         f"{name} BN={bn}", bn)

            for bn in (*widths, 0):
                outs[bn] = torch.empty(rows, n, dtype=out_dtype, device=dev)
                product(bn, outs[bn])
            torch.cuda.synchronize()
            ref = q8.gemm_q8_ref(epi, a_q, w, row_scale, col, bias, resid,
                                 inv, k // groups, torch.bfloat16)
            if epi == q8.QEPI_GELU_F32:
                err = float(((outs[64] - ref).abs() / (1 + ref.abs())).max())
                plain = err <= Q8_ERF_TOL
                what = f"max |err|/(1+|ref|) {err:.3e}"
            else:
                plain = torch.equal(outs[64], ref)
                what = f"bit-equal to the plain arithmetic {plain}"
            same = all(torch.equal(outs[64], o) for o in outs.values())
            good = same and plain
            ok = ok and good
            picked = ctypes.c_int()
            _build.check(lib, lib.dfu_q8_gemm_width(
                0, epi, rows, n, k, k // groups, ctypes.addressof(picked)),
                "pick_bn")
            ms = _device_ms({**{bn: (lambda bn=bn: product(bn, outs[bn]))
                                for bn in widths},
                             "cuBLAS": lambda: torch._int_mm(a_q, w_t.t())},
                            iters)
            ops = 2 * rows * n * k
            timed = [bn for bn in widths if ms[bn]]
            best = min(timed, key=ms.get) if timed else None
            rate = ("" if best is None else
                    f" ({ops / ms[best] / 1e9:.0f} TOP/s)")
            lib_rate = ("" if ms["cuBLAS"] is None else
                        f" ({ops / ms['cuBLAS'] / 1e9:.0f} TOP/s)")
            print(f"[int8 {name}] rows={rows} n={n} k={k} groups={groups}: "
                  f"every width and the pick bit-equal {same}, {what} "
                  f"{'ok' if good else 'FAIL'}; device ms "
                  + ", ".join(f"BN={bn} {_ms(ms[bn])}" for bn in widths)
                  + f"; fastest BN={best}{rate}; pick_bn BN={picked.value}; "
                  f"torch._int_mm {_ms(ms['cuBLAS'])}{lib_rate}", flush=True)
    return ok


def run(iters: int) -> bool:
    lib, dev = vb._lib(), torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (scale * torch.randn(*shape, generator=gen, device=dev)
                ).to(dtype)

    ok = True
    for name, (epi, trans_b, n, k) in PRODUCTS.items():
        w = randn(*((n, k) if trans_b else (k, n)), scale=k ** -0.5)
        bias = randn(n, scale=0.1, dtype=torch.float32)
        for rows in ROWS:
            a = randn(rows, k)
            aux = randn(rows, n)
            out_dtype = torch.float32 if epi == vb._EPI_F32 else torch.bfloat16
            outs = {}

            def product(bn, out):       # bn 0: the launcher's pick_bn
                _build.check(lib, lib.dfu_gemm_sm90(
                    0, epi, int(trans_b), bn, a.data_ptr(), w.data_ptr(),
                    bias.data_ptr(), aux.data_ptr(), out.data_ptr(), rows, n,
                    k, stream), f"{name} BN={bn}")

            for bn in (*WIDTHS, 0):
                outs[bn] = torch.empty(rows, n, dtype=out_dtype, device=dev)
                product(bn, outs[bn])
            torch.cuda.synchronize()
            ref = _reference(epi, a, w.t() if trans_b else w, bias, aux)
            err = float(((outs[64].float() - ref.float()).abs()
                         / (1 + ref.float().abs())).max())
            same = all(torch.equal(outs[64], o) for o in outs.values())
            good = same and err <= BF16_TOL
            ok = ok and good
            picked = ctypes.c_int()
            _build.check(lib, lib.dfu_gemm_sm90_width(
                0, int(trans_b), rows, n, k, ctypes.addressof(picked)),
                "pick_bn")
            wt = w.t() if trans_b else w
            ms = _device_ms({**{bn: (lambda bn=bn: product(bn, outs[bn]))
                                for bn in WIDTHS},
                             "cuBLAS": lambda: torch.matmul(a, wt)}, iters)
            flop = 2 * rows * n * k
            timed = [bn for bn in WIDTHS if ms[bn]]
            best = min(timed, key=ms.get) if timed else None
            rate = ("" if best is None else
                    f" ({flop / ms[best] / 1e9:.0f} TFLOP/s)")
            lib_rate = ("" if ms["cuBLAS"] is None else
                        f" ({flop / ms['cuBLAS'] / 1e9:.0f} TFLOP/s)")
            print(f"[{name}] rows={rows} n={n} k={k}: every width and the "
                  f"pick bit-equal {same}, max |err|/(1+|ref|) {err:.3e} "
                  f"{'ok' if good else 'FAIL'}; device ms "
                  + ", ".join(f"BN={bn} {_ms(ms[bn])}" for bn in WIDTHS)
                  + f"; fastest BN={best}{rate}; pick_bn BN={picked.value}; "
                  f"cuBLAS {_ms(ms['cuBLAS'])}{lib_rate}", flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--products", default="all",
                    choices=("all", "bf16", "int8"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_vit_fwd: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    ok = True
    if args.products in ("all", "bf16"):
        ok = run(args.iters) and ok
    if args.products in ("all", "int8"):
        ok = run_int8(args.iters) and ok
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
