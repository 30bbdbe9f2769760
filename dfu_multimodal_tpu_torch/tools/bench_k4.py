"""Where the time of the bf16 K4 products (``ops/csrc/gemm_sm90.cuh``)
goes, on one card.

    python -m dfu_multimodal_tpu_torch.tools.bench_k4 [--iters 20]

Builds ``ops/csrc/vit_block.cu`` as it stands and, under
``build/dfu_multimodal_tpu_torch/bench_k4/``, copies whose
``gemm_sm90.cuh`` is edited by text substitution (:data:`VARIANTS`):

- ``swap_mn``: the MN-major B descriptor's LBO and SBO exchanged, which
  must disagree with the plain version (the fields' meaning is shown,
  not assumed);
- ``no_math``: the dual product's epilogue without GELU and dGELU;
- ``no_store``: no epilogue at all (the products alone);
- ``wait1``: a stage released one k step later (wait_group 1, one group
  of products left in flight).

Each build runs in a process of its own, in turns (the kernel as it
stands first and last): ``mlp_block_bwd`` in bf16 against its plain
version at a few shapes (ok / FAIL; a variant that edits the epilogue
fails by design, ``no_store`` leaves its outputs unwritten), then the
profiler's device ms of the dual product and of dy at 3152 rows (B = 16
of ViT-B/16) with C = 384, 768, 1536 and 3072 (hidden 3072: the same
tiles, so the per-tile cost splits from the per-k-step cost), and at B =
128. Prints the card's name and power limit first. Needs a CUDA device
and nvcc; exits non-zero without them.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from dfu_multimodal_tpu_torch.ops import _build
from dfu_multimodal_tpu_torch.ops import vit_block as vb

# (old, new) substitutions of gemm_sm90.cuh per variant
VARIANTS = {
    "swap_mn": [("desc_sw128(st + T::B1 + 2048 * kk, BOX_MN, 1024)",
                 "desc_sw128(st + T::B1 + 2048 * kk, 1024, BOX_MN)")],
    "no_math": [("acc2[i] *= dgelu_erf(hp0);", "acc2[i] *= hp0;"),
                ("acc2[i + 1] *= dgelu_erf(hp1);", "acc2[i + 1] *= hp1;"),
                ("gelu_erf(hp0), gelu_erf(hp1));", "hp0, hp1);")],
    "no_store": [("      if constexpr (DUAL) {\n        // h to this group",
                  "      if (p.k > 0) {   // always: no epilogue\n"
                  "      } else if constexpr (DUAL) {\n        // h to this "
                  "group")],
    "wait1": [("      for (int kb = 0; kb < kblocks; ++kb) {\n"
               "        mbar_wait(full",
               "      int prev = 0;\n"
               "      for (int kb = 0; kb < kblocks; ++kb) {\n"
               "        mbar_wait(full"),
              ("        wgmma_wait();       // this stage's products have "
               "read it\n"
               "        if (threadIdx.x % 128 == 0) mbar_arrive(empty + 8 * "
               "stage);\n",
               "        if (kb > 0) {\n"
               "          asm volatile(\"wgmma.wait_group.sync.aligned 1;\" :::"
               " \"memory\");\n"
               "          if (threadIdx.x % 128 == 0) mbar_arrive(empty + 8 * "
               "prev);\n"
               "        }\n"
               "        prev = stage;\n"),
              ("      fence_regs(acc1);\n"
               "      if constexpr (DUAL) fence_regs(acc2);\n\n"
               "      // epilogue",
               "      wgmma_wait();\n"
               "      if (threadIdx.x % 128 == 0) mbar_arrive(empty + 8 * "
               "prev);\n"
               "      fence_regs(acc1);\n"
               "      if constexpr (DUAL) fence_regs(acc2);\n\n"
               "      // epilogue")],
}
# (B, N, C) of the correctness cases: one row, a ragged 129, B = 16, and
# widths past the 128-column tile and the 64-deep k step
CASES = ((1, 1, 768), (1, 129, 768), (16, 197, 768), (2, 20, 40))
# (rows, C, hidden) of the timings
SHAPES = ((3152, 384, 3072), (3152, 768, 3072), (3152, 1536, 3072),
          (3152, 3072, 3072), (25216, 768, 3072))


def build_variant(name: str) -> str:
    """Compile vit_block.cu with the variant's gemm_sm90.cuh; returns the
    library's path."""
    out = _build.BUILD_ROOT / "bench_k4" / name
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build.CSRC, out)
    header = out / "gemm_sm90.cuh"
    src = header.read_text()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise RuntimeError(f"variant {name}: {old!r} not in the header")
        src = src.replace(old, new)
    header.write_text(src)
    so = out / "libvit_block.so"
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(out),
                           "-o", str(so), str(out / "vit_block.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stderr}")
    return str(so)


def _device_ms(fn, iters: int) -> dict:
    """Profiler device ms per call of the dual and dy kernels."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ms = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and "gemm_kernel" in e.key:
            ms["dual" if "true" in e.key else "dy"] = (
                e.self_device_time_total / 1e3 / iters)
    return ms


def run(tag: str, so: str, iters: int) -> None:
    """One turn, in this process: the checks and timings of the library
    at ``so`` (empty: the kernel as it stands)."""
    if so:      # bind the variant in place of the build of vit_block.cu
        lib = ctypes.CDLL(so)
        lib.dfu_error_string.argtypes = [ctypes.c_int]
        lib.dfu_error_string.restype = ctypes.c_char_p
        for fn, argtypes in vb._SIGNATURES.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        _build._libs["vit_block"] = lib
    lib, dev = vb._lib(), torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (scale * torch.randn(*shape, generator=gen, device=dev)
                ).to(dtype)

    for b, n, c in CASES:
        args = (randn(b, n, c), randn(b, n, c),
                1 + randn(c, scale=0.1, dtype=torch.float32),
                randn(c, scale=0.1, dtype=torch.float32),
                randn(c, 4 * c, scale=c ** -0.5),
                randn(4 * c, scale=0.1, dtype=torch.float32),
                randn(4 * c, c, scale=(4 * c) ** -0.5))
        outs, refs = vb.mlp_block_bwd(*args), vb.mlp_block_bwd_ref(*args)
        err = max(float(((o.float() - r.float()).abs()
                         / (1 + r.float().abs())).max())
                  for o, r in zip(outs, refs))
        print(f"[{tag}] B={b} N={n} C={c}: max |err|/(1+|ref|) {err:.3e} "
              f"{'ok' if err <= 2e-2 else 'FAIL'}", flush=True)
    for rows, c, hidden in SHAPES:
        y, g = randn(rows, c), randn(rows, c)
        w1 = randn(c, hidden, scale=c ** -0.5)
        w2 = randn(hidden, c, scale=hidden ** -0.5)
        b1 = randn(hidden, scale=0.1, dtype=torch.float32)
        h = torch.empty(rows, hidden, dtype=torch.bfloat16, device=dev)
        dhpre = torch.empty_like(h)
        dy = torch.empty(rows, c, device=dev)

        def products():
            _build.check(lib, lib.dfu_mlp_block_bwd_gemms(
                0, y.data_ptr(), g.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                w2.data_ptr(), h.data_ptr(), dhpre.data_ptr(), dy.data_ptr(),
                rows, c, hidden, torch.cuda.current_stream().cuda_stream),
                "products")

        ms = _device_ms(products, iters)
        flop = 2 * rows * c * hidden
        print(f"[{tag}] rows={rows} C={c} hidden={hidden}: dual "
              f"{ms['dual']:.4f} ms ({2 * flop / ms['dual'] / 1e9:.0f} "
              f"TFLOP/s), dy {ms['dy']:.4f} ms "
              f"({flop / ms['dy'] / 1e9:.0f} TFLOP/s)", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_k4: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    with ThreadPoolExecutor(1 + len(VARIANTS)) as pool:  # one nvcc each
        base = pool.submit(_build.build, "vit_block")
        builds = {k: pool.submit(build_variant, k) for k in VARIANTS}
        base.result()
        sos = {"as it stands": "", **{k: f.result()
                                      for k, f in builds.items()}}
    turns = [*sos, "as it stands"]
    for tag in turns:
        code = (f"from dfu_multimodal_tpu_torch.tools.bench_k4 import run; "
                f"run({tag!r}, {sos[tag]!r}, {args.iters})")
        proc = subprocess.run([sys.executable, "-c", code], timeout=600)
        if proc.returncode != 0:
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
