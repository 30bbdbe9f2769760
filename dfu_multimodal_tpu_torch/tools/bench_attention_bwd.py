"""Where the time of the bf16 attention backward
(``ops/csrc/attention_bwd_mma.cuh``) goes, on one card.

    python -m dfu_multimodal_tpu_torch.tools.bench_attention_bwd [--iters 20]

Builds ``ops/csrc/attention.cu`` as it stands and, under
``build/dfu_multimodal_tpu_torch/bench_attention_bwd/``, copies whose
``attention_bwd_mma.cuh`` is edited by text substitution
(:data:`VARIANTS`):

- ``q_min3``: the query-side kernel bounded to three resident blocks an
  SM (at most 168 registers a thread; at D = 64 with ``WRITE_O`` it
  takes 167, so this one changes nothing);
- ``kv_free``, ``kv_min4``: the key-side kernel, which is bounded to
  three (168 registers), left unbounded (it takes 220, so two fit) or
  bounded to four (at most 128 registers);
- ``both``: ``q_min3`` and ``kv_min4`` together.

Launch bounds move only the register allocation, not the arithmetic, so
every variant must give the bits of the kernel as it stands.  Each build
runs in a process of its own, in turns (the kernel as it stands first
and last): K5 ``qkv_attention_fwdbwd`` in bf16 against its plain version
at a few shapes (ok / FAIL) with the sha1 of its outputs, then the
profiler's device ms of each of the two kernels for K5
and the K6 backward at B = 16 and 128 (N = 197) and at N = 577 (B = 16),
ViT-B/16's 12 heads of 64.  Prints the card's name and power limit
first.  Needs a CUDA device and nvcc; exits non-zero without them.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from dfu_multimodal_tpu_torch.ops import _build
from dfu_multimodal_tpu_torch.ops import attention as at

_Q = "__launch_bounds__(MMA_THREADS)\nattention_bwd_q_mma("
_KV = "__launch_bounds__(MMA_THREADS, 3)\nattention_bwd_kv_mma("
# (old, new) substitutions of attention_bwd_mma.cuh per variant
VARIANTS = {
    "q_min3": [(_Q, _Q.replace("MMA_THREADS)", "MMA_THREADS, 3)"))],
    "kv_free": [(_KV, _KV.replace("MMA_THREADS, 3)", "MMA_THREADS)"))],
    "kv_min4": [(_KV, _KV.replace("MMA_THREADS, 3)", "MMA_THREADS, 4)"))],
    "both": [(_Q, _Q.replace("MMA_THREADS)", "MMA_THREADS, 3)")),
             (_KV, _KV.replace("MMA_THREADS, 3)", "MMA_THREADS, 4)"))],
}
# (B, N) of the correctness cases, 12 heads of 64
CASES = ((2, 5), (16, 197), (2, 577))
# (B, N) of the timings
SHAPES = ((16, 197), (128, 197), (16, 577))
HEADS, C = 12, 768


def build_variant(name: str) -> str:
    """Compile attention.cu with the variant's attention_bwd_mma.cuh;
    returns the library's path."""
    out = _build.BUILD_ROOT / "bench_attention_bwd" / name
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build.CSRC, out)
    header = out / "attention_bwd_mma.cuh"
    src = header.read_text()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise RuntimeError(f"variant {name}: {old!r} not in the header")
        src = src.replace(old, new)
    header.write_text(src)
    so = out / "libattention.so"
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(out),
                           "-o", str(so), str(out / "attention.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stderr}")
    entry = ""      # ptxas's registers and spills of the D = 64 kernels
    for line in (proc.stdout + proc.stderr).splitlines():
        if "entry function" in line:
            entry = ("query side (WRITE_O)" if "bwd_q_mmaILi64ELb1" in line
                     else "key side" if "bwd_kv_mmaILi64" in line else "")
        elif entry and ("registers" in line or "spill" in line):
            print(f"[{name}] {entry}: {line.strip()}", flush=True)
    return str(so)


def _device_ms(fn, iters: int) -> dict:
    """Profiler device ms per call of the query-side and key-side
    kernels."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ms = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and "_mma" in e.key:
            side = "q" if "bwd_q_mma" in e.key else "kv"
            ms[side] = ms.get(side, 0.0) + (e.self_device_time_total / 1e3
                                            / iters)
    return ms


def run(tag: str, so: str, iters: int) -> None:
    """One turn, in this process: the checks and timings of the library
    at ``so`` (empty: the kernel as it stands)."""
    if so:      # bind the variant in place of the build of attention.cu
        lib = ctypes.CDLL(so)
        lib.dfu_error_string.argtypes = [ctypes.c_int]
        lib.dfu_error_string.restype = ctypes.c_char_p
        for fn, argtypes in at._SIGNATURES.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        _build._libs["attention"] = lib
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).bfloat16()

    for b, n in CASES:
        qkv, do = randn(b, n, 3 * C), randn(b, n, C)
        outs = at.qkv_attention_fwdbwd(qkv, do, HEADS)
        refs = at.qkv_attention_fwdbwd_ref(qkv, do, HEADS)
        err = max(float(((o.float() - r.float()).abs()
                         / (1 + r.float().abs())).max())
                  for o, r in zip(outs, refs))
        sha = hashlib.sha1()
        for t in outs:
            sha.update(t.view(-1).view(torch.uint8).cpu().numpy())
        print(f"[{tag}] K5 B={b} N={n}: max |err|/(1+|ref|) {err:.3e} "
              f"{'ok' if err <= 2e-2 else 'FAIL'}; sha1 "
              f"{sha.hexdigest()[:16]}", flush=True)
    for b, n in SHAPES:
        qkv, do = randn(b, n, 3 * C), randn(b, n, C)
        for name, fn in (
                ("K5", lambda: at.qkv_attention_fwdbwd(qkv, do, HEADS)),
                ("K6 bwd", lambda: at.qkv_attention_bwd(qkv, do, HEADS))):
            ms = _device_ms(fn, iters)
            print(f"[{tag}] {name} B={b} N={n}: device ms query side "
                  f"{ms.get('q', 0.0):.4f}, key side {ms.get('kv', 0.0):.4f}"
                  f", total {sum(ms.values()):.4f}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_attention_bwd: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    with ThreadPoolExecutor(1 + len(VARIANTS)) as pool:  # one nvcc each
        base = pool.submit(_build.build, "attention")
        builds = {k: pool.submit(build_variant, k) for k in VARIANTS}
        base.result()
        sos = {"as it stands": "", **{k: f.result()
                                      for k, f in builds.items()}}
    for tag in [*sos, "as it stands"]:
        code = (f"from dfu_multimodal_tpu_torch.tools.bench_attention_bwd "
                f"import run; run({tag!r}, {sos[tag]!r}, {args.iters})")
        proc = subprocess.run([sys.executable, "-c", code], timeout=600)
        if proc.returncode != 0:
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
