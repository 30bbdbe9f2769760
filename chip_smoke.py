"""Drive the PyTorch port's multimodal serving path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. device   — name, count, and nvidia-smi's name and power limit;
2. build    — nvcc builds the kernels from ops/csrc (sm_90a); prints the
              build seconds and ptxas's register / spill report;
3. kernels  — each hand-written kernel against its plain PyTorch version
              on the card at the serving path's shapes (ViT-B/16 blocks at
              B = 8 and 128 in fp32 and bf16, the fusion head at B = 8, 13,
              128 in fp32), with error and CUDA-event times;
4. slice    — the full-width multimodal model (ResNet50 + ViT-B/16, random
              weights from a seeded generator) behind Trainer +
              ServingEngine(max_batch=8) in bf16: 24 requests from 3
              threads, launch counts, and the card (bf16 and fp32) against
              the CPU's plain fp32 path on the same weights and inputs;
5. the kernels' JSON line, then the device JSON line last.

Exits non-zero with no result line when no CUDA device is present.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from dfu_multimodal_tpu_torch.models import zoo
from dfu_multimodal_tpu_torch.ops import _build
from dfu_multimodal_tpu_torch.ops import fused_mlp as fm
from dfu_multimodal_tpu_torch.ops import vit_block as vb
from dfu_multimodal_tpu_torch.serve.engine import ServingEngine
from dfu_multimodal_tpu_torch.train.engine import (Trainer, TrainConfig,
                                                   rgb_modality,
                                                   thermal_modality)


def log(msg: str = "") -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_errors(out: torch.Tensor, ref: torch.Tensor):
    err = (out.float() - ref.float()).abs()
    rel = err / ref.float().abs().clamp_min(1e-3)
    return float(err.max()), float(rel.max())


# ---------------------------------------------------------------- phase 1


def phase_device() -> str:
    name = torch.cuda.get_device_name(0)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{name}; device_count={torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    return name


# ---------------------------------------------------------------- phase 2


def phase_build() -> None:
    for name in ("vit_block", "fused_mlp"):
        t0 = time.perf_counter()
        _build.build(name)
        log(f"[build] {name}.cu: {time.perf_counter() - t0:.2f} s "
            f"-> {_build.library_path(name)}")
        for line in _build.ptxas_log(name).splitlines():
            if "registers" in line or "spill" in line or "entry" in line:
                log(f"[ptxas] {line.strip()}")
    # bind the entry points now, so a missing symbol fails this phase
    vb._lib()
    _build.load("fused_mlp", fm._SIGNATURES)


# ---------------------------------------------------------------- phase 3

KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _randn(gen, *shape, scale=1.0, offset=0.0, dtype=torch.float32):
    t = torch.randn(*shape, generator=gen, device=gen.device)
    return (offset + scale * t).to(dtype)


def _check_and_time(label, kernel, plain, tol):
    out = kernel()
    torch.cuda.synchronize()
    ref = plain()
    abs_err, rel_err = max_errors(out, ref)
    bound = tol * (1.0 + ref.float().abs())
    ok = bool(torch.isfinite(out.float()).all()) and bool(
        ((out.float() - ref.float()).abs() <= bound).all())
    k_ms, p_ms = cuda_ms(kernel), cuda_ms(plain)
    p_ms2, k_ms2 = cuda_ms(plain), cuda_ms(kernel)     # turns: p, k, k, p
    k_ms, p_ms = (k_ms + k_ms2) / 2, (p_ms + p_ms2) / 2
    log(f"[kernel] {label}: max_abs_err={abs_err:.3e} max_rel_err="
        f"{rel_err:.3e} tol=|err|<={tol:g}*(1+|ref|) kernel_ms={k_ms:.4f} "
        f"plain_ms={p_ms:.4f} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: kernel disagrees with its plain "
                             f"version (max abs err {abs_err:.3e})")
    return {"max_abs_err": abs_err, "ms": k_ms, "plain_ms": p_ms}


def phase_kernels(dev) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n, c, heads = 197, 768, 12
    main = {}
    for dtype in (torch.float32, torch.bfloat16):
        for b in (8, 128):
            g = torch.Generator(device=dev).manual_seed(b)
            x = _randn(g, b, n, c, dtype=dtype)
            ln = (_randn(g, c, scale=0.1, offset=1.0),
                  _randn(g, c, scale=0.1))
            wqkv = _randn(g, c, 3 * c, scale=c ** -0.5, dtype=dtype)
            bqkv = _randn(g, 3 * c, scale=0.1)
            wproj = _randn(g, c, c, scale=c ** -0.5, dtype=dtype)
            bproj = _randn(g, c, scale=0.1)
            w1 = _randn(g, c, 4 * c, scale=c ** -0.5, dtype=dtype)
            b1 = _randn(g, 4 * c, scale=0.1)
            w2 = _randn(g, 4 * c, c, scale=(4 * c) ** -0.5, dtype=dtype)
            b2 = _randn(g, c, scale=0.1)
            tag = f"{str(dtype).split('.')[1]} B={b}"
            attn = _check_and_time(
                f"attn_block {tag}",
                lambda: vb.attn_block(x, *ln, wqkv, bqkv, wproj, bproj,
                                      heads),
                lambda: vb.attn_block_ref(x, *ln, wqkv, bqkv, wproj, bproj,
                                          heads), KERNEL_TOL[dtype])
            mlp = _check_and_time(
                f"mlp_block {tag}",
                lambda: vb.mlp_block(x, *ln, w1, b1, w2, b2),
                lambda: vb.mlp_block_ref(x, *ln, w1, b1, w2, b2),
                KERNEL_TOL[dtype])
            if dtype == torch.bfloat16 and b == 8:   # the serving shape
                main["attn_block"], main["mlp_block"] = attn, mlp
            del x, wqkv, wproj, w1, w2
            torch.cuda.empty_cache()
    dims = (2816, 512, 256, 2)
    for b in (8, 13, 128):
        g = torch.Generator(device=dev).manual_seed(1000 + b)
        args = [_randn(g, b, dims[0])]
        for din, dout in zip(dims[:-1], dims[1:]):
            args += [_randn(g, din, dout, scale=din ** -0.5),
                     _randn(g, dout, scale=0.1)]
        res = _check_and_time(f"fused_mlp float32 B={b}",
                              lambda: fm.fused_mlp(*args),
                              lambda: fm.fused_mlp_ref(*args),
                              KERNEL_TOL[torch.float32])
        if b == 8:
            main["fused_mlp"] = res
    return main


# ---------------------------------------------------------------- phase 4

N_REQUESTS, N_THREADS, IMAGE = 24, 3, 224
# card vs CPU (plain fp32) on the same weights and inputs: fp32 differs
# only in summation order; bf16 rounds every activation to 8 bits
SLICE_TOL = {"float32": {"logits": 1e-3, "probs": 1e-4},
             "bfloat16": {"logits": 1e-1, "probs": 5e-2}}


def _trainer(dtype: str, device):
    return Trainer("multimodal", TrainConfig(compute_dtype=dtype),
                   {"rgb": rgb_modality(), "thermal": thermal_modality()},
                   device=device, image_size=IMAGE)


def _logits(trainer, batch):
    with torch.inference_mode():
        trainer.module.eval()
        inputs = {m: torch.as_tensor(batch[m]).to(trainer.device)
                  for m in batch}
        return trainer.module(*trainer._preprocess_eval(inputs)).float().cpu()


def phase_slice(dev) -> dict:
    torch.cuda.reset_peak_memory_stats(dev)
    served = _trainer("bfloat16", dev)
    zoo.init_model(served.module, torch.Generator(device=dev).manual_seed(0))
    n_params = zoo.param_count(served.module)
    log(f"[slice] multimodal at {IMAGE}x{IMAGE}: {n_params:,} params on "
        f"{dev}, compute bfloat16")
    if n_params != 110_880_834:
        raise AssertionError(f"param count {n_params} != 110,880,834")

    rng = np.random.default_rng(0)
    samples = [{m: rng.integers(0, 256, (IMAGE, IMAGE, 3), dtype=np.uint8)
                for m in ("rgb", "thermal")} for _ in range(N_REQUESTS)]
    engine = ServingEngine(served, image_size=IMAGE, max_batch=8)
    t0 = time.perf_counter()
    engine.warmup()
    torch.cuda.synchronize()
    log(f"[slice] warmup of buckets {engine.buckets}: "
        f"{time.perf_counter() - t0:.2f} s")

    futures = [None] * N_REQUESTS
    errors = []

    def client(k: int) -> None:
        try:
            pace = np.random.default_rng(100 + k)
            for i in range(k, N_REQUESTS, N_THREADS):
                futures[i] = engine.submit(samples[i])
                time.sleep(float(pace.uniform(0.0, 0.02)))
        except Exception as exc:              # re-raised below
            errors.append(exc)

    t0 = time.perf_counter()
    with engine:
        log(f"[slice] engine start (every bucket on the batcher thread): "
            f"{time.perf_counter() - t0:.3f} s")
        vb.attn_block.launches = vb.mlp_block.launches = 0
        fm.fused_mlp.launches = 0
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(N_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if errors:
            raise errors[0]
        results = [f.result(timeout=600) for f in futures]
    launches = {"attn_block": vb.attn_block.launches,
                "mlp_block": vb.mlp_block.launches,
                "fused_mlp": fm.fused_mlp.launches}
    stats = engine.stats()
    peak = torch.cuda.max_memory_allocated(dev)
    hist = stats["batch_size_hist"]
    n_batches = sum(hist.values())
    log(f"[slice] {stats['requests']} requests in {n_batches} batches, "
        f"batch sizes {hist}, errors {stats['errors']}")
    log(f"[slice] request latency p50={stats['latency_ms']['p50']:.3f} ms "
        f"p99={stats['latency_ms']['p99']:.3f} ms; peak device memory "
        f"{peak / 2**20:.1f} MiB")
    log(f"[slice] launches {launches}")

    probs = np.array([p for p, _ in results])
    if stats["requests"] != N_REQUESTS or stats["errors"]:
        raise AssertionError(f"stats counted {stats['requests']} requests, "
                             f"{stats['errors']} errors")
    if not (np.isfinite(probs).all() and (probs >= 0).all()
            and (probs <= 1).all()):
        raise AssertionError(f"served probabilities out of [0, 1]: {probs}")
    want = {"attn_block": 12 * n_batches, "mlp_block": 12 * n_batches,
            "fused_mlp": n_batches}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")

    # the card (served bf16, and fp32) against the CPU's plain fp32 path
    cpu = _trainer("float32", "cpu")
    cpu.module.load_state_dict(served.variables())
    card32 = _trainer("float32", dev)
    card32.module.load_state_dict(served.variables())
    batches = [{m: np.stack([s[m] for s in samples[i:i + 8]])
                for m in ("rgb", "thermal")}
               for i in range(0, N_REQUESTS, 8)]
    ref = torch.cat([_logits(cpu, b) for b in batches])
    ref_probs = torch.softmax(ref, -1)[:, 1].numpy()
    scale = 1.0 + float(ref.abs().max())
    for dtype, trainer in (("float32", card32), ("bfloat16", served)):
        logits = torch.cat([_logits(trainer, b) for b in batches])
        dl = float((logits - ref).abs().max())
        p = (torch.softmax(logits, -1)[:, 1].numpy() if dtype == "float32"
             else probs)
        dp = float(np.abs(p - ref_probs).max())
        tol = SLICE_TOL[dtype]
        ok = dl <= tol["logits"] * scale and dp <= tol["probs"]
        log(f"[slice] card {dtype} vs CPU float32: max|dlogit|={dl:.3e} "
            f"(tol {tol['logits']:g}*(1+max|logit|={scale:.3f})), "
            f"max|dprob|={dp:.3e} (tol {tol['probs']:g}), preds agree "
            f"{int((logits.argmax(-1) == ref.argmax(-1)).sum())}/"
            f"{N_REQUESTS} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"card {dtype} disagrees with the CPU")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    name = phase_device()
    phase_build()
    main_shapes = phase_kernels(dev)
    launches = phase_slice(dev)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    sources = {"attn_block": ("vit_block.cu", "vit_block.py:122"),
               "mlp_block": ("vit_block.cu", "vit_block.py:564"),
               "fused_mlp": ("fused_mlp.cu", "fused_mlp.py:27")}
    kernels = [{"name": k, "route": "cuda",
                "source": f"dfu_multimodal_tpu_torch/ops/csrc/{src}",
                "replaces": f"dfu_multimodal_tpu/ops/{tpu}",
                "launches": launches[k], **main_shapes[k]}
               for k, (src, tpu) in sources.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
