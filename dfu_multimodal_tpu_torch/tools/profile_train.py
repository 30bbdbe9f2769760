"""Where the time of the thermal_only train step goes, on one card.

    python -m dfu_multimodal_tpu_torch.tools.profile_train [--steps 3]
        [--top 25] [--block-impl fused|flax]
        [--attention-impl auto|pallas|xla] [--eval-multimodal]
        [--eval-int8 dynamic|static] [--eval-rgb-only fused|flax]

Builds the full-width thermal_only ViT-B/16 through :func:`recipe_trainer`
(seeded weights, bf16 compute, the thermal recipe's batch of 16 — the
trainer ``chip_smoke.py`` drives; ``--block-impl fused``, the default,
runs the fused blocks K1/K2 with their K4/K5 backward, ``--block-impl
flax`` the flax blocks with the packed-qkv attention K6 under
``--attention-impl pallas``), runs two warm-up steps on the first
batch of :func:`synthetic_thermal`, then ``--steps`` train steps under
``torch.profiler`` and prints: the card's name and power limit, the
host-clock step time, device time by kernel (self time, summed over the
window and per step, largest first), the device's busy time and idle
share of the window, and one JSON line with the totals.
``--eval-multimodal`` profiles the serving path's step instead: the
full-width multimodal model (ResNet-50 + ViT-B/16 on K1/K2, the fusion
head on K3; seeded weights, bf16) through ``Trainer.eval_step`` on a
batch of 8 random image pairs (``ServingEngine``'s largest bucket), each
step ending in a copy of the probabilities to the host.
``--eval-int8`` profiles the int8 serving step: the full-width
thermal_only ViT-B/16 (seeded weights, bf16) quantised on the card,
``dynamic`` by ``quantize_for_serving`` (K7's blocks), ``static`` by
``quantize_variables`` calibrated on 16 synthetic images (K8's blocks),
through ``Trainer.eval_step`` on a batch of 8 random thermal images, each
step ending in the probabilities' copy to the host.
``--eval-rgb-only`` profiles the rgb_only serving step: the full-width
ResNet-50 (seeded weights, bf16) with its stride-1 bottlenecks on K11
(``fused``) or on cuDNN (``flax``), through ``Trainer.eval_step`` on a
batch of 8 random RGB images, each step ending in the probabilities' copy
to the host.  Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from dfu_multimodal_tpu_torch.data.transforms import eval_normalize
from dfu_multimodal_tpu_torch.models import zoo
from dfu_multimodal_tpu_torch.models.vit import quantize_variables
from dfu_multimodal_tpu_torch.train.engine import (Trainer, TrainConfig,
                                                   class_weights_from_labels,
                                                   rgb_modality,
                                                   thermal_modality)


# the thermal recipe (cli/train_thermal_only.py): batch 16 at 224x224
TRAIN_BATCH, IMAGE = 16, 224
EVAL_BATCH = 8                  # ServingEngine's largest bucket


def synthetic_thermal(n: int, seed: int = 0):
    """(images (n, 224, 224, 3) uint8, labels (n,) int32), random from
    ``seed``."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, n).astype(np.int32)
    images = rng.integers(0, 256, (n, IMAGE, IMAGE, 3), dtype=np.uint8)
    return images, labels


def recipe_trainer(device, labels, block_impl: str = "fused",
                   attention_impl: str = "auto") -> Trainer:
    """The full-width thermal_only ViT-B/16 as the recipe trains it: bf16
    compute, batch 16, class weights from ``labels``, weights drawn from a
    generator seeded with 0; ``block_impl`` / ``attention_impl`` pick the
    trunk's blocks."""
    trainer = Trainer("thermal_only",
                      TrainConfig(batch_size=TRAIN_BATCH,
                                  compute_dtype="bfloat16"),
                      {"thermal": thermal_modality()},
                      class_weights=class_weights_from_labels(labels),
                      device=device, image_size=IMAGE,
                      block_impl=block_impl, attention_impl=attention_impl)
    zoo.init_model(trainer.module,
                   torch.Generator(device=device).manual_seed(0))
    return trainer


def _multimodal_eval(device):
    """One serving step of the full-width multimodal model in bf16 (seeded
    weights) on a batch of EVAL_BATCH random image pairs, ending in the
    probabilities' copy to the host."""
    trainer = Trainer("multimodal", TrainConfig(compute_dtype="bfloat16"),
                      {"rgb": rgb_modality(), "thermal": thermal_modality()},
                      device=device, image_size=IMAGE)
    zoo.init_model(trainer.module,
                   torch.Generator(device=device).manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {m: rng.integers(0, 256, (EVAL_BATCH, IMAGE, IMAGE, 3),
                             dtype=np.uint8) for m in ("rgb", "thermal")}

    def step():
        with torch.inference_mode():
            trainer.eval_step(batch)["probs"].cpu()
    return step


def _rgb_only_eval(device, block_impl: str):
    """One serving step of the full-width rgb_only ResNet-50 in bf16
    (seeded weights) with ``block_impl`` on a batch of EVAL_BATCH random
    RGB images, ending in the probabilities' copy to the host."""
    trainer = Trainer("rgb_only", TrainConfig(compute_dtype="bfloat16"),
                      {"rgb": rgb_modality()}, device=device,
                      image_size=IMAGE, block_impl=block_impl)
    zoo.init_model(trainer.module,
                   torch.Generator(device=device).manual_seed(0))
    batch = {"rgb": np.random.default_rng(0).integers(
        0, 256, (EVAL_BATCH, IMAGE, IMAGE, 3), dtype=np.uint8)}

    def step():
        with torch.inference_mode():
            trainer.eval_step(batch)["probs"].cpu()
    return step


def _int8_eval(device, scales: str):
    """One int8 serving step of the full-width thermal_only model in bf16
    (seeded weights), quantised on the card with ``dynamic`` or
    calibrated ``static`` activation scales, on a batch of EVAL_BATCH
    random thermal images, ending in the probabilities' copy to the
    host."""
    from dfu_multimodal_tpu_torch.serve.engine import quantize_for_serving
    images, _ = synthetic_thermal(EVAL_BATCH + 16, seed=3)
    base = Trainer("thermal_only", TrainConfig(compute_dtype="bfloat16"),
                   {"thermal": thermal_modality()}, device=device,
                   image_size=IMAGE)
    zoo.init_model(base.module,
                   torch.Generator(device=device).manual_seed(0))
    if scales == "dynamic":
        trainer = quantize_for_serving(base, image_size=IMAGE)
    else:
        calib = eval_normalize(torch.as_tensor(images[EVAL_BATCH:],
                                               device=device),
                               thermal_modality(), torch.float32)
        trainer = Trainer("thermal_only",
                          TrainConfig(compute_dtype="bfloat16"),
                          {"thermal": thermal_modality()}, device=device,
                          image_size=IMAGE, block_impl="fused_q8s")
        trainer.module.load_state_dict(
            quantize_variables(base.variables(), calib_batches=[calib]))
    batch = {"thermal": images[:EVAL_BATCH]}

    def step():
        with torch.inference_mode():
            trainer.eval_step(batch)["probs"].cpu()
    return step


def _device_ms(event) -> float:
    us = getattr(event, "self_device_time_total", None)
    if us is None:                     # older torch
        us = event.self_cuda_time_total
    return us / 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--block-impl", default="fused", choices=("fused",
                                                              "flax"))
    ap.add_argument("--attention-impl", default="auto",
                    choices=("auto", "pallas", "xla"))
    ap.add_argument("--eval-multimodal", action="store_true")
    ap.add_argument("--eval-int8", choices=("dynamic", "static"))
    ap.add_argument("--eval-rgb-only", choices=("fused", "flax"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)

    if args.eval_multimodal:
        step, batch_size, what = _multimodal_eval(dev), EVAL_BATCH, "eval"
    elif args.eval_int8:
        step, batch_size, what = (_int8_eval(dev, args.eval_int8),
                                  EVAL_BATCH, "eval")
    elif args.eval_rgb_only:
        step, batch_size, what = (_rgb_only_eval(dev, args.eval_rgb_only),
                                  EVAL_BATCH, "eval")
    else:
        images, labels = synthetic_thermal(TRAIN_BATCH)
        batch = {"thermal": images, "label": labels,
                 "valid": np.ones(TRAIN_BATCH, np.float32)}
        trainer = recipe_trainer(dev, labels, args.block_impl,
                                 args.attention_impl)
        gen = torch.Generator(device=dev).manual_seed(1)

        def step():
            trainer.train_step(batch, gen)
        batch_size, what = TRAIN_BATCH, "train"
    for _ in range(2):
        step()
    torch.cuda.synchronize(dev)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: an operator's own "self device time" repeats the time
    # of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and _device_ms(e) > 0]
    busy_ms = sum(_device_ms(e) for e in events)
    events.sort(key=_device_ms, reverse=True)
    label = ("multimodal eval" if args.eval_multimodal else
             f"thermal_only int8 eval, {args.eval_int8} scales"
             if args.eval_int8 else
             f"rgb_only eval, block_impl {args.eval_rgb_only}"
             if args.eval_rgb_only else
             f"block_impl {args.block_impl}, attention_impl "
             f"{args.attention_impl}")
    print(f"[profile] {label}, batch {batch_size}, {args.steps} "
          f"{what} steps: host "
          f"{wall_ms / args.steps:.3f} ms per step; device busy "
          f"{busy_ms / args.steps:.3f} ms per step; idle share "
          f"{1.0 - busy_ms / wall_ms:.4f}", flush=True)
    for e in events[:args.top]:
        ms = _device_ms(e)
        print(f"[profile] {ms / args.steps:9.3f} ms/step {ms / busy_ms:7.2%} "
              f"calls/step {e.count / args.steps:7.1f}  {e.key[:110]}",
              flush=True)
    print(json.dumps({"step": what, "block_impl": args.block_impl,
                      "eval_int8": args.eval_int8,
                      "eval_rgb_only": args.eval_rgb_only,
                      "attention_impl": args.attention_impl,
                      "batch": batch_size, "steps": args.steps,
                      "step_ms": wall_ms / args.steps,
                      "device_busy_ms": busy_ms / args.steps,
                      "idle_share": 1.0 - busy_ms / wall_ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
