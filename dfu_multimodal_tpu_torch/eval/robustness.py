"""Corruption-robustness sweep (the port's counterpart of
``dfu_multimodal_tpu/eval/robustness.py``; `dfu robustness`).

No reference counterpart — the reference's only robustness probe is TTA
(notebooks/test_time_augmentation.py:404-441: clean-vs-TTA F1 with
robust/moderate verdicts at 0.05/0.15 drops).  Deployment cameras
degrade in specific, *parametric* ways (sensor noise, defocus blur,
exposure drift, contrast loss); this module measures F1 as a function
of corruption type × severity, per input modality — an ImageNet-C-style
sweep on the model's own test split.

Each corruption is a plain torch function of float [0, 255] NHWC images,
applied on the trainer's device inside the eval step's forward, before
``eval_normalize`` (which takes float [0, 255] as it takes uint8); the
model then runs its eval forward (on the card: the ViT blocks on K1/K2,
the fusion head on K3, a fused ResNet trunk on K11).  JAX dispatches the
corruption through ``lax.switch`` with a traced severity only so that one
compiled program serves the grid; eager PyTorch has nothing to compile.

Noise: batch ``b``'s input ``i`` draws its standard normal from TTA's
stream of (seed, b, i) (``eval/tta.py::tta_generator``; the same draw at
every severity, as JAX folds ``b`` and then ``i`` into
``PRNGKey(seed)``).  JAX's PRNG stream cannot be reproduced in torch,
so the noise corruption takes the draw as an argument and the tests inject
JAX's.  Verdicts reuse the reference's TTA thresholds so the two
robustness reports read on one scale.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from dfu_multimodal_tpu_torch.data import loader as data_loader
from dfu_multimodal_tpu_torch.data.transforms import eval_normalize
from dfu_multimodal_tpu_torch.eval import metrics as metrics_mod
from dfu_multimodal_tpu_torch.eval.tta import tta_generator

# severity 1-5 parameter grids (uint8-scale units where applicable)
SEVERITY_PARAMS: Dict[str, Tuple[float, ...]] = {
    "gaussian_noise": (4.0, 8.0, 16.0, 24.0, 32.0),      # noise sigma
    "gaussian_blur": (0.5, 1.0, 1.5, 2.0, 3.0),          # blur sigma
    "brightness": (8.0, 16.0, 32.0, 48.0, 64.0),         # +delta
    "contrast": (0.85, 0.70, 0.55, 0.40, 0.30),          # scale factor
}
CORRUPTIONS = tuple(SEVERITY_PARAMS)

_BLUR_RADIUS = 5        # 11-tap separable kernel


def _blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """(B,H,W,C) separable Gaussian blur, edge-padded, sigma floored at
    1e-3; the taps summed in JAX's order."""
    offs = torch.arange(-_BLUR_RADIUS, _BLUR_RADIUS + 1,
                        dtype=torch.float32, device=x.device)
    sigma = torch.tensor(sigma, dtype=torch.float32, device=x.device)
    kern = torch.exp(-0.5 * (offs / torch.clamp(sigma, min=1e-3)) ** 2)
    kern = kern / torch.sum(kern)

    def conv_axis(img, axis):
        n = img.shape[axis]
        edge = torch.arange(-_BLUR_RADIUS, n + _BLUR_RADIUS,
                            device=img.device).clamp(0, n - 1)
        padded = img.index_select(axis, edge)
        out = torch.zeros_like(img)
        for i in range(2 * _BLUR_RADIUS + 1):
            out = out + kern[i] * padded.narrow(axis, i, n)
        return out

    return conv_axis(conv_axis(x, 1), 2)


def _noise(x, param, noise):
    if noise is None:
        raise ValueError("gaussian_noise needs its standard-normal draw")
    return x + param * noise


def _brightness(x, param, noise):
    return x + param


def _contrast(x, param, noise):
    mean = torch.mean(x, dim=(1, 2, 3), keepdim=True)
    return mean + param * (x - mean)


_CORRUPTION_FNS = {"gaussian_noise": _noise,
                   "gaussian_blur": lambda x, p, n: _blur(x, p),
                   "brightness": _brightness,
                   "contrast": _contrast}
assert tuple(_CORRUPTION_FNS) == CORRUPTIONS


def apply_corruption(name: str, images_f: torch.Tensor, param: float,
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Corrupt float-[0,255] images; returns clipped float [0,255].
    ``noise``: the standard-normal draw of ``images_f``'s shape that
    ``gaussian_noise`` scales by ``param`` (the others ignore it)."""
    if name not in _CORRUPTION_FNS:
        raise ValueError(f"unknown corruption {name!r} "
                         f"(choose from {sorted(SEVERITY_PARAMS)})")
    return torch.clamp(_CORRUPTION_FNS[name](images_f, param, noise),
                       0.0, 255.0)


def make_step(trainer, corrupt_inputs: Iterable[str]):
    """The eval step of a modality subset under a corruption:
    ``step(batch, name, param, seed, batch_index)`` -> the batch's
    confusion counts [tn, fp, fn, tp] on the device, the corruption
    applied to the inputs in ``corrupt_inputs`` only."""
    corrupt_set = frozenset(corrupt_inputs)
    unknown = corrupt_set - set(trainer.spec.inputs)
    if unknown:
        raise ValueError(f"model {trainer.spec.name!r} has no input(s) "
                         f"{sorted(unknown)}")
    spec, mods = trainer.spec, trainer.modalities
    dtype = trainer.compute_dtype

    @torch.inference_mode()
    def step(batch, name: str, param: float, seed: int, batch_index: int):
        trainer.module.eval()
        inputs = []
        for i, m in enumerate(spec.inputs):
            x = batch[m].float()
            if m in corrupt_set:
                noise = None
                if name == "gaussian_noise":
                    noise = torch.randn(
                        x.shape, generator=tta_generator(
                            seed, batch_index, i, x.device),
                        device=x.device)
                x = apply_corruption(name, x, param, noise)
            # eval_normalize handles float [0,255] directly
            inputs.append(eval_normalize(x, mods[m], dtype))
        logits = trainer._forward(*inputs).float()
        preds = torch.argmax(logits, dim=-1)
        return metrics_mod.confusion_counts(preds, batch["label"],
                                            batch["valid"])

    return step


def corrupted_counts(trainer, dataset, name: str,
                     corrupt_inputs: Iterable[str], severities: List[int],
                     seed: int = 0, step=None) -> List[np.ndarray]:
    """Confusion counts per severity level, streaming the dataset once
    per level.  Pass ``step`` (from :func:`make_step`) to reuse one step
    across corruptions, as :func:`sweep` does."""
    if name not in SEVERITY_PARAMS:
        raise ValueError(f"unknown corruption {name!r} "
                         f"(choose from {sorted(SEVERITY_PARAMS)})")
    if step is None:
        step = make_step(trainer, corrupt_inputs)
    params_grid = SEVERITY_PARAMS[name]
    bad = [s for s in severities if not 1 <= int(s) <= len(params_grid)]
    if bad:
        # severity 0 would silently negative-index to the HARSHEST level
        raise ValueError(
            f"severities must be in 1..{len(params_grid)}, got {bad}")
    out = []
    for sev in severities:
        param = params_grid[sev - 1]
        counts = [step(batch, name, param, seed, bi)
                  for bi, batch in enumerate(data_loader.device_prefetch(
                      data_loader.batch_slices(
                          dataset, np.arange(len(dataset)),
                          trainer.cfg.eval_bs), trainer.device))]
        out.append(torch.stack(counts).sum(0).cpu().numpy())
    return out


def verdict(clean_f1: float, f1: float) -> str:
    """The reference's TTA robustness thresholds
    (test_time_augmentation.py:404-441): drop <0.05 robust, <0.15
    moderate, else fragile."""
    drop = clean_f1 - f1
    if drop < 0.05:
        return "robust"
    if drop < 0.15:
        return "moderate"
    return "fragile"


def sweep(trainer, dataset, corruptions: Iterable[str],
          severities: List[int], modality_subsets: List[Tuple[str, ...]],
          seed: int = 0, log=print) -> Dict:
    """Full sweep -> report dict (also the robustness_report.json
    payload)."""
    clean_m, _ = trainer.run_eval_epoch(dataset)
    report = {"model": trainer.spec.name, "n": len(dataset),
              "clean_f1": clean_m.f1, "clean_acc": clean_m.accuracy,
              "severities": list(severities), "results": []}
    log(f"clean: F1 {clean_m.f1:.4f}, acc {clean_m.accuracy:.4f}")
    for subset in modality_subsets:
        step = make_step(trainer, subset)
        for name in corruptions:
            rows = corrupted_counts(trainer, dataset, name, subset,
                                    severities, seed=seed, step=step)
            f1s = [metrics_mod.f1_from_counts(c) for c in rows]
            accs = [metrics_mod.accuracy_from_counts(c) for c in rows]
            worst = min(f1s)
            entry = {"corruption": name, "modalities": list(subset),
                     "f1": [round(float(v), 4) for v in f1s],
                     "acc": [round(float(v), 4) for v in accs],
                     "worst_f1": round(float(worst), 4),
                     "verdict": verdict(clean_m.f1, float(worst))}
            report["results"].append(entry)
            log(f"{'+'.join(subset):>12s} {name:<15s} "
                + " ".join(f"{v:.3f}" for v in f1s)
                + f"  [{entry['verdict']}]")
    return report
