"""Frozen serving bundles: ahead-of-time ``torch.export`` of the serving
forward (the port's counterpart of ``dfu_multimodal_tpu/serve/export.py``).

A deployment should not have to carry the model-building Python or pay
the model's construction at process start.  This module freezes a
trainer's SERVING forward into an on-disk bundle:

- one ``torch.export`` program per batch bucket, ``forward_b{n}.pt2``:
  the Trainer's own eval step (``train/engine.py::serving_outputs``:
  uint8 batch -> normalise -> trunks -> probs / preds / loss / counts),
  traced as a function of (weights, batch), so no program carries a
  weight;
- the weights once, ``params.pt``: every parameter and buffer of the
  model by name (the int8 layers' K-major weight copies too), a
  state_dict that ``torch.load(weights_only=True)`` reads;
- a JSON manifest, ``export_meta.json``: model, inputs, image size,
  buckets, platforms, compute dtype and torch version.

The port's kernels are ``torch.library`` ops (``dfu::attn_block``,
``dfu::conv_q8``, ..., ``ops/_build.py::define_op``), so each kernel call
is one node of the program, and replaying it on a CUDA device launches
the kernel, on the CPU runs its plain version.  An int8 bundle is a
quantised trainer exported the same way (``serve/engine.py::
quantize_for_serving`` first); a token-merged one likewise
(``tome_for_serving``).  :func:`load_bundle` builds no model module: it
imports the modules that define the ops and nothing of the model zoo.

The platform contract (JAX's): the manifest's ``platforms`` list the
device types the bundle is for, and a bundle loads on no other.  The
programs hold no device: what the forward makes is placed on the device
the bundle is loaded on.
"""

from __future__ import annotations

import importlib
import itertools
import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

FORMAT_VERSION = 1
META_NAME = "export_meta.json"
PARAMS_NAME = "params.pt"
PLATFORMS = ("cuda", "cpu")
# the modules that define the port's dfu:: ops: a program's nodes name
# them, so they are imported before a program is loaded
_OP_MODULES = ("attention", "conv_q8", "fused_mlp", "resnet_block",
               "vit_block", "vit_block_q8")


def _program_name(bucket: int) -> str:
    return f"forward_b{bucket}.pt2"


def default_buckets(max_batch: int) -> Tuple[int, ...]:
    """The ServingEngine's power-of-two ladder up to ``max_batch``."""
    ladder, b = [], 1
    while b < max_batch:
        ladder.append(b)
        b *= 2
    ladder.append(int(max_batch))
    return tuple(sorted(set(ladder)))


def serving_state(module: nn.Module) -> Dict[str, torch.Tensor]:
    """Every parameter and buffer of ``module`` by name, detached: the
    persistent ones and the non-persistent copies made from them (the
    int8 layers' ``kernel_kmajor`` / ``col_scale``), all of them inputs
    of an exported program."""
    return {name: t.detach() for name, t in itertools.chain(
        module.named_parameters(), module.named_buffers())}


class ServingProgram(nn.Module):
    """The trainer's serving forward as a module of ``(state, batch)``:
    ``serving_outputs`` with the trainer's own forward run on ``state``
    (``Trainer._forward``, so a ``--qat`` trainer's snap is frozen too).
    The trainer is held outside the module tree, so an exported program
    lifts none of its tensors."""

    def __init__(self, trainer):
        super().__init__()
        object.__setattr__(self, "trainer", trainer)

    def forward(self, state: Dict[str, torch.Tensor],
                batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        from dfu_multimodal_tpu_torch.train.engine import serving_outputs

        t = self.trainer

        def forward(*inputs):
            return t._forward(*inputs, state=state)

        return serving_outputs(forward, batch, t.spec.inputs, t.modalities,
                               t.compute_dtype, t.loss_class_weights())


def _example_batch(inputs: Sequence[str], bucket: int, image_size: int,
                   device: torch.device) -> Dict[str, torch.Tensor]:
    s = int(image_size)
    batch = {m: torch.zeros((bucket, s, s, 3), dtype=torch.uint8,
                            device=device) for m in inputs}
    batch["label"] = torch.zeros(bucket, dtype=torch.long, device=device)
    batch["valid"] = torch.ones(bucket, dtype=torch.float32, device=device)
    return batch


def export_bundle(trainer, out_dir: Path, *, image_size: int = 224,
                  max_batch: int = 64,
                  buckets: Optional[Sequence[int]] = None,
                  platforms: Optional[Sequence[str]] = None,
                  extra_meta: Optional[Dict] = None) -> Dict:
    """Export ``trainer``'s serving forward on its current weights for
    every batch bucket into ``out_dir`` (traced on the trainer's device).
    Returns the manifest, which also records each bucket's export
    seconds (``export_seconds``).  ``platforms``: the device types the
    bundle is for (default: the trainer's).

    ``trainer`` may already be int8-quantised or token-merged
    (``serve/engine.py``): whatever forward the Trainer serves is what
    gets frozen."""
    platforms = tuple(platforms or (trainer.device.type,))
    unknown = sorted(set(platforms) - set(PLATFORMS))
    if unknown:
        raise ValueError(f"unknown platforms {unknown}; have {PLATFORMS}")
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    buckets = tuple(sorted(set(int(b) for b in (
        buckets if buckets is not None else default_buckets(max_batch)))))
    trainer.module.eval()
    state = serving_state(trainer.module)
    program = ServingProgram(trainer)
    seconds = {}
    for bucket in buckets:
        t0 = time.perf_counter()
        batch = _example_batch(trainer.spec.inputs, bucket, image_size,
                               trainer.device)
        with torch.no_grad():
            ep = torch.export.export(program, (state, batch), strict=False)
        ep.example_inputs = None        # they hold every weight
        torch.export.save(ep, out_dir / _program_name(bucket))
        seconds[str(bucket)] = time.perf_counter() - t0
    torch.save({k: v.cpu() for k, v in state.items()}, out_dir / PARAMS_NAME)
    meta = {
        "format_version": FORMAT_VERSION,
        "model": trainer.spec.name,
        "inputs": list(trainer.spec.inputs),
        "image_size": int(image_size),
        "buckets": list(buckets),
        "platforms": list(platforms),
        "compute_dtype": str(trainer.compute_dtype).replace("torch.", ""),
        "torch_version": torch.__version__,
        "export_seconds": seconds,
    }
    if extra_meta:
        meta.update(extra_meta)
    (out_dir / META_NAME).write_text(json.dumps(meta, indent=2))
    return meta


@dataclass(frozen=True)
class _Spec:
    name: str
    inputs: Tuple[str, ...]


class ExportedServable:
    """A loaded bundle with the surface ``ServingEngine`` reads from a
    trainer (``spec``, ``device``, ``eval_step``), so
    ``ServingEngine(servable, buckets=servable.buckets)`` serves a bundle
    with no model source present.

    ``eval_step(batch)`` routes on the batch's leading size to that
    bucket's program; a size with no program raises ``KeyError``."""

    def __init__(self, meta: Dict, state: Dict[str, torch.Tensor],
                 programs: Dict[int, Path], device: torch.device):
        self.spec = _Spec(meta["model"], tuple(meta["inputs"]))
        self.image_size = int(meta["image_size"])
        self.buckets: Tuple[int, ...] = tuple(sorted(meta["buckets"]))
        self.device = device
        self.state = state
        self._paths = dict(programs)
        self._calls: Dict[int, nn.Module] = {}

    def program(self, bucket: int) -> nn.Module:
        """The bucket's program as a module of (state, batch), placed on
        the servable's device; loaded at its first use."""
        from torch.export.passes import move_to_device_pass

        call = self._calls.get(bucket)
        if call is None:
            ep = torch.export.load(self._paths[bucket])
            call = move_to_device_pass(ep, self.device).module()
            self._calls[bucket] = call
        return call

    @torch.inference_mode()
    def eval_step(self, batch: Mapping[str, Union[np.ndarray, torch.Tensor]]
                  ) -> Dict[str, torch.Tensor]:
        """As ``Trainer.eval_step``: ``batch`` {modality: (B, S, S, 3)
        uint8[, "label", "valid"]} -> device tensors ``probs``,
        ``preds`` and, with ``label``, ``loss`` and ``counts``."""
        n = int(np.shape(batch[self.spec.inputs[0]])[0])
        if n not in self._paths:
            raise KeyError(
                f"batch size {n} has no exported program; bundle buckets "
                f"are {list(self.buckets)} (re-export with --max-batch / "
                f"--buckets covering it)")
        tensors = {m: torch.as_tensor(batch[m]).to(self.device)
                   for m in self.spec.inputs}
        labelled = "label" in batch
        tensors["label"] = (torch.as_tensor(batch["label"]).long()
                            if labelled else torch.zeros(n, dtype=torch.long)
                            ).to(self.device)
        tensors["valid"] = (torch.as_tensor(batch["valid"]).float()
                            if "valid" in batch else torch.ones(n)
                            ).to(self.device)
        out = self.program(n)(self.state, tensors)
        if not labelled:
            out = {k: out[k] for k in ("probs", "preds")}
        return out

    def warmup_programs(self) -> None:
        """Load every bucket's program (the ServingEngine's warm-up then
        runs each once)."""
        for b in self.buckets:
            self.program(b)


def load_bundle(path: Path, device: Union[str, torch.device] = "cuda"
                ) -> ExportedServable:
    """Load a bundle directory onto ``device`` (the card unless the
    caller asks for the CPU).  Raises ``ValueError`` for a format this
    build does not read and for a device type outside the bundle's
    ``platforms``; the programs load at first use
    (:meth:`ExportedServable.warmup_programs` loads them all)."""
    path = Path(path)
    device = torch.device(device)
    meta = json.loads((path / META_NAME).read_text())
    if meta.get("format_version") != FORMAT_VERSION:
        raise ValueError(
            f"unsupported export bundle format {meta.get('format_version')} "
            f"(this build reads {FORMAT_VERSION})")
    if device.type not in meta.get("platforms", ()):
        raise ValueError(
            f"bundle {path} was exported for {meta.get('platforms')}, not "
            f"for {device.type}: export it again with --platforms "
            f"{device.type}")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    for name in _OP_MODULES:
        importlib.import_module(f"dfu_multimodal_tpu_torch.ops.{name}")
    programs = {}
    for b in meta["buckets"]:
        program = path / _program_name(int(b))
        if not program.exists():
            raise FileNotFoundError(f"bundle is missing {program.name}")
        programs[int(b)] = program
    state = torch.load(path / PARAMS_NAME, map_location=device,
                       weights_only=True)
    return ExportedServable(meta, state, programs, device)
