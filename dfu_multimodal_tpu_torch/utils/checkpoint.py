"""Checkpoint save/load with the reference's logical contract (counterpart
of ``dfu_multimodal_tpu/utils/checkpoint.py``).

The port writes ``{basename}.pt``, a ``torch.save`` of the source's keys
``epoch``, ``model_state_dict``, ``optimizer_state_dict``, ``val_f1`` and
``history`` (plus ``raw_params`` from an EMA run), and the JSON sidecar
``{basename}.meta.json`` with the JAX package's meta keys.  The basenames
are ``best_model`` (best by validation F1) and ``last_model`` (the
per-epoch resume point).  Tensors are saved on the CPU.

A directory the JAX package wrote (``{basename}.msgpack``, flax msgpack)
loads too, with no flax: ``utils/flax_msgpack.py`` reads it and
``tools/convert_jax.py::port_payload`` maps it onto the port's keys (a
pretraining checkpoint's, whose meta names its ``ssl_method``, onto the
port's pretraining keys, which hold the trunk under both of its names).
"""

from __future__ import annotations

import copy
import json
import os
import threading
import time
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from dfu_multimodal_tpu_torch.tools.convert_jax import port_payload
from dfu_multimodal_tpu_torch.utils.flax_msgpack import msgpack_restore

LAST_BASENAME = "last_model"     # per-epoch resume checkpoint (save_last)
JAX_SUFFIX = ".msgpack"          # the JAX package's checkpoints

StateDict = Dict[str, torch.Tensor]


def _names(basename: str) -> Tuple[str, str]:
    return f"{basename}.pt", f"{basename}.meta.json"


def _map_tensors(tree: Any, fn) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, Mapping):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    return tree


def _to_cpu(tree: Any) -> Any:
    return _map_tensors(tree, lambda t: t.detach().cpu())


def save_checkpoint(directory: Path, *, epoch: int, model_state: StateDict,
                    opt_state: Optional[Dict], val_f1: float, history: Dict,
                    extra_meta: Optional[Dict] = None,
                    extra_state: Optional[Dict] = None,
                    basename: str = "best_model") -> Path:
    """Write ``{basename}.pt`` and its meta sidecar, replacing the previous
    pair.  ``extra_state`` adds top-level payload entries (the EMA
    trainer's ``raw_params``).

    Both files are staged to pid-suffixed temporaries and renamed back to
    back, so a crash leaves the previous pair whole (or, in the gap
    between the two renames, new weights beside the previous meta).
    Temporaries older than an hour, left by a killed save, are removed
    first; a younger one may belong to a concurrent writer."""
    payload = {"epoch": epoch, "model_state_dict": _to_cpu(model_state),
               "optimizer_state_dict": _to_cpu(opt_state),
               "val_f1": float(val_f1), "history": history}
    for key, tree in (extra_state or {}).items():
        payload[key] = _to_cpu(tree)
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    ckpt_name, meta_name = _names(basename)
    cutoff = time.time() - 3600.0
    for pattern in (f".{ckpt_name}.tmp*", f".{meta_name}.tmp*"):
        for stale in directory.glob(pattern):
            try:
                if stale.stat().st_mtime < cutoff:
                    stale.unlink()
            except OSError:
                pass
    meta = {"epoch": epoch, "val_f1": float(val_f1), "history": history}
    if extra_meta:
        meta.update(extra_meta)
    path = directory / ckpt_name
    tmp = directory / f".{ckpt_name}.tmp{os.getpid()}"
    meta_tmp = directory / f".{meta_name}.tmp{os.getpid()}"
    try:
        torch.save(payload, tmp)
        meta_tmp.write_text(json.dumps(meta, indent=2))
        os.replace(tmp, path)
        os.replace(meta_tmp, directory / meta_name)
    except BaseException:
        for t in (tmp, meta_tmp):
            try:
                t.unlink()
            except OSError:
                pass
        raise
    return path


def load_checkpoint(directory: Path, basename: str = "best_model",
                    model_name: Optional[str] = None) -> Tuple[Dict, Dict]:
    """Return (payload, meta) with the port's payload keys, tensors on the
    CPU.  A JAX checkpoint (``{basename}.msgpack``, read when no
    ``{basename}.pt`` is there) needs the zoo ``model_name`` to map its
    trees onto the port model's keys."""
    directory = Path(directory)
    ckpt_name, _ = _names(basename)
    path = directory / ckpt_name
    if path.exists():
        payload = torch.load(path, map_location="cpu", weights_only=True)
    else:
        jax_path = directory / f"{basename}{JAX_SUFFIX}"
        if not jax_path.exists():
            raise FileNotFoundError(f"no {ckpt_name} or {jax_path.name} "
                                    f"in {directory}")
        meta = load_meta(directory, basename)
        if "ssl_method" in meta:
            # a pretraining checkpoint: its trunk keys, whatever loads it
            model_name = "pretrain"
        if model_name is None:
            raise ValueError(f"{jax_path} is a JAX checkpoint: its model "
                             "name is needed to map its keys")
        payload = port_payload(model_name,
                               msgpack_restore(jax_path.read_bytes()))
    return payload, load_meta(directory, basename)


def load_flexible(target: Mapping[str, torch.Tensor],
                  saved: Mapping[str, torch.Tensor], verbose: bool = True
                  ) -> Tuple[StateDict, int, int]:
    """Merge ``saved`` into ``target`` (state dicts), skipping keys that
    are absent from ``target`` or of another shape, so a mismatched
    classifier head keeps its fresh weights, as the reference's flexible
    loader does.  Returns (merged, n_loaded, n_skipped)."""
    loaded = skipped = 0
    merged = dict(target)
    for key, value in saved.items():
        if key not in target or (tuple(value.shape)
                                 != tuple(target[key].shape)):
            skipped += 1
            continue
        merged[key] = value
        loaded += 1
    if verbose:
        print(f"  Loaded {loaded} arrays from checkpoint"
              + (f"; skipped {skipped}" if skipped else ""))
    return merged, loaded, skipped


def load_weights(module: torch.nn.Module, directory: Path,
                 basename: str = "best_model",
                 model_name: Optional[str] = None, verbose: bool = True
                 ) -> Tuple[Dict, Dict]:
    """Load a checkpoint's model weights (the port's, or the JAX
    package's mapped for zoo ``model_name``) into ``module`` flexibly (see
    :func:`load_flexible`); returns (payload, meta) of
    :func:`load_checkpoint`."""
    payload, meta = load_checkpoint(directory, basename, model_name)
    merged, _, _ = load_flexible(module.state_dict(),
                                 payload["model_state_dict"], verbose)
    module.load_state_dict(merged)
    return payload, meta


def load_meta(directory: Path, basename: str = "best_model") -> Dict:
    meta_path = Path(directory) / _names(basename)[1]
    return json.loads(meta_path.read_text()) if meta_path.exists() else {}


def best_checkpoint_exists(directory: Path,
                           basename: str = "best_model") -> bool:
    """A ``{basename}.pt`` of the port or a JAX ``{basename}.msgpack``."""
    directory = Path(directory)
    return ((directory / _names(basename)[0]).exists()
            or (directory / f"{basename}{JAX_SUFFIX}").exists())


def resume_basename(directory: Path) -> Optional[str]:
    """Pick the checkpoint to resume from: ``last_model`` when it is at
    least as recent as the best, else ``best_model``; None when neither
    exists."""
    have_best = best_checkpoint_exists(directory)
    if best_checkpoint_exists(directory, LAST_BASENAME):
        if not have_best:
            return LAST_BASENAME
        best_ep = int(load_meta(directory).get("epoch", 0))
        last_ep = int(load_meta(directory, LAST_BASENAME).get("epoch", 0))
        return LAST_BASENAME if last_ep >= best_ep else "best_model"
    return "best_model" if have_best else None


class AsyncCheckpointer:
    """Overlap checkpoint writes with training.

    :meth:`save` first copies every tensor of the state on its own device,
    synchronously (the copies are enqueued on the current stream before
    the next step's in-place updates of the parameters and moments), then
    moves the copies to the host and writes them on a daemon thread
    through :func:`save_checkpoint`.  At most one save is in flight: a new
    :meth:`save` (and :meth:`wait`) joins the previous one first, and a
    failure of the background write is re-raised there.  Call
    :meth:`wait` after the epoch loop so the last checkpoint is on disk
    before the run returns."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, directory: Path, *, epoch: int, model_state: StateDict,
             opt_state: Optional[Dict], val_f1: float, history: Dict,
             extra_meta: Optional[Dict] = None,
             extra_state: Optional[Dict] = None,
             basename: str = "best_model") -> None:
        self.wait()

        def snap(t):
            return t.detach().clone()

        snap_model = _map_tensors(model_state, snap)
        snap_opt = _map_tensors(opt_state, snap)
        snap_extra = _map_tensors(extra_state, snap) if extra_state else None
        # history and meta mutate in place each epoch: freeze this view
        history = copy.deepcopy(history)
        extra_meta = copy.deepcopy(extra_meta)

        def write():
            try:
                save_checkpoint(directory, epoch=epoch,
                                model_state=snap_model, opt_state=snap_opt,
                                val_f1=val_f1, history=history,
                                extra_meta=extra_meta,
                                extra_state=snap_extra, basename=basename)
            except BaseException as e:          # re-raised in wait()
                self._error = e

        self._thread = threading.Thread(target=write, name="ckpt-writer",
                                        daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the in-flight save; re-raise its failure, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from err
