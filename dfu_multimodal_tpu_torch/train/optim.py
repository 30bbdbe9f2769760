"""AdamW written out over the parameter list (counterpart of the
``optax.adamw`` the JAX ``Trainer`` builds, ``train/engine.py``).

    mu  = (1 - b1)·g + b1·mu          stored in ``mu_dtype``
    nu  = (1 - b2)·g² + b2·nu         stored in fp32
    u   = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)
    p  += -lr·(u + weight_decay·p)

in optax's order of operations: the new first moment is formed in fp32
from the stored one (for a bf16 ``mu_dtype``, b1·mu is rounded to bf16 as
JAX's weak-typed product is), the update uses that fp32 value, and only
the stored copy is cast to ``mu_dtype``.  ``torch.optim.AdamW`` has no
first-moment dtype, hence this class.  The learning rate is a constant or
a schedule of the update count (:func:`learning_rate_schedule`), read, as
optax reads it, at the count before the update.  Updates run as
``torch._foreach_*`` ops over all tensors at once.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Union

import numpy as np
import torch

Schedule = Callable[[int], float]


def learning_rate_schedule(cfg) -> Union[float, Schedule]:
    """The learning rate of ``optax.adamw`` in the JAX ``Trainer``
    (``train/engine.py::learning_rate_schedule``): the constant
    ``cfg.learning_rate`` by default; with ``lr_schedule="cosine"`` and/or
    ``warmup_epochs > 0`` a function of the update count over
    ``steps_per_epoch · num_epochs`` steps: optax's
    ``warmup_cosine_decay_schedule(0, lr, warm, total, 0)``, or a linear
    warm-up from 0 joined to the constant rate."""
    sched = cfg.lr_schedule
    warm_epochs = float(cfg.warmup_epochs)
    lr = float(cfg.learning_rate)
    if sched == "constant" and warm_epochs == 0.0:
        return lr
    spe = int(cfg.steps_per_epoch)
    if spe <= 0:
        raise ValueError(
            "lr_schedule/warmup_epochs need cfg.steps_per_epoch > 0 "
            "(the train CLIs derive it from the dataset size)")
    total = max(1, spe * cfg.num_epochs)
    warm = int(round(warm_epochs * spe))
    if sched == "cosine":
        if total - warm <= 0:
            raise ValueError(f"the cosine decay needs steps after the "
                             f"warm-up: {warm} warm-up of {total} steps")
        return warmup_cosine_schedule(lr, warm, total)
    if sched != "constant":
        raise ValueError(f"unknown lr_schedule {sched!r} "
                         "(choose 'constant' or 'cosine')")
    return _warmup_then(lr, warm, lambda t: lr)


def warmup_cosine_schedule(lr: float, warm: int, total: int) -> Schedule:
    """optax's ``warmup_cosine_decay_schedule(0, lr, warm, total, 0)``: a
    linear warm-up from 0 over ``warm`` steps, then a cosine from ``lr``
    to 0 over the ``total - warm`` steps after it (held at 0 past
    them)."""
    span = total - warm
    return _warmup_then(lr, warm, lambda t: lr * 0.5 * (1.0 + math.cos(
        math.pi * min(t, span) / span)))


def _warmup_then(lr: float, warm: int, tail: Schedule) -> Schedule:
    """A linear warm-up from 0 to ``lr`` joined to ``tail``, in fp32."""

    def schedule(count: int) -> float:
        # optax.join_schedules: the warm-up below the boundary, the tail
        # at count - warm from it; a warm-up of 0 steps is never taken
        if count < warm:
            return float(np.float32(lr * count / warm))
        return float(np.float32(tail(count - warm)))

    return schedule


class AdamW:
    """``optax.adamw(lr, b1, b2, eps, weight_decay, mu_dtype=...)`` over
    ``params`` (decay applies to every parameter, as in the reference).
    ``lr`` is a float or a schedule of the update count; ``names`` key the
    moments in :meth:`state_dict` (the parameters' positions without)."""

    def __init__(self, params: Iterable[torch.Tensor],
                 lr: Union[float, Schedule], weight_decay: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 mu_dtype: torch.dtype = torch.bfloat16,
                 names: Optional[Sequence[str]] = None):
        self.params: List[torch.Tensor] = list(params)
        self.names = (list(names) if names is not None
                      else [str(i) for i in range(len(self.params))])
        if len(self.names) != len(self.params):
            raise ValueError(f"{len(self.names)} names for "
                             f"{len(self.params)} parameters")
        self.lr, self.weight_decay = lr, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p, dtype=mu_dtype) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        """One update from each parameter's ``.grad`` (a missing gradient
        counts as zero, as JAX's gradient of an unused leaf)."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        lr = self.lr(self.count) if callable(self.lr) else self.lr
        self.count += 1
        # foreach lists may not mix DTensors (parameters sharded by FSDP or
        # tensor parallelism) with plain tensors: one update for each kind
        kinds: Dict[bool, List[int]] = {}
        for i, p in enumerate(self.params):
            kinds.setdefault(hasattr(p, "device_mesh"), []).append(i)
        for idx in kinds.values():
            self._update([self.params[i] for i in idx],
                         [grads[i] for i in idx], [self.mu[i] for i in idx],
                         [self.nu[i] for i in idx], lr)

    def _update(self, params, grads, mus, nus, lr: float) -> None:
        b1, b2 = self.b1, self.b2
        # optax computes 1 - decay**count in fp32
        bc1 = float(np.float32(1) - np.float32(b1) ** np.int32(self.count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.int32(self.count))

        mu = torch._foreach_mul(grads, 1.0 - b1)
        torch._foreach_add_(mu, torch._foreach_mul(mus, b1))
        torch._foreach_mul_(nus, b2)
        torch._foreach_add_(nus, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1.0 - b2))
        denom = torch._foreach_div(nus, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(mu, bc1)
        torch._foreach_div_(update, denom)
        del denom
        torch._foreach_add_(update, params, alpha=self.weight_decay)
        torch._foreach_mul_(update, -lr)
        torch._foreach_add_(params, update)
        for dst, src in zip(mus, mu):
            dst.copy_(src)

    def state_dict(self) -> Dict:
        """``count``, and ``mu`` (in its dtype) and ``nu`` keyed by
        parameter name.  The tensors are the live moments, not copies."""
        return {"count": self.count,
                "mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu))}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        """Copy a :meth:`state_dict` in (any device; mu cast to this
        optimizer's dtype).  Every name must be there, at its shape."""
        for key in ("mu", "nu"):
            missing = set(self.names) - set(state[key])
            if missing:
                raise KeyError(f"optimizer state lacks {key} of "
                               f"{sorted(missing)[:3]}")
            for name, dst in zip(self.names, getattr(self, key)):
                src = state[key][name]
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(f"{key} of {name}: shape "
                                     f"{tuple(src.shape)}, expected "
                                     f"{tuple(dst.shape)}")
                dst.copy_(src)
        self.count = int(state["count"])
