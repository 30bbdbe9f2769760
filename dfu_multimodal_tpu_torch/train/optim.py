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
first-moment dtype, hence this class.  Only a constant learning rate is
supported (``learning_rate_schedule`` raises otherwise).  Updates run as
``torch._foreach_*`` ops over all tensors at once.
"""

from __future__ import annotations

from typing import Iterable, List

import numpy as np
import torch


def learning_rate_schedule(cfg) -> float:
    """The constant learning rate of ``cfg`` (the reference's default);
    the cosine schedule and warm-up are not ported yet."""
    if cfg.lr_schedule != "constant" or float(cfg.warmup_epochs) > 0.0:
        raise NotImplementedError(
            f"lr_schedule={cfg.lr_schedule!r} / warmup_epochs="
            f"{cfg.warmup_epochs}: only the constant learning rate is "
            "ported")
    return float(cfg.learning_rate)


class AdamW:
    """``optax.adamw(lr, b1, b2, eps, weight_decay, mu_dtype=...)`` over
    ``params`` (decay applies to every parameter, as in the reference)."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float,
                 weight_decay: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, mu_dtype: torch.dtype = torch.bfloat16):
        self.params: List[torch.Tensor] = list(params)
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
        b1, b2 = self.b1, self.b2
        self.count += 1
        # optax computes 1 - decay**count in fp32
        bc1 = float(np.float32(1) - np.float32(b1) ** np.int32(self.count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.int32(self.count))

        mu = torch._foreach_mul(grads, 1.0 - b1)
        torch._foreach_add_(mu, torch._foreach_mul(self.mu, b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1.0 - b2))
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(mu, bc1)
        torch._foreach_div_(update, denom)
        del denom
        torch._foreach_add_(update, self.params, alpha=self.weight_decay)
        torch._foreach_mul_(update, -self.lr)
        torch._foreach_add_(self.params, update)
        for dst, src in zip(self.mu, mu):
            dst.copy_(src)
