"""Eval half of the engine (counterpart of ``dfu_multimodal_tpu/train/
engine.py::Trainer``): model build on one explicit device, compute dtype,
modality routing, and the eval/serving step

    uint8 NHWC batch -> eval_normalize -> model -> softmax P(ulcer), argmax

The train step, optimizer, mesh and checkpoint restore are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple, Union

import numpy as np
import torch

# host-only configuration shared with the JAX package (no jax import)
from dfu_multimodal_tpu.config import (  # noqa: F401
    ModalityConfig, TrainConfig, rgb_modality, thermal_modality)
from dfu_multimodal_tpu_torch.data.transforms import eval_normalize
from dfu_multimodal_tpu_torch.models import zoo
from dfu_multimodal_tpu_torch.models.common import canonical_dtype


class Trainer:
    """Eval engine for one model-zoo entry on one device.  Weights are
    the module's own: load them with ``module.load_state_dict`` (e.g.
    from ``tools.convert_jax.variables_to_state_dict``) or draw them with
    ``models.zoo.init_model``."""

    def __init__(self, model_name: str, cfg: TrainConfig,
                 modalities: Dict[str, ModalityConfig], *,
                 device: Union[str, torch.device], image_size: int = 224):
        self.device = torch.device(device)
        self.compute_dtype = canonical_dtype(cfg.compute_dtype)
        self.module, self.spec = zoo.build(
            model_name, drop_rate=cfg.drop_rate, dtype=self.compute_dtype,
            image_size=image_size)
        self.module.to(self.device)
        self.modalities = modalities

    def variables(self) -> Dict[str, torch.Tensor]:
        """The model's weights and BatchNorm statistics (the JAX
        ``variables`` tree, as a state_dict)."""
        return self.module.state_dict()

    def _preprocess_eval(self, batch: Mapping[str, torch.Tensor]
                         ) -> Tuple[torch.Tensor, ...]:
        return tuple(
            eval_normalize(batch[m], self.modalities[m], self.compute_dtype)
            for m in self.spec.inputs)

    @torch.inference_mode()
    def eval_step(self, batch: Mapping[str, Union[np.ndarray, torch.Tensor]]
                  ) -> Dict[str, torch.Tensor]:
        """``batch``: {modality: (B, S, S, 3) uint8} (numpy or tensors).
        Returns device tensors ``probs`` = softmax(logits)[:, 1] and
        ``preds`` = argmax(logits)."""
        self.module.eval()
        inputs = {m: torch.as_tensor(batch[m]).to(self.device)
                  for m in self.spec.inputs}
        logits = self.module(*self._preprocess_eval(inputs)).float()
        return {"probs": torch.softmax(logits, dim=-1)[:, 1],
                "preds": torch.argmax(logits, dim=-1)}
