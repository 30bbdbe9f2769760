"""Model soups: weight-space averaging of same-architecture checkpoints
(the port's counterpart of ``dfu_multimodal_tpu/train/soup.py``; `dfu
soup`).

No reference counterpart — the reference trains one model per family and
keeps the single best-by-val-F1 checkpoint.  Averaging the weights of
several fine-tunes (different seeds / hyperparameters) routinely beats
every ingredient at ZERO inference cost (Wortsman et al. 2022, "Model
soups") — unlike an ensemble, the soup is still one model, so every
serving path (predict/serve/export, int8, TTA) consumes it unchanged.

Two recipes:
- **uniform**: average every candidate;
- **greedy**: sort candidates by their own val F1, then add one at a
  time keeping the addition only when the averaged model's val F1 does
  not drop — the published recipe that makes soups safe when some
  ingredients are bad.

BatchNorm running statistics are averaged along with the weights (the
standard soup treatment; exact for the means, a mild approximation for
the variances).  All selection happens on the validation split — test
stays untouched until the final report.  A model state here is a
state_dict (the ``model_state_dict`` of a port checkpoint).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch

StateDict = Dict[str, torch.Tensor]


def average_model_states(states: Sequence[StateDict]) -> StateDict:
    """Uniform weight-space average of state_dicts (the
    ``payload['model_state_dict']`` of utils/checkpoint.py), every float
    entry, BatchNorm running statistics included, summed in float64 and
    stored in its own dtype (fp32), as JAX averages its trees.  All
    states must share one set of keys and shapes (same architecture)."""
    if not states:
        raise ValueError("nothing to average")
    if len(states) == 1:
        return states[0]
    keys = list(states[0])
    for s in states[1:]:
        if set(s) != set(keys):
            raise ValueError(
                "cannot average states of different structure: keys "
                f"{sorted(set(keys) ^ set(s))} are not in every state")

    def mean(key, leaves):
        first = leaves[0]
        if any(leaf.shape != first.shape for leaf in leaves):
            raise ValueError(f"cannot average {key!r}: shapes "
                             f"{[tuple(leaf.shape) for leaf in leaves]}")
        if not first.is_floating_point():
            if key.endswith("num_batches_tracked"):
                # torch's BatchNorm counter has no JAX counterpart and
                # nothing reads it (the BatchNorms have a momentum): the
                # soup keeps the first ingredient's count
                return first.clone()
            raise ValueError(
                f"cannot soup non-float leaf of dtype {first.dtype} "
                "(int8-quantized checkpoints are not soup ingredients; "
                "quantize AFTER averaging)")
        acc = torch.zeros_like(first, dtype=torch.float64)
        for leaf in leaves:
            acc += leaf.to(first.device, torch.float64)
        return (acc / len(leaves)).to(first.dtype)

    return {k: mean(k, [s[k] for s in states]) for k in keys}


def greedy_soup(candidates: List[Tuple[str, Dict]],
                eval_fn: Callable[[Dict], float],
                log: Callable[[str], None] = print
                ) -> Tuple[Dict, List[str], float]:
    """Greedy soup (Wortsman et al. 2022, alg. 1).

    ``candidates``: (name, model_state) pairs.  ``eval_fn`` scores a
    model_state on the VALIDATION split (higher better).  Candidates are
    ranked by their individual score; each is then added to the pot only
    if the averaged model's score does not drop.  Returns
    (soup_state, ingredient_names, soup_score)."""
    scored = [(name, state, eval_fn(state)) for name, state in candidates]
    scored.sort(key=lambda t: t[2], reverse=True)
    for name, _, s in scored:
        log(f"  candidate {name}: val score {s:.4f}")

    pot = [scored[0][1]]
    names = [scored[0][0]]
    best = scored[0][2]
    for name, state, _ in scored[1:]:
        trial = average_model_states(pot + [state])
        score = eval_fn(trial)
        if score >= best:
            pot.append(state)
            names.append(name)
            best = score
            log(f"  + {name} kept (val {score:.4f})")
        else:
            log(f"  - {name} rejected (val {score:.4f} < {best:.4f})")
    return average_model_states(pot), names, best
