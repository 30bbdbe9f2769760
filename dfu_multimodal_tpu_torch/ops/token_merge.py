"""Bipartite token merging for ViT serving (ToMe, Bolya et al., "Token
Merging: Your ViT But Faster", ICLR'23).

Counterpart of ``dfu_multimodal_tpu/ops/token_merge.py``: split the patch
tokens alternately into sets A and B, match each A-token to its most
cosine-similar B-token, and merge the ``r`` best-matched A-tokens into
their B-tokens by size-weighted mean, in one shot.  The CLS token (row 0)
never takes part, and a parallel ``sizes`` vector keeps the weighted means
exact when merges compose.

JAX computes this outside any Pallas kernel (a small matrix product, a
stable argsort and a one-hot matrix product), so it is no kernel here
either: plain PyTorch on every device.  Its numerics are JAX's: the
similarity in fp32 (on the card with TF32 off, which this function
checks: a TF32 product would round the scores to ~3 digits and change
which tokens merge), ``1e-6`` added to each norm, the first index among
equal scores (``torch.max``, as ``jnp.argmax``), a stable descending sort
(``jnp.argsort`` is stable; ``torch.argsort`` only with ``stable=True``),
so equal scores, as identical tokens give, merge in index order.  The
scatter of merged tokens into their destinations stays a one-hot matrix
product, as in JAX: it sums in a fixed order on the card, where
``index_add_`` would add with atomics in a varying order.

Inference only: the serving path of ``models/vit.py`` (``token_merge``)
runs it; training always runs the full token set.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _gather_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t (B, N, ...) rows at idx (B, K) -> (B, K, ...)
    (``jnp.take_along_axis`` along axis 1)."""
    if t.dim() == 2:
        return torch.gather(t, 1, idx)
    return torch.gather(t, 1, idx[:, :, None].expand(-1, -1, t.shape[-1]))


def bipartite_merge(x: torch.Tensor, sizes: torch.Tensor, r: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge ``r`` patch tokens of ``x`` into their nearest neighbours.

    ``x``: (B, N, C) token sequence, CLS at index 0 (never merged).
    ``sizes``: (B, N) fp32: how many original tokens each current token
    already represents (all ones before the first merge).  Returns
    ``(x', sizes')`` with N' = N − r: the CLS token, the A-tokens kept (most
    similar first removed, the rest in the sorted order), then every
    B-token, the merged ones the size-weighted means of their constituents
    (computed in fp32, cast back to ``x.dtype``).  Raises ValueError when
    ``r`` exceeds the mergeable A-tokens."""
    if r <= 0:
        return x, sizes
    if (x.is_cuda and torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(
            "bipartite_merge: torch.backends.cuda.matmul.allow_tf32 is "
            "True; the similarity product must run in full fp32 (TF32 "
            "changes which tokens merge)")
    cls_tok, t = x[:, :1], x[:, 1:]
    s_cls, st = sizes[:, :1], sizes[:, 1:]
    a, bt = t[:, 0::2], t[:, 1::2]            # alternating bipartition
    sa, sb = st[:, 0::2], st[:, 1::2]
    na, nb = a.shape[1], bt.shape[1]
    if r > na:
        raise ValueError(f"r={r} exceeds the {na} mergeable A-tokens")

    af, bf = a.float(), bt.float()
    an = af / (torch.linalg.vector_norm(af, dim=-1, keepdim=True) + 1e-6)
    bn = bf / (torch.linalg.vector_norm(bf, dim=-1, keepdim=True) + 1e-6)
    scores = torch.matmul(an, bn.transpose(-1, -2))      # (B, nA, nB)
    best, dst = scores.max(dim=-1)                       # first index of max

    order = torch.argsort(-best, dim=-1, stable=True)    # most similar first
    merged_src, kept_src = order[:, :r], order[:, r:]

    a_kept = _gather_rows(a, kept_src)
    sa_kept = _gather_rows(sa, kept_src)
    a_m = _gather_rows(af, merged_src)
    sa_m = _gather_rows(sa, merged_src)                  # (B, r)
    dst_m = _gather_rows(dst, merged_src)                # (B, r)

    # several A-tokens may land in one B-token: a one-hot product sums them
    onehot_t = F.one_hot(dst_m, nb).to(torch.float32).transpose(1, 2)
    add_feat = torch.matmul(onehot_t, a_m * sa_m[:, :, None])
    add_size = torch.matmul(onehot_t, sa_m[:, :, None])[..., 0]
    sb_new = sb + add_size
    b_new = ((bf * sb[:, :, None] + add_feat)
             / sb_new[:, :, None]).to(x.dtype)

    x_out = torch.cat([cls_tok, a_kept, b_new], dim=1)
    s_out = torch.cat([s_cls, sa_kept, sb_new], dim=1)
    return x_out, s_out
