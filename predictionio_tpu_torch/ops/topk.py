"""Top-k in ``jax.lax.top_k``'s total order, for torch tensors.

``lax.top_k`` returns values descending with equal values broken by the
LOWER index first, also at the k-th boundary; ``host_topk_desc`` in
``predictionio_tpu/models/common.py`` reproduces that order on numpy.
``torch.topk`` promises no order among equal values, so it never ranks
scores directly here.  Instead every score gets a distinct int64 key — the
float's monotone int32 image in the high word (sign-magnitude to two's
complement, which also orders ``-0.0`` below ``+0.0`` as XLA does) and the
descending index in the low word — and ``torch.topk`` of the keys is the
(score desc, index asc) order exactly.  No host sync, any device.
"""

from __future__ import annotations

from typing import Tuple

import torch


def topk_order_keys(scores: torch.Tensor) -> torch.Tensor:
    """int64 keys of a float32 [..., N] tensor whose descending order is
    (score desc, index asc), every key distinct."""
    if scores.dtype != torch.float32:
        raise TypeError(f"topk_order_keys: float32 scores expected, got {scores.dtype}")
    bits = scores.contiguous().view(torch.int32)
    mono = bits ^ ((bits >> 31) & 0x7FFFFFFF)        # monotone float → int map
    n = scores.shape[-1]
    low = (2**32 - 1) - torch.arange(n, dtype=torch.int64, device=scores.device)
    return (mono.to(torch.int64) << 32) + low


def topk_desc(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` along the last dim of float32 ``scores`` in ``lax.top_k``
    order: (values [..., k], int64 indices [..., k])."""
    n = scores.shape[-1]
    if not 0 <= k <= n:
        raise ValueError(f"topk_desc: k={k} outside [0, {n}]")
    idx = torch.topk(topk_order_keys(scores), k, dim=-1, sorted=True).indices
    return scores.gather(-1, idx), idx
