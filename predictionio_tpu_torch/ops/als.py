"""ALS serving: top-k item scores from user and item factors.

Counterpart of the serving half of ``predictionio_tpu/ops/als.py``
(``recommend_*``, ``bucket_width``, ``pad_ids``, lines 414-467 and
626-686).  Every route scores through the fused masked-score kernel
(``ops.hopper_kernels.masked_score_matmul``) and ranks in ``lax.top_k``'s
order (``ops.topk.topk_desc``).  Functions take tensors on one device and
return tensors on it; the item factors stay resident there, and per query
only the user vector's row and a small padded exclusion-id list cross to
the device.  ALS training waits for a later slice.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from predictionio_tpu_torch.ops.hopper_kernels import (
    masked_score_matmul,
    recommend_batch_fused,
)
from predictionio_tpu_torch.ops.topk import topk_desc


def check_f32_id_range(n_items: int) -> None:
    """The stacked-readback serving paths pack item indices as f32, which
    is exact only below 2**24: violating catalogs fail loudly instead of
    silently serving corrupted item ids."""
    if n_items >= 1 << 24:
        raise ValueError(
            f"catalog of {n_items} items exceeds the 2**24 exact-int range "
            "of the f32-packed top-k serving path; shard the catalog across "
            "devices or split the app")


def _stack_topk(scores: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Pack (scores, idx) as one [..., 2, k] f32 tensor so serving does ONE
    device→host copy per query (item ids are exact in f32 below 2**24,
    see check_f32_id_range)."""
    return torch.stack([scores, idx.to(torch.float32)], dim=-2)


def bucket_width(n: int, min_width: int = 16) -> int:
    """Smallest power-of-two ≥ n (and ≥ min_width) — the one shape-bucketing
    rule for serving: distinct exclusion lengths, batch sizes and top-k
    values collapse to a handful of shapes."""
    return max(min_width, 1 << max(0, (int(n) - 1).bit_length()))


def pad_ids(ids, min_width: int = 16) -> np.ndarray:
    """Pad an id list to a bucketed width with -1 (see bucket_width)."""
    n = len(ids)
    out = np.full(bucket_width(n, min_width), -1, np.int32)
    if n:
        out[:n] = np.asarray(ids, np.int32)
    return out


def exclusion_mask(excl_idx, n_items: int, device: torch.device) -> torch.Tensor:
    """[B, W] -1-padded item ids → [B, n_items] uint8 mask (1 = excluded),
    built on ``device``: only the id list crosses to it.

    Padding (and any id outside the catalog, which JAX's scatter drops) is
    sent to a sink column past the last item and sliced off, so item 0 is
    excluded only when it is listed.  The result is a row-strided view,
    which the kernel takes as it is."""
    ids = torch.as_tensor(excl_idx).to(device=device, dtype=torch.int64)
    ids = torch.where((ids >= 0) & (ids < n_items), ids, n_items)
    mask = torch.zeros((ids.shape[0], n_items + 1), dtype=torch.uint8,
                       device=device)
    mask.scatter_(1, ids, 1)
    return mask[:, :n_items]


def recommend_scores(
    user_vec: torch.Tensor,       # [K]
    item_factors: torch.Tensor,   # [n_items, K]
    seen_mask: torch.Tensor,      # [n_items] >0 where already interacted
    top_k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-K item scores for one user; seen items pushed to -inf."""
    scores = masked_score_matmul(user_vec[None], item_factors, seen_mask[None])
    s, i = topk_desc(scores, top_k)
    return s[0], i[0]


def recommend_batch_excl(
    user_vecs: torch.Tensor,      # [B, K]
    item_factors: torch.Tensor,   # [n_items, K] — device-resident
    excl_idx,                     # [B, W] per-row exclusions, -1 padding
    top_k: int,
) -> torch.Tensor:                # [B, 2, top_k]: scores row, item-id row
    """Top-K per row with an exclusion LIST instead of a dense mask."""
    n_items = item_factors.shape[0]
    check_f32_id_range(n_items)
    mask = exclusion_mask(excl_idx, n_items, item_factors.device)
    return _stack_topk(*recommend_batch_fused(
        user_vecs, item_factors, mask, top_k))


def recommend_scores_excl(
    user_vec: torch.Tensor,       # [K]
    item_factors: torch.Tensor,   # [n_items, K] — device-resident
    excl_idx,                     # [W] item ids to exclude, -1 padding
    top_k: int,
) -> torch.Tensor:                # [2, top_k]: scores row, item-id row
    """Single-query ``recommend_batch_excl``."""
    return recommend_batch_excl(user_vec[None], item_factors,
                                torch.as_tensor(excl_idx)[None], top_k)[0]


def recommend_batch(
    user_vecs: torch.Tensor,      # [B, K]
    item_factors: torch.Tensor,   # [n_items, K]
    seen_mask: torch.Tensor,      # [B, n_items]
    top_k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched top-K scoring through the fused kernel."""
    return recommend_batch_fused(user_vecs, item_factors, seen_mask, top_k)
