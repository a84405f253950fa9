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

Counterpart of ``predictionio_tpu/ops/topk.py`` as the tiled CCO merge uses
it: ``block_width`` (the carry width), ``merge_desc`` (the carry merge) and
``tile_topk_desc_plain``, the plain version of the per-tile top-b kernel
(K3, ``ops/csrc/tile_topk.cu``), which with a carry is the per-tile top-b
followed by ``merge_desc``.  The JAX package's bitonic network
(``sort_topb_desc``/``bitonic_topk``) is exact on values only; here every
top-k keeps the total order, so a tiled run equals one ``lax.top_k`` over
the whole row, ties included.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def block_width(k: int) -> int:
    """Carry width of the tiled top-k merge for a requested top-k: a power
    of two, ≥ k, ≥ 8 (``predictionio_tpu/ops/topk.py:block_width``)."""
    return max(8, 1 << max(int(k) - 1, 0).bit_length())


def tile_topk_desc_plain(
    scores: torch.Tensor, b: int, id_offset: int = 0,
    carry: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3: the top-``b`` of every row of float32
    ``scores`` [R, W], sorted by (score desc, column asc), as
    (values [R, b] f32, int32 column ids + ``id_offset`` [R, b]).

    A row narrower than ``b`` is padded with -inf at columns W, W+1, …,
    as the Pallas kernel pads its width: padding ranks below every real
    entry, -inf included, and surfaces with its padded column id.

    With ``carry=(carry_s, carry_i)`` ([R, b] each) the result is the carry
    merge of the tiled CCO loop: ``merge_desc(carry_s, carry_i, top-b of
    the tile)``."""
    r, w = scores.shape
    if w < b:
        pad = torch.full((r, b - w), float("-inf"), dtype=scores.dtype,
                         device=scores.device)
        scores = torch.cat([scores, pad], dim=1)
    vals, idx = topk_desc(scores, b)
    idx = idx.to(torch.int32) + id_offset
    if carry is None:
        return vals, idx
    return merge_desc(carry[0], carry[1], vals, idx)


def merge_desc(
    as_: torch.Tensor, ai: torch.Tensor, bs: torch.Tensor, bi: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-b of two lists [R, b] sorted desc, sorted desc: the carry merge
    of the tiled CCO strategy (``predictionio_tpu/ops/topk.py:merge_desc``).

    Equal scores keep ``as_`` (the carry, which holds the lower column ids)
    first, then each list's own order, so merging a row's tiles left to
    right gives exactly one ``lax.top_k`` over the whole row."""
    b = as_.shape[1]
    s = torch.cat([as_, bs], dim=1)
    i = torch.cat([ai, bi], dim=1)
    pos = torch.topk(topk_order_keys(s), b, dim=1, sorted=True).indices
    return s.gather(1, pos), i.gather(1, pos)
