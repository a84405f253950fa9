"""Published peaks of one NVIDIA H100 SXM and the work a CCO train needs.

Peaks are NVIDIA's data sheet's dense rates at the card's full 700 W:
1,979 TOP/s in int8 and 3.35 TB/s of HBM3.  A card set below 700 W runs
below them; the harness prints the card's power limit beside every share.

Every count is of the dense formulation that the program and the JAX
package both compute: for each event type t against the primary p, the
count product ``Pᵀ·A_t`` over all U users ([I_p, I_t] int32 counts), then
Dunning's G² of every cell (K2) and the top-k of every row (K3).  A program
that computes less (a sparse count on the card, say) needs these functions
recounted before its shares mean anything.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

INT8_PEAK_OPS = 1979e12   # int8 tensor-core operations a second, dense
HBM_BYTES_S = 3.35e12     # HBM3 bytes a second


def indicator_pairs(cfg: Dict) -> List[Tuple[str, int, int]]:
    """(event type, I_p, I_t) of every indicator a train computes: each
    event type against the first (the primary), the first with itself."""
    items = int(cfg["items"])
    return [(t["name"], items, items) for t in cfg["event_types"]]


def events_per_train(cfg: Dict) -> int:
    return sum(int(t["events"]) for t in cfg["event_types"])


def dense_ops_per_train(cfg: Dict) -> float:
    """Int8 operations of the count products of one train: Σ 2·U·I_p·I_t."""
    users = int(cfg["users"])
    return float(sum(2 * users * ip * it for _, ip, it in indicator_pairs(cfg)))


def k2_bytes_per_train(cfg: Dict) -> float:
    """K2's bytes a train, each input read once and each output written
    once (as ``chip_smoke.py``'s ``bound`` counts one launch): int32
    counts in and f32 scores out a cell, the two marginals once."""
    return float(sum(ip * it * (4 + 4) + 4 * (ip + it)
                     for _, ip, it in indicator_pairs(cfg)))


def k3_bytes_per_train(cfg: Dict) -> float:
    """K3's bytes a train: every f32 score read once, and each row's top
    k written once as an f32 score and an int32 id.  A tiled train also
    reads and writes a running carry a tile; that traffic is the tiling's,
    not the work's, and is not counted."""
    k = int(cfg["top_k"])
    return float(sum(ip * it * 4 + ip * k * 8 for _, ip, it in indicator_pairs(cfg)))


def count_product_bound_s(m: int, k: int, n: int) -> float:
    """Least time of one int8 product [m, k] · [k, n] → int32 [m, n]: the
    larger of its operations at the int8 peak and of its bytes (both
    operands read once, the int32 result written once) at HBM's rate."""
    ops = 2.0 * m * k * n
    bytes_ = m * k + k * n + 4.0 * m * n
    return max(ops / INT8_PEAK_OPS, bytes_ / HBM_BYTES_S)
