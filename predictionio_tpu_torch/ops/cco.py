"""Correlated cross-occurrence (CCO): the training op of the Universal
Recommender and of the similar-product template's cooccurrence algorithm.

Counterpart of ``predictionio_tpu/ops/cco.py``.  For each event type,
against one primary event type:

1. densify the (user, item) pairs of a user block or an item tile into a 0/1
   matrix by a scatter of ones — the scatter is the dedup;
2. ``C = Pᵀ·A``, the cooccurrence counts, exact (see ``_count_product``),
   with the row and column marginals (distinct users per item) as sums of
   the densified matrices;
3. Dunning's G² of every cell, masked to -inf where the count is 0 or the
   score misses the threshold: the K2 kernel (``llr_masked_scores``);
4. the exact per-row top-k in ``lax.top_k``'s order: the K3 kernel
   (``tile_topk_desc``), which in the tiled strategies also merges each
   tile into the running carry (``ops.topk.merge_desc``, fused into the
   launch).

Four strategies, chosen per event type:

- **dense** (``_DenseRunner``): users in chunks, the whole [I_p, I_t] count
  matrix accumulated, then one K2 pass and one K3 row top-k — when the
  count matrix fits the reference's budget (``_DENSE_C_BYTES``), or
  ``PIO_CCO_DENSE=on``;
- **P-resident tiled** (``_cco_indicators_resident``): the densified
  primary stays on the device, item tiles of the other type are densified
  one at a time, and each tile's K3 top-b merges into a running carry —
  the full count matrix never exists;
- **chunked tiled** (``_cco_indicators_chunked``): when the resident
  working set misses its budget, each item tile sums its counts over user
  blocks of both types (``user_block``), re-densifying the primary's block
  for every tile; the same K2 and K3 per tile;
- **host sparse-count** (``_SparseHostRunner``): a per-user cross-join and
  a count on the host, O(E + Σ_u deg_P·deg_A), then either the host tail
  (the nonzero cells scored through ``llr_masked_cells``, the plain K2's
  own elementwise chain, on the training's device, and a row top-k by one
  lexsort on the host) or the device tail (K2 and K3 on the host-built
  counts, ``PIO_CCO_SPARSE_TAIL``).

All four count exactly and score every cell with the same f32 chain on the
training's device (K2 on the card, whose results equal its plain chain's
there bit for bit; the plain chain on the CPU), so on the same data and
device they give bit-identical indicator tables.

The rules that choose, against the reference's:

- ``PIO_CCO_DENSE=auto|on|off`` and ``PIO_CCO_SPARSE=auto|on|off`` are read
  as the reference reads them, but the sparse runner's ``auto`` differs on
  purpose: the reference picks it on any backend but the TPU; here it is
  picked when the target device is the CPU and never on CUDA, where the
  tensor cores invert the comparison as the MXU does.  ``on`` still forces
  it on the card, where its ``device`` tail runs K2 and K3.
- The P-resident budget counts the port's own bytes: 1 a cell for the
  resident primary and the A tile (int8, not the reference's bf16) and 8 a
  cell for the [I_p, tile] int32 counts and f32 scores, which are both live
  in the tile loop.  On CUDA it is measured against ``_RESIDENT_CARD_SHARE``
  of the card's memory (half: about n_users x I_p of 40 GB on an 80 GB
  card); on the CPU against the reference's 8 GiB, so the CPU picks what
  the reference picks.  Past it the chunked strategy takes over.
- The dense budgets stay the reference's.

Over a mesh of ranks (``mesh``, ``parallel.mesh.create_mesh``; one
process a device), as in the reference: the user space is split over the
mesh's ``dp`` axis (user chunks, or user blocks, padded to a multiple of
dp, rank r taking its contiguous share); each rank sums its partial counts
and marginals, which are summed over the ranks by one all-reduce
(``parallel.distributed.all_reduce_sum``, the reference's ``psum``) for
each event type (dense) or each item tile (chunked), two counts a 32-bit
word when the users fit 15 bits; then K2 and K3 run in every rank on the
full counts, so every rank holds the whole tables.  A
mesh takes the dense strategy when it fits, else the chunked one, never
the P-resident strategy or the sparse runner (the reference's rule).
Counts are exact, so a train over several ranks gives tables bit-identical
to one rank's on the same device.

Layouts: every 0/1 matrix is int8 and stored item-major, [items, users], so
the count product is ``Pt · Atᵀ`` with both operands in the layout the int8
tensor-core product takes (``torch._int_mm``: the first operand row-major,
the second column-major).  The host layout of blocked COO
(``BlockedInteractions``) is the reference's, array for array.

Staging: the tiled strategies copy a blocked layout to the device as it
is, 32-bit, and flatten it there (``_flatten_blocked_on``); flat (user,
item) ids are copied in the width they come in and widened there; the
dense strategy and the sparse runner take the layout flattened on the host
(``_flatten_blocked``).  Each staging copies its own input and nothing
staged outlives it.  Ids are checked on the host (``_check_ids``) before
any strategy but the one-rank dense one, which checks them on the device
as it stages them (``_StagedCOO``'s ``ids``): no host pass over the
events.  ``staging_by_route`` counts the stagings by route,
``strategy_by_type`` the event types by the strategy that trained them and
``dense_chunks`` the dense strategy's user-chunk passes; each dense run
(``_DenseRunner.dispatch``: its chunk loop, marginals, K2 and K3) is a
``cco.dense`` span.
"""

from __future__ import annotations

import dataclasses
import math
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.ops.hopper_kernels import (
    llr_masked_scores,
    row_counts,
    tile_topk_desc,
)
from predictionio_tpu_torch.ops.topk import block_width
from predictionio_tpu_torch.parallel.distributed import all_reduce_sum
from predictionio_tpu_torch.utils.tracing import timed

#: the reference's clamp ``-1 + 1e-9``, which rounds to exactly -1.0 in f32
_LOG1P_FLOOR = -1.0

# Budgets of the reference, copied as they are (sized there for one 16 GB
# TPU v5e).  The dense ones count 2 bytes a densified cell, the reference's
# bf16; the port's int8 matrices take half of that.
_TILED_P_BYTES = 8 << 30       # P-resident working set on the CPU
_DENSE_CHUNK_BYTES = 1 << 30   # per-chunk densified P + A
_DENSE_C_BYTES = 2 << 30       # the whole count matrix, 4 bytes a cell
_REF_BYTES_PER_CELL = 2
#: share of the card's memory the P-resident working set may take on CUDA
_RESIDENT_CARD_SHARE = 0.5

def _env_switch(name: str) -> Optional[bool]:
    """``auto`` (None), ``on`` (True) or ``off`` (False) from the
    environment, spelled as the reference spells them."""
    conf = os.environ.get(name, "auto").lower()
    if conf in ("0", "off", "false"):
        return False
    if conf in ("1", "on", "true"):
        return True
    return None


# ---------------------------------------------------------------------------
# host-side layout
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BlockedInteractions:
    """COO pairs grouped into fixed-size user blocks, padded to equal
    length (``predictionio_tpu/ops/cco.py:BlockedInteractions``).

    local_u[b, e] is the in-block user row (or 0 with mask 0), item[b, e]
    the item id.  Block b covers global users [b*block, (b+1)*block).  Pairs
    need not be unique: every consumer densifies by a scatter of ones."""

    local_u: np.ndarray   # int32 [n_blocks, E]
    item: np.ndarray      # int32 [n_blocks, E]
    mask: np.ndarray      # f32   [n_blocks, E]
    n_users: int
    n_items: int
    user_block: int

    @property
    def n_blocks(self) -> int:
        return self.local_u.shape[0]


def block_interactions(
    user: np.ndarray,
    item: np.ndarray,
    n_users: int,
    n_items: int,
    user_block: int = 1024,
    pad_multiple: int = 8,
    dedup: bool = False,
) -> BlockedInteractions:
    """Group raw COO by user block: the native counting layout
    (``native.layout_chunks``) when it loads, else the numpy one.
    ``dedup`` (off by default) only shrinks the padded width of heavily
    duplicated data."""
    from predictionio_tpu_torch.native import layout_chunks

    if dedup:
        user, item = dedup_pairs(user, item, n_items)
    user = np.asarray(user, np.int32)
    item = np.asarray(item, np.int32)
    n_blocks = max(math.ceil(n_users / user_block), 1)
    if len(user) and 0 <= int(user.min()) and int(user.max()) < n_blocks * user_block:
        native = layout_chunks(user, item, user_block, n_blocks, pad_multiple)
        if native is not None:
            lu, it, cnt = native
            mask = (np.arange(lu.shape[1]) < cnt[:, None]).astype(np.float32)
            return BlockedInteractions(lu, it, mask, n_users, n_items, user_block)
    return block_interactions_stream(
        [(user, item)], n_users, n_items,
        user_block=user_block, pad_multiple=pad_multiple,
    )


def block_interactions_stream(
    batches,
    n_users: int,
    n_items: int,
    user_block: int = 1024,
    pad_multiple: int = 8,
) -> BlockedInteractions:
    """``block_interactions`` over an iterator of (user, item) array
    batches: the host staging of event logs too large for one array.  Peak
    host memory is the grouped per-block copies plus the padded layout,
    freed block by block as the layout fills."""
    n_blocks = max(math.ceil(n_users / user_block), 1)
    per_block_u: List[List[np.ndarray]] = [[] for _ in range(n_blocks)]
    per_block_i: List[List[np.ndarray]] = [[] for _ in range(n_blocks)]
    for user, item in batches:
        user = np.asarray(user, np.int32)
        item = np.asarray(item, np.int32)
        blk = user // user_block
        order = np.argsort(blk, kind="stable")
        user, item, blk = user[order], item[order], blk[order]
        counts = np.bincount(blk, minlength=n_blocks)
        start = 0
        for b in range(n_blocks):
            c = int(counts[b])
            if c:
                sl = slice(start, start + c)
                per_block_u[b].append(user[sl] % user_block)
                per_block_i[b].append(item[sl])
                start += c
    sizes = [sum(len(a) for a in lists) for lists in per_block_u]
    width = max(max(sizes) if sizes else 1, 1)
    width = ((width + pad_multiple - 1) // pad_multiple) * pad_multiple
    lu = np.zeros((n_blocks, width), np.int32)
    it = np.zeros((n_blocks, width), np.int32)
    mk = np.zeros((n_blocks, width), np.float32)
    for b in range(n_blocks):
        c = sizes[b]
        if c:
            lu[b, :c] = np.concatenate(per_block_u[b])
            it[b, :c] = np.concatenate(per_block_i[b])
            mk[b, :c] = 1.0
        per_block_u[b] = per_block_i[b] = []   # free as we go
    return BlockedInteractions(lu, it, mk, n_users, n_items, user_block)


def interaction_counts(item: np.ndarray, n_items: int) -> np.ndarray:
    """Distinct-user count per item of dedup'd pairs."""
    return np.bincount(item, minlength=n_items).astype(np.float32)


def dedup_pairs(user: np.ndarray, item: np.ndarray, n_items: int):
    """Dedup (user, item) pairs, sorted by user then item — CCO is binary
    occurrence.  Host O(E log E): the sparse runner's CSR and the tests."""
    user = np.asarray(user, np.int64)
    item = np.asarray(item, np.int64)
    if not len(user):
        return user.astype(np.int32), item.astype(np.int32)
    flat = np.unique(user * n_items + item)
    return (flat // n_items).astype(np.int32), (flat % n_items).astype(np.int32)


def distinct_user_counts(user: np.ndarray, item: np.ndarray, n_items: int) -> np.ndarray:
    """Distinct users per item, straight from raw COO."""
    _, di = dedup_pairs(user, item, n_items)
    return interaction_counts(di, n_items)


#: stagings of event pairs by route, so a run can show which it took:
#: ``blocked_on_device``, a blocked layout flattened on the device (the tiled
#: strategies of ``cco_indicators``); ``pairs_on_device``, host (user, item)
#: arrays copied in their own width and widened on the device;
#: ``host_flatten``, a blocked layout flattened on the host
#: (``_flatten_blocked``: the dense and sparse routes of ``cco_indicators``)
staging_by_route = {"blocked_on_device": 0, "pairs_on_device": 0, "host_flatten": 0}
_staging_lock = threading.Lock()


def reset_staging_counts() -> None:
    """Set every route's staging count to 0."""
    with _staging_lock:
        staging_by_route.update(blocked_on_device=0, pairs_on_device=0, host_flatten=0)


def _count_staging(route: str) -> None:
    with _staging_lock:
        staging_by_route[route] += 1


#: event types trained, one count each, by the strategy that trained them:
#: ``dense`` (``_DenseRunner``), ``resident``, ``chunked`` (the tiled
#: loops) and ``sparse`` (``_SparseHostRunner``); and the dense strategy's
#: user-chunk passes, one a chunk and event type (``dense_chunks``)
strategy_by_type = {"dense": 0, "resident": 0, "chunked": 0, "sparse": 0}
dense_chunks = 0
_strategy_lock = threading.Lock()


def reset_strategy_counts() -> None:
    """Set ``strategy_by_type``'s counts and ``dense_chunks`` to 0."""
    global dense_chunks
    with _strategy_lock:
        strategy_by_type.update(dense=0, resident=0, chunked=0, sparse=0)
        dense_chunks = 0


def _count_strategy(strategy: str, chunks: int = 0) -> None:
    global dense_chunks
    with _strategy_lock:
        strategy_by_type[strategy] += 1
        dense_chunks += chunks


def _flatten_blocked(b: BlockedInteractions) -> Tuple[np.ndarray, np.ndarray]:
    """Blocked layout → global COO (the inverse of ``block_interactions``)."""
    _count_staging("host_flatten")
    gu = (np.arange(b.n_blocks, dtype=np.int64)[:, None] * b.user_block + b.local_u)
    keep = b.mask.ravel() > 0
    return gu.ravel()[keep].astype(np.int32), b.item.ravel()[keep].astype(np.int32)


def _ids_to(ids, device: torch.device) -> torch.Tensor:
    """Integer ids on ``device`` in the width they come in: a tensor moved
    as it is, a host int32 or int64 array in one copy with no host pass;
    any other dtype through NumPy's int64 first."""
    if torch.is_tensor(ids):
        return ids.to(device)
    ids = np.asarray(ids)
    if ids.dtype not in (np.int32, np.int64):
        ids = ids.astype(np.int64)
    return torch.as_tensor(ids, device=device)


@timed("cco.flatten")
def _flatten_blocked_on(b: BlockedInteractions,
                        device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_flatten_blocked`` on the device, as int64 tensors: the layout's
    three arrays copied as they are, one copy each; each pair's global user
    (block × ``user_block`` + local user) computed there, and the pairs
    whose mask is > 0 kept, in the layout's order."""
    _count_staging("blocked_on_device")
    keep = torch.as_tensor(b.mask, device=device) > 0
    base = torch.arange(b.n_blocks, dtype=torch.int64, device=device)[:, None] * b.user_block
    user = (base + _ids_to(b.local_u, device))[keep]
    return user, _ids_to(b.item, device)[keep].to(torch.int64)


def _pairs_on(pairs, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A staging's input as (user, item) int64 tensors on ``device``:
    ``pairs`` is a ``BlockedInteractions`` (flattened there) or a (user,
    item) pair of host arrays or tensors (copied in their width, widened
    there)."""
    if isinstance(pairs, BlockedInteractions):
        return _flatten_blocked_on(pairs, device)
    user, item = pairs
    if not torch.is_tensor(user):
        _count_staging("pairs_on_device")
    return _ids_to(user, device).to(torch.int64), _ids_to(item, device).to(torch.int64)


# ---------------------------------------------------------------------------
# LLR (the plain scoring function; K2 is its fused kernel)
# ---------------------------------------------------------------------------


def _llr_term(k, sign_d, d, row_marg, col_marg):
    # k·log(k·N/(row·col)) rewritten as k·log1p(±D/(row·col))
    arg = sign_d * d / torch.clamp_min(row_marg * col_marg, 1e-30)
    return torch.where(k > 0, k * torch.log1p(torch.clamp_min(arg, _LOG1P_FLOOR)),
                       0.0)


def llr_score(k11, k12, k21, k22):
    """Dunning G² (Mahout ``LogLikelihood.logLikelihoodRatio``) of f32
    tables, in the determinant form of the reference: for a 2×2 table
    k_ij·N − r_i·c_j = ±D with D = k11·k22 − k12·k21, so
    G² = 2·Σ k·log1p(±D/(r·c)).  Same f32 operations in the same order as
    ``predictionio_tpu/ops/cco.py:llr_score``."""
    r1, r2 = k11 + k12, k21 + k22
    c1, c2 = k11 + k21, k12 + k22
    d = k11 * k22 - k12 * k21
    g2 = 2.0 * (
        _llr_term(k11, 1.0, d, r1, c1)
        + _llr_term(k12, -1.0, d, r1, c2)
        + _llr_term(k21, -1.0, d, r2, c1)
        + _llr_term(k22, 1.0, d, r2, c2)
    )
    return torch.clamp_min(g2, 0.0)


def llr_masked_cells(c, row, col, n_total: float, threshold: float):
    """G² of f32 counts ``c`` against their row and column marginals
    (tensors broadcastable to ``c``), -inf where the count is 0 or G² <
    ``threshold``: the elementwise chain of K2's plain version, which is
    this function on [R, 1] and [1, C] marginals.  The sparse tails score
    their gathered cells through it on 1-D tensors, so a cell's score is
    the dense tail's value at that cell, bit for bit."""
    k12 = row - c
    k21 = col - c
    k22 = n_total - c - k12 - k21
    scores = torch.where(c > 0, llr_score(c, k12, k21, k22), float("-inf"))
    return torch.where(scores >= threshold, scores, float("-inf"))


def _llr_mask_scores(c, row_counts, col_counts, n_total, llr_threshold):
    """The LLR scoring + masking every dense tile shares: always the K2
    kernel (its plain version for CPU tensors)."""
    return llr_masked_scores(c, row_counts, col_counts, float(n_total),
                             float(llr_threshold))


@timed("cco.finalize")
def _finalize_topk(best_scores, best_idx, n_items_t: int,
                   top_k: Optional[int] = None):
    """Host epilogue: -1-pad entries that are -inf or padding columns, and
    slice a power-of-two carry back to ``top_k``.  Takes tensors on any
    device, or host arrays."""
    scores = np.asarray(best_scores.cpu() if torch.is_tensor(best_scores) else best_scores)
    idx = np.asarray(best_idx.cpu() if torch.is_tensor(best_idx) else best_idx)
    idx = idx.astype(np.int32)
    if top_k is not None and scores.shape[1] > top_k:
        scores, idx = scores[:, :top_k], idx[:, :top_k]
    idx = np.where((scores > -np.inf) & (idx < n_items_t), idx, -1)
    return np.where(idx >= 0, scores, -np.inf).astype(np.float32), idx


# ---------------------------------------------------------------------------
# densify and count
# ---------------------------------------------------------------------------


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _item_rows(n_items: int) -> int:
    """Rows of an item-major int8 matrix: a multiple of 8, and more than 16
    (the int8 product's shape rules); padding rows stay zero."""
    return _round_up(max(n_items, 17), 8)


def _densify(items: torch.Tensor, users: torch.Tensor, n_rows: int,
             n_cols: int) -> torch.Tensor:
    """0/1 int8 matrix [n_rows, n_cols] with ones at (items, users): a
    scatter of ones, so duplicate pairs collapse — this IS the dedup."""
    m = torch.zeros((n_rows, n_cols), dtype=torch.int8, device=items.device)
    m[items, users] = 1
    return m


def _count_product(pt: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
    """Exact cooccurrence counts ``pt · atᵀ`` → int32 [pt rows, at rows] of
    two item-major 0/1 int8 matrices over the same users.

    On the card: the int8 tensor-core product ``torch._int_mm``, whose int32
    accumulation is exact to 2**31 (a bf16 product would return bf16, exact
    only to 256).  On the CPU: an f32 product, exact while counts stay below
    2**24 users.  The reference leaves this product to XLA, outside any
    Pallas kernel, so it is a library call here too."""
    if pt.device.type == "cuda":
        return torch._int_mm(pt, at.t())
    return (pt.to(torch.float32) @ at.to(torch.float32).t()).to(torch.int32)


def _marginal(m: torch.Tensor, out: Optional[torch.Tensor] = None,
              accumulate: bool = False) -> torch.Tensor:
    """Distinct users per item of an item-major 0/1 matrix, exact int32,
    written into ``out`` or, with ``accumulate``, added to it: on the card
    the row-count kernel, one pass over the int8 bytes with no int32 copy."""
    return row_counts(m, out, accumulate)


class _StagedCOO:
    """One event type's raw (user, item) pairs on the device, sorted by a
    key with the host-side boundaries of every span — one sort, one small
    readback.  ``by="user"``: spans of ``step`` users (user chunks or
    blocks); ``by="item"``: spans of ``step`` items (item tiles), and with
    ``block`` each tile further split into user blocks of ``block`` users,
    tile-major, so every (tile, block) span is one slice (``span2``).
    ``ids=(n_users, n_items, what)`` checks every id there, read back with
    the boundaries, and raises as ``_check_ids`` does."""

    def __init__(self, user, item, device: torch.device, by: str, step: int,
                 n_steps: int, block: Optional[int] = None, n_blocks: int = 1,
                 ids: Optional[Tuple[int, int, str]] = None):
        u, i = _pairs_on((user, item), device)
        if len(u) != len(i):
            raise ValueError(f"user/item length mismatch: {len(u)} vs {len(i)}")
        self.n_blocks = n_blocks if block is not None else 1
        if block is not None:
            key = torch.div(i, step, rounding_mode="floor") * n_blocks \
                + torch.div(u, block, rounding_mode="floor")
            starts = torch.arange(n_steps * n_blocks + 1, device=device, dtype=torch.int64)
        else:
            key = u if by == "user" else i
            starts = torch.arange(n_steps + 1, device=device, dtype=torch.int64) * step
        key, order = torch.sort(key, stable=True)
        self.user, self.item = u[order], i[order]
        bounds = torch.searchsorted(key, starts)
        check = ids is not None and len(u) > 0
        if check:
            bounds = torch.cat([bounds, torch.stack([u.min(), u.max(), i.min(), i.max()])])
        self.bounds: List[int] = bounds.tolist()
        if check:
            _check_extremes(*self.bounds[-4:], *ids)
            del self.bounds[-4:]
        self.step = step

    def span(self, s: int) -> Tuple[torch.Tensor, torch.Tensor]:
        lo, hi = self.bounds[s], self.bounds[s + 1]
        return self.user[lo:hi], self.item[lo:hi]

    def span2(self, t: int, b: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The pairs of item tile ``t`` and user block ``b``."""
        return self.span(t * self.n_blocks + b)


def _mesh_share(n_spans: int, mesh) -> Tuple[int, int]:
    """(this rank's first span, its span count): the spans padded to a
    multiple of dp, rank r taking spans [r * per, (r + 1) * per)."""
    if mesh is None:
        return 0, n_spans
    per = math.ceil(n_spans / mesh.shape["dp"])
    return mesh.position("dp") * per, per


def _local_pairs(user, item, lo: int, hi: int):
    """The pairs of users [lo, hi), users renumbered from 0, of host arrays
    or of tensors."""
    if not torch.is_tensor(user):
        user, item = np.asarray(user), np.asarray(item)
    if lo == 0 and (len(user) == 0 or int(user.max()) < hi):
        return user, item
    keep = (user >= lo) & (user < hi)
    return user[keep] - lo, item[keep]


#: with fewer users than this every count and marginal fits 15 bits, so an
#: all-reduce carries two of them in one int32 word: lane sums stay below
#: the number of users (each user is on one rank), with no carry between
#: the lanes and no sign
_PACK_USERS = 1 << 15


def _pack_pairs(buf: torch.Tensor) -> torch.Tensor:
    """Counts ``buf`` (flat int32, each < 2**15) two a word: even index in
    the low 16 bits, odd index in the high."""
    packed = buf[0::2].clone()
    packed[:buf.numel() // 2] += buf[1::2] << 16
    return packed


def _unpack_pairs(packed: torch.Tensor, buf: torch.Tensor) -> None:
    """``_pack_pairs`` undone into ``buf``."""
    buf[0::2] = packed & 0xFFFF
    buf[1::2] = (packed >> 16)[:buf.numel() // 2]


def _all_reduce_counts(buf: torch.Tensor, mesh, n_users: int) -> None:
    """Sum a flat int32 count buffer over the mesh's dp ranks in one
    all-reduce: two counts a word when the users fit ``_PACK_USERS`` (half
    the bytes), else as they are."""
    if mesh.group("dp") is None:
        return
    if n_users >= _PACK_USERS:
        all_reduce_sum(buf, mesh)
        return
    packed = _pack_pairs(buf)
    all_reduce_sum(packed, mesh)
    _unpack_pairs(packed, buf)


def _count_buffer(*shapes, device) -> List[torch.Tensor]:
    """Zeroed int32 tensors of ``shapes`` as views of ONE buffer (the
    first is the buffer's head), so a mesh sums them in one all-reduce."""
    sizes = [math.prod(sh) for sh in shapes]
    buf = torch.zeros(sum(sizes), dtype=torch.int32, device=device)
    return [buf] + [v.view(sh) for v, sh in zip(buf.split(sizes), shapes)]


def _check_extremes(u_min: int, u_max: int, i_min: int, i_max: int,
                    n_users: int, n_items: int, what: str) -> None:
    if u_min < 0 or u_max >= n_users:
        raise ValueError(f"{what}: user ids outside [0, {n_users})")
    if i_min < 0 or i_max >= n_items:
        raise ValueError(f"{what}: item ids outside [0, {n_items})")


@timed("cco.check_ids")
def _check_ids(user, item, n_users: int, n_items: int, what: str) -> None:
    def extremes(a):
        a = np.asarray(a)
        return (int(a.min()), int(a.max())) if len(a) else (0, -1)

    _check_extremes(*extremes(user), *extremes(item), n_users, n_items, what)


# ---------------------------------------------------------------------------
# dense user-chunked strategy
# ---------------------------------------------------------------------------


def _dense_chunk_users(n_items_p: int, it_pad: int, n_users: int, dp: int = 1) -> int:
    """Chunk size minimizing padded-user waste: the number of chunks the
    budget forces (a multiple of dp), then users split evenly
    (``predictionio_tpu/ops/cco.py:_dense_chunk_users``)."""
    per_user = (n_items_p + it_pad) * _REF_BYTES_PER_CELL
    max_chunk = max(_DENSE_CHUNK_BYTES // max(per_user, 1), 256)
    n_chunks = max(math.ceil(n_users / max_chunk), 1)
    n_chunks = math.ceil(n_chunks / dp) * dp
    chunk = math.ceil(n_users / n_chunks / 256) * 256
    return max(chunk, 256)


def _dense_path_ok(n_items_p: int, n_items_t: int) -> bool:
    """The dense strategy: ``PIO_CCO_DENSE=on|off`` forces it either way;
    ``auto`` takes it when the whole int32 count matrix fits its budget
    (the reference's rule)."""
    forced = _env_switch("PIO_CCO_DENSE")
    if forced is not None:
        return forced
    it_pad = max(_round_up(n_items_t, 128), 128)
    return n_items_p * it_pad * 4 <= _DENSE_C_BYTES


def _llr_topk_dense(C, rc, cc, n_total, llr_threshold, top_k: int,
                    exclude_self: bool):
    """K2 over the whole count matrix, the diagonal masked for the
    self-indicator BEFORE the top-k (so every row still gets top_k
    correlators), then the K3 row top-k."""
    scores = _llr_mask_scores(C, rc, cc, n_total, llr_threshold)
    if exclude_self:
        scores.diagonal().fill_(float("-inf"))
    bs, bi = tile_topk_desc(scores, block_width(top_k))
    return bs[:, :top_k], bi[:, :top_k]


class _DenseRunner:
    """Stages a primary event type once and runs the dense strategy for
    each event type against it.  One instance per training run.
    ``n_total_users`` is the LLR population, which may exceed ``n_users``
    when the pairs are one slice of a larger user space.  Over a ``mesh``
    the user chunks are padded to a multiple of dp and this rank stages
    and counts its contiguous share of them."""

    def __init__(self, p_user, p_item, n_users: int, n_items_p: int,
                 it_pad_max: int, device: torch.device,
                 n_total_users: Optional[int] = None, mesh=None):
        self.device = device
        self.mesh = mesh
        self.n_users = n_users
        self.n_total_users = n_total_users if n_total_users else n_users
        self.n_items_p = n_items_p
        dp = mesh.shape["dp"] if mesh is not None else 1
        self.chunk = _dense_chunk_users(n_items_p, it_pad_max, n_users, dp)
        c0, self.n_chunks = _mesh_share(
            math.ceil(max(n_users, 1) / self.chunk), mesh)
        self.users = (c0 * self.chunk, (c0 + self.n_chunks) * self.chunk)
        self.p = self._stage(p_user, p_item, n_items_p, "primary")

    def _stage(self, user, item, n_items: int, what: str) -> _StagedCOO:
        """One type's pairs staged by user chunk, its ids checked: on one
        rank on the device, as they are staged; over a mesh on the host
        first, before this rank's share is cut out and renumbered."""
        if self.mesh is None:
            return _StagedCOO(user, item, self.device, "user", self.chunk,
                              self.n_chunks, ids=(self.n_users, n_items, what))
        _check_ids(user, item, self.n_users, n_items, what)
        user, item = _local_pairs(user, item, *self.users)
        return _StagedCOO(user, item, self.device, "user", self.chunk,
                          self.n_chunks)

    def _densify_chunk(self, staged: _StagedCOO, c: int, n_items: int):
        u, i = staged.span(c)
        return _densify(i, u - c * self.chunk, _item_rows(n_items), self.chunk)

    def counts(self, a_user, a_item, n_items_t: int, self_pair: bool = False,
               what: str = "other"):
        """(C [I_p, it_pad] int32, row marginals [I_p], column marginals
        [it_pad]) on the device: the sum over user chunks of ``Pᵀ·A``."""
        if self_pair:
            it_pad, a = self.n_items_p, self.p
        else:
            it_pad = max(_round_up(n_items_t, 128), 128)
            a = self._stage(a_user, a_item, max(n_items_t, 1), what)
        i_p = self.n_items_p
        buf, C, rc, cc = _count_buffer((i_p, it_pad), (i_p,), (it_pad,),
                                       device=self.device)
        for c in range(self.n_chunks):
            pt = self._densify_chunk(self.p, c, i_p)
            at = pt if self_pair else self._densify_chunk(a, c, it_pad)
            C += _count_product(pt, at)[:i_p, :it_pad]
            _marginal(pt[:i_p], rc, accumulate=True)
            _marginal(at[:it_pad], cc, accumulate=True)
        if self.mesh is not None:   # the reference's psum, once a type
            _all_reduce_counts(buf, self.mesh, self.n_users)
        return C, rc, cc

    @timed("cco.dense")
    def dispatch(self, a_user, a_item, n_items_t: int, top_k: int,
                 llr_threshold: float, exclude_self: bool,
                 self_pair: bool = False, what: str = "other"):
        """One event type's indicators, left on the device until
        ``collect``; ``what`` names the type in an id error."""
        _count_strategy("dense", self.n_chunks)
        C, rc, cc = self.counts(a_user, a_item, n_items_t, self_pair, what)
        k = min(top_k, C.shape[1])
        s, i = _llr_topk_dense(C, rc, cc, float(self.n_total_users),
                               float(llr_threshold), k, bool(exclude_self))
        return s, i, n_items_t, top_k

    @staticmethod
    def collect(dispatched) -> Tuple[np.ndarray, np.ndarray]:
        s_dev, i_dev, n_items_t, req_k = dispatched
        scores, idx = _finalize_topk(s_dev, i_dev, n_items_t)
        pad = req_k - scores.shape[1]
        if pad > 0:   # restore the promised [I_p, req_k] width
            scores = np.pad(scores, ((0, 0), (0, pad)), constant_values=-np.inf)
            idx = np.pad(idx, ((0, 0), (0, pad)), constant_values=-1)
        return scores, idx


# ---------------------------------------------------------------------------
# the tiled strategies (large catalogs: the count matrix never exists)
# ---------------------------------------------------------------------------


def _resident_budget(device: torch.device) -> int:
    """Bytes the P-resident working set may take: ``_RESIDENT_CARD_SHARE``
    of the card's memory on CUDA, the reference's ``_TILED_P_BYTES`` on the
    CPU."""
    if device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
        return int(_RESIDENT_CARD_SHARE * total)
    return _TILED_P_BYTES


def _resident_p_ok(n_users: int, n_items_p: int, item_tile: int,
                   device: torch.device) -> bool:
    """The P-resident strategy when its whole working set fits the budget
    of ``device``: the resident P and one A tile at 1
    byte a cell, and the [I_p, tile] int32 counts and f32 scores at 8.  The
    reference also caps bf16 at 2**24 users; the int8 product accumulates
    in int32 and has no such cap."""
    n_rows = max(_round_up(n_users, 128), 128)
    working = n_rows * _item_rows(n_items_p) + n_rows * _round_up(item_tile, 8) \
        + n_items_p * item_tile * 8
    return working <= _resident_budget(device)


def _tile_slab(m: torch.Tensor, start: int, width: int) -> torch.Tensor:
    """Rows [start, start + width) of item-major ``m``, widened to a
    multiple of 8 rows (zeros past ``m``'s end): a view where ``m`` has the
    rows, else a padded copy.  Extra rows only add count columns the caller
    slices off."""
    w8 = _round_up(width, 8)
    if start + w8 <= m.shape[0]:
        return m[start:start + w8]
    out = torch.zeros((w8, m.shape[1]), dtype=m.dtype, device=m.device)
    have = max(min(m.shape[0] - start, w8), 0)
    out[:have] = m[start:start + have]
    return out


def _tile_tail(scores, t0: int, exclude_self: bool, b: int, carry):
    """The per-tile tail both tiled strategies share: the diagonal masked
    for the self-indicator (the items t0 + j of this tile's rows t0 + j),
    then K3's top-b of the tile merged into the carry in one launch."""
    if exclude_self:
        scores.diagonal(offset=-t0).fill_(float("-inf"))
    return tile_topk_desc(scores, b, id_offset=t0, carry=carry)


def _initial_carry(n_rows: int, top_k: int, device: torch.device):
    b = block_width(top_k)
    return (torch.full((n_rows, b), float("-inf"), dtype=torch.float32, device=device),
            torch.zeros((n_rows, b), dtype=torch.int32, device=device))


class _ResidentPrimary:
    """The densified primary, item-major [I_p rows, users], built once per
    training run and shared by every tiled event type.  ``pairs``: a
    staging's input (``_pairs_on``), freed when the primary is built."""

    @timed("cco.stage")
    def __init__(self, pairs, n_users: int, n_items_p: int, device: torch.device):
        self.n_items_p = n_items_p
        self.n_rows = max(_round_up(n_users, 128), 128)   # users, padded
        u, i = _pairs_on(pairs, device)
        self.pt = _densify(i, u, _item_rows(n_items_p), self.n_rows)
        self.rc = _marginal(self.pt[:n_items_p])


def _cco_indicators_resident(
    primary: _ResidentPrimary, a, n_items_t: int,
    n_total_users: int, top_k: int, llr_threshold: float, item_tile: int,
    exclude_self: bool, self_pair: bool,
) -> Tuple[np.ndarray, np.ndarray]:
    """Item tiles of the other event type ``a`` (a staging's input, unused
    for the self-indicator) against the resident primary: densify the tile
    (a slice of P itself for the self-indicator), one count product, K2,
    the diagonal mask, and K3's top-b of the tile merged into the carry in
    one launch.  The carry is ``block_width(top_k)`` wide."""
    _count_strategy("resident")
    pt, i_p = primary.pt, primary.n_items_p
    device = pt.device
    tile = min(item_tile, max(n_items_t, 1))
    n_tiles = math.ceil(n_items_t / tile)
    if not self_pair:
        with timed("cco.stage"):
            a = _StagedCOO(*_pairs_on(a, device), device, "item", tile, n_tiles)
    b = block_width(top_k)
    best = _initial_carry(i_p, top_k, device)
    with timed("cco.tiles"):
        for t in range(n_tiles):
            t0 = t * tile
            if self_pair:
                at = _tile_slab(pt, t0, tile)
            else:
                u, i = a.span(t)
                at = _densify(i - t0, u, _round_up(tile, 8), primary.n_rows)
            counts = _count_product(pt, at)[:i_p, :tile]
            scores = _llr_mask_scores(counts, primary.rc, _marginal(at)[:tile],
                                      n_total_users, llr_threshold)
            best = _tile_tail(scores, t0, exclude_self, b, best)
            # free this tile's [I_p, tile] counts and scores before the next
            # product allocates its own: one of each is live, not two
            del counts, scores
    return _finalize_topk(*best, n_items_t, top_k)


class _ChunkedPrimary:
    """The primary's pairs staged once on the device in user blocks of
    ``user_block`` users; each block densifies on demand, item-major
    [I_p rows, block columns].  ``rc`` (distinct users per item) is summed
    over the blocks by the first tile that runs and kept.  Over a ``mesh``
    the blocks are padded to a multiple of dp and this rank holds its
    contiguous share of them (``local``: its users, renumbered)."""

    @timed("cco.stage")
    def __init__(self, pairs, n_users: int, n_items_p: int,
                 user_block: int, device: torch.device, mesh=None):
        if user_block < 1:
            raise ValueError(f"user_block must be positive, got {user_block}")
        self.n_items_p = n_items_p
        self.n_users = n_users
        self.block = user_block
        self.mesh = mesh
        self.device = device
        self.cols = _round_up(user_block, 8)   # the int8 product's k rule
        b0, self.n_blocks = _mesh_share(max(math.ceil(n_users / user_block), 1), mesh)
        self.users = (b0 * user_block, (b0 + self.n_blocks) * user_block)
        self.p = _StagedCOO(*self.local(pairs), device, "user", user_block,
                            self.n_blocks)
        self.rc: Optional[torch.Tensor] = None

    def local(self, pairs):
        """This rank's pairs of a staging's input, on the device."""
        return _local_pairs(*_pairs_on(pairs, self.device), *self.users)

    def block_matrix(self, b: int) -> torch.Tensor:
        u, i = self.p.span(b)
        return _densify(i, u - b * self.block, _item_rows(self.n_items_p), self.cols)


def _cco_indicators_chunked(
    primary: _ChunkedPrimary, a, n_items_t: int,
    n_total_users: int, top_k: int, llr_threshold: float, item_tile: int,
    exclude_self: bool, self_pair: bool,
) -> Tuple[np.ndarray, np.ndarray]:
    """The chunked tiled strategy (``predictionio_tpu/ops/cco.py:
    _cco_chunked_all_tiles``): for each item tile, for each user block,
    densify the block of P and the block's in-tile slice of A (a slice of
    the P block itself for the self-indicator), add their count product to
    the tile's int32 counts and the marginals; then the tile's K2, the
    diagonal mask and K3 with its carry, as the resident strategy runs
    them.  A block with no pairs of the tile adds nothing and is skipped
    once ``rc`` is known.  The other type ``a`` (a staging's input, unused
    for the self-indicator) is staged once, sorted by (tile, block).  Over
    a mesh each rank sums its own blocks, and one all-reduce
    a tile (the reference's ``psum``, ``_cco_tile_step``) sums the tile's
    counts and marginals over the ranks before K2 and K3 run in every
    rank."""
    _count_strategy("chunked")
    device, i_p = primary.device, primary.n_items_p
    tile = min(item_tile, max(n_items_t, 1))
    n_tiles = math.ceil(n_items_t / tile)
    w8 = _round_up(tile, 8)
    if not self_pair:
        with timed("cco.stage"):
            a = _StagedCOO(*primary.local(a), device, "item", tile, n_tiles,
                           block=primary.block, n_blocks=primary.n_blocks)
    b = block_width(top_k)
    best = _initial_carry(i_p, top_k, device)
    with timed("cco.tiles"):
        for t in range(n_tiles):
            t0 = t * tile
            need_rc = primary.rc is None
            shapes = [(_item_rows(i_p), w8), (w8,)] + ([(i_p,)] if need_rc else [])
            buf, counts, cc, *rc = _count_buffer(*shapes, device=device)
            rc = rc[0] if need_rc else primary.rc
            for blk in range(primary.n_blocks):
                if not self_pair:
                    u, i = a.span2(t, blk)
                    if len(u) == 0 and not need_rc:
                        continue
                pb = primary.block_matrix(blk)
                if need_rc:
                    _marginal(pb[:i_p], rc, accumulate=True)
                if self_pair:
                    at = _tile_slab(pb, t0, tile)
                elif len(u) == 0:
                    continue
                else:
                    at = _densify(i - t0, u - blk * primary.block, w8, primary.cols)
                counts += _count_product(pb, at)
                _marginal(at, cc, accumulate=True)
                del pb, at
            if primary.mesh is not None:
                _all_reduce_counts(buf, primary.mesh, primary.n_users)
            if need_rc:   # kept past this tile: not as a view holding the buffer
                primary.rc = rc.clone()
            del buf
            scores = _llr_mask_scores(counts[:i_p, :tile], rc, cc[:tile],
                                      n_total_users, llr_threshold)
            del counts, cc, rc   # the last views of the buffer: freed before K3
            best = _tile_tail(scores, t0, exclude_self, b, best)
            del scores
    return _finalize_topk(*best, n_items_t, top_k)


# ---------------------------------------------------------------------------
# host sparse-count strategy (the CPU's, low-density workloads)
# ---------------------------------------------------------------------------

# Budgets of the host path, the reference's: the expanded per-user
# cross-join and the host count matrix.  Past either, the densified count
# product is the better deal even on the CPU.
_SPARSE_PAIR_BUDGET = 200_000_000
_SPARSE_C_BYTES = 512 << 20
_SPARSE_CHUNK_PAIRS = 8_000_000   # cross-join temporaries cap (~64 MB a chunk)
# Matrices at or under this cell count may use the bincount accumulation
# branch (which loses per-cell identities: a chunk that takes it downgrades
# want_coo to one final flatnonzero scan, bounded by this same size).
_SPARSE_BINCOUNT_CELLS = 16 << 20
# Touched-cell collection holds up to one int64 per cross-join pair; past
# this pair count the tail falls back to one flatnonzero scan of C.
_SPARSE_COO_PAIRS = 32_000_000


def _sparse_path_ok(device: torch.device) -> bool:
    """The host sparse-count strategy: ``PIO_CCO_SPARSE=on|off`` forces it
    either way; ``auto`` takes it when the training's device is the CPU and
    never on CUDA.  At low occupancy the densified product does
    O(U·I_p·I_t) work for O(E) information, which loses on a CPU; the
    tensor cores invert that comparison (the reference's ``auto`` picks it
    on every backend but the TPU)."""
    forced = _env_switch("PIO_CCO_SPARSE")
    if forced is not None:
        return forced
    return device.type == "cpu"


class _SparseHostCSR:
    """One event type's dedup'd (user, item) pairs, user-sorted, with
    degrees — the reusable half of a host cross-join.  ``dedup_pairs``
    sorts by user·n_items + item, so no extra sort happens here."""

    def __init__(self, user: np.ndarray, item: np.ndarray, n_items: int,
                 n_users: int):
        self.user, self.item = dedup_pairs(user, item, n_items)
        self.n_items = n_items
        self.deg = np.bincount(self.user, minlength=n_users).astype(np.int64)
        self.start = np.concatenate([[0], np.cumsum(self.deg)])
        self.col_counts = np.bincount(self.item, minlength=n_items).astype(np.int32)


def _cross_join_pairs(p: _SparseHostCSR, a: _SparseHostCSR) -> int:
    """Σ_u deg_P(u)·deg_A(u): the exact cross-join size, an upper bound on
    the count matrix's nonzero cells."""
    n = min(len(p.deg), len(a.deg))
    return int((p.deg[:n] * a.deg[:n]).sum())


def _cross_join_flat_chunks(p: _SparseHostCSR, a: _SparseHostCSR):
    """Yield the cross-join's flat cell indices (p_item·I_t + a_item,
    int64) in chunks of about ``_SPARSE_CHUNK_PAIRS`` pairs: the one
    expansion loop behind every host count."""
    I_t = a.n_items
    rep_all = a.deg[p.user]                   # partners per primary entry
    csum_all = np.cumsum(rep_all)
    lo = 0
    while lo < len(p.user):
        hi = int(np.searchsorted(
            csum_all, (csum_all[lo - 1] if lo else 0) + _SPARSE_CHUNK_PAIRS,
            side="left")) + 1
        hi = min(max(hi, lo + 1), len(p.user))
        rep = rep_all[lo:hi]
        chunk = int(rep.sum())
        if chunk:
            p_rep = np.repeat(p.item[lo:hi], rep)
            offs = np.repeat(a.start[p.user[lo:hi]], rep)
            csum = np.cumsum(rep)
            within = np.arange(chunk, dtype=np.int64) - np.repeat(csum - rep, rep)
            yield p_rep.astype(np.int64) * I_t + a.item[offs + within]
        lo = hi


def _sparse_counts(p: _SparseHostCSR, a: _SparseHostCSR,
                   want_coo: bool = False,
                   total_pairs: Optional[int] = None):
    """Exact cooccurrence counts C[i, j] = |users with both| by the host
    cross-join and a bincount or unique count: the same integers as the
    densified product.  None when the expansion or the count matrix would
    blow the host budgets (the caller takes a device strategy).

    ``want_coo=True`` returns ``(C, flat)``, ``flat`` the sorted unique
    flat indices of C's nonzero cells: collected from the unique-branch
    chunks while the pair count fits ``_SPARSE_COO_PAIRS``, else (or when a
    bincount-branch chunk ran) one final flatnonzero scan."""
    I_p, I_t = p.n_items, a.n_items
    if I_p * I_t * 4 > _SPARSE_C_BYTES:
        return None
    total = _cross_join_pairs(p, a) if total_pairs is None else total_pairs
    if total > _SPARSE_PAIR_BUDGET:
        return None
    touched: Optional[list] = [] if want_coo and total <= _SPARSE_COO_PAIRS else None
    C = np.zeros(I_p * I_t, np.int32)         # counts <= n_users < 2**31
    if total == 0:
        empty = np.empty(0, np.int64)
        return (C.reshape(I_p, I_t), empty) if want_coo else C.reshape(I_p, I_t)
    for flat in _cross_join_flat_chunks(p, a):
        if I_p * I_t <= _SPARSE_BINCOUNT_CELLS and len(flat) * 8 >= I_p * I_t:
            # a dense-ish chunk over a small matrix: an O(n + cells)
            # bincount beats the sort-based unique
            C += np.bincount(flat, minlength=I_p * I_t).astype(np.int32)
            touched = None   # identities lost; the tail rescans
        else:
            cells, counts = np.unique(flat, return_counts=True)
            C[cells] += counts.astype(np.int32)
            if touched is not None:
                touched.append(cells)
    if not want_coo:
        return C.reshape(I_p, I_t)
    if touched is None:
        flat_nz = np.flatnonzero(C)
    elif touched:
        flat_nz = np.unique(np.concatenate(touched))
    else:
        flat_nz = np.empty(0, np.int64)
    return C.reshape(I_p, I_t), flat_nz


def _sparse_counts_coo(p: _SparseHostCSR, a: _SparseHostCSR,
                       total_pairs: Optional[int] = None):
    """Counts as (sorted unique flat cell indices, int32 counts), never
    holding the dense [I_p, I_t] matrix: the count path for catalogs whose
    I_p·I_t·4 blows ``_SPARSE_C_BYTES``.  Per-chunk uniques merge at the
    end with one argsort and a segment sum.  None past
    ``_SPARSE_COO_PAIRS``."""
    total = _cross_join_pairs(p, a) if total_pairs is None else total_pairs
    if total > _SPARSE_COO_PAIRS:
        return None
    if total == 0:
        return np.empty(0, np.int64), np.empty(0, np.int32)
    cells_parts: List[np.ndarray] = []
    count_parts: List[np.ndarray] = []
    for flat in _cross_join_flat_chunks(p, a):
        cells, counts = np.unique(flat, return_counts=True)
        cells_parts.append(cells)
        count_parts.append(counts.astype(np.int32))
    if len(cells_parts) == 1:
        return cells_parts[0], count_parts[0]
    cells = np.concatenate(cells_parts)
    counts = np.concatenate(count_parts)
    order = np.argsort(cells, kind="stable")
    cells, counts = cells[order], counts[order]
    new = np.concatenate(([True], cells[1:] != cells[:-1]))
    starts = np.flatnonzero(new)
    summed = np.add.reduceat(counts.astype(np.int64), starts)
    return cells[starts], summed.astype(np.int32)


def _score_llr_cells(k11, rc_g, cc_g, n_total, llr_threshold,
                     device: Optional[torch.device] = None) -> np.ndarray:
    """f32 score (-inf = masked) of each gathered cell: ``llr_masked_cells``
    on 1-D tensors, the one scoring function of every sparse tail.  The
    cells are scored on the training's ``device`` (the CPU when None), as
    the reference jits its cell scoring onto its default backend: a
    cell's f32 score then equals the dense tail's on the same device bit
    for bit (the CPU's libm and the card's differ in the last bit of some
    logarithms, so a CPU score can miss the card's K2 by one ulp)."""
    if len(k11) == 0:
        return np.zeros(0, np.float32)

    def f32(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device or "cpu")

    return llr_masked_cells(f32(k11), f32(rc_g), f32(cc_g), float(n_total),
                            float(llr_threshold)).cpu().numpy()


def _select_topk_cells(rows, cols, scores, n_rows: int, width: int):
    """Each row's top ``width`` of finite-scored cells (``rows`` in
    [0, n_rows)) by (score desc, column asc) — ``lax.top_k``'s order —
    into [n_rows, width] outputs (-inf / -1 padded).  Rows are independent,
    so callers may split the cells at row boundaries."""
    out_s = np.full((n_rows, width), -np.inf, np.float32)
    out_i = np.full((n_rows, width), -1, np.int32)
    if len(rows):
        order = np.lexsort((cols, -scores, rows))
        rows, cols, scores = rows[order], cols[order], scores[order]
        starts = np.concatenate([[0], np.flatnonzero(np.diff(rows)) + 1])
        counts = np.diff(np.concatenate([starts, [len(rows)]]))
        rank = np.arange(len(rows)) - np.repeat(starts, counts)
        sel = rank < width
        out_s[rows[sel], rank[sel]] = scores[sel]
        out_i[rows[sel], rank[sel]] = cols[sel]
    return out_s, out_i


def _llr_topk_cells(rows, cols, k11, rc_g, cc_g, n_total, llr_threshold,
                    n_rows: int, width: int, device: Optional[torch.device] = None):
    """The sparse selection tail: score the gathered nonzero cells
    (``_score_llr_cells`` on ``device``) and select each row's top
    ``width`` on the host."""
    if len(rows):
        scores = _score_llr_cells(k11, rc_g, cc_g, n_total, llr_threshold, device)
        keep = scores > -np.inf
        rows, cols, scores = rows[keep], cols[keep], scores[keep]
    else:
        scores = np.zeros(0, np.float32)
    return _select_topk_cells(rows, cols, scores, n_rows, width)


def _llr_topk_sparse_host(C, rc, cc, n_total, llr_threshold,
                          top_k: int, exclude_self: bool,
                          flat: Optional[np.ndarray] = None,
                          device: Optional[torch.device] = None):
    """The host tail: score only C's nonzero cells (the dense tail masks
    zeros to -inf anyway), then a per-row top-k by one lexsort.  Equal to
    ``_llr_topk_dense`` bit for bit: the same scores, and ties to the
    smaller column.  ``flat`` (``_sparse_counts(..., want_coo=True)``)
    spares the O(I_p·I_t) scan for the nonzero cells."""
    I_p, I_t = C.shape
    if flat is not None:
        rows, cols = np.divmod(flat, I_t)
    else:
        rows, cols = np.nonzero(C)
    if exclude_self:
        off_diag = rows != cols
        rows, cols = rows[off_diag], cols[off_diag]
    return _llr_topk_cells(rows, cols, C[rows, cols], rc[rows], cc[cols],
                           n_total, llr_threshold, I_p, min(top_k, I_t), device)


def _llr_topk_sparse_rows(cell_rows, cell_cols, cell_counts, rc_rows, cc,
                          n_total, llr_threshold, top_k: int,
                          n_rows: int, n_cols: int,
                          self_cols: Optional[np.ndarray] = None,
                          device: Optional[torch.device] = None):
    """Row-scoped twin of ``_llr_topk_sparse_host`` straight from COO
    cells: the pure-COO training tail, and a streaming fold's re-LLR.
    ``cell_rows`` are local rows in [0, n_rows), ``rc_rows`` the row
    marginals of those rows, ``cc`` the whole column marginal;
    ``self_cols[r]`` is row r's global column to exclude (None: no mask).
    Equal, bit for bit, to the dense tail's result at the same rows."""
    rows = np.asarray(cell_rows, np.int64)
    cols = np.asarray(cell_cols, np.int64)
    counts = np.asarray(cell_counts)
    if self_cols is not None and len(rows):
        keep = cols != np.asarray(self_cols, np.int64)[rows]
        rows, cols, counts = rows[keep], cols[keep], counts[keep]
    rc_rows = np.asarray(rc_rows)
    cc = np.asarray(cc)
    return _llr_topk_cells(rows, cols, counts.astype(np.float32),
                           rc_rows[rows], cc[cols], n_total, llr_threshold,
                           n_rows, min(top_k, n_cols), device)


def _sparse_tail() -> str:
    """``auto`` (default) | ``host`` | ``device`` from PIO_CCO_SPARSE_TAIL:
    auto picks per event type by pair density (see ``dispatch``)."""
    conf = os.environ.get("PIO_CCO_SPARSE_TAIL", "auto").lower()
    if conf in ("device", "dense"):
        return "device"
    if conf == "host":
        return "host"
    return "auto"


class _SparseHostRunner:
    """Host-count twin of ``_DenseRunner``, with its dispatch/collect
    contract: the counts come from the host cross-join; the tail is the
    host one (``_llr_topk_sparse_host``, or the pure-COO
    ``_llr_topk_sparse_rows`` when the dense host count matrix cannot
    exist) or the device one (K2 and K3 on the counts, copied to
    ``device``).  ``dispatch`` returns None when the host budgets say to
    take a device strategy."""

    def __init__(self, p_user, p_item, n_users: int, n_items_p: int,
                 device: torch.device, n_total_users: Optional[int] = None):
        self.device = device
        self.n_users = n_users
        self.n_total_users = n_total_users if n_total_users else n_users
        self.n_items_p = n_items_p
        self.p = _SparseHostCSR(p_user, p_item, n_items_p, n_users)

    def _dispatch_coo(self, a: _SparseHostCSR, n_items_t: int, top_k: int,
                      llr_threshold: float, exclude_self: bool, pairs: int):
        got = _sparse_counts_coo(self.p, a, total_pairs=pairs)
        if got is None:
            return None
        cells, counts = got
        rows, cols = np.divmod(cells, n_items_t)
        self_cols = np.arange(self.n_items_p, dtype=np.int64) if exclude_self else None
        s, i = _llr_topk_sparse_rows(
            rows, cols, counts, self.p.col_counts, a.col_counts,
            float(self.n_total_users), float(llr_threshold),
            top_k=top_k, n_rows=self.n_items_p, n_cols=n_items_t,
            self_cols=self_cols, device=self.device)
        _count_strategy("sparse")
        return s, i, n_items_t, top_k

    def dispatch(self, a_user, a_item, n_items_t: int, top_k: int,
                 llr_threshold: float, exclude_self: bool,
                 self_pair: bool = False):
        a = self.p if self_pair else _SparseHostCSR(a_user, a_item, n_items_t, self.n_users)
        pairs = _cross_join_pairs(self.p, a)
        tail = _sparse_tail()
        if tail == "auto":
            # nnz <= the cross-join pairs, so pairs/cells bounds the share
            # the host tail has to sort; past ~0.25 the dense tail is the
            # better deal (the reference's measured crossover)
            tail = "host" if pairs * 4 < self.n_items_p * n_items_t else "device"
        host_tail = tail == "host"
        if host_tail and self.n_items_p * n_items_t * 4 > _SPARSE_C_BYTES:
            return self._dispatch_coo(a, n_items_t, top_k, llr_threshold,
                                      exclude_self, pairs)
        got = _sparse_counts(self.p, a, want_coo=host_tail, total_pairs=pairs)
        if got is None:
            return None
        if host_tail:
            C, flat = got
            s, i = _llr_topk_sparse_host(
                C, self.p.col_counts, a.col_counts,
                float(self.n_total_users), float(llr_threshold),
                top_k=top_k, exclude_self=bool(exclude_self), flat=flat,
                device=self.device)
        else:
            dev = self.device

            def put(x):
                return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

            s, i = _llr_topk_dense(
                put(got), put(self.p.col_counts), put(a.col_counts),
                float(self.n_total_users), float(llr_threshold),
                min(top_k, n_items_t), bool(exclude_self))
        _count_strategy("sparse")
        return s, i, n_items_t, top_k

    @staticmethod
    def collect(dispatched) -> Tuple[np.ndarray, np.ndarray]:
        return _DenseRunner.collect(dispatched)


# ---------------------------------------------------------------------------
# the entries
# ---------------------------------------------------------------------------


@timed("cco.train")
def cco_train_indicators(
    p_user: np.ndarray, p_item: np.ndarray,
    others: Sequence[Tuple[str, np.ndarray, np.ndarray, int]],
    n_users: int, n_items_p: int,
    top_k: int = 50,
    llr_threshold: float = 0.0,
    mesh=None,
    exclude_self_for: Optional[str] = None,
    user_block: int = 1024,
    item_tile: int = 4096,
    per_type: Optional[Dict[str, Tuple[int, float]]] = None,
    device=None,
) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """The UR train loop's entry: indicators for every event type against
    one staged primary, with the reference's signature
    (``predictionio_tpu/ops/cco.py:cco_train_indicators``) plus ``device``
    (default ``"cuda"``).

    ``others`` is an ordered list of ``(name, a_user, a_item, n_items_t)``;
    pass the primary's own arrays for the self-indicator (detected by array
    identity: it reuses the staged primary).  Returns name →
    ``(scores [I_p, top_k] f32, ids [I_p, top_k] int32)``, -inf / -1 where a
    row has fewer significant correlators.  ``per_type`` overrides
    ``(top_k, llr_threshold)`` per event type.  Each event type takes the
    sparse runner when it is on and its budgets hold, else the dense
    strategy when it fits, else the P-resident one, else the chunked one,
    whose user blocks are ``user_block`` users.  Over a ``mesh`` (a mesh of
    ranks, ``parallel.mesh.create_mesh``) the sparse runner and the
    P-resident strategy are never taken, and every rank returns the whole
    tables.
    """
    dev = resolve_device(device)
    per_type = per_type or {}
    _check_ids(p_user, p_item, n_users, n_items_p, "primary")
    dense_names = [nm for nm, _, _, nt in others if _dense_path_ok(n_items_p, nt)]
    sparse: Optional[_SparseHostRunner] = None
    if mesh is None and _sparse_path_ok(dev):
        sparse = _SparseHostRunner(p_user, p_item, n_users, n_items_p, dev)
    runner: Optional[_DenseRunner] = None
    resident: Optional[_ResidentPrimary] = None
    chunked: Optional[_ChunkedPrimary] = None
    pending: List[Tuple[str, object]] = []
    results: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for name, au, ai, n_items_t in others:
        excl = name == exclude_self_for
        t_k, t_llr = per_type.get(name, (top_k, llr_threshold))
        self_pair = au is p_user and ai is p_item
        if sparse is not None or name not in dense_names:
            _check_ids(au, ai, n_users, max(n_items_t, 1), name)
        if sparse is not None:
            d = sparse.dispatch(au, ai, n_items_t, t_k, t_llr, excl, self_pair=self_pair)
            if d is not None:
                pending.append((name, d))
                continue
        if name in dense_names:
            if runner is None:
                it_pad_max = max(max(_round_up(nt, 128), 128)
                                 for nm, _, _, nt in others if nm in dense_names)
                runner = _DenseRunner(p_user, p_item, n_users, n_items_p,
                                      max(it_pad_max, n_items_p), dev, mesh=mesh)
            pending.append((name, runner.dispatch(au, ai, n_items_t, t_k, t_llr,
                                                  excl, self_pair=self_pair,
                                                  what=name)))
        elif mesh is None and _resident_p_ok(n_users, n_items_p,
                                             min(item_tile, max(n_items_t, 1)), dev):
            if resident is None:
                resident = _ResidentPrimary((p_user, p_item), n_users, n_items_p, dev)
            results[name] = _cco_indicators_resident(
                resident, (au, ai), n_items_t, n_users, t_k, t_llr, item_tile,
                excl, self_pair)
        else:
            if chunked is None:
                chunked = _ChunkedPrimary((p_user, p_item), n_users, n_items_p,
                                          user_block, dev, mesh=mesh)
            results[name] = _cco_indicators_chunked(
                chunked, (au, ai), n_items_t, n_users, t_k, t_llr, item_tile,
                excl, self_pair)
    for name, d in pending:
        results[name] = _DenseRunner.collect(d)
    return {name: results[name] for name, _, _, _ in others}


def _cco_indicators_dense_coo(
    pu: np.ndarray, pi: np.ndarray,
    au: np.ndarray, ai: np.ndarray,
    n_users: int, n_items_p: int, n_items_t: int,
    top_k: int,
    llr_threshold: float,
    mesh,
    exclude_self: bool,
    n_total_users: Optional[int] = None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """One event type by the sparse runner when it is on, its budgets hold
    and there is no mesh, else by the dense strategy."""
    dev = resolve_device(device)
    # strict identity only: anything weaker could alias two event types
    self_pair = au is pu and ai is pi
    if mesh is None and _sparse_path_ok(dev):
        sr = _SparseHostRunner(pu, pi, n_users, n_items_p, dev, n_total_users=n_total_users)
        d = sr.dispatch(au, ai, n_items_t, top_k, llr_threshold, exclude_self,
                        self_pair=self_pair)
        if d is not None:
            return _SparseHostRunner.collect(d)
    it_pad = max(_round_up(n_items_t, 128), 128)
    runner = _DenseRunner(pu, pi, n_users, n_items_p, max(it_pad, n_items_p), dev,
                          n_total_users=n_total_users, mesh=mesh)
    return _DenseRunner.collect(runner.dispatch(
        au, ai, n_items_t, top_k, llr_threshold, exclude_self, self_pair=self_pair))


def _cco_indicators_tiled(
    p, a, n_users: int, n_items_p: int, n_items_t: int,
    n_total_users: int, top_k: int, llr_threshold: float, user_block: int,
    item_tile: int, exclude_self: bool, self_pair: bool, device: torch.device,
    mesh=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """One event type by the P-resident strategy when its working set fits
    and there is no mesh, else by the chunked one.  ``p`` and ``a`` are
    stagings' inputs (``_pairs_on``), each staged on the device where its
    strategy stages it, so nothing staged outlives its staging."""
    tile = min(item_tile, max(n_items_t, 1))
    if mesh is None and _resident_p_ok(n_users, n_items_p, tile, device):
        primary = _ResidentPrimary(p, n_users, n_items_p, device)
        return _cco_indicators_resident(
            primary, a, n_items_t, n_total_users, top_k, llr_threshold,
            item_tile, exclude_self, self_pair)
    primary = _ChunkedPrimary(p, n_users, n_items_p, user_block, device, mesh=mesh)
    return _cco_indicators_chunked(
        primary, a, n_items_t, n_total_users, top_k, llr_threshold,
        item_tile, exclude_self, self_pair)


def cco_indicators_coo(
    p_user: np.ndarray, p_item: np.ndarray,
    a_user: np.ndarray, a_item: np.ndarray,
    n_users: int, n_items_p: int, n_items_t: int,
    top_k: int = 50,
    llr_threshold: float = 0.0,
    user_block: int = 1024,
    item_tile: int = 4096,
    mesh=None,
    exclude_self: bool = False,
    primary_deduped: bool = False,
    other_deduped: bool = False,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """``cco_indicators`` from raw (user, item) COO pairs, one event type
    (``predictionio_tpu/ops/cco.py:cco_indicators_coo``) plus ``device``.
    Pass the same arrays twice for the self-indicator.  ``primary_deduped``
    and ``other_deduped`` are accepted for the signature and ignored: no
    strategy needs dedup'd pairs."""
    del primary_deduped, other_deduped
    dev = resolve_device(device)
    _check_ids(p_user, p_item, n_users, max(n_items_p, 1), "primary")
    _check_ids(a_user, a_item, n_users, max(n_items_t, 1), "other")
    if _dense_path_ok(n_items_p, n_items_t):
        return _cco_indicators_dense_coo(
            p_user, p_item, a_user, a_item, n_users, n_items_p, n_items_t,
            top_k, llr_threshold, mesh, exclude_self, device=dev)
    return _cco_indicators_tiled(
        (p_user, p_item), (a_user, a_item), n_users, n_items_p, n_items_t, n_users,
        top_k, llr_threshold, user_block, item_tile, exclude_self,
        a_user is p_user and a_item is p_item, dev, mesh)


@timed("cco.train")
def cco_indicators(
    primary: BlockedInteractions,
    other: BlockedInteractions,
    primary_item_counts: Optional[np.ndarray] = None,
    other_item_counts: Optional[np.ndarray] = None,
    n_total_users: int = 0,
    top_k: int = 50,
    llr_threshold: float = 0.0,
    item_tile: int = 4096,
    mesh=None,
    exclude_self: bool = False,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-primary-item indicator lists against ``other``'s items from the
    blocked layout (``predictionio_tpu/ops/cco.py:cco_indicators``) plus
    ``device``: ``(scores [I_p, top_k], ids [I_p, top_k])``, -inf / -1
    padding.  Pass the same object twice for the self-indicator;
    ``exclude_self`` masks the diagonal.

    The dense strategy (or the sparse runner before it) when the count
    matrix fits (``PIO_CCO_DENSE``), on pairs the host flattens
    (``_flatten_blocked``); else the P-resident strategy when its working
    set fits, else the chunked one over the layout's user blocks, both
    staging the layout as it is and flattening it on the device
    (``_flatten_blocked_on``).  ``n_total_users`` is the LLR population.
    The item-count arguments are ignored, as in the reference: every
    strategy takes its marginals from the densified (hence dedup'd)
    matrices."""
    del primary_item_counts, other_item_counts
    if n_total_users <= 0:
        raise ValueError(f"n_total_users must be positive, got {n_total_users}")
    dev = resolve_device(device)
    self_pair = other is primary
    if _dense_path_ok(primary.n_items, other.n_items):
        with timed("cco.flatten"):
            pu, pi = _flatten_blocked(primary)
            au, ai = (pu, pi) if self_pair else _flatten_blocked(other)
        if primary.n_users != other.n_users:
            raise ValueError("primary/other must share the user space")
        return _cco_indicators_dense_coo(
            pu, pi, au, ai, primary.n_users, primary.n_items, other.n_items,
            top_k, llr_threshold, mesh, exclude_self,
            n_total_users=n_total_users, device=dev)
    if primary.n_blocks != other.n_blocks or primary.user_block != other.user_block:
        raise ValueError("primary/other must be blocked with the same user layout")
    return _cco_indicators_tiled(
        primary, other, primary.n_users, primary.n_items, other.n_items,
        n_total_users, top_k, llr_threshold, primary.user_block, item_tile,
        exclude_self, self_pair, dev, mesh)


# ---------------------------------------------------------------------------
# basket association rules (the complementary-purchase template)
# ---------------------------------------------------------------------------

# The reference's budgets, copied as they are: the dense [I, I] rule matrix
# up to _BASKET_RULES_DENSE_MAX_ITEMS items, the item-tiled strategy past
# it; baskets densified _BASKET_CHUNK at a time (dense), or as many as
# _BASKET_CHUNK_BYTES holds at the reference's 2 bytes a cell (tiled); the
# tile as wide as _BASKET_TILE_BYTES holds at 12 bytes a cell.  The tile
# width, hence the tiles and the K3 launches, is the reference's.
_BASKET_RULES_DENSE_MAX_ITEMS = 16_384
_BASKET_CHUNK = 8192
_BASKET_CHUNK_BYTES = 512 << 20
_BASKET_TILE_BYTES = 2 << 30


def _basket_scores(c, ci_row, ci_col, n, min_support, min_confidence):
    """Per-cell rule scores in float32: lift where the support and
    confidence cuts pass and the pair occurs, else -inf — the reference's
    ``_basket_scores`` as XLA evaluates it: its algebraic simplifier folds
    ``(c / r) / q`` into ``c / (r · q)``, so the lift is one division by
    that product (bit-equal to the reference's lifts)."""
    support = c / n
    row = torch.clamp_min(ci_row, 1.0)
    confidence = c / row
    lift = c / (row * torch.clamp_min(ci_col / n, 1e-9))
    ok = (support >= min_support) & (confidence >= min_confidence) & (c > 0)
    return torch.where(ok, lift, float("-inf"))


class _StagedBaskets:
    """The (basket, item) pairs that can form a rule, on the device, in
    basket chunks of ``chunk`` columns; each chunk densifies item-major
    [items, chunk] on demand, and is kept when every chunk fits the
    device's budget (the P-resident rule of the CCO strategies).

    A basket with one distinct item adds only to its item's count, which
    comes exact from the host (``ci``), and to the diagonal, which no rule
    reads: such baskets are left out of the product, and the pair counts
    off the diagonal stay exact."""

    def __init__(self, basket_idx, item_idx, n_items: int, chunk_of, device: torch.device):
        db, di = dedup_pairs(basket_idx, item_idx, n_items)
        self.ci = np.bincount(di, minlength=n_items).astype(np.int64)
        per_basket = np.bincount(db) if len(db) else np.zeros(0, np.int64)
        keep = per_basket[db] >= 2
        multi = np.flatnonzero(per_basket >= 2)
        compact = np.full(len(per_basket), -1, np.int64)
        compact[multi] = np.arange(len(multi))
        self.n_multi = len(multi)
        self.chunk = chunk_of(self.n_multi)
        self.n_chunks = max(math.ceil(self.n_multi / self.chunk), 1)
        self.rows = _item_rows(n_items)
        self.staged = _StagedCOO(compact[db[keep]], di[keep], device, "user",
                                 self.chunk, self.n_chunks)
        self.keep_all = (self.n_chunks * self.chunk * self.rows
                         <= _resident_budget(device) // 2)
        self._kept: Dict[int, torch.Tensor] = {}

    def matrix(self, c: int) -> torch.Tensor:
        m = self._kept.get(c)
        if m is None:
            b, i = self.staged.span(c)
            m = _densify(i, b - c * self.chunk, self.rows, self.chunk)
            if self.keep_all:
                self._kept[c] = m
        return m


def _basket_rules_dense(baskets: _StagedBaskets, n_items: int, b: int, score):
    """The whole [I, I] pair counts summed over the basket chunks, the rule
    scores, the diagonal at -inf, and K3's row top-b (no carry)."""
    dev = baskets.staged.user.device
    C = torch.zeros((baskets.rows, baskets.rows), dtype=torch.int32, device=dev)
    for c in range(baskets.n_chunks):
        m = baskets.matrix(c)
        C += _count_product(m, m)
    scores = score(C[:n_items, :n_items].to(torch.float32), 0, n_items)
    scores.diagonal().fill_(float("-inf"))
    return tile_topk_desc(scores, b)


def _basket_rules_tiled(baskets: _StagedBaskets, n_items: int, tile: int, b: int, score):
    """Item tiles: each tile's [I, tile] pair counts summed over the basket
    chunks (the tile's rows of a chunk are a slice of it), the rule scores,
    and K3's top-b merged into the running carry with the self-pair
    excluded (``_tile_tail``), one launch a tile."""
    dev = baskets.staged.user.device
    best = _initial_carry(n_items, b, dev)
    for t0 in range(0, n_items, tile):
        width = min(tile, n_items - t0)
        counts = torch.zeros((baskets.rows, _round_up(width, 8)), dtype=torch.int32,
                             device=dev)
        for c in range(baskets.n_chunks):
            m = baskets.matrix(c)
            counts += _count_product(m, _tile_slab(m, t0, width))
        scores = score(counts[:n_items, :width].to(torch.float32), t0, width)
        del counts
        best = _tile_tail(scores, t0, True, b, best)
        del scores
    return best


def basket_tile(n_items: int, item_tile: int = 4096) -> int:
    """Items a tile of ``basket_rules`` spans: the whole catalog on the
    dense strategy; past it, ``item_tile`` capped so the [I, tile] working
    set (counts, scores, merge buffer: ~12 bytes a cell) stays within
    ``_BASKET_TILE_BYTES`` — the reference's rule."""
    if n_items <= _BASKET_RULES_DENSE_MAX_ITEMS:
        return n_items
    tile_cap = max((_BASKET_TILE_BYTES // max(n_items * 12, 1)) // 128 * 128, 128)
    return min(item_tile, tile_cap, max(n_items, 1))


def basket_rules(
    basket_idx: np.ndarray, item_idx: np.ndarray,
    n_baskets: int, n_items: int,
    top_k: int = 20,
    min_support: float = 0.0,
    min_confidence: float = 0.0,
    item_tile: int = 4096,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pairwise association rules from (basket, item) events
    (``predictionio_tpu/ops/cco.py:basket_rules``) plus ``device``
    (default ``"cuda"``): (lift [I, K], complement ids [I, K], confidence
    [I, K]), -inf / -1 / 0 where fewer rules pass the cuts.

    For each ordered pair i → j: support c_ij / N, confidence c_ij / c_i,
    lift confidence / (c_j / N), all in float32 from exact pair counts
    (the int8 count product, ``_count_product``); the per-row top-k by
    lift is ``lax.top_k``'s order, ties included, with self-pairs excluded.
    Up to ``_BASKET_RULES_DENSE_MAX_ITEMS`` items the whole count matrix is
    built and K3 takes its row top-k; past it, item tiles of the
    reference's width feed K3's carry form, one launch a tile.  Confidence
    is derived from the top-k lift (lift·c_j/N) with the exact host counts.
    """
    if n_baskets >= (1 << 31):
        raise ValueError(
            f"{n_baskets} baskets would overflow the int32 pair-count "
            "accumulator (exact to 2^31); shard the basket log first")
    dev = resolve_device(device)
    k = min(max(top_k, 1), max(n_items, 1))
    b = block_width(k)
    dense = n_items <= _BASKET_RULES_DENSE_MAX_ITEMS
    tile = basket_tile(n_items, item_tile)
    if dense:
        def chunk_of(n_b):
            return _BASKET_CHUNK
    else:
        def chunk_of(n_b):
            return max(256, min(
                _BASKET_CHUNK,
                (_BASKET_CHUNK_BYTES // max(n_items * _REF_BYTES_PER_CELL, 1)) // 256 * 256,
                math.ceil(max(n_b, 1) / 256) * 256))
    baskets = _StagedBaskets(basket_idx, item_idx, n_items, chunk_of, dev)
    ci_f = torch.as_tensor(baskets.ci.astype(np.float32)).to(dev)
    n = torch.tensor(max(float(n_baskets), 1.0), dtype=torch.float32, device=dev)
    ms = torch.tensor(min_support, dtype=torch.float32, device=dev)
    mc = torch.tensor(min_confidence, dtype=torch.float32, device=dev)

    def score(c, t0, width):
        return _basket_scores(c, ci_f[:, None], ci_f[t0:t0 + width][None, :], n, ms, mc)

    if dense:
        st, si = _basket_rules_dense(baskets, n_items, b, score)
    else:
        st, si = _basket_rules_tiled(baskets, n_items, tile, b, score)
    st, si = st[:, :k].cpu().numpy(), si[:, :k].cpu().numpy()
    dead = ~np.isfinite(st) | (si < 0) | (si >= n_items)
    si = np.where(dead, -1, si).astype(np.int32)
    st = np.where(dead, -np.inf, st)
    # conf = lift·c_j/N from the exact int64 host counts (-inf lifts zeroed
    # before the multiply, so no NaN transient)
    nf = max(float(n_baskets), 1.0)
    conf = np.where(dead, 0.0, st) * baskets.ci[np.maximum(si, 0)] / nf
    return st, si, conf
