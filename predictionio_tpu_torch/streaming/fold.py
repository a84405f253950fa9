"""Incremental CCO fold: delta events → an updated ``URModel``, exactly.

Counterpart of ``predictionio_tpu/streaming/fold.py``.  A full UR retrain
stages the whole log, translates it to dense id spaces, counts the
cooccurrences, scores and selects every row, and rebuilds the popularity,
CSR and property epilogues.  CCO counts are additive, so
:class:`URFoldState` keeps, per event type, the deduped (user, item) pair
set, the cooccurrence counts and the LLR marginals (distinct users per row
and column), and folds a delta as ``C_new = C + Δpᵀ·A_old + P_newᵀ·Δa``
over the delta's cross-join: O(delta footprint), never O(U·I²).

- Counts are sorted COO by default (:class:`_SparseCounts`: one int64
  ``(row << 32) | col`` key and an int32 count a nonzero cell, O(nnz));
  ``PIO_FOLLOW_STATE=dense`` keeps [I_p, I_t] int32 matrices instead, the
  oracle the sparse≡dense tests compare against.
- Only affected rows are scored again.  A delta that changes no global LLR
  input (no new user, no new target-side pair for the type) re-selects the
  touched primary rows (a *sliced* re-LLR); a new user (N) or a new target
  pair (a column marginal) couples every cell of the type, which forces its
  *full* re-LLR.  A full re-LLR of the sparse state scores every resident
  cell once (``ops.cco._score_llr_cells`` on the state's device) and keeps
  the stored selection of each row that the selection-stability
  certificate proves unchanged (membership and order under the new
  scores); only the uncertified rows are re-selected.
  ``PIO_FOLLOW_RELLR_PRUNE=off`` re-selects every row (the oracle).
- Re-selection takes the route training takes on the state's device, so a
  fold equals a from-scratch train on that device bit for bit:

  * on the CPU, the reference's default route: the cells scored through
    ``_llr_topk_sparse_rows`` and each row's top-k selected on the host by
    one lexsort (chunked across ``PIO_FOLLOW_RELLR_WORKERS`` threads);
  * on CUDA, the K2 and K3 kernels (``_llr_topk_row_slices``): the rows'
    counts densified into int32 [r, I_t] slices on the card, in row chunks
    of at most ``_RESELECT_SLICE_BYTES``, K2 with the rows' marginals,
    the self pair set to -inf at each row's global primary id, K3 at
    ``block_width(top_k)``.  Every re-selected row goes this way: the
    touched rows of a sliced re-LLR, the uncertified rows of a full one,
    and every row at bootstrap.  A CUDA tensor launches its kernel or
    raises; nothing moves to the CPU.  The certificate's cell scores come
    from the card too (``device=``), whose bits are K2's.

  A catalog whose dense [I_p, I_t] f32 matrix fits
  ``PIO_FOLLOW_DENSE_RELLR_BYTES`` (4 MiB) takes the dense tail instead
  (``ops.cco._llr_topk_dense``: K2 and K3, or their plain versions on the
  CPU), as the reference does at tiny shapes.
- Each fold emits a NEW ``URModel`` on the state's device.  Generation-keyed
  serving caches invalidate by model identity; where provably identical,
  derived serving state carries over (the host inverted CSR is row-patched,
  ``host_pop_order`` merged, the property indexes carried), and the
  model's ``_plane_prov`` tells the response cache which targets moved.
  The emitted model shares its indicator tables and dictionaries with the
  state, copy-on-write: the next fold clones before it writes in place.

State is bounded by ``PIO_FOLLOW_STATE_BYTES`` (default 1 GiB: counts plus
the parts that grow with the log); past it :class:`FoldUnsupported` tells
the follower to retrain per tick instead.  The state checkpoints to flat
arrays (``checkpoint_arrays``/``restore_checkpoint``) plus the accumulated
batch, so a restarted follower folds only the unapplied suffix.
"""

from __future__ import annotations

import concurrent.futures as _cf
import dataclasses
import os
import time
import weakref
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.events.event import SPECIAL_EVENTS
from predictionio_tpu_torch.models.common import topk_order_keys
from predictionio_tpu_torch.obs import metrics as _obs_metrics
from predictionio_tpu_torch.ops import cco as cco_ops
from predictionio_tpu_torch.ops.hopper_kernels import llr_masked_scores, tile_topk_desc
from predictionio_tpu_torch.ops.topk import block_width
from predictionio_tpu_torch.store.columnar import (
    CSRLookup,
    EventBatch,
    IdDict,
    fold_properties,
)

_LOW32 = np.int64((1 << 32) - 1)

_REG = _obs_metrics.get_registry()
_M_RELLR_ROWS = _REG.counter(
    "pio_follow_rellr_rows_total",
    "Primary rows handled by a full (marginal-coupled) re-LLR pass, by "
    "outcome: certified (the selection-stability certificate proved the "
    "row's stored top-k keeps membership AND order under the new scores "
    "— its k stored scores refresh in O(k), no per-row sort) vs "
    "selected (routed through the per-row top-k re-selection)")
_M_EMIT = _REG.counter(
    "pio_follow_emit_total",
    "Derived-serving-state emissions by component (inverted | pop_order "
    "| popularity | user_seen | seen_by_event | props) and path: "
    "carried (previous "
    "generation's object reused, provably identical), patched "
    "(incremental splice/merge/weight-regather), rebuilt (from scratch)")

#: device bytes of one re-selection chunk on the card: its int32 counts
#: and the f32 scores K2 writes, 8 bytes a cell of the [rows, I_t] slice
_RESELECT_SLICE_BYTES = 1 << 30


def rellr_prune_enabled() -> bool:
    """``PIO_FOLLOW_RELLR_PRUNE=off`` disables the selection-stability
    certificate: every full re-LLR re-selects every row (the exactness
    oracle of the pruning tests)."""
    return os.environ.get("PIO_FOLLOW_RELLR_PRUNE", "").lower() not in (
        "off", "0", "false")


def rellr_workers() -> int:
    """``PIO_FOLLOW_RELLR_WORKERS``: threads of the chunked host top-k
    re-selection (numpy's sorts release the GIL on large arrays).  Default
    min(4, cores); 1 = inline."""
    try:
        w = int(os.environ.get("PIO_FOLLOW_RELLR_WORKERS", "0"))
    except ValueError:
        w = 0
    if w <= 0:
        w = min(4, os.cpu_count() or 1)
    return max(w, 1)


# below this many cells the pool's handoff costs more than the sort
_RELLR_CHUNK_MIN_CELLS = 262_144


def _select_topk_chunked(rows: np.ndarray, cols: np.ndarray,
                         scores: np.ndarray, n_rows: int, width: int):
    """``ops.cco._select_topk_cells`` split at row boundaries across a
    small thread pool (``PIO_FOLLOW_RELLR_WORKERS``).  Rows are
    independent, so the outputs equal one global pass; ``rows`` must be
    ascending."""
    workers = rellr_workers()
    if workers <= 1 or len(rows) < _RELLR_CHUNK_MIN_CELLS or n_rows < 2:
        return cco_ops._select_topk_cells(rows, cols, scores, n_rows, width)
    out_s = np.full((n_rows, width), -np.inf, np.float32)
    out_i = np.full((n_rows, width), -1, np.int32)
    n_chunks = min(workers * 2, n_rows)
    # split at row boundaries near equal CELL counts: cell skew, not row
    # count, is what unbalances the sorts
    marks = (np.arange(1, n_chunks) * (len(rows) / n_chunks)).astype(np.int64)
    edges, prev = [0], 0
    for m in marks:
        r = int(rows[min(int(m), len(rows) - 1)])
        if r > prev:
            edges.append(r)
            prev = r
    edges.append(n_rows)

    def work(r0: int, r1: int) -> None:
        lo = np.searchsorted(rows, r0, side="left")
        hi = np.searchsorted(rows, r1, side="left")
        s, i = cco_ops._select_topk_cells(rows[lo:hi] - r0, cols[lo:hi],
                                          scores[lo:hi], r1 - r0, width)
        out_s[r0:r1] = s
        out_i[r0:r1] = i

    with _cf.ThreadPoolExecutor(max_workers=workers) as ex:
        list(ex.map(lambda b: work(*b), zip(edges[:-1], edges[1:])))
    return out_s, out_i


def _kernel_reselect(device: torch.device) -> bool:
    """Whether a fold on ``device`` re-selects rows through K2 and K3 (on
    CUDA) rather than the host lexsort (on the CPU, the reference's
    default route)."""
    return device.type == "cuda"


def _llr_topk_row_slices(local: np.ndarray, cols: np.ndarray,
                         counts: np.ndarray, rc_rows: np.ndarray,
                         cc: np.ndarray, n_total: float, llr_threshold: float,
                         self_cols: Optional[np.ndarray], top_k: int,
                         n_cols: int, device: torch.device
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Row-sliced twin of ``ops.cco._llr_topk_dense`` (the reference's
    ``_llr_topk_rows``) from COO cells: ``local`` are rows in [0, r)
    ascending (``_SparseCounts.row_cells``), ``rc_rows`` the r rows' row
    marginals, ``cc`` the whole column marginal, ``self_cols[k]`` row k's
    global primary id (None: no self pair).  Chunks of rows are densified
    into int32 [rows, n_cols] slices on ``device`` (at most
    ``_RESELECT_SLICE_BYTES`` each), scored by K2 with the same N and
    threshold, the self pair set to -inf, and cut by K3 at
    ``block_width(top_k)`` without a carry (a slice's ids are column ids,
    offset 0).  → host (scores, ids) [r, top_k], -inf/-1 where a row has
    fewer candidates (the caller's ``_DenseRunner.collect`` pads)."""
    r = len(rc_rows)
    out_s = np.full((r, top_k), -np.inf, np.float32)
    out_i = np.full((r, top_k), -1, np.int32)
    if r == 0 or top_k == 0:
        return out_s, out_i
    b = block_width(top_k)
    chunk = max(1, _RESELECT_SLICE_BYTES // (8 * max(n_cols, 1)))
    cc_dev = torch.as_tensor(np.asarray(cc, np.int32), device=device)
    local = np.asarray(local, np.int64)
    for r0 in range(0, r, chunk):
        r1 = min(r0 + chunk, r)
        lo, hi = np.searchsorted(local, [r0, r1])
        c = torch.zeros((r1 - r0, n_cols), dtype=torch.int32, device=device)
        if hi > lo:
            c[torch.as_tensor(local[lo:hi] - r0, device=device),
              torch.as_tensor(np.asarray(cols[lo:hi], np.int64), device=device)] = \
                torch.as_tensor(np.asarray(counts[lo:hi], np.int32), device=device)
        rc = torch.as_tensor(np.asarray(rc_rows[r0:r1], np.int32), device=device)
        scores = llr_masked_scores(c, rc, cc_dev, float(n_total), float(llr_threshold))
        del c
        if self_cols is not None:
            scores[torch.arange(r1 - r0, device=device),
                   torch.as_tensor(np.asarray(self_cols[r0:r1], np.int64),
                                   device=device)] = float("-inf")
        s, i = tile_topk_desc(scores, b)
        del scores
        out_s[r0:r1] = s[:, :top_k].cpu().numpy()
        out_i[r0:r1] = i[:, :top_k].cpu().numpy()
    return out_s, out_i


def _merge_pop_order(old_order: np.ndarray, new_pop: np.ndarray,
                     changed_ids: np.ndarray) -> np.ndarray:
    """Incremental ``URModel.host_pop_order``: drop the changed ids from
    the previous order (the rest keep their relative order: their keys did
    not move), rank the changed ids by ``host_topk_desc``'s composite key
    and splice them in.  Array-identical to ``host_topk_desc(new_pop,
    n)[1]`` whenever ``changed_ids`` holds every id whose popularity moved
    and every new id (a superset is fine)."""
    changed = np.asarray(changed_ids, np.int64)
    if len(changed) == 0:
        return old_order
    keys = topk_order_keys(np.asarray(new_pop, np.float32))
    keep = ~_in_sorted(old_order.astype(np.int64), changed)
    base = old_order[keep].astype(np.int32, copy=False)
    corder = changed[np.argsort(-keys[changed])].astype(np.int32)
    pos = np.searchsorted(-keys[base.astype(np.int64)],
                          -keys[corder.astype(np.int64)])
    return np.insert(base, pos, corder)


def _inverted_perm(idx: np.ndarray) -> np.ndarray:
    """The row-major flat positions of ``idx``'s valid cells in the host
    inverted CSR's order (stable by target): the rebuild's weights are
    ``llr.ravel()[perm]``, so a generation whose CSR structure is unchanged
    refreshes its weights with one gather."""
    valid = idx >= 0
    flat = np.flatnonzero(valid.ravel())
    return flat[np.argsort(idx.ravel()[flat], kind="stable")]


def state_budget_bytes() -> int:
    """``PIO_FOLLOW_STATE_BYTES`` caps the resident fold state: the counts
    plus the parts that grow with the log (the accumulated batch, pair
    sets, raw popularity inputs, indicator tables).  Past it the follower
    retrains instead of folding (exact either way)."""
    try:
        return max(int(os.environ.get("PIO_FOLLOW_STATE_BYTES", str(1 << 30))), 1)
    except ValueError:
        return 1 << 30


def fold_state_impl() -> str:
    """``PIO_FOLLOW_STATE``: 'sparse' (default) keeps sorted-COO counts;
    'dense' keeps [I_p, I_t] int32 matrices (the oracle)."""
    conf = os.environ.get("PIO_FOLLOW_STATE", "auto").lower()
    return "dense" if conf == "dense" else "sparse"


def _dense_rellr_bytes() -> int:
    """``PIO_FOLLOW_DENSE_RELLR_BYTES`` (default 4 MiB): a sparse-state
    re-LLR whose dense [I_p, I_t] f32 matrix fits it materializes the
    counts and takes the dense tail (the tiny-shape fast path of the
    reference).  0 keeps the sparse tail everywhere (the tests use it so
    the sparse path stays covered at small shapes)."""
    try:
        return max(int(os.environ.get("PIO_FOLLOW_DENSE_RELLR_BYTES",
                                      str(4 << 20))), 0)
    except ValueError:
        return 4 << 20


class FoldUnsupported(RuntimeError):
    """The fold cannot (or should not) keep incremental state for this
    engine or shape: the follower retrains per tick instead."""


class _SparseCounts:
    """Sorted-COO cooccurrence counts: ``keys`` holds one int64
    ``(row << 32) | col`` a nonzero cell, ascending; ``counts`` the int32
    count there.  Every mutation keeps the order: increments merge by
    searchsorted and ``np.insert``; row and column remaps apply a strictly
    increasing map (``_extend_item_space``'s old→new ids are a searchsorted
    into a sorted union), so remapped keys stay ascending unsorted."""

    __slots__ = ("keys", "counts")

    def __init__(self, keys: np.ndarray, counts: np.ndarray):
        self.keys = np.asarray(keys, np.int64)
        self.counts = np.asarray(counts, np.int32)

    @classmethod
    def empty(cls) -> "_SparseCounts":
        return cls(np.zeros(0, np.int64), np.zeros(0, np.int32))

    @classmethod
    def from_dense(cls, C: np.ndarray) -> "_SparseCounts":
        rows, cols = np.nonzero(C)
        return cls(_pair_key(rows, cols), C[rows, cols].astype(np.int32))

    @property
    def nnz(self) -> int:
        return len(self.keys)

    @property
    def nbytes(self) -> int:
        return int(self.keys.nbytes) + int(self.counts.nbytes)

    def add_pairs(self, rows: np.ndarray, cols: np.ndarray) -> None:
        """counts[r, c] += the multiplicity of (r, c) in the pairs."""
        if len(rows) == 0:
            return
        uniq, inc = np.unique(_pair_key(rows, cols), return_counts=True)
        pos = np.searchsorted(self.keys, uniq)
        hit = np.zeros(len(uniq), bool)
        in_range = pos < len(self.keys)
        hit[in_range] = self.keys[pos[in_range]] == uniq[in_range]
        if hit.any():
            self.counts[pos[hit]] += inc[hit].astype(np.int32)
        miss = ~hit
        if miss.any():
            self.keys = np.insert(self.keys, pos[miss], uniq[miss])
            self.counts = np.insert(self.counts, pos[miss], inc[miss].astype(np.int32))

    def all_cells(self):
        """(rows, cols, counts) of every nonzero cell, (row, col) ascending."""
        return self.keys >> np.int64(32), self.keys & _LOW32, self.counts

    def row_cells(self, rows: np.ndarray):
        """The cells of a sorted unique row subset: (index into ``rows``,
        col, count), each row's cells one contiguous key segment."""
        rows = np.asarray(rows, np.int64)
        starts = np.searchsorted(self.keys, rows << np.int64(32))
        ends = np.searchsorted(self.keys, (rows + 1) << np.int64(32))
        seg = ends - starts
        total = int(seg.sum())
        if total == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.int32)
        csum = np.cumsum(seg)
        within = np.arange(total, dtype=np.int64) - np.repeat(csum - seg, seg)
        idx = np.repeat(starts, seg) + within
        local = np.repeat(np.arange(len(rows), dtype=np.int64), seg)
        return local, self.keys[idx] & _LOW32, self.counts[idx]

    def remap_cols(self, perm: np.ndarray) -> None:
        """col → perm[col] (perm strictly increasing: order kept)."""
        if self.nnz and len(perm):
            self.keys = (self.keys & ~_LOW32) | np.asarray(perm, np.int64)[self.keys & _LOW32]

    def remap_rows(self, perm: np.ndarray) -> None:
        """row → perm[row] (perm strictly increasing: order kept)."""
        if self.nnz and len(perm):
            self.keys = ((np.asarray(perm, np.int64)[self.keys >> np.int64(32)]
                          << np.int64(32)) | (self.keys & _LOW32))

    def to_dense(self, n_rows: int, n_cols: int) -> np.ndarray:
        C = np.zeros((n_rows, n_cols), np.int32)
        if self.nnz:
            C[self.keys >> np.int64(32), self.keys & _LOW32] = self.counts
        return C


def _pair_key(u: np.ndarray, i: np.ndarray) -> np.ndarray:
    """(user id, type-local item id) → one sortable int64 key."""
    return (np.asarray(u, np.int64) << np.int64(32)) | np.asarray(i, np.int64)


def _key_item(key: np.ndarray) -> np.ndarray:
    return (key & _LOW32).astype(np.int64)


def _key_user(key: np.ndarray) -> np.ndarray:
    return (key >> np.int64(32)).astype(np.int64)


def _in_sorted(values: np.ndarray, sorted_arr: np.ndarray) -> np.ndarray:
    """Boolean membership of ``values`` in an ascending array."""
    if len(sorted_arr) == 0 or len(values) == 0:
        return np.zeros(len(values), bool)
    pos = np.searchsorted(sorted_arr, values)
    np.minimum(pos, len(sorted_arr) - 1, out=pos)
    return sorted_arr[pos] == values


def _cross_partners(pairs_sorted: np.ndarray, du: np.ndarray,
                    di: np.ndarray, rows_from_delta: bool):
    """One side of the count update as (row, col) increments: for every
    delta pair (du[e], di[e]) and every partner item j in the other side's
    segment of user du[e] in ``pairs_sorted`` (deduped ``(user, item)``
    keys, ascending): (di[e], j) when ``rows_from_delta`` (Δpᵀ·A), else
    (j, di[e]) (Pᵀ·Δa).  One searchsorted pair bounds each segment."""
    if len(du) == 0 or len(pairs_sorted) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    starts = np.searchsorted(pairs_sorted, np.asarray(du, np.int64) << np.int64(32))
    ends = np.searchsorted(pairs_sorted, (np.asarray(du, np.int64) + 1) << np.int64(32))
    seg = ends - starts
    total = int(seg.sum())
    if total == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    csum = np.cumsum(seg)
    within = np.arange(total, dtype=np.int64) - np.repeat(csum - seg, seg)
    partners = _key_item(pairs_sorted[np.repeat(starts, seg) + within])
    own = np.repeat(np.asarray(di, np.int64), seg)
    if rows_from_delta:
        return own, partners
    return partners, own


def _cross_scatter(counts, pairs_sorted: np.ndarray, du: np.ndarray,
                   di: np.ndarray, rows_from_delta: bool) -> np.ndarray:
    """Apply one side of the count update (``_cross_partners``) to a dense
    int32 matrix or a :class:`_SparseCounts`; → the touched primary rows."""
    rows, cols = _cross_partners(pairs_sorted, du, di, rows_from_delta)
    if len(rows) == 0:
        return np.zeros(0, np.int64)
    if isinstance(counts, _SparseCounts):
        counts.add_pairs(rows, cols)
    else:
        np.add.at(counts, (rows, cols), 1)
    return np.unique(rows)


def _patch_inverted_csr(old_indptr: np.ndarray, old_rows: np.ndarray,
                        old_perm: np.ndarray, changed_rows: np.ndarray,
                        old_idx: np.ndarray, new_idx: np.ndarray,
                        n_t: int, i_p: int,
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Row-patch a host inverted CSR's structure: drop every posting whose
    primary row changed, insert the changed rows' new postings at their
    (target, row) slots, and splice the weight permutation
    (``_inverted_perm``) alike; the caller gathers the weights as
    ``new_llr.ravel()[perm]``, so unchanged rows' weights refresh too.
    ``indptr`` moves by the prefix sums of (inserted - removed) per target
    and extends for new targets and new primary rows.  Array-identical to
    inverting the new table from scratch."""
    k = new_idx.shape[1]
    changed_rows = np.asarray(changed_rows, np.int64)
    if len(old_indptr) < n_t + 1:
        old_indptr = np.concatenate([
            old_indptr, np.full(n_t + 1 - len(old_indptr), old_indptr[-1], np.int64)])
    tgt_of = np.repeat(np.arange(n_t, dtype=np.int64), np.diff(old_indptr))
    keep = ~_in_sorted(old_rows.astype(np.int64), changed_rows)
    k_t, k_r, k_p = tgt_of[keep], old_rows[keep], old_perm[keep]
    changed_old = changed_rows[changed_rows < old_idx.shape[0]]
    rem = old_idx[changed_old]
    rem_t = rem[rem >= 0].astype(np.int64)
    sub = new_idx[changed_rows]
    valid = sub >= 0
    n_r = np.repeat(changed_rows, k)[valid.ravel()]
    n_tg = sub[valid].astype(np.int64)
    n_flat = (changed_rows[:, None] * k + np.arange(k, dtype=np.int64)).ravel()[valid.ravel()]
    order = np.lexsort((n_r, n_tg))
    n_tg, n_r, n_flat = n_tg[order], n_r[order], n_flat[order]
    pos = np.searchsorted(k_t * i_p + k_r.astype(np.int64), n_tg * i_p + n_r)
    rows2 = np.insert(k_r, pos, n_r.astype(np.int32)).astype(np.int32)
    perm2 = np.insert(k_p, pos, n_flat)
    delta = np.bincount(n_tg, minlength=n_t) - np.bincount(rem_t, minlength=n_t)
    indptr2 = (old_indptr + np.concatenate([[0], np.cumsum(delta)])).astype(np.int64)
    return indptr2, rows2, perm2


@dataclasses.dataclass
class _TypeState:
    """Per-event-type incremental state; one of ``C`` (dense) and ``sc``
    (sparse) holds the counts."""

    codes: np.ndarray            # int64 sorted unique target-dict codes
    item_dict: IdDict            # strings of ``codes`` (id = position)
    local_of_target: np.ndarray  # target code → local item id (-1 unknown)
    pairs: np.ndarray            # int64 sorted deduped (u << 32 | i) keys
    col_counts: np.ndarray       # int64 [I_t] distinct users per target
    raw_items: List[np.ndarray]  # per-fold raw event items (local ids)
    raw_times: List[np.ndarray]  # per-fold raw event epoch seconds
    C: Optional[np.ndarray] = None       # int32 [I_p, I_t] counts (dense)
    sc: Optional[_SparseCounts] = None   # sorted-COO counts (sparse)
    idx: Optional[np.ndarray] = None     # int32 [I_p, K] indicator ids
    llr: Optional[np.ndarray] = None     # f32   [I_p, K] indicator scores
    # copy-on-write marks: an emitted model shares idx/llr and item_dict by
    # reference (the emit may run on the publisher thread), so an in-place
    # write clones first
    shared_tables: bool = False
    shared_dict: bool = False

    def mutable_tables(self) -> None:
        """The copy-on-write guard before an in-place idx/llr write."""
        if self.shared_tables:
            if self.idx is not None:
                self.idx = self.idx.copy()
                self.llr = self.llr.copy()
            self.shared_tables = False

    @property
    def n_items(self) -> int:
        return len(self.codes)

    @property
    def counts(self):
        return self.sc if self.sc is not None else self.C


@dataclasses.dataclass
class _EmitSnapshot:
    """A consistent emission view captured by ``URFoldState.fold_apply``:
    references to replace-on-change structures and copy-on-write-marked
    shared arrays, so ``emit_snapshot`` (and the serving warm behind it)
    can run on the follower's publisher thread while the next delta
    applies."""

    generation: int
    n_users: int
    user_dict: IdDict
    types: Dict[str, dict]
    props: Dict[str, dict]
    pop_f32: Optional[np.ndarray]
    pop_changed: Optional[np.ndarray]
    remap: dict
    hints: Dict[str, dict]


class URFoldState:
    """Resident incremental-training state of ONE Universal Recommender
    algorithm on ``device`` (default ``"cuda"``).  ``fold(delta)`` folds a
    columnar delta (sharing this state's dictionaries: the
    ``scan_tail_from`` contract) and returns a fresh ``URModel`` on the
    device, equal to ``URAlgorithm.train`` over the accumulated batch on
    that device."""

    def __init__(self, algo_params, ds_params, device=None):
        from predictionio_tpu_torch.models.universal_recommender.engine import URAlgorithm
        from predictionio_tpu_torch.models.universal_recommender.popmodel import (
            parse_duration,
        )

        self.device = resolve_device(device)
        self.params = algo_params
        self.ds_params = ds_params
        self.event_names: List[str] = list(ds_params.event_names)
        if not self.event_names:
            raise FoldUnsupported("no event_names configured")
        self.primary = self.event_names[0]
        blacklist = self.params.blacklist_events or [self.primary]
        unknown = [b for b in blacklist if b not in self.event_names]
        if unknown:
            raise ValueError(f"blacklist_events {unknown} not in event_names "
                             f"{self.event_names}")
        bf_names = self.params.backfill_event_names or [self.primary]
        unknown_bf = [b for b in bf_names if b not in self.event_names]
        if unknown_bf:
            raise ValueError(f"backfill_event_names {unknown_bf} not in event_names "
                             f"{self.event_names}")
        if self.params.checkpoint:
            raise FoldUnsupported(
                "checkpointed training is a batch-durability feature; "
                "the follower's unit of durability is the watermark")
        self.per_type = URAlgorithm.per_type_tuning(algo_params, self.event_names)
        self.impl = fold_state_impl()
        self.user_dict = IdDict()
        self.user_of_code = np.full(1, -1, np.int32)
        self.row_counts = np.zeros(0, np.int64)
        self.types: Dict[str, _TypeState] = {
            name: _TypeState(
                codes=np.zeros(0, np.int64), item_dict=IdDict(),
                local_of_target=np.full(1, -1, np.int64),
                pairs=np.zeros(0, np.int64),
                C=np.zeros((0, 0), np.int32) if self.impl == "dense" else None,
                sc=_SparseCounts.empty() if self.impl == "sparse" else None,
                col_counts=np.zeros(0, np.int64), raw_items=[], raw_times=[])
            for name in self.event_names
        }
        self.batch: Optional[EventBatch] = None
        self._props: Dict[str, dict] = {}
        self._props_ever = False
        self._primary_perm = np.zeros(0, np.int64)
        self.generation = 0
        self.model = None
        self.last_fold_stats: Dict[str, dict] = {}
        self.last_rellr_stats: Dict[str, dict] = {}
        self.last_phase_s: Dict[str, float] = {}
        self.last_emit_s = 0.0
        self._rellr_s = 0.0
        self._user_dict_shared = False
        self._emit_hints: Dict[str, dict] = {}
        self._reshape_identity: Dict[str, bool] = {}
        self._last_remap: Optional[dict] = None
        # incremental popularity: running int64 per-item event counts and
        # the observed time range, valid while the backfill window covers
        # every event; otherwise the emit recomputes from the raw lists
        self._pop_incremental = (self.params.backfill_type == "popular"
                                 and list(bf_names) == [self.primary])
        self._pop_duration = 0.0
        if self._pop_incremental:
            try:
                self._pop_duration = parse_duration(self.params.backfill_duration)
            except (ValueError, TypeError):
                self._pop_incremental = False
        self._pop: Optional[list] = None     # [counts, t_min, t_max]
        self._pop_changed_now: Optional[np.ndarray] = None
        # emit-side caches (touched only by emit_snapshot, which runs
        # serialized, in snapshot order)
        self._user_seen_cache: Optional[tuple] = None
        self._seen_by_ev_cache: Dict[str, tuple] = {}
        self._inv_cache: Dict[str, dict] = {}

    # -- public entry ---------------------------------------------------------

    def fold(self, delta: EventBatch):
        """Fold one columnar delta (built with ``base=self.batch``, so the
        dictionaries are shared; the first call bootstraps) and return the
        new URModel."""
        return self.emit_snapshot(self.fold_apply(delta))

    def fold_apply(self, delta: EventBatch) -> _EmitSnapshot:
        """Apply one delta to the resident state and return the emission
        snapshot ``emit_snapshot`` needs.  The split lets the follower emit
        (and warm) on its publisher thread while the next delta applies."""
        t0 = time.perf_counter()
        self._rellr_s = 0.0
        if self.batch is None:
            self.batch = delta
        elif len(delta):
            self.batch = EventBatch.concat([self.batch, delta])
        self._apply(delta)
        self._check_budget()
        self.last_phase_s = {
            "apply": max(time.perf_counter() - t0 - self._rellr_s, 0.0),
            "rellr": self._rellr_s,
        }
        snap = self._snapshot()
        self.generation += 1
        return snap

    @classmethod
    def bootstrap(cls, algo_params, ds_params, batch: EventBatch,
                  device=None) -> "URFoldState":
        """Build the state and its first model from a full columnar batch."""
        state = cls(algo_params, ds_params, device=device)
        state.fold(batch)
        return state

    @property
    def state_mode(self) -> str:
        """'sparse' | 'dense': the resident count representation."""
        return self.impl

    def state_bytes(self) -> int:
        """Resident bytes of the incremental state: the counts plus what
        grows with the log (the accumulated batch, pair sets, raw
        popularity inputs, indicator tables): what
        ``PIO_FOLLOW_STATE_BYTES`` bounds."""
        total = 0
        for t in self.types.values():
            total += (t.sc.nbytes if t.sc is not None else int(t.C.nbytes)) + int(t.pairs.nbytes)
            total += int(t.col_counts.nbytes) + int(t.local_of_target.nbytes)
            total += sum(int(a.nbytes) for a in t.raw_items)
            total += sum(int(a.nbytes) for a in t.raw_times)
            if t.idx is not None:
                total += int(t.idx.nbytes) + int(t.llr.nbytes)
        if self._pop is not None:
            total += int(self._pop[0].nbytes)
        # list(): the publisher thread's emit may be installing entries
        for inv in list(self._inv_cache.values()):
            total += int(inv["perm"].nbytes)
        if self.batch is not None:
            b = self.batch
            for arr in (b.event_codes, b.entity_type_codes, b.entity_ids,
                        b.target_ids, b.times_us, b.ratings):
                total += int(arr.nbytes)
        return total

    # -- delta application ----------------------------------------------------

    def _check_budget(self) -> None:
        used, budget = self.state_bytes(), state_budget_bytes()
        if used > budget:
            raise FoldUnsupported(
                f"fold state {used} B exceeds PIO_FOLLOW_STATE_BYTES={budget}")

    @staticmethod
    def _grow_translate(arr: np.ndarray, n: int) -> np.ndarray:
        if len(arr) >= n:
            return arr
        out = np.full(max(n, 1), -1, arr.dtype)
        out[: len(arr)] = arr
        return out

    def _apply(self, delta: EventBatch) -> None:
        """``URDataSource.read_training`` incrementally over ``delta``, and
        the translated pairs folded into the counts."""
        self.last_fold_stats = {}
        self.last_rellr_stats = {}
        self._emit_hints = {}
        self._reshape_identity = {}
        self._pop_changed_now = None
        special = [delta.event_dict.id(n) for n in sorted(SPECIAL_EVENTS)]
        special = np.asarray([c for c in special if c is not None], np.int32)
        props_changed = bool(len(delta)) and bool(np.isin(delta.event_codes, special).any())
        view = dataclasses.replace(delta, prop_columns=None)
        per_type_raw: Dict[str, tuple] = {}
        for name in self.event_names:
            sel = view.select_events([name])
            has_t = sel.target_ids >= 0
            per_type_raw[name] = (sel.entity_ids[has_t], sel.target_ids[has_t],
                                  sel.times_us[has_t].astype(np.float64) / 1e6)
        # users enroll as read_training's per-type unique pass enrolls
        # them; the order only assigns internal user ids, which no answer
        # depends on
        self.user_of_code = self._grow_translate(self.user_of_code, len(delta.entity_dict))
        n_users_before = len(self.user_dict)
        for name in self.event_names:
            for c in np.unique(per_type_raw[name][0]):
                if self.user_of_code[c] < 0:
                    if self._user_dict_shared:
                        self.user_dict = self.user_dict.clone()   # copy on write
                        self._user_dict_shared = False
                    self.user_of_code[c] = self.user_dict.add(delta.entity_dict.str(int(c)))
        new_users = len(self.user_dict) != n_users_before
        # item spaces: each type keeps the sorted unique target codes,
        # the set read_training's np.unique gives over the whole batch, so
        # local ids (and their tie order) equal a retrain's even when an
        # old code first appears under a type (mid-array insert + remap)
        reshaped: Dict[str, bool] = {}
        for name in self.event_names:
            reshaped[name] = self._extend_item_space(name, per_type_raw[name][1], delta)
        primary_reshaped = reshaped[self.primary]
        if primary_reshaped:
            self._reshape_primary_rows()
        # translate, and append the raw events (popularity inputs)
        deltas: Dict[str, np.ndarray] = {}
        for name in self.event_names:
            st = self.types[name]
            e_codes, t_codes, times = per_type_raw[name]
            u = self.user_of_code[e_codes].astype(np.int64)
            i = st.local_of_target[t_codes]
            if len(i):
                st.raw_items.append(i.astype(np.int32))
                st.raw_times.append(times)
            if name == self.primary and self._pop_incremental:
                self._count_popularity(st.n_items, i, times)
            keys = np.unique(_pair_key(u, i)) if len(u) else np.zeros(0, np.int64)
            if len(keys):
                keys = keys[~_in_sorted(keys, st.pairs)]
            deltas[name] = keys
        # counts: C_new = C + Δpᵀ·A_old + P_newᵀ·Δa per type (for the
        # primary A ≡ P, and the two terms cover (P+Δ)ᵀ(P+Δ) exactly).  The
        # first pass sees every type's pre-delta pairs, the second the
        # post-delta primary pairs.
        p_st = self.types[self.primary]
        dp = deltas[self.primary]
        dp_u, dp_i = _key_user(dp), _key_item(dp)
        touched: Dict[str, List[np.ndarray]] = {n: [] for n in self.event_names}
        for name in self.event_names:
            st = self.types[name]
            touched[name].append(_cross_scatter(st.counts, st.pairs, dp_u, dp_i,
                                                rows_from_delta=True))
        if len(dp):
            p_st.pairs = np.sort(np.concatenate([p_st.pairs, dp]))
            self.row_counts += np.bincount(dp_i, minlength=p_st.n_items)
        for name in self.event_names:
            st = self.types[name]
            da = deltas[name]
            if len(da) == 0:
                continue
            touched[name].append(_cross_scatter(st.counts, p_st.pairs, _key_user(da),
                                                _key_item(da), rows_from_delta=False))
            st.col_counts += np.bincount(_key_item(da), minlength=st.n_items)
            if name != self.primary:
                st.pairs = np.sort(np.concatenate([st.pairs, da]))
        # re-LLR scope per type (exact): a changed N or column marginal
        # couples every cell of the type; otherwise only rows whose cells
        # or row marginal changed can differ
        rc_rows = np.unique(dp_i) if len(dp) else np.zeros(0, np.int64)
        for name in self.event_names:
            st = self.types[name]
            if st.n_items == 0 or p_st.n_items == 0:
                continue
            if (new_users or len(deltas[name]) or reshaped[name]
                    or primary_reshaped or st.idx is None):
                self._rellr_type(name, rows=None)
                continue
            rows = np.unique(np.concatenate([rc_rows] + touched[name]))
            if len(rows) == 0:
                self.last_fold_stats[name] = {"rows": 0, "mode": "skip"}
                self._emit_hints[name] = {"idx_rows": np.zeros(0, np.int64),
                                          "llr_changed": False}
                continue
            self._rellr_type(name, rows=rows.astype(np.int64))
        if props_changed or not self._props_ever:
            # a full-history recompute, not a merge: properties apply in
            # (eventTime, row) order, so a delta $set with an EARLIER
            # eventTime than an applied one must lose
            self._props = {k: dict(v) for k, v in fold_properties(
                self.batch, self.ds_params.item_entity_type).items()}
            self._props_ever = True
        self._last_remap = {
            "primary": primary_reshaped,
            "primary_identity": self._reshape_identity.get(self.primary, True),
            "types": dict(reshaped),
            "type_identity": dict(self._reshape_identity),
            "props": props_changed,
        }

    def _count_popularity(self, n_p: int, items: np.ndarray, times: np.ndarray) -> None:
        """The running primary event counts and time range of the
        incremental popularity."""
        if self._pop is None:
            self._pop = [np.zeros(max(n_p, 1), np.int64), np.inf, -np.inf]
        cnts = self._pop[0]
        if len(cnts) < n_p:   # growth the reshape did not see
            grown = np.zeros(n_p, np.int64)
            grown[:len(cnts)] = cnts
            self._pop[0] = cnts = grown
        if len(items):
            cnts += np.bincount(items, minlength=len(cnts))
            self._pop[1] = min(self._pop[1], float(times.min()))
            self._pop[2] = max(self._pop[2], float(times.max()))
            self._pop_changed_now = np.unique(items).astype(np.int64)
        else:
            self._pop_changed_now = np.zeros(0, np.int64)

    def _extend_item_space(self, name: str, t_codes: np.ndarray,
                           delta: EventBatch) -> bool:
        """Merge new target codes into the type's sorted code set; True
        when the type's item-id space changed (grew and/or ids shifted)."""
        st = self.types[name]
        st.local_of_target = self._grow_translate(st.local_of_target, len(delta.target_dict))
        if len(t_codes) == 0:
            return False
        uniq = np.unique(t_codes.astype(np.int64))
        new = uniq[~_in_sorted(uniq, st.codes)]
        if len(new) == 0:
            return False
        merged = np.union1d(st.codes, new)
        perm = np.searchsorted(merged, st.codes)  # old local → new local
        remapped = bool(len(st.codes)) and bool((perm != np.arange(len(st.codes))).any())
        n_old = len(st.codes)
        st.codes = merged
        self._reshape_identity[name] = not remapped
        if remapped or n_old == 0:
            st.item_dict = IdDict([delta.target_dict.str(int(c)) for c in merged])
            st.shared_dict = False
        else:
            # pure end growth: existing local ids are stable, so the
            # dictionary appends (a clone first when a model shares it)
            if st.shared_dict:
                st.item_dict = st.item_dict.clone()
                st.shared_dict = False
            for c in merged[n_old:]:
                st.item_dict.add(delta.target_dict.str(int(c)))
        lot = np.full(len(st.local_of_target), -1, np.int64)
        lot[merged] = np.arange(len(merged), dtype=np.int64)
        st.local_of_target = lot
        if remapped:
            st.pairs = np.sort((st.pairs & ~_LOW32) | perm[_key_item(st.pairs)])
            st.raw_items = [perm[a].astype(np.int32) for a in st.raw_items]
        cc = np.zeros(len(merged), np.int64)
        if len(perm):
            cc[perm] = st.col_counts
        st.col_counts = cc
        if st.sc is not None:
            if remapped:
                st.sc.remap_cols(perm)
        else:
            C = np.zeros((st.C.shape[0], len(merged)), np.int32)
            if len(perm) and st.C.size:
                C[:, perm] = st.C
            st.C = C
        if remapped:
            # stored indicator column ids shifted: the full re-LLR rebuilds
            st.idx = st.llr = None
        # pure end growth keeps every stored column id valid; the forced
        # full re-LLR re-certifies each row against the new columns
        if name == self.primary:
            self._primary_perm = perm
        return True

    def _reshape_primary_rows(self) -> None:
        """The primary item space changed: every type's count rows, the
        row marginals and the indicator tables follow the new id order."""
        p_st = self.types[self.primary]
        n_p = p_st.n_items
        # the primary pairs were remapped already; the delta's merge later
        self.row_counts = (np.bincount(_key_item(p_st.pairs), minlength=n_p).astype(np.int64)
                           if len(p_st.pairs) else np.zeros(n_p, np.int64))
        perm = self._primary_perm
        identity = self._reshape_identity.get(self.primary, True)
        if self._pop is not None:
            cnts = np.zeros(n_p, np.int64)
            if len(perm):
                cnts[perm] = self._pop[0][:len(perm)]
            self._pop[0] = cnts
        for name in self.event_names:
            st = self.types[name]
            if st.sc is not None:
                st.sc.remap_rows(perm)
            else:
                C = np.zeros((n_p, st.C.shape[1]), np.int32)
                if len(perm) and st.C.size:
                    C[perm, :] = st.C
                st.C = C
            if identity and st.idx is not None and st.idx.shape[0] <= n_p:
                # pure end growth: existing rows keep their ids, the tables
                # gain empty rows (selected through the full re-LLR)
                pad = n_p - st.idx.shape[0]
                if pad:
                    st.idx = np.concatenate([st.idx, np.full((pad, st.idx.shape[1]), -1,
                                                             np.int32)])
                    st.llr = np.concatenate([st.llr, np.zeros((pad, st.llr.shape[1]),
                                                              np.float32)])
                    st.shared_tables = False
            else:
                st.idx = st.llr = None

    def _rellr_type(self, name: str, rows: Optional[np.ndarray]) -> None:
        """LLR and top-k of ``rows`` of one type (None: all), bit-identical
        to what training computes on the state's device."""
        t0 = time.perf_counter()
        try:
            self._rellr_type_inner(name, rows)
        finally:
            self._rellr_s += time.perf_counter() - t0

    def _tuning(self, name: str) -> Tuple[int, float]:
        t_k, t_llr = self.per_type.get(
            name, (self.params.max_correlators_per_item, self.params.min_llr))
        return int(t_k), float(t_llr)

    def _put(self, a: np.ndarray, dtype=np.int32) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a, dtype), device=self.device)

    def _reselect_sparse_rows(self, st: _TypeState, rows: np.ndarray, width: int,
                              t_llr: float, excl: bool, n_t: int, n_total: float):
        """The top-``width`` of the given global primary rows from the
        sparse state, by the device's route: K2/K3 row slices on CUDA, the
        host scoring and lexsort on the CPU → (scores, ids) [len(rows),
        width]."""
        local, cols, counts = st.sc.row_cells(rows)
        self_cols = rows if excl else None
        if _kernel_reselect(self.device):
            return _llr_topk_row_slices(
                local, cols, counts, self.row_counts[rows], st.col_counts, n_total,
                t_llr, self_cols, width, n_t, self.device)
        return cco_ops._llr_topk_sparse_rows(
            local, cols, counts, self.row_counts[rows], st.col_counts, n_total,
            t_llr, top_k=width, n_rows=len(rows), n_cols=n_t, self_cols=self_cols,
            device=self.device)

    def _rellr_type_inner(self, name: str, rows: Optional[np.ndarray]) -> None:
        st = self.types[name]
        p_st = self.types[self.primary]
        t_k, t_llr = self._tuning(name)
        excl = name == self.primary
        n_t, n_p = st.n_items, p_st.n_items
        n_total = float(len(self.user_dict))
        width = min(t_k, n_t)
        small_dense = n_p * n_t * 4 <= _dense_rellr_bytes()
        if st.sc is not None and not small_dense:
            if rows is None:
                self._rellr_full_sparse(name, st, width, t_k, t_llr, excl, n_p, n_t,
                                        n_total)
                return
            s, i = self._reselect_sparse_rows(st, rows, width, t_llr, excl, n_t, n_total)
            self._store_rows(name, st, rows, s, i, n_t, t_k)
            return
        # the dense tail: the dense state, or a transient materialization
        # of a catalog small enough for PIO_FOLLOW_DENSE_RELLR_BYTES
        C_full = st.sc.to_dense(n_p, n_t) if st.sc is not None else st.C
        if rows is None:
            s, i = cco_ops._llr_topk_dense(
                self._put(C_full), self._put(self.row_counts), self._put(st.col_counts),
                n_total, t_llr, width, excl)
            scores, idx = cco_ops._DenseRunner.collect((s, i, n_t, t_k))
            st.idx = idx.astype(np.int32)
            st.llr = np.where(np.isfinite(scores), scores, 0.0).astype(np.float32)
            st.shared_tables = False
            self.last_fold_stats[name] = {"rows": int(C_full.shape[0]), "mode": "full"}
            self._emit_hints[name] = {"idx_rows": None, "llr_changed": True}
            return
        s, i = _llr_topk_row_slices(
            *_dense_rows_as_cells(C_full[rows]), self.row_counts[rows], st.col_counts,
            n_total, t_llr, rows if excl else None, width, n_t, self.device)
        self._store_rows(name, st, rows, s, i, n_t, t_k)

    def _store_rows(self, name: str, st: _TypeState, rows: np.ndarray,
                    s: np.ndarray, i: np.ndarray, n_t: int, t_k: int) -> None:
        """Write a sliced re-LLR's rows into the (copy-on-write) tables."""
        scores, idx = cco_ops._DenseRunner.collect((s, i, n_t, t_k))
        st.mutable_tables()
        st.idx[rows] = idx.astype(np.int32)
        st.llr[rows] = np.where(np.isfinite(scores), scores, 0.0).astype(np.float32)
        self.last_fold_stats[name] = {"rows": int(len(rows)), "mode": "sliced"}
        self._emit_hints[name] = {"idx_rows": rows, "llr_changed": True}

    def _rellr_full_sparse(self, name: str, st: _TypeState, width: int,
                           t_k: int, t_llr: float, excl: bool,
                           n_p: int, n_t: int, n_total: float) -> None:
        """Full (marginal-coupled) re-LLR of one type over the sparse state,
        pruned.  One score pass over every resident nonzero cell on the
        state's device (``_score_llr_cells``), then per-row re-selection
        only where the selection could have moved.

        A row keeps its stored selection iff (a) membership holds: with a
        full selection its weakest selected cell beats its best
        non-selected cell (a score tie is decided by the column tie-break,
        exactly); with fewer than ``width`` stored, no non-selected cell
        scores finite and no selected cell fell to -inf; and (b) the stored
        order is still (score desc, col asc) under the new scores.  A
        certified row refreshes its k stored scores by one gather; the rest
        are re-selected (``_reselect_sparse_rows``).  Without stored tables
        (the bootstrap, a column remap) every row is re-selected."""
        old_idx = st.idx if (rellr_prune_enabled() and st.idx is not None
                             and st.llr is not None
                             and st.idx.shape == (n_p, t_k)) else None
        self.last_fold_stats[name] = {"rows": n_p, "mode": "full"}
        if old_idx is None:
            all_rows = np.arange(n_p, dtype=np.int64)
            if _kernel_reselect(self.device):
                s, i = self._reselect_sparse_rows(st, all_rows, width, t_llr, excl,
                                                  n_t, n_total)
            else:
                crows, ccols, ccnt = self._scored_cells(st, excl)
                scores = self._score_cells(crows, ccols, ccnt, st, n_total, t_llr)
                keep = scores > -np.inf
                s, i = _select_topk_chunked(crows[keep], ccols[keep], scores[keep],
                                            n_p, width)
            sc2, idx2 = cco_ops._DenseRunner.collect((s, i, n_t, t_k))
            st.idx = idx2.astype(np.int32)
            st.llr = np.where(np.isfinite(sc2), sc2, 0.0).astype(np.float32)
            st.shared_tables = False
            if n_p:
                _M_RELLR_ROWS.inc(n_p, outcome="selected")
            self.last_rellr_stats[name] = {"certified": 0, "selected": int(n_p)}
            self._emit_hints[name] = {"idx_rows": None, "llr_changed": True}
            return
        crows, ccols, ccnt = self._scored_cells(st, excl)
        scores = self._score_cells(crows, ccols, ccnt, st, n_total, t_llr)
        # -- certification ------------------------------------------------
        valid = old_idx >= 0
        sel_count = valid.sum(axis=1)
        span = np.int64(n_t + 1)
        cell_flat = crows * span + ccols
        # one searchsorted locates every stored cell among the resident
        # ones (counts never decrease, so they exist; a miss would be a
        # corrupt state, which scores -inf and re-selects the row)
        vr, vj = np.nonzero(valid)
        vc = old_idx[vr, vj].astype(np.int64)
        new_sel = np.full((n_p, t_k), -np.inf, np.float32)
        is_sel = np.zeros(len(cell_flat), bool)
        if len(vr) and len(cell_flat):
            key = vr.astype(np.int64) * span + vc
            pos = np.searchsorted(cell_flat, key)
            np.minimum(pos, len(cell_flat) - 1, out=pos)
            hit = cell_flat[pos] == key
            is_sel[pos[hit]] = True
            new_sel[vr[hit], vj[hit]] = scores[pos[hit]]
        # each row's best non-selected contender (a segment max: cells are
        # (row, col)-sorted, so each row is one contiguous run)
        max_nonsel = np.full(n_p, -np.inf, np.float32)
        starts = np.zeros(0, np.int64)
        if len(crows):
            non_scores = np.where(is_sel, np.float32(-np.inf), scores)
            starts = np.concatenate([[0], np.flatnonzero(np.diff(crows)) + 1])
            max_nonsel[crows[starts]] = np.maximum.reduceat(non_scores, starts)
        min_sel = np.where(valid, new_sel, np.inf).min(axis=1)
        # a score tie at the membership boundary is decidable: under (score
        # desc, col asc) the tied selected cells win iff their largest
        # column is below the tied contenders' smallest
        nonsel_tie_min = np.full(n_p, int(span), np.int64)
        if len(crows):
            tie_cols = np.where(~is_sel & (scores == max_nonsel[crows]), ccols, span)
            nonsel_tie_min[crows[starts]] = np.minimum.reduceat(tie_cols, starts)
        sel_tie_max = (np.where(valid & (new_sel == min_sel[:, None]), old_idx, -1)
                       .max(axis=1).astype(np.int64) if t_k
                       else np.full(n_p, -1, np.int64))
        tie_ok = (min_sel > -np.inf) & (sel_tie_max < nonsel_tie_min)
        member_ok = np.where(
            sel_count == width,
            (min_sel > max_nonsel) | ((min_sel == max_nonsel) & tie_ok),
            (max_nonsel == -np.inf) & (min_sel > -np.inf))
        if t_k > 1:
            s0, s1 = new_sel[:, :-1], new_sel[:, 1:]
            i0 = old_idx[:, :-1].astype(np.int64)
            i1 = old_idx[:, 1:].astype(np.int64)
            # padding is a suffix, so valid[:, 1:] marks exactly the
            # adjacent pairs that are both valid
            pair_ok = (s0 > s1) | ((s0 == s1) & (i0 < i1)) | ~valid[:, 1:]
            certified = member_ok & pair_ok.all(axis=1)
        else:
            certified = member_ok
        uncert = np.flatnonzero(~certified).astype(np.int64)
        idx_new = old_idx.copy()
        llr_new = np.zeros((n_p, t_k), np.float32)
        cert2d = certified[:, None] & valid
        llr_new[cert2d] = new_sel[cert2d]
        if len(uncert):
            if _kernel_reselect(self.device):
                s_u, i_u = self._reselect_sparse_rows(st, uncert, width, t_llr, excl,
                                                      n_t, n_total)
            else:
                s_u, i_u = self._select_uncertified(crows, ccols, scores, uncert, width)
            sc2, idx2 = cco_ops._DenseRunner.collect((s_u, i_u, n_t, t_k))
            idx_new[uncert] = idx2.astype(np.int32)
            llr_new[uncert] = np.where(np.isfinite(sc2), sc2, 0.0).astype(np.float32)
        st.idx, st.llr = idx_new, llr_new
        st.shared_tables = False
        n_cert = int(n_p - len(uncert))
        if n_cert:
            _M_RELLR_ROWS.inc(n_cert, outcome="certified")
        if len(uncert):
            _M_RELLR_ROWS.inc(int(len(uncert)), outcome="selected")
        self.last_rellr_stats[name] = {"certified": n_cert, "selected": int(len(uncert))}
        self._emit_hints[name] = {"idx_rows": uncert, "llr_changed": True}

    @staticmethod
    def _scored_cells(st: _TypeState, excl: bool):
        """Every resident cell, the self pairs of the primary type dropped."""
        crows, ccols, ccnt = st.sc.all_cells()
        if excl and len(crows):
            off = ccols != crows
            crows, ccols, ccnt = crows[off], ccols[off], ccnt[off]
        return crows, ccols, ccnt

    def _score_cells(self, crows, ccols, ccnt, st: _TypeState, n_total: float,
                     t_llr: float) -> np.ndarray:
        """G² of the gathered cells on the state's device (-inf masked)."""
        return cco_ops._score_llr_cells(
            ccnt.astype(np.float32), self.row_counts[crows].astype(np.float32),
            st.col_counts[ccols].astype(np.float32), n_total, t_llr, device=self.device)

    @staticmethod
    def _select_uncertified(crows, ccols, scores, uncert: np.ndarray, width: int):
        """The host re-selection of the uncertified rows from the scored
        cells (the CPU route)."""
        keep = scores > -np.inf
        kr, kc, ks = crows[keep], ccols[keep], scores[keep]
        lo = np.searchsorted(kr, uncert, side="left")
        hi = np.searchsorted(kr, uncert, side="right")
        seg = hi - lo
        total = int(seg.sum())
        if not total:
            return (np.full((len(uncert), width), -np.inf, np.float32),
                    np.full((len(uncert), width), -1, np.int32))
        csum = np.cumsum(seg)
        within = np.arange(total, dtype=np.int64) - np.repeat(csum - seg, seg)
        gidx = np.repeat(lo, seg) + within
        local = np.repeat(np.arange(len(uncert), dtype=np.int64), seg)
        return _select_topk_chunked(local, kc[gidx], ks[gidx], len(uncert), width)

    # -- model emission -------------------------------------------------------

    def _snapshot(self) -> _EmitSnapshot:
        """A consistent emission view: references to structures replaced on
        change, a copy of the in-place popularity counts, and copy-on-write
        marks on the tables and dictionaries the model will share."""
        pop_f32, pop_changed = self._pop_view()
        types: Dict[str, dict] = {}
        for name in self.event_names:
            st = self.types[name]
            types[name] = {
                "idx": st.idx, "llr": st.llr, "pairs": st.pairs,
                "item_dict": st.item_dict, "n_items": st.n_items,
                "raw_items": list(st.raw_items), "raw_times": list(st.raw_times),
            }
            st.shared_tables = True
            st.shared_dict = True
        self._user_dict_shared = True
        return _EmitSnapshot(
            generation=self.generation + 1,
            n_users=len(self.user_dict),
            user_dict=self.user_dict,
            types=types,
            props=self._props,
            pop_f32=pop_f32,
            pop_changed=pop_changed,
            remap=dict(self._last_remap or {"primary": True, "primary_identity": False,
                                            "types": {}, "type_identity": {},
                                            "props": True}),
            hints=dict(self._emit_hints),
        )

    def _pop_view(self):
        """(popularity f32, changed ids) while the incremental counts are
        valid: no event has left the end-anchored window (``min_t >= max_t
        + 1e-6 - duration``, the full recompute's float64 arithmetic).
        (None, None) otherwise: the emit recomputes."""
        if not self._pop_incremental or self._pop is None:
            return None, None
        cnts, t_min, t_max = self._pop
        if np.isfinite(t_max) and t_min < (float(t_max) + 1e-6) - float(self._pop_duration):
            return None, None
        return cnts.astype(np.float32), self._pop_changed_now

    def _emit(self):
        """A fresh URModel from the current state (the restore entry)."""
        return self.emit_snapshot(self._snapshot())

    def emit_snapshot(self, snap: _EmitSnapshot):
        """The URModel one snapshot describes, on the state's device:
        array-identical to the one ``URAlgorithm.train`` builds, reusing
        derived serving state across generations where provably identical.
        Emits are serialized and in snapshot order, so the previous
        generation (``self.model``) stays the one the hints describe."""
        from predictionio_tpu_torch.models.universal_recommender.engine import URModel
        from predictionio_tpu_torch.models.universal_recommender.popmodel import (
            backfill_scores,
            parse_duration,
        )

        t0 = time.perf_counter()
        p = snap.types[self.primary]
        n_items = p["n_items"]
        n_users = snap.n_users
        if n_items == 0:
            raise ValueError(f"no {self.primary!r} events to train on")
        indicator_idx: Dict[str, np.ndarray] = {}
        indicator_llr: Dict[str, np.ndarray] = {}
        event_item_dicts: Dict[str, IdDict] = {}
        for name in self.event_names:
            t = snap.types[name]
            if name != self.primary and t["n_items"] == 0:
                continue
            event_item_dicts[name] = t["item_dict"]
            indicator_idx[name] = t["idx"]
            indicator_llr[name] = t["llr"]
        # user → seen primary items: the resident pairs are (user, item)-
        # sorted and deduped, so a changed generation rebuilds in O(pairs)
        # without a sort and an untouched one carries the CSR object
        pairs = p["pairs"]
        us_cache = self._user_seen_cache
        if us_cache is not None and us_cache[0] is pairs and us_cache[1] == n_users:
            user_seen = us_cache[2]
            _M_EMIT.inc(1, component="user_seen", path="carried")
        else:
            user_seen = CSRLookup.from_sorted_pairs(_key_user(pairs), _key_item(pairs),
                                                    n_users)
            self._user_seen_cache = (pairs, n_users, user_seen)
            _M_EMIT.inc(1, component="user_seen", path="rebuilt")
        if snap.pop_f32 is not None:
            popularity = snap.pop_f32
            _M_EMIT.inc(1, component="popularity", path="patched")
        else:
            _M_EMIT.inc(1, component="popularity", path="rebuilt")
            popularity = self._full_popularity(snap, backfill_scores, parse_duration)
        blacklist_events = self.params.blacklist_events or [self.primary]
        user_seen_by_event: Dict[str, CSRLookup] = {}
        for name in blacklist_events:
            if name == self.primary or name not in event_item_dicts:
                continue
            t = snap.types[name]
            cache = self._seen_by_ev_cache.get(name)
            if (cache is not None and cache[0] is t["pairs"] and cache[1] is p["item_dict"]
                    and cache[2] is t["item_dict"] and cache[3] == n_users):
                user_seen_by_event[name] = cache[4]
                _M_EMIT.inc(1, component="seen_by_event", path="carried")
                continue
            translate = p["item_dict"].lookup_many(t["item_dict"].strings())
            u, i = _key_user(t["pairs"]), _key_item(t["pairs"])
            mapped = translate[i] if len(i) else i
            keep = mapped >= 0
            csr = CSRLookup.from_pairs(u[keep], mapped[keep], n_users)
            user_seen_by_event[name] = csr
            self._seen_by_ev_cache[name] = (t["pairs"], p["item_dict"], t["item_dict"],
                                            n_users, csr)
            _M_EMIT.inc(1, component="seen_by_event", path="rebuilt")
        prev = self.model
        model = URModel(
            primary_event=self.primary,
            item_dict=p["item_dict"],
            user_dict=snap.user_dict,
            indicator_idx=indicator_idx,
            indicator_llr=indicator_llr,
            event_item_dicts=event_item_dicts,
            popularity=popularity,
            item_properties=snap.props,
            user_seen=user_seen,
            user_seen_by_event=user_seen_by_event,
            device=self.device,
        )
        self._carry_serving_state(model, prev, snap)
        self.model = model
        self.last_emit_s = time.perf_counter() - t0
        return model

    def _full_popularity(self, snap: _EmitSnapshot, backfill_scores, parse_duration):
        """The backfill scores recomputed from the raw event lists, as
        ``URAlgorithm.train`` computes them."""
        p = snap.types[self.primary]
        bf_items, bf_times = [], []
        for name in self.params.backfill_event_names or [self.primary]:
            t = snap.types[name]
            items = np.concatenate(t["raw_items"]) if t["raw_items"] else np.zeros(0, np.int32)
            times = (np.concatenate(t["raw_times"]) if t["raw_times"]
                     else np.zeros(0, np.float64))
            if name == self.primary:
                bf_items.append(items)
                bf_times.append(times)
            else:
                translate = p["item_dict"].lookup_many(t["item_dict"].strings())
                mapped = translate[items] if len(items) else items
                keep = mapped >= 0
                bf_items.append(mapped[keep])
                bf_times.append(times[keep])
        return backfill_scores(
            self.params.backfill_type,
            np.concatenate(bf_items) if bf_items else np.zeros(0, np.int32),
            np.concatenate(bf_times) if bf_times else np.zeros(0, np.float64),
            p["n_items"], parse_duration(self.params.backfill_duration))

    def _carry_serving_state(self, model, prev, snap: _EmitSnapshot) -> None:
        """Hand derived serving state to the new generation where provably
        identical to a rebuild; everything else stays generation-keyed (a
        fresh ``__dict__`` is the invalidation).  Pure end growth of the
        catalog patches: the host inverted CSR splices the changed rows and
        regathers every weight through the cached inversion permutation,
        and ``host_pop_order`` merges the changed and new ids."""
        if prev is None:
            return
        # provenance of this generation relative to ``prev`` (a weakref:
        # it is valid only against the generation it patched from): the
        # response cache reads ``serve``, the row patches ``inv`` and
        # ``pop_order``
        prov: Dict[str, object] = {"prev": weakref.ref(prev), "inv": {}}
        model.__dict__["_plane_prov"] = prov
        remap = snap.remap
        same_catalog = not remap["primary"] and len(model.item_dict) == len(prev.item_dict)
        grown_ok = same_catalog or (remap["primary"] and remap.get("primary_identity"))
        props_carried = (same_catalog and not remap["props"]
                         and model.item_properties is prev.item_properties)
        if props_carried:
            carried = False
            for attr in ("_prop_value_index", "_prop_date_array", "_known_prop_names"):
                v = prev.__dict__.get(attr)
                if v is not None:
                    model.__dict__[attr] = v
                    carried = True
            if carried:
                _M_EMIT.inc(1, component="props", path="carried")
        # the rule, value-mask and date caches are functions of (item_dict,
        # item_properties): exactly what props_carried proves unchanged
        model.adopt_rule_caches(prev, carry=props_carried)
        if not grown_ok:
            return
        self._serve_provenance(model, prev, snap, prov)
        self._carry_pop_order(model, prev, snap, prov)
        self._carry_inverted(model, prev, snap, prov)

    @staticmethod
    def _serve_provenance(model, prev, snap: _EmitSnapshot, prov: dict) -> None:
        """The response cache's provenance: per type the changed primary
        rows, and the changed popularity ids, from the emit hints and
        copy-on-write identity.  Any unknowable piece (a full re-select, a
        column remap, non-incremental popularity) withholds it, and the
        cache flushes."""
        remap = snap.remap
        n_new, n_old = len(model.item_dict), len(prev.item_dict)
        grow = np.arange(n_old, n_new, dtype=np.int64) if n_new > n_old else None
        sinv: Dict[str, np.ndarray] = {}
        if set(model.indicator_idx) != set(prev.indicator_idx):
            return
        for name in model.indicator_idx:
            if remap["types"].get(name) and not remap["type_identity"].get(name):
                return   # target-column ids shifted
            new_idx = model.indicator_idx[name]
            old_idx = prev.indicator_idx.get(name)
            if new_idx is old_idx:
                changed = np.zeros(0, np.int64)   # copy-on-write: untouched
            elif new_idx is None or old_idx is None:
                return
            else:
                hint = snap.hints.get(name)
                if hint is None or hint.get("idx_rows") is None:
                    return   # a full re-select: any row may have moved
                changed = np.asarray(hint["idx_rows"], np.int64)
                if new_idx.shape[0] > old_idx.shape[0]:
                    changed = np.union1d(changed, np.arange(
                        old_idx.shape[0], new_idx.shape[0], dtype=np.int64))
            sinv[name] = changed
        if snap.pop_changed is not None:
            pchg = np.asarray(snap.pop_changed, np.int64)
            if grow is not None:
                pchg = np.union1d(pchg, grow)
            prov["serve"] = {"inv": sinv, "pop": pchg}

    @staticmethod
    def _carry_pop_order(model, prev, snap: _EmitSnapshot, prov: dict) -> None:
        old_order = prev.__dict__.get("_host_pop_order")
        if old_order is None or snap.pop_changed is None:
            return
        n_new, n_old = len(model.item_dict), len(prev.item_dict)
        changed = snap.pop_changed
        if n_new > n_old:
            changed = np.union1d(changed, np.arange(n_old, n_new, dtype=np.int64))
        model.__dict__["_host_pop_order"] = _merge_pop_order(
            old_order, np.asarray(model.popularity, np.float32), changed)
        prov["pop_order"] = np.asarray(changed, np.int64)
        _M_EMIT.inc(1, component="pop_order", path="patched" if len(changed) else "carried")

    def _carry_inverted(self, model, prev, snap: _EmitSnapshot, prov: dict) -> None:
        """The host inverted CSR: carried, weights regathered, or rows
        patched (``_patch_inverted_csr``)."""
        remap = snap.remap
        for name, old in (prev.__dict__.get("_host_inv") or {}).items():
            if name not in model.indicator_idx:
                continue
            if remap["types"].get(name) and not remap["type_identity"].get(name):
                self._inv_cache.pop(name, None)
                continue   # column ids shifted: rebuild from scratch
            new_idx = model.indicator_idx[name]
            old_idx = prev.indicator_idx.get(name)
            if (old_idx is None or old_idx.ndim != 2 or new_idx.ndim != 2
                    or old_idx.shape[1] != new_idx.shape[1]
                    or old_idx.shape[0] > new_idx.shape[0]):
                self._inv_cache.pop(name, None)
                continue
            new_llr = model.indicator_llr[name]
            i_p = new_idx.shape[0]
            n_t = max(len(model.event_item_dicts[name]), 1)
            hint = snap.hints.get(name)
            if hint is not None and hint["idx_rows"] is not None:
                changed = np.asarray(hint["idx_rows"], np.int64)
                llr_changed = bool(hint["llr_changed"])
            else:
                # no hint (a restored state): a structural diff
                rows_eq = min(old_idx.shape[0], i_p)
                diff = (new_idx[:rows_eq] != old_idx[:rows_eq]).any(axis=1)
                changed = np.flatnonzero(diff).astype(np.int64)
                llr_changed = True
            if old_idx.shape[0] < i_p:
                changed = np.union1d(changed, np.arange(old_idx.shape[0], i_p,
                                                        dtype=np.int64))
            if len(changed) * 2 > i_p:
                self._inv_cache.pop(name, None)
                continue   # most rows moved: a fresh inversion is cheaper
            cache = self._inv_cache.get(name)
            perm = (cache["perm"] if cache is not None and cache["for_idx"] is old_idx
                    else _inverted_perm(old_idx))
            if len(changed) == 0:
                if not llr_changed:
                    model.__dict__.setdefault("_host_inv", {})[name] = old
                    self._inv_cache[name] = {"for_idx": new_idx, "perm": perm}
                    _M_EMIT.inc(1, component="inverted", path="carried")
                    continue
                indptr, rows = old[0], old[1]
                if len(indptr) < n_t + 1:
                    indptr = np.concatenate([indptr, np.full(n_t + 1 - len(indptr),
                                                             indptr[-1], np.int64)])
            else:
                indptr, rows, perm = _patch_inverted_csr(
                    old[0], old[1], perm, changed, old_idx, new_idx, n_t, i_p)
            w = new_llr.ravel()[perm].astype(np.float32, copy=False)
            model.__dict__.setdefault("_host_inv", {})[name] = (indptr, rows, w)
            self._inv_cache[name] = {"for_idx": new_idx, "perm": perm}
            prov["inv"][name] = np.asarray(changed, np.int64)
            _M_EMIT.inc(1, component="inverted", path="patched")

    # -- checkpointing --------------------------------------------------------
    #
    # The numeric state serializes to one flat array dict (npz, no pickle)
    # and a small JSON meta; the accumulated batch persists through
    # store.columnar.write_batch.  The dictionaries rebuild from the
    # batch's plus the stored code maps.  ``state_fingerprint`` (crc32 over
    # the pairs, marginals and code sets) makes bit rot detectable.

    def state_fingerprint(self) -> int:
        h = zlib.crc32(self.row_counts.tobytes())
        for name in self.event_names:
            st = self.types[name]
            h = zlib.crc32(np.ascontiguousarray(st.pairs).tobytes(), h)
            h = zlib.crc32(np.ascontiguousarray(st.col_counts).tobytes(), h)
            h = zlib.crc32(np.ascontiguousarray(st.codes).tobytes(), h)
        return int(h)

    def checkpoint_arrays(self) -> Tuple[Dict[str, np.ndarray], dict]:
        """(arrays, meta) capturing everything but the batch, in the JAX
        package's layout."""
        arrays: Dict[str, np.ndarray] = {
            "user_of_code": self.user_of_code,
            "row_counts": self.row_counts,
        }
        meta = {
            "version": 1,
            "impl": self.impl,
            "event_names": list(self.event_names),
            "n_users": len(self.user_dict),
            "props_ever": bool(self._props_ever),
            "generation": int(self.generation),
            "fingerprint": self.state_fingerprint(),
        }
        for k, name in enumerate(self.event_names):
            st = self.types[name]
            p = f"t{k}_"
            arrays[p + "codes"] = st.codes
            arrays[p + "local_of_target"] = st.local_of_target
            arrays[p + "pairs"] = st.pairs
            arrays[p + "col_counts"] = st.col_counts
            arrays[p + "raw_items"] = (np.concatenate(st.raw_items) if st.raw_items
                                       else np.zeros(0, np.int32))
            arrays[p + "raw_times"] = (np.concatenate(st.raw_times) if st.raw_times
                                       else np.zeros(0, np.float64))
            if st.idx is not None:
                arrays[p + "idx"] = st.idx
                arrays[p + "llr"] = st.llr
            if st.sc is not None:
                arrays[p + "cell_keys"] = st.sc.keys
                arrays[p + "cell_counts"] = st.sc.counts
            else:
                arrays[p + "dense_C"] = st.C
        return arrays, meta

    @classmethod
    def restore_checkpoint(cls, algo_params, ds_params, batch, arrays, meta,
                           device=None) -> "URFoldState":
        """Rebuild a state from ``checkpoint_arrays`` output and the
        persisted batch, verify the fingerprint, and emit its model on
        ``device``.  Raises ValueError on any mismatch (version, config
        drift, corrupt arrays): the caller restages from the log."""
        if meta.get("version") != 1:
            raise ValueError(f"unknown checkpoint version {meta.get('version')}")
        state = cls(algo_params, ds_params, device=device)
        if list(meta.get("event_names") or []) != state.event_names:
            raise ValueError("checkpoint event_names do not match the current engine params")
        state.batch = batch
        state.user_of_code = np.array(arrays["user_of_code"], np.int32)
        state.row_counts = np.array(arrays["row_counts"], np.int64)
        # the user dictionary is user_of_code inverted over the batch's
        # entity dictionary (enrollment order is the map's value order)
        n_users = int(meta["n_users"])
        order = np.full(n_users, -1, np.int64)
        valid = np.flatnonzero(state.user_of_code >= 0)
        order[state.user_of_code[valid]] = valid
        if n_users and (order < 0).any():
            raise ValueError("checkpoint user map is not a bijection")
        state.user_dict = IdDict([batch.entity_dict.str(int(c)) for c in order])
        state.impl = str(meta.get("impl") or "sparse")
        for k, name in enumerate(state.event_names):
            st = state.types[name]
            p = f"t{k}_"
            st.codes = np.array(arrays[p + "codes"], np.int64)
            st.item_dict = IdDict([batch.target_dict.str(int(c)) for c in st.codes])
            st.local_of_target = np.array(arrays[p + "local_of_target"], np.int64)
            st.pairs = np.array(arrays[p + "pairs"], np.int64)
            st.col_counts = np.array(arrays[p + "col_counts"], np.int64)
            ri = np.array(arrays[p + "raw_items"], np.int32)
            rt = np.array(arrays[p + "raw_times"], np.float64)
            if len(ri) != len(rt):
                raise ValueError("checkpoint raw popularity arrays torn")
            st.raw_items = [ri] if len(ri) else []
            st.raw_times = [rt] if len(rt) else []
            if p + "idx" in arrays:
                st.idx = np.array(arrays[p + "idx"], np.int32)
                st.llr = np.array(arrays[p + "llr"], np.float32)
            if p + "cell_keys" in arrays:
                st.sc = _SparseCounts(np.array(arrays[p + "cell_keys"]),
                                      np.array(arrays[p + "cell_counts"]))
                st.C = None
            elif p + "dense_C" in arrays:
                st.C = np.array(arrays[p + "dense_C"], np.int32)
                st.sc = None
            else:
                raise ValueError(f"checkpoint carries no counts for {name}")
        if state.state_fingerprint() != int(meta["fingerprint"]):
            raise ValueError("checkpoint integrity fingerprint mismatch")
        if meta.get("props_ever"):
            state._props = {k2: dict(v) for k2, v in fold_properties(
                batch, ds_params.item_entity_type).items()}
            state._props_ever = True
        state.generation = int(meta.get("generation", 0))
        if state._pop_incremental:
            # the running popularity counts are derived: rebuilt from the
            # restored raw lists, so later folds keep the incremental path
            p_st = state.types[state.primary]
            items = (np.concatenate(p_st.raw_items) if p_st.raw_items
                     else np.zeros(0, np.int32))
            times = (np.concatenate(p_st.raw_times) if p_st.raw_times
                     else np.zeros(0, np.float64))
            state._pop = [
                np.bincount(items, minlength=max(p_st.n_items, 1)).astype(np.int64),
                float(times.min()) if len(times) else np.inf,
                float(times.max()) if len(times) else -np.inf,
            ]
        state.model = None
        state.model = state._emit()
        return state


def _dense_rows_as_cells(C_rows: np.ndarray):
    """A dense [r, I_t] count slice as ``row_cells``-style COO cells."""
    local, cols = np.nonzero(C_rows)
    return local.astype(np.int64), cols.astype(np.int64), C_rows[local, cols]
