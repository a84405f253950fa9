"""Correlated cross-occurrence (CCO): the Universal Recommender's training op.

Counterpart of the device strategies of ``predictionio_tpu/ops/cco.py``.
For each event type, against one primary event type:

1. densify the (user, item) pairs of a user chunk or an item tile into a 0/1
   matrix by a scatter of ones — the scatter is the dedup;
2. ``C = Pᵀ·A``, the cooccurrence counts, exact (see ``_count_product``),
   with the row and column marginals (distinct users per item) as sums of
   the densified matrices;
3. Dunning's G² of every cell, masked to -inf where the count is 0 or the
   score misses the threshold: the K2 kernel (``llr_masked_scores``);
4. the exact per-row top-k in ``lax.top_k``'s order: the K3 kernel
   (``tile_topk_desc``), which in the tiled strategy also merges each tile
   into the running carry (``ops.topk.merge_desc``, fused into the launch).

Two strategies, chosen per event type by the reference's own budgets
(copied as they are, so the port picks the strategy the JAX package picks):

- **dense** (``_DenseRunner``): users in chunks, the whole [I_p, I_t] count
  matrix accumulated, then one K2 pass and one K3 row top-k;
- **P-resident tiled** (``_cco_indicators_resident``): the densified primary
  stays on the device, item tiles of the other type are densified one at a
  time, and each tile's K3 top-b merges into a running carry — the full
  count matrix never exists.

Both call the same K2 kernel on the same integer counts, so on the same data
they give bit-identical indicator tables.  Left for later (each raises
``NotImplementedError`` naming its ROADMAP item): the chunked tiled strategy
(when the densified primary does not fit its budget), the ``mesh`` (multi-
device) variants, and the host sparse-count runner, a CPU specialisation.

Layouts: every 0/1 matrix is int8 and stored item-major, [items, users], so
the count product is ``Pt · Atᵀ`` with both operands in the layout the int8
tensor-core product takes (``torch._int_mm``: the first operand row-major,
the second column-major).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.ops.hopper_kernels import (
    llr_masked_scores,
    tile_topk_desc,
)
from predictionio_tpu_torch.ops.topk import block_width

#: the reference's clamp ``-1 + 1e-9``, which rounds to exactly -1.0 in f32
_LOG1P_FLOOR = -1.0

# Budgets of the reference, copied as they are (sized there for one 16 GB
# TPU v5e).  They count 2 bytes a densified cell, the reference's bf16; the
# port's int8 matrices take half of that.
_TILED_P_BYTES = 8 << 30       # P-resident working set (P + A tile + counts)
_DENSE_CHUNK_BYTES = 1 << 30   # per-chunk densified P + A
_DENSE_C_BYTES = 2 << 30       # the whole count matrix, 4 bytes a cell
_REF_BYTES_PER_CELL = 2

ROADMAP_CCO = ("ROADMAP.md, queue A, 'the chunked tiled and sparse-host CCO "
               "strategies'")
ROADMAP_MESH = "ROADMAP.md, queue A, 'parallel → torch.distributed'"


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


def _llr_mask_scores(c, row_counts, col_counts, n_total, llr_threshold):
    """The LLR scoring + masking every strategy shares: always the K2
    kernel (its plain version for CPU tensors)."""
    return llr_masked_scores(c, row_counts, col_counts, float(n_total),
                             float(llr_threshold))


def _finalize_topk(best_scores, best_idx, n_items_t: int,
                   top_k: Optional[int] = None):
    """Host epilogue: -1-pad entries that are -inf or padding columns, and
    slice a power-of-two carry back to ``top_k``."""
    scores = best_scores.cpu().numpy()
    idx = best_idx.cpu().numpy().astype(np.int32)
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


#: rows per block of ``_marginal``'s sum
_MARGINAL_ROWS = 4096


def _marginal(m: torch.Tensor) -> torch.Tensor:
    """Distinct users per item of an item-major 0/1 matrix, exact int32.
    Summed in row blocks: ``sum(dtype=int32)`` first casts its whole input
    to int32, which for the resident primary is 4x its int8 bytes."""
    out = torch.empty(m.shape[0], dtype=torch.int32, device=m.device)
    for s in range(0, m.shape[0], _MARGINAL_ROWS):
        torch.sum(m[s:s + _MARGINAL_ROWS], 1, dtype=torch.int32,
                  out=out[s:s + _MARGINAL_ROWS])
    return out


class _StagedCOO:
    """One event type's raw (user, item) pairs on the device, sorted by a
    key (user for user chunks, item for item tiles) with the host-side
    boundaries of each chunk or tile — one sort, one small readback."""

    def __init__(self, user, item, device: torch.device, by: str, step: int,
                 n_steps: int):
        u = torch.as_tensor(np.asarray(user, np.int64), device=device)
        i = torch.as_tensor(np.asarray(item, np.int64), device=device)
        if len(u) != len(i):
            raise ValueError(f"user/item length mismatch: {len(u)} vs {len(i)}")
        key = u if by == "user" else i
        key, order = torch.sort(key, stable=True)
        self.user, self.item = u[order], i[order]
        starts = torch.arange(n_steps + 1, device=device, dtype=torch.int64) * step
        self.bounds: List[int] = torch.searchsorted(key, starts).tolist()
        self.step = step

    def span(self, s: int) -> Tuple[torch.Tensor, torch.Tensor]:
        lo, hi = self.bounds[s], self.bounds[s + 1]
        return self.user[lo:hi], self.item[lo:hi]


def _check_ids(user, item, n_users: int, n_items: int, what: str) -> None:
    user, item = np.asarray(user), np.asarray(item)
    if len(user) and (int(user.min()) < 0 or int(user.max()) >= n_users):
        raise ValueError(f"{what}: user ids outside [0, {n_users})")
    if len(item) and (int(item.min()) < 0 or int(item.max()) >= n_items):
        raise ValueError(f"{what}: item ids outside [0, {n_items})")


# ---------------------------------------------------------------------------
# dense user-chunked strategy
# ---------------------------------------------------------------------------


def _dense_chunk_users(n_items_p: int, it_pad: int, n_users: int) -> int:
    """Chunk size minimizing padded-user waste: the number of chunks the
    budget forces, then users split evenly (``predictionio_tpu/ops/cco.py:
    _dense_chunk_users``, one device)."""
    per_user = (n_items_p + it_pad) * _REF_BYTES_PER_CELL
    max_chunk = max(_DENSE_CHUNK_BYTES // max(per_user, 1), 256)
    n_chunks = max(math.ceil(n_users / max_chunk), 1)
    chunk = math.ceil(n_users / n_chunks / 256) * 256
    return max(chunk, 256)


def _dense_path_ok(n_items_p: int, n_items_t: int) -> bool:
    """The dense strategy when the whole int32 count matrix fits its
    budget (the reference's auto rule)."""
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
    each event type against it.  One instance per training run."""

    def __init__(self, p_user, p_item, n_users: int, n_items_p: int,
                 it_pad_max: int, device: torch.device):
        self.device = device
        self.n_users = n_users
        self.n_items_p = n_items_p
        self.chunk = _dense_chunk_users(n_items_p, it_pad_max, n_users)
        self.n_chunks = math.ceil(max(n_users, 1) / self.chunk)
        self.p = self._stage(p_user, p_item)

    def _stage(self, user, item) -> _StagedCOO:
        return _StagedCOO(user, item, self.device, "user", self.chunk,
                          self.n_chunks)

    def _densify_chunk(self, staged: _StagedCOO, c: int, n_items: int):
        u, i = staged.span(c)
        return _densify(i, u - c * self.chunk, _item_rows(n_items), self.chunk)

    def counts(self, a_user, a_item, n_items_t: int, self_pair: bool = False):
        """(C [I_p, it_pad] int32, row marginals [I_p], column marginals
        [it_pad]) on the device: the sum over user chunks of ``Pᵀ·A``."""
        if self_pair:
            it_pad, a = self.n_items_p, self.p
        else:
            it_pad = max(_round_up(n_items_t, 128), 128)
            a = self._stage(a_user, a_item)
        i_p = self.n_items_p
        C = torch.zeros((i_p, it_pad), dtype=torch.int32, device=self.device)
        rc = torch.zeros(i_p, dtype=torch.int32, device=self.device)
        cc = torch.zeros(it_pad, dtype=torch.int32, device=self.device)
        for c in range(self.n_chunks):
            pt = self._densify_chunk(self.p, c, i_p)
            at = pt if self_pair else self._densify_chunk(a, c, it_pad)
            C += _count_product(pt, at)[:i_p, :it_pad]
            rc += _marginal(pt[:i_p])
            cc += _marginal(at[:it_pad])
        return C, rc, cc

    def dispatch(self, a_user, a_item, n_items_t: int, top_k: int,
                 llr_threshold: float, exclude_self: bool,
                 self_pair: bool = False):
        """One event type's indicators, left on the device until
        ``collect``."""
        C, rc, cc = self.counts(a_user, a_item, n_items_t, self_pair)
        k = min(top_k, C.shape[1])
        s, i = _llr_topk_dense(C, rc, cc, float(self.n_users),
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
# P-resident tiled strategy (large catalogs: the count matrix never exists)
# ---------------------------------------------------------------------------


def _resident_p_ok(n_users: int, n_items_p: int, item_tile: int = 4096) -> bool:
    """The P-resident strategy when its whole working set (resident P, one
    densified A tile, the 4-byte count tile) fits the reference's budget.
    The reference also caps bf16 at 2**24 users; the port's int8 product
    accumulates in int32 and has no such cap."""
    n_rows = max(_round_up(n_users, 128), 128)
    working = (n_rows * n_items_p + n_rows * item_tile) * _REF_BYTES_PER_CELL \
        + n_items_p * item_tile * 4
    return working <= _TILED_P_BYTES


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


class _ResidentPrimary:
    """The densified primary, item-major [I_p rows, users], built once per
    training run and shared by every tiled event type."""

    def __init__(self, p_user, p_item, n_users: int, n_items_p: int,
                 device: torch.device):
        self.n_items_p = n_items_p
        self.n_rows = max(_round_up(n_users, 128), 128)   # users, padded
        u = torch.as_tensor(np.asarray(p_user, np.int64), device=device)
        i = torch.as_tensor(np.asarray(p_item, np.int64), device=device)
        self.pt = _densify(i, u, _item_rows(n_items_p), self.n_rows)
        self.rc = _marginal(self.pt[:n_items_p])


def _cco_indicators_resident(
    primary: _ResidentPrimary, a_user, a_item, n_items_t: int,
    n_total_users: int, top_k: int, llr_threshold: float, item_tile: int,
    exclude_self: bool, self_pair: bool,
) -> Tuple[np.ndarray, np.ndarray]:
    """Item tiles of the other event type against the resident primary:
    densify the tile (a slice of P itself for the self-indicator), one
    count product, K2, the diagonal mask, and K3's top-b of the tile merged
    into the carry in one launch.  The carry is ``block_width(top_k)``
    wide."""
    pt, i_p = primary.pt, primary.n_items_p
    device = pt.device
    tile = min(item_tile, max(n_items_t, 1))
    n_tiles = math.ceil(n_items_t / tile)
    if not self_pair:
        a = _StagedCOO(a_user, a_item, device, "item", tile, n_tiles)
    b = block_width(top_k)
    best_s = torch.full((i_p, b), float("-inf"), dtype=torch.float32, device=device)
    best_i = torch.zeros((i_p, b), dtype=torch.int32, device=device)
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
        if exclude_self:   # the items t0 + j of this tile's rows t0 + j
            scores.diagonal(offset=-t0).fill_(float("-inf"))
        # K3 with the carry merged in: merge_desc(best, top-b of the tile)
        best_s, best_i = tile_topk_desc(scores, b, id_offset=t0, carry=(best_s, best_i))
        # free this tile's [I_p, tile] counts and scores before the next
        # product allocates its own: one of each is live, not two
        del counts, scores
    return _finalize_topk(best_s, best_i, n_items_t, top_k)


# ---------------------------------------------------------------------------
# the training entry
# ---------------------------------------------------------------------------


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
    identity: it reuses the densified primary).  Returns name →
    ``(scores [I_p, top_k] f32, ids [I_p, top_k] int32)``, -inf / -1 where a
    row has fewer significant correlators.  ``per_type`` overrides
    ``(top_k, llr_threshold)`` per event type.  ``user_block`` is accepted
    only so the signature matches the reference's, where it sizes the
    chunked tiled strategy; the port does not have that strategy yet and
    ignores it.
    """
    del user_block
    if mesh is not None:
        raise NotImplementedError(f"CCO over a device mesh is not ported yet ({ROADMAP_MESH})")
    dev = resolve_device(device)
    per_type = per_type or {}
    _check_ids(p_user, p_item, n_users, n_items_p, "primary")
    dense_names = [nm for nm, _, _, nt in others if _dense_path_ok(n_items_p, nt)]
    runner: Optional[_DenseRunner] = None
    resident: Optional[_ResidentPrimary] = None
    pending: List[Tuple[str, object]] = []
    results: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for name, au, ai, n_items_t in others:
        _check_ids(au, ai, n_users, max(n_items_t, 1), name)
        excl = name == exclude_self_for
        t_k, t_llr = per_type.get(name, (top_k, llr_threshold))
        self_pair = au is p_user and ai is p_item
        if name in dense_names:
            if runner is None:
                it_pad_max = max(max(_round_up(nt, 128), 128)
                                 for nm, _, _, nt in others if nm in dense_names)
                runner = _DenseRunner(p_user, p_item, n_users, n_items_p,
                                      max(it_pad_max, n_items_p), dev)
            pending.append((name, runner.dispatch(au, ai, n_items_t, t_k, t_llr,
                                                  excl, self_pair=self_pair)))
        elif _resident_p_ok(n_users, n_items_p, min(item_tile, max(n_items_t, 1))):
            if resident is None:
                resident = _ResidentPrimary(p_user, p_item, n_users, n_items_p, dev)
            results[name] = _cco_indicators_resident(
                resident, au, ai, n_items_t, n_users, t_k, t_llr, item_tile,
                excl, self_pair)
        else:
            raise NotImplementedError(
                f"event type {name!r}: the densified primary ({n_users} users x "
                f"{n_items_p} items) exceeds the P-resident budget, and the "
                f"chunked tiled strategy is not ported yet ({ROADMAP_CCO})")
    for name, d in pending:
        results[name] = _DenseRunner.collect(d)
    return {name: results[name] for name, _, _, _ in others}
