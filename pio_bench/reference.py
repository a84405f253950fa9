"""The plain reference of a CCO train: NumPy, with the G² chain in torch
on the host at a chosen dtype (float64 for the reference, bfloat16 for the
control).  It reads the generated events only and imports nothing of the
program.

For a sample of primary items (rows) and each event type t, it counts
exactly, from deduplicated (user, item) pairs, how many users hold both the
row's item and each item of t; scores every nonzero cell with Dunning's G²
(Mahout's ``LogLikelihood.logLikelihoodRatio``) against the row's and the
column's distinct users and the population N; masks the row's own item
for the primary's self-indicator and scores under the threshold; and ranks
the rest by (score desc, item asc).  It also gives, for every row, whether
any item co-occurs with it, each item's popularity and each user's
primary items.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

#: cross-join pairs expanded at once, and count cells held at once
_EXPAND = 1 << 25
_CELLS = 1 << 26


class Pairs:
    """Deduplicated (user, item) pairs of one event type, sorted by user,
    with each user's span and each item's distinct users."""

    def __init__(self, user: np.ndarray, item: np.ndarray, n_users: int, n_items: int):
        key = np.sort(user.astype(np.int64) * n_items + item)
        key = key[np.concatenate([[True], key[1:] != key[:-1]])]
        self.user = (key // n_items).astype(np.int32)
        self.item = (key % n_items).astype(np.int32)
        self.n_users, self.n_items = n_users, n_items
        self.deg = np.bincount(self.user, minlength=n_users)      # distinct items a user
        self.user_start = np.concatenate([[0], np.cumsum(self.deg)])
        self.col = np.bincount(self.item, minlength=n_items)      # distinct users an item

    def users_of(self, rows: Sequence[int]) -> Dict[int, np.ndarray]:
        """The users of each item of ``rows``, ascending, in one pass."""
        sel = np.isin(self.item, np.asarray(rows))
        items, users = self.item[sel], self.user[sel]
        order = np.argsort(items, kind="stable")
        items, users = items[order], users[order]
        bounds = np.searchsorted(items, np.asarray(rows), side="left")
        ends = np.searchsorted(items, np.asarray(rows), side="right")
        return {int(r): users[b:e] for r, b, e in zip(rows, bounds, ends)}


def _expand(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenated ranges [starts[j], starts[j] + lens[j])."""
    total = int(lens.sum())
    offsets = np.repeat(starts - (np.cumsum(lens) - lens), lens)
    return offsets + np.arange(total, dtype=np.int64)


def count_rows(p: Pairs, a: Pairs, rows: Sequence[int]) -> List[np.ndarray]:
    """Exact count rows: for each row item r of p, an int64 [a.n_items]
    vector of users holding r and each item of a."""
    users_of = p.users_of(rows)
    out: List[np.ndarray] = []
    chunk: List[int] = []
    load = 0

    def flush():
        if not chunk:
            return
        lens = np.array([len(users_of[r]) for r in chunk], np.int64)
        us = np.concatenate([users_of[r] for r in chunk])
        local = np.repeat(np.arange(len(chunk), dtype=np.int64), lens)
        starts = a.user_start[us]
        n = a.user_start[us + 1] - starts
        items = a.item[_expand(starts, n)]
        key = np.repeat(local, n) * a.n_items + items
        counts = np.bincount(key, minlength=len(chunk) * a.n_items)
        out.extend(counts.reshape(len(chunk), a.n_items))
        chunk.clear()

    for r in rows:
        cost = int(a.deg[users_of[int(r)]].sum())
        if chunk and (load + cost > _EXPAND or (len(chunk) + 1) * a.n_items > _CELLS):
            flush()
            load = 0
        chunk.append(int(r))
        load += cost
    flush()
    return out


def g2(k11, row, col, n_total: float, dtype=torch.float64) -> torch.Tensor:
    """Dunning's G² = 2 Σ k·ln(k·N / (r·c)) over the 2×2 table of each
    cell, computed in ``dtype``; negative round-off is clamped to 0."""
    k11, row, col = (torch.as_tensor(np.asarray(x, np.float64)).to(dtype)
                     for x in (k11, row, col))
    n = torch.tensor(float(n_total), dtype=torch.float64).to(dtype)
    k12, k21 = row - k11, col - k11
    k22 = n - (row + col - k11)
    r2, c2 = n - row, n - col

    def term(k, r, c):
        safe = torch.where(k > 0, k, torch.ones_like(k))
        return torch.where(k > 0, k * torch.log(safe * n / (r * c)), torch.zeros_like(k))

    out = 2 * (term(k11, row, col) + term(k12, row, c2)
               + term(k21, r2, col) + term(k22, r2, c2))
    return torch.clamp_min(out, 0)


@dataclasses.dataclass
class RefRow:
    """One row's reference: every scored item (ascending) with its score,
    and the top-k items and scores in (score desc, item asc) order."""

    cols: np.ndarray       # int64, items with a score (count > 0, kept)
    scores: np.ndarray     # float64
    top_ids: np.ndarray    # int64 [<= k]
    top_scores: np.ndarray

    def score_of(self, ids: np.ndarray) -> np.ndarray:
        """Reference scores of ``ids``; -inf where the reference has none."""
        if not len(self.cols):
            return np.full(len(ids), -np.inf)
        pos = np.clip(np.searchsorted(self.cols, ids), 0, len(self.cols) - 1)
        return np.where(self.cols[pos] == ids, self.scores[pos], -np.inf)


def indicator_rows(p: Pairs, a: Pairs, rows: Sequence[int], n_total: float,
                   top_k: int, threshold: float, exclude_self: bool,
                   dtype=torch.float64, counts: Sequence[np.ndarray] = None,
                   ) -> Dict[int, RefRow]:
    """The reference's indicator rows of ``rows`` against ``a``, scored in
    ``dtype``; ``counts`` are ``count_rows(p, a, rows)`` where the caller
    has them."""
    out: Dict[int, RefRow] = {}
    if counts is None:
        counts = count_rows(p, a, rows)
    for r, row_counts in zip(rows, counts):
        cols = np.flatnonzero(row_counts)
        if exclude_self:
            cols = cols[cols != r]
        s = g2(row_counts[cols], np.full(len(cols), p.col[r]), a.col[cols],
               n_total, dtype).to(torch.float64).numpy()
        keep = s >= threshold
        cols, s = cols[keep], s[keep]
        order = np.lexsort((cols, -s))[:top_k]
        out[int(r)] = RefRow(cols, s, cols[order], s[order])
    return out


def nonempty_rows(p: Pairs, a: Pairs, self_pair: bool) -> np.ndarray:
    """bool [p.n_items]: whether any item of ``a`` (other than the row's own
    on the self-indicator) co-occurs with each row item of ``p``."""
    need = 2 if self_pair else 1
    return np.bincount(p.item, weights=a.deg[p.user] >= need, minlength=p.n_items) > 0


def popularity(item: np.ndarray, time: np.ndarray, n_items: int,
               duration_s: float) -> np.ndarray:
    """Events an item in the window that ends at the newest event."""
    newest = float(time.max())
    sel = time > newest - duration_s
    return np.bincount(item[sel], minlength=n_items).astype(np.float64)


def seen_csr(p: Pairs) -> tuple:
    """(indptr, items) of every user's distinct primary items, ascending."""
    return p.user_start.astype(np.int64), p.item.astype(np.int64)


def sample_rows(p: Pairs, seed_rng: np.random.Generator, heavy: int, rows: int,
                any_rows: int) -> np.ndarray:
    """Rows the check compares: the ``heavy`` items with the most users,
    ``rows`` drawn among the other items that have a user, and ``any_rows``
    drawn among all items, sorted and unique."""
    order = np.argsort(-p.col, kind="stable")
    top = order[:heavy]
    held = np.setdiff1d(np.flatnonzero(p.col > 0), top)
    drawn = seed_rng.choice(held, min(rows, len(held)), replace=False) if len(held) else []
    anyr = seed_rng.choice(p.n_items, min(any_rows, p.n_items), replace=False)
    return np.unique(np.concatenate([top, drawn, anyr]).astype(np.int64))
