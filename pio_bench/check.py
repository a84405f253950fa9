"""The comparison that decides ``correct``.

What a step of the program returned (``Output``) is held against the plain
reference (``reference.py``) built from the same generated events.  The
numbers, each the worst over the window's steps:

- ``score_err``: over the sampled rows, the largest gap between a score the
  program returned and the reference's score of the same item, as a share
  of the row's best reference score (at least 1);
- ``rank_gap``: over the sampled rows, the largest amount by which the
  reference's score of the program's j-th item lies below the reference's
  j-th best score, on the same scale: 0 where the program's items are a
  top-k of the reference's, whichever of tied items it took;
- ``entries_mismatch``: rows at fault: over every row, an id out of range,
  valid entries that are not a prefix, scores that rise, an id twice, or a
  row empty where items co-occur with it (or the reverse); over the sampled
  rows, a different number of entries than the reference's or an item with
  no reference score;
- ``popularity_err``: the largest gap between an item's backfill
  popularity and the reference's count of its events in the window;
- ``seen_mismatch``: users whose seen items differ from the reference's.

Each has a limit of its own in ``limits/<workload>.json``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from pio_bench import gen, reference


@dataclasses.dataclass
class Output:
    """What one step of the program returned, on the host."""

    tables: Dict[str, Tuple[np.ndarray, np.ndarray]]   # type → (scores, ids) [I_p, k]
    popularity: Optional[np.ndarray] = None             # [I_p]
    seen: Optional[Tuple[np.ndarray, np.ndarray]] = None   # (indptr, items)


class Reference:
    """The reference's answers for one cell and seed: sampled indicator
    rows of every event type, which rows are nonempty, and (where the
    traffic checks them) popularity and the seen lookup."""

    def __init__(self, cfg: Dict, traffic: Dict, events: Dict[str, gen.Events],
                 seed: int, dtype=torch.float64):
        chk = traffic["check"]
        users, self.n_items = int(cfg["users"]), int(cfg["items"])
        self.top_k = int(cfg["top_k"])
        threshold = float(cfg.get("min_llr", 0.0))
        names = [t["name"] for t in cfg["event_types"]]
        pairs = {n: reference.Pairs(events[n].user, events[n].item, users, self.n_items)
                 for n in names}
        p = pairs[names[0]]
        self.rows = reference.sample_rows(p, gen.rng(seed, 1000), int(chk["heavy_rows"]),
                                          int(chk["rows"]), int(chk["any_rows"]))
        self.indicators = {
            n: reference.indicator_rows(p, pairs[n], self.rows, users, self.top_k,
                                        threshold, n == names[0], dtype)
            for n in names}
        self.nonempty = ({n: reference.nonempty_rows(p, pairs[n], n == names[0])
                          for n in names} if threshold <= 0 else None)
        self.popularity = None
        if chk.get("popularity"):
            duration = float(cfg["backfill_duration_s"])
            first = events[names[0]]
            self.popularity = reference.popularity(first.item, first.time, self.n_items,
                                                   duration)
        self.seen = reference.seen_csr(p) if chk.get("seen") else None
        self.n_users = users


def _row_numbers(ref_row: reference.RefRow, ids: np.ndarray,
                 scores: np.ndarray) -> Tuple[float, float, int]:
    """(score_err, rank_gap, at fault 0/1) of one row's valid entries."""
    scale = max(float(ref_row.top_scores[0]) if len(ref_row.top_scores) else 0.0, 1.0)
    refs = ref_row.score_of(ids.astype(np.int64))
    known = np.isfinite(refs)
    fault = int(len(ids) != len(ref_row.top_ids) or not known.all())
    err = float(np.max(np.abs(scores[known] - refs[known]), initial=0.0)) / scale
    m = min(len(ids), len(ref_row.top_scores))
    gap_rows = known[:m]
    gap = float(np.max(ref_row.top_scores[:m][gap_rows] - refs[:m][gap_rows],
                       initial=0.0)) / scale
    return err, max(gap, 0.0), fault


def compare_rows(ref_rows: Dict[int, reference.RefRow],
                 got: Iterable[Tuple[int, np.ndarray, np.ndarray]]) -> Dict[str, float]:
    """score_err, rank_gap and the rows at fault of (row, ids, scores)
    triples, each holding a row's valid entries in the order returned."""
    out = {"score_err": 0.0, "rank_gap": 0.0, "entries_mismatch": 0}
    for r, ids, scores in got:
        err, gap, fault = _row_numbers(ref_rows[r], ids, np.asarray(scores, np.float64))
        out["score_err"] = max(out["score_err"], err)
        out["rank_gap"] = max(out["rank_gap"], gap)
        out["entries_mismatch"] += fault
    return out


def _bad_rows(scores: np.ndarray, ids: np.ndarray, n_items_t: int,
              nonempty: Optional[np.ndarray]) -> np.ndarray:
    """bool [rows]: rows whose table breaks a rule every answer keeps."""
    valid = ids >= 0
    bad = ((ids >= n_items_t) | (ids < -1)).any(1)
    bad |= (valid[:, 1:] & ~valid[:, :-1]).any(1)
    sv = np.where(valid, scores.astype(np.float64), -np.inf)
    bad |= (valid[:, 1:] & (sv[:, 1:] > sv[:, :-1])).any(1)
    tagged = np.where(valid, ids.astype(np.int64), -1 - np.arange(ids.shape[1]))
    tagged.sort(axis=1)
    bad |= (tagged[:, 1:] == tagged[:, :-1]).any(1)
    if nonempty is not None:
        bad |= valid[:, 0] != nonempty
    return bad


def _seen_mismatch(ref: Reference, seen: Tuple[np.ndarray, np.ndarray]) -> int:
    indptr, items = (np.asarray(a, np.int64) for a in seen)
    if len(indptr) != ref.n_users + 1 or indptr[-1] != len(items):
        return ref.n_users
    rip, ritems = ref.seen
    if np.array_equal(indptr, rip) and np.array_equal(items, ritems):
        return 0
    users = np.repeat(np.arange(ref.n_users, dtype=np.int64), np.diff(indptr))
    key = users * ref.n_items + items
    unsorted = users[1:][key[1:] <= key[:-1]]
    rkey = np.repeat(np.arange(ref.n_users, dtype=np.int64), np.diff(rip)) * ref.n_items + ritems
    differ = np.setxor1d(key, rkey) // ref.n_items
    return len(np.union1d(differ, unsorted))


def compare(ref: Reference, out: Output) -> Dict[str, float]:
    """The numbers of one step's output."""
    nums: Dict[str, float] = {"score_err": 0.0, "rank_gap": 0.0, "entries_mismatch": 0}
    for name, ref_rows in ref.indicators.items():
        if name not in out.tables:
            nums["entries_mismatch"] += ref.n_items
            continue
        scores, ids = (np.asarray(a) for a in out.tables[name])
        if ids.shape != (ref.n_items, ref.top_k) or scores.shape != ids.shape:
            nums["entries_mismatch"] += ref.n_items
            continue
        nonempty = ref.nonempty[name] if ref.nonempty is not None else None
        nums["entries_mismatch"] += int(_bad_rows(scores, ids, ref.n_items, nonempty).sum())
        valid = ids >= 0
        rows = compare_rows(ref_rows, ((r, ids[r][valid[r]], scores[r][valid[r]])
                                       for r in ref.rows))
        nums["score_err"] = max(nums["score_err"], rows["score_err"])
        nums["rank_gap"] = max(nums["rank_gap"], rows["rank_gap"])
        nums["entries_mismatch"] += rows["entries_mismatch"]
    if ref.popularity is not None:
        pop = out.popularity
        nums["popularity_err"] = (float(np.max(np.abs(np.asarray(pop, np.float64)
                                                      - ref.popularity)))
                                  if pop is not None and len(pop) == len(ref.popularity)
                                  else float("inf"))
    if ref.seen is not None:
        nums["seen_mismatch"] = (_seen_mismatch(ref, out.seen) if out.seen is not None
                                 else ref.n_users)
    return nums


def worst(per_step: Iterable[Dict[str, float]]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for nums in per_step:
        for k, v in nums.items():
            out[k] = max(out.get(k, v), v)
    return out


def judge(nums: Dict[str, float], limits: Dict[str, Dict]) -> bool:
    """True when every number the limits name is there and within its
    limit (a missing or non-finite number fails)."""
    for name, lim in limits.items():
        v = nums.get(name)
        if v is None or not np.isfinite(v) or v > float(lim["limit"]):
            return False
    return True
