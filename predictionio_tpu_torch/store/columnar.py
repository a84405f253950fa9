"""Columnar event batches, id dictionaries and CSR row lookups.

Counterpart of ``predictionio_tpu/store/columnar.py``: ``IdDict``,
``CSRLookup``, the per-key property columns of the native scan
(``PropColumn``), ``EventBatch`` (``from_events``, ``concat``, ``subset``,
``select_events``) and ``fold_properties``.  The port keeps its own
copies: it imports nothing of the JAX package.  The JAX ``IdDict``'s lazy
blob plumbing, ``BatchMerger``, ``EventIdColumn`` and the snapshot
writers serve its columnar snapshots (ROADMAP.md, queue A, 'Columnar
snapshots and the staged cache'), so this ``IdDict`` is the plain list +
dict form with the same state format (``to_state``/``from_state``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import datetime as _dt
import json

import numpy as np

from predictionio_tpu_torch.events.event import (
    DELETE_EVENT,
    SET_EVENT,
    SPECIAL_EVENTS,
    UNSET_EVENT,
    Event,
    PropertyMap,
)


class IdDict:
    """Bidirectional string ↔ dense-int dictionary.

    Maps external ids ("u123", item SKUs) to dense int32 codes suitable
    for device-side gathers.  The string→id index is built lazily, so a
    model loaded from its state pays the dictcomp only at first lookup.
    """

    __slots__ = ("_to_id", "_to_str")

    def __init__(self, items: Optional[Sequence[str]] = None):
        self._to_id: Optional[Dict[str, int]] = {}
        self._to_str: List[str] = []
        for s in items or ():
            self.add(s)

    def _index(self) -> Dict[str, int]:
        if self._to_id is None:
            self._to_id = {s: i for i, s in enumerate(self._to_str)}
        return self._to_id

    def add(self, s: str) -> int:
        to_id = self._index()
        i = to_id.get(s)
        if i is None:
            i = len(self._to_str)
            to_id[s] = i
            self._to_str.append(s)
        return i

    def id(self, s: str) -> Optional[int]:
        return self._index().get(s)

    def str(self, i: int) -> str:
        return self._to_str[i]

    def __len__(self) -> int:
        return len(self._to_str)

    def strings(self) -> List[str]:
        return list(self._to_str)

    def lookup_many(self, values: Sequence[str]) -> np.ndarray:
        """int32 ids of ``values``, -1 for unknown strings."""
        get = self._index().get
        return np.fromiter([get(v, -1) for v in values], dtype=np.int32,
                           count=len(values))

    def to_state(self) -> List[str]:
        return self._to_str

    @classmethod
    def from_state(cls, strings: Sequence[str]) -> "IdDict":
        d = cls.__new__(cls)
        d._to_str = list(strings)
        d._to_id = None
        return d


class CSRLookup:
    """Row → sorted unique int values, stored as two flat arrays
    (``indptr`` int64 [rows + 1], ``values`` int32 [nnz])."""

    __slots__ = ("indptr", "values")

    def __init__(self, indptr: np.ndarray, values: np.ndarray):
        self.indptr = np.asarray(indptr, np.int64)
        self.values = np.asarray(values, np.int32)

    @classmethod
    def from_pairs(cls, rows: np.ndarray, values: np.ndarray, n_rows: int) -> "CSRLookup":
        rows = np.asarray(rows, np.int64)
        values = np.asarray(values, np.int64)
        if len(rows):
            n_vals = int(values.max()) + 1
            flat = np.sort(rows * n_vals + values)
            flat = flat[np.concatenate(([True], flat[1:] != flat[:-1]))]
            rows, values = flat // n_vals, flat % n_vals
        counts = (np.bincount(rows, minlength=n_rows) if len(rows)
                  else np.zeros(n_rows, np.int64))
        indptr = np.zeros(n_rows + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        return cls(indptr, values.astype(np.int32))

    @classmethod
    def empty(cls, n_rows: int = 0) -> "CSRLookup":
        return cls(np.zeros(n_rows + 1, np.int64), np.empty(0, np.int32))

    def row(self, r: int) -> np.ndarray:
        if r < 0 or r >= len(self):
            return np.empty(0, np.int32)
        return self.values[self.indptr[r]:self.indptr[r + 1]]

    def __len__(self) -> int:
        return len(self.indptr) - 1

    @property
    def nnz(self) -> int:
        return len(self.values)

    def to_state(self) -> Dict[str, np.ndarray]:
        return {"indptr": self.indptr, "values": self.values}

    @classmethod
    def from_state(cls, state: Dict[str, np.ndarray]) -> "CSRLookup":
        return cls(state["indptr"], state["values"])


@dataclass
class PropColumn:
    """Sparse column of one property key (the native scan's discovered
    schema).  Entry j belongs to batch row ``rows[j]``; ``kind[j]`` is 0
    number, 1 bool, 2 string, 3 list of strings, 4 null, 5 nested object
    (its raw JSON); numbers and bools live in ``num``, strings as codes of
    ``dict`` in ``codes[str_offs[j]:str_offs[j + 1]]``."""

    rows: np.ndarray      # int64 [n], ascending
    kind: np.ndarray      # int8 [n]
    num: np.ndarray       # f64 [n]
    str_offs: np.ndarray  # int64 [n + 1]
    codes: np.ndarray     # int32 [total strings]
    dict: IdDict

    def __len__(self) -> int:
        return int(self.rows.shape[0])

    def value_at(self, j: int):
        k = int(self.kind[j])
        if k == 0:
            v = float(self.num[j])
            return int(v) if v.is_integer() else v
        if k == 1:
            return bool(self.num[j])
        if k == 4:
            return None
        s, e = int(self.str_offs[j]), int(self.str_offs[j + 1])
        strs = [self.dict.str(int(c)) for c in self.codes[s:e]]
        if k == 5:
            try:
                return json.loads(strs[0]) if strs else None
            except ValueError:
                return None
        return strs if k == 3 else (strs[0] if strs else "")

    def remap_rows(self, new_row_of: np.ndarray) -> "PropColumn":
        """The column of a row subset: ``new_row_of[old_row]`` is the new
        row, or -1 where the row is dropped."""
        nr = new_row_of[self.rows]
        keep = nr >= 0
        if keep.all():
            return PropColumn(nr, self.kind, self.num, self.str_offs, self.codes, self.dict)
        idx = np.flatnonzero(keep)
        lens = np.diff(self.str_offs)[idx]
        offs = np.zeros(len(idx) + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        total = int(offs[-1])
        if total == 0:
            codes = np.empty(0, np.int32)
        else:
            # ragged gather: each kept entry's start plus its inner offset
            gather = np.arange(total, dtype=np.int64) + np.repeat(
                self.str_offs[idx] - offs[:-1], lens)
            codes = self.codes[gather]
        return PropColumn(nr[keep], self.kind[keep], self.num[keep], offs,
                          codes.astype(np.int32), self.dict)


def _code_map(target: IdDict, part: IdDict) -> Optional[np.ndarray]:
    """Add ``part``'s strings to ``target`` in order; the int32 code of
    each in ``target``, or None when ``part`` is ``target``."""
    if part is target:
        return None
    return np.fromiter((target.add(x) for x in part.strings()), np.int32, count=len(part))


def _recode(codes: np.ndarray, code_map: Optional[np.ndarray]) -> np.ndarray:
    """``codes`` through ``code_map``, -1 (no target) kept."""
    if code_map is None or not len(codes):
        return codes
    return np.where(codes >= 0, code_map[np.maximum(codes, 0)], -1).astype(np.int32)


@dataclass
class EventBatch:
    """Struct-of-arrays block of events.

    Columns are parallel arrays of length N; string columns are dictionary
    encoded.  ``target_ids`` rows with no target are -1.  ``prop_columns``
    (the native scan's) holds the full property maps as sparse per-key
    columns; None means only the ``ratings`` column is there.
    """

    event_codes: np.ndarray      # int32 [N] → event_dict
    entity_type_codes: np.ndarray  # int32 [N] → entity_type_dict
    entity_ids: np.ndarray       # int32 [N] → entity_dict
    target_ids: np.ndarray       # int32 [N] → target_dict (or -1)
    times_us: np.ndarray         # int64 [N] epoch microseconds
    ratings: np.ndarray          # float32 [N] numeric 'rating' property (NaN if absent)
    event_dict: IdDict
    entity_type_dict: IdDict
    entity_dict: IdDict
    target_dict: IdDict
    prop_columns: Optional[Dict[str, PropColumn]] = None

    def __len__(self) -> int:
        return int(self.event_codes.shape[0])

    @classmethod
    def from_events(
        cls,
        events: Sequence[Event],
        entity_dict: Optional[IdDict] = None,
        target_dict: Optional[IdDict] = None,
        event_dict: Optional[IdDict] = None,
    ) -> "EventBatch":
        n = len(events)
        event_dict = event_dict if event_dict is not None else IdDict()
        entity_type_dict = IdDict()
        entity_dict = entity_dict if entity_dict is not None else IdDict()
        target_dict = target_dict if target_dict is not None else IdDict()
        ev = np.empty(n, np.int32)
        et = np.empty(n, np.int32)
        ei = np.empty(n, np.int32)
        ti = np.full(n, -1, np.int32)
        ts = np.empty(n, np.int64)
        rt = np.full(n, np.nan, np.float32)
        for k, e in enumerate(events):
            ev[k] = event_dict.add(e.event)
            et[k] = entity_type_dict.add(e.entity_type)
            ei[k] = entity_dict.add(e.entity_id)
            if e.target_entity_id is not None:
                ti[k] = target_dict.add(e.target_entity_id)
            ts[k] = int(e.event_time.timestamp() * 1e6)
            r = e.properties.get("rating")
            if isinstance(r, (int, float)):
                rt[k] = float(r)
        return cls(ev, et, ei, ti, ts, rt, event_dict, entity_type_dict, entity_dict, target_dict)

    _DICTS = ("event_dict", "entity_type_dict", "entity_dict", "target_dict")
    _CODES = ("event_codes", "entity_type_codes", "entity_ids", "target_ids")

    @classmethod
    def concat(cls, batches: Sequence["EventBatch"]) -> "EventBatch":
        """Rows of ``batches`` in order.  Batches that share their four
        dictionaries (the same objects) concatenate their columns as they
        are; otherwise every batch's codes are re-coded into fresh
        dictionaries, strings in first appearance over the batches' own
        dictionaries in order (the JAX package's ``BatchMerger`` order).
        Property columns merge when every batch has them (see
        ``_concat_props``)."""
        if len(batches) == 1:
            return batches[0]
        b0 = batches[0]
        if all(getattr(b, d) is getattr(b0, d) for b in batches[1:] for d in cls._DICTS):
            dicts = [getattr(b0, d) for d in cls._DICTS]
            maps = [[None] * 4 for _ in batches]
        else:
            dicts = [IdDict() for _ in cls._DICTS]
            maps = [[_code_map(t, getattr(b, d)) for t, d in zip(dicts, cls._DICTS)]
                    for b in batches]
        codes = [np.concatenate([_recode(getattr(b, c), m[k]) for b, m in zip(batches, maps)])
                 for k, c in enumerate(cls._CODES)]
        return cls(*codes,
                   np.concatenate([b.times_us for b in batches]),
                   np.concatenate([b.ratings for b in batches]),
                   *dicts, prop_columns=cls._concat_props(batches))

    @staticmethod
    def _concat_props(batches: Sequence["EventBatch"]) -> Optional[Dict[str, PropColumn]]:
        """Row-shifted merge of the per-key property columns, or None when
        some batch has none.  A key whose string dictionary is the same
        object in every batch merges its codes as they are; otherwise they
        are re-coded into one merged dictionary."""
        if any(b.prop_columns is None for b in batches):
            return None
        offsets = np.cumsum([0] + [len(b) for b in batches])
        keys: List[str] = []
        for b in batches:
            keys.extend(k for k in b.prop_columns if k not in keys)
        out: Dict[str, PropColumn] = {}
        for key in keys:
            entries = [(offsets[i], b.prop_columns[key]) for i, b in enumerate(batches)
                       if key in b.prop_columns]
            d = entries[0][1].dict
            if any(c.dict is not d for _, c in entries[1:]):
                d = IdDict()
                code_cols = [_recode(np.asarray(c.codes, np.int32), _code_map(d, c.dict))
                             for _, c in entries]
            else:
                code_cols = [np.asarray(c.codes, np.int32) for _, c in entries]
            code_base = np.cumsum([0] + [len(c.codes) for _, c in entries])
            str_offs = np.concatenate([np.zeros(1, np.int64)] + [
                c.str_offs[1:] + code_base[i] for i, (_, c) in enumerate(entries)])
            out[key] = PropColumn(
                np.concatenate([c.rows + off for off, c in entries]),
                np.concatenate([c.kind for _, c in entries]),
                np.concatenate([c.num for _, c in entries]),
                str_offs,
                np.concatenate(code_cols) if code_base[-1] else np.empty(0, np.int32),
                d)
        return out

    def subset(self, mask: np.ndarray) -> "EventBatch":
        """Row-filter by boolean mask; dictionaries are shared."""
        props = None
        if self.prop_columns is not None:
            new_row_of = np.full(len(self), -1, np.int64)
            new_row_of[mask] = np.arange(int(mask.sum()), dtype=np.int64)
            props = {k: c.remap_rows(new_row_of) for k, c in self.prop_columns.items()}
        return EventBatch(
            self.event_codes[mask], self.entity_type_codes[mask], self.entity_ids[mask],
            self.target_ids[mask], self.times_us[mask], self.ratings[mask],
            self.event_dict, self.entity_type_dict, self.entity_dict, self.target_dict,
            prop_columns=props,
        )

    def select_events(self, names: Sequence[str]) -> "EventBatch":
        """Filter to rows whose event verb is in ``names`` (dicts shared)."""
        codes = [self.event_dict.id(n) for n in names]
        codes = [c for c in codes if c is not None]
        mask = np.isin(self.event_codes, np.asarray(codes, np.int32))
        return self.subset(mask)


def fold_properties(batch: EventBatch, entity_type: Optional[str] = None
                    ) -> Dict[str, PropertyMap]:
    """``$set``/``$unset``/``$delete`` folded from a native-scanned batch's
    columns: the columnar ``events.event.aggregate_properties`` (reference:
    LEventAggregator.aggregateProperties).  Events apply in (event time,
    row) order; ``$set`` merges keys, ``$unset`` removes the named keys,
    ``$delete`` drops the snapshot.  Only the special events' rows are
    touched in Python."""
    if batch.prop_columns is None:
        raise ValueError("fold_properties requires a batch with prop_columns")
    special = [batch.event_dict.id(n) for n in SPECIAL_EVENTS]
    sel = np.isin(batch.event_codes, np.asarray([c for c in special if c is not None], np.int32))
    if entity_type is not None:
        et = batch.entity_type_dict.id(entity_type)
        sel &= batch.entity_type_codes == (et if et is not None else -2)
    rows = np.flatnonzero(sel)
    if not len(rows):
        return {}
    rows = rows[np.lexsort((rows, batch.times_us[rows]))]
    # each selected row's property entries, gathered column by column
    # (col.rows ascends, so searchsorted finds a row's entry)
    row_props: Dict[int, list] = {int(r): [] for r in rows}
    for key, col in batch.prop_columns.items():
        if len(col) == 0:   # the key exists only on filtered-out rows
            continue
        pos = np.searchsorted(col.rows, rows)
        hit = (pos < len(col)) & (col.rows[np.minimum(pos, len(col) - 1)] == rows)
        for r, j in zip(rows[hit], pos[hit]):
            row_props[int(r)].append((key, col, int(j)))
    set_c = batch.event_dict.id(SET_EVENT)
    unset_c = batch.event_dict.id(UNSET_EVENT)
    del_c = batch.event_dict.id(DELETE_EVENT)
    snap: Dict[str, PropertyMap] = {}
    for r in rows:
        code = batch.event_codes[r]
        eid = batch.entity_dict.str(int(batch.entity_ids[r]))
        if code == del_c:
            snap.pop(eid, None)
            continue
        cur = snap.get(eid)
        when = _dt.datetime.fromtimestamp(batch.times_us[r] / 1e6, tz=_dt.timezone.utc)
        if code == set_c:
            if cur is None:
                cur = snap[eid] = PropertyMap({}, first_updated=when, last_updated=when)
            for key, col, j in row_props[int(r)]:
                cur[key] = col.value_at(j)
            cur.last_updated = max(cur.last_updated, when)
        elif code == unset_c:
            if cur is None:
                continue
            for key, _col, _j in row_props[int(r)]:
                cur.pop(key, None)
            cur.last_updated = max(cur.last_updated, when)
    return snap
