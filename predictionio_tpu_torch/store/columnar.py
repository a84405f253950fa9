"""Columnar event batches, id dictionaries and CSR row lookups.

Counterpart of ``predictionio_tpu/store/columnar.py`` (``IdDict``,
``CSRLookup`` and ``EventBatch``'s ``from_events``/``select_events``/
``subset``).  The port keeps its own copies: it imports nothing of the JAX
package.  The JAX ``IdDict``'s lazy blob plumbing, the per-key property
columns (``PropColumn``), ``BatchMerger``, ``EventIdColumn`` and the
snapshot writers serve its native scanner and localfs snapshots, which the
port does not have yet (ROADMAP.md, queue A, 'Storage and event store:
localfs'), so this ``IdDict`` is the plain list + dict form with the same
state format (``to_state``/``from_state``) and an ``EventBatch`` carries
no property columns.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from predictionio_tpu_torch.events.event import Event


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
class EventBatch:
    """Struct-of-arrays block of events.

    Columns are parallel arrays of length N; string columns are dictionary
    encoded.  ``target_ids`` rows with no target are -1.
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

    def subset(self, mask: np.ndarray) -> "EventBatch":
        """Row-filter by boolean mask; dictionaries are shared."""
        return EventBatch(
            self.event_codes[mask], self.entity_type_codes[mask], self.entity_ids[mask],
            self.target_ids[mask], self.times_us[mask], self.ratings[mask],
            self.event_dict, self.entity_type_dict, self.entity_dict, self.target_dict,
        )

    def select_events(self, names: Sequence[str]) -> "EventBatch":
        """Filter to rows whose event verb is in ``names`` (dicts shared)."""
        codes = [self.event_dict.id(n) for n in names]
        codes = [c for c in codes if c is not None]
        mask = np.isin(self.event_codes, np.asarray(codes, np.int32))
        return self.subset(mask)
