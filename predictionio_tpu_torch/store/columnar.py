"""Id dictionaries and CSR row lookups for serving.

Counterpart of ``predictionio_tpu/store/columnar.py`` (``IdDict`` and
``CSRLookup`` only; ``EventBatch`` comes with the training slice).  The
port keeps its own copies: it imports nothing of the JAX package.  The
JAX ``IdDict``'s lazy blob plumbing serves its native scanner, which the
port does not have yet, so this copy is the plain list + dict form with
the same state format (``to_state``/``from_state``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


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
