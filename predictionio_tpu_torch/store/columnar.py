"""Columnar event batches, id dictionaries and CSR row lookups.

Counterpart of ``predictionio_tpu/store/columnar.py``: ``IdDict`` (with
its lazy blob form), ``CSRLookup``, the per-key property columns of the
native scan (``PropColumn``), ``EventBatch`` (``from_events``,
``concat``, ``subset``, ``select_events``), ``EventIdColumn``, the PIOCOL01
snapshot container (``write_batch``, ``read_batch``: byte-equal files and
the same reads in both packages), ``fold_properties`` and
``category_masks``.  The port keeps its own copies: it imports nothing of
the JAX package.  The PIOARR01 named-array container of the model plane
(``write_arrays``, ``read_arrays``: byte-equal files in both packages,
read-only mapped views) is here too, and ``BatchMerger``, the k-way merge
of the sharded store's cross-shard reads and of ``EventBatch.concat``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import datetime as _dt
import json
import mmap as _mmap
import os

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
    for device-side gathers.  Lazily materialised, as the JAX package's:
    a dictionary read from a columnar snapshot by the native header parse
    holds its strings as an undecoded UTF-8 blob with int64 offsets
    (``from_blob``) until an accessor needs Python strings, and the
    string→id index is built at the first lookup.
    """

    __slots__ = ("_to_id", "_to_str", "_pending")

    def __init__(self, items: Optional[Sequence[str]] = None):
        self._to_id: Optional[Dict[str, int]] = {}
        self._to_str: List[str] = []
        self._pending: Optional[List[Tuple[bytes, np.ndarray]]] = None
        for s in items or ():
            self.add(s)

    @classmethod
    def from_blob(cls, blob: bytes, offs: np.ndarray) -> "IdDict":
        """The ``len(offs) - 1`` strings packed as ``blob`` + offsets;
        nothing is decoded until an accessor needs it."""
        d = cls.__new__(cls)
        d._to_str = []
        d._pending = [(blob, offs)] if len(offs) > 1 else None
        d._to_id = None if d._pending is not None else {}
        return d

    def _strings(self) -> List[str]:
        """The live string list, any pending blob decoded in: one decode
        and one split of the NUL-joined blob, or a decode a string where a
        string holds a NUL."""
        if self._pending is not None:
            for blob, offs in self._pending:
                joined = _nul_joined(blob, offs)
                if joined is not None:
                    self._to_str.extend(joined.decode("utf-8", "surrogatepass").split("\0"))
                else:
                    o = offs.tolist()
                    self._to_str.extend(blob[o[j]:o[j + 1]].decode("utf-8", "surrogatepass")
                                        for j in range(len(o) - 1))
            self._pending = None
        return self._to_str

    def _index(self) -> Dict[str, int]:
        if self._to_id is None:
            self._to_id = {s: i for i, s in enumerate(self._strings())}
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
        return self._strings()[i]

    def __len__(self) -> int:
        n = len(self._to_str)
        for _blob, offs in self._pending or ():
            n += len(offs) - 1
        return n

    def __contains__(self, s: str) -> bool:
        return s in self._index()

    def strings(self) -> List[str]:
        return list(self._strings())

    def _append_pending(self, blob: bytes, offs: np.ndarray) -> None:
        """Append strings not yet in the dictionary (codes continue from
        its length) as an undecoded blob; the index is rebuilt at the next
        lookup."""
        if len(offs) <= 1:
            return
        if self._pending is None:
            self._pending = []
        self._pending.append((blob, offs))
        self._to_id = None

    def clone(self) -> "IdDict":
        """A copy that grows independently (the copy-on-write step of the
        streaming fold, whose emitted model shares the dictionary): the
        dict and list copy constructors, pending blobs shared (they are
        immutable), nothing decoded."""
        out = IdDict.__new__(IdDict)
        out._to_id = dict(self._to_id) if self._to_id is not None else None
        out._to_str = list(self._to_str)
        out._pending = list(self._pending) if self._pending is not None else None
        return out

    def encode(self, values: Sequence[str]) -> np.ndarray:
        """int32 codes of ``values``, adding the unknown ones in order."""
        get = self._index().get
        add = self.add
        codes = [c if (c := get(v)) is not None else add(v) for v in values]
        return np.fromiter(codes, dtype=np.int32, count=len(codes))

    def lookup_many(self, values: Sequence[str]) -> np.ndarray:
        """int32 ids of ``values``, -1 for unknown strings."""
        get = self._index().get
        return np.fromiter([get(v, -1) for v in values], dtype=np.int32,
                           count=len(values))

    def to_state(self) -> List[str]:
        return self._strings()

    @classmethod
    def from_state(cls, strings: Sequence[str]) -> "IdDict":
        d = cls.__new__(cls)
        d._to_str = list(strings)
        d._to_id = None
        d._pending = None
        return d

    # the JAX package's pickle state: the string list in a 1-tuple
    def __getstate__(self):
        return (list(self._strings()),)

    def __setstate__(self, state) -> None:
        if len(state) == 2 and isinstance(state[1], dict):   # a slots pickle
            state = (state[1]["_to_str"],)
        self._to_str = list(state[0])
        self._to_id = None
        self._pending = None


def _nul_joined(blob: bytes, offs: np.ndarray) -> Optional[bytes]:
    """The ``len(offs) - 1`` strings packed as ``blob`` + offsets, joined
    by NUL bytes in one ``np.insert``, so one ``split("\\0")`` gives them
    all; None when there are none or a string holds a NUL itself."""
    if len(offs) < 2:
        return None
    a, b = int(offs[0]), int(offs[-1])
    part = blob[a:b]
    if b"\0" in part:
        return None
    return np.insert(np.frombuffer(part, np.uint8), np.asarray(offs[1:-1]) - a, 0).tobytes()


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
    def from_sorted_pairs(cls, rows: np.ndarray, values: np.ndarray,
                          n_rows: int) -> "CSRLookup":
        """``from_pairs`` for pairs already sorted by (row, value) and
        deduplicated (the fold state's ``(user << 32 | item)`` key sets):
        no sort, and array-identical to ``from_pairs`` on such input.  The
        order and uniqueness are the caller's contract, not checked."""
        rows = np.asarray(rows, np.int64)
        counts = (np.bincount(rows, minlength=n_rows) if len(rows)
                  else np.zeros(n_rows, np.int64))
        indptr = np.zeros(n_rows + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        return cls(indptr, np.asarray(values, np.int32))

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


def _export_dict_blob(d: IdDict) -> Tuple[bytes, np.ndarray]:
    """(UTF-8 blob, int64 offsets) of every string of ``d``: a dictionary
    still in its one blob (a native snapshot read) hands it back as it is;
    any other is encoded once."""
    if not d._to_str and d._pending is not None and len(d._pending) == 1:
        return d._pending[0]
    strs = d._strings()
    joined = "".join(strs)
    blob = joined.encode("utf-8", "surrogatepass")
    if len(blob) == len(joined):
        lens = [len(x) for x in strs]
    else:
        lens = [len(x.encode("utf-8", "surrogatepass")) for x in strs]
    offs = np.zeros(len(strs) + 1, np.int64)
    if strs:
        np.cumsum(lens, out=offs[1:])
    return blob, offs


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

    @classmethod
    def concat(cls, batches: Sequence["EventBatch"]) -> "EventBatch":
        """Rows of ``batches`` in order, through ``BatchMerger``.  Batches
        that share their four dictionaries (the same objects: the snapshot
        and tail contract) merge into those dictionaries with no re-coding;
        otherwise every batch is re-coded into fresh dictionaries, strings
        in first appearance over the batches' own dictionaries in order.
        Property columns merge when every batch has them; a key whose
        dictionaries differ re-codes into a new one.  No input changes."""
        if len(batches) == 1:
            return batches[0]
        b0 = batches[0]
        shared = all(getattr(b, d) is getattr(b0, d) for b in batches[1:] for d in cls._DICTS)
        merger = BatchMerger(base=b0 if shared else None, grow_base_props=False)
        for b in batches:
            merger.add(b)
        return merger.finish()[0]

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


# ``EventIdColumn.rows_of`` looks ids up in one pass from this many on:
# where the pass costs as much as an ``index_of`` scan an id.  Both grow
# with the column's bytes, so the break-even does not; at 1.3M ids of 32
# hex digits on an 8-core H100 host the pass took 0.426 s and
# ``index_of`` 13.9 ms an id (``profile_torch.py --only store``, step 7).
ROWS_OF_ONE_PASS = 31


class EventIdColumn:
    """Per-row event ids as a flat byte blob + int64 offsets: the
    mmap-able companion of an ``EventBatch`` in a snapshot (for tombstones
    after the build and integrity checks).  Row j is
    ``blob[offs[j]:offs[j + 1]]``."""

    __slots__ = ("blob", "offs", "_bytes")

    def __init__(self, blob: np.ndarray, offs: np.ndarray):
        self.blob = np.asarray(blob, np.uint8)
        self.offs = np.asarray(offs, np.int64)
        self._bytes: Optional[bytes] = None

    @classmethod
    def from_ids(cls, ids: Sequence[str]) -> "EventIdColumn":
        encoded = [s.encode("utf-8", "surrogatepass") for s in ids]
        offs = np.zeros(len(encoded) + 1, np.int64)
        np.cumsum([len(b) for b in encoded], out=offs[1:])
        return cls(np.frombuffer(b"".join(encoded), np.uint8).copy(), offs)

    def __len__(self) -> int:
        return len(self.offs) - 1

    def _materialize(self) -> bytes:
        if self._bytes is None:
            self._bytes = self.blob.tobytes()
        return self._bytes

    def tolist(self) -> List[str]:
        b, offs = self._materialize(), self.offs
        return [b[offs[j]:offs[j + 1]].decode("utf-8", "surrogatepass")
                for j in range(len(self))]

    def index_of(self, event_id: str) -> int:
        """Row of ``event_id`` or -1: a substring scan of the blob checked
        against the offsets (a hit inside a longer id is skipped)."""
        needle = event_id.encode("utf-8", "surrogatepass")
        if not needle:
            return -1
        blob = self._materialize()
        start = 0
        while True:
            p = blob.find(needle, start)
            if p < 0:
                return -1
            row = int(np.searchsorted(self.offs, p, side="left"))
            if (row < len(self) and self.offs[row] == p
                    and self.offs[row + 1] - p == len(needle)):
                return row
            start = p + 1

    def rows_of(self, event_ids) -> List[int]:
        """The row ``index_of`` finds for each of ``event_ids`` that is in
        the column: for ``ROWS_OF_ONE_PASS`` ids or more, one pass over the
        column (its ids split out of the NUL-joined blob and looked up in a
        set) instead of a blob scan an id."""
        event_ids = list(event_ids)
        joined = (_nul_joined(self._materialize(), self.offs)
                  if len(event_ids) >= ROWS_OF_ONE_PASS else None)
        if joined is None:
            return [r for r in map(self.index_of, event_ids) if r >= 0]
        needles = {e.encode("utf-8", "surrogatepass") for e in event_ids}
        found: Dict[bytes, int] = {}
        for j, x in enumerate(joined.split(b"\0")):
            if x in needles and x not in found:
                found[x] = j
        return list(found.values())

    @classmethod
    def concat(cls, columns: Sequence["EventIdColumn"]) -> "EventIdColumn":
        if len(columns) == 1:
            return columns[0]
        offs = [np.zeros(1, np.int64)]
        base = 0
        for c in columns:
            offs.append(c.offs[1:] + base)
            base += int(c.offs[-1])
        return cls(np.concatenate([c.blob for c in columns]), np.concatenate(offs))

    def subset(self, mask: np.ndarray) -> "EventIdColumn":
        idx = np.flatnonzero(mask)
        lens = np.diff(self.offs)[idx]
        offs = np.zeros(len(idx) + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        total = int(offs[-1])
        if total == 0:
            return EventIdColumn(np.empty(0, np.uint8), offs)
        gather = np.arange(total, dtype=np.int64) + np.repeat(self.offs[idx] - offs[:-1], lens)
        return EventIdColumn(self.blob[gather], offs)


class BatchMerger:
    """The k-way merge of batch parts (and their id columns), in two phases.

    ``add`` (phase A, once per part, in part order) unions the part's
    dictionaries into the target ones and keeps its code maps: the sharded
    store's parallel scan calls it for each shard as it completes, while
    later shards still parse.  ``finish`` (phase B) allocates each output
    column once and gathers every part into its slice.

    With ``base`` the codes are assigned in the base batch's dictionaries,
    which grow in place (its property dictionaries too, as
    ``ColumnarBuilder(base=...)`` does), so the result concatenates with
    the base through the shared-dictionary path: the sharded store splices
    a cross-shard tail into a retained batch that way.  With
    ``grow_base_props=False`` (``EventBatch.concat``) a base property
    dictionary that a later part does not share is copied first.

    Rows come in ``add`` order and codes in first appearance across the
    parts' own dictionaries: the order of a pairwise concatenation, and the
    JAX package's.  Where ``PIO_NATIVE`` engages the native core, the
    unions (``native.core.DictHandle``) and the gathers (``take_i32``) run
    in C with the same result; a native failure mid-merge is counted
    (``pio_native_fallback_total{reason="error"}``) and the Python path
    carries on from the same state."""

    def __init__(self, base: Optional[EventBatch] = None, grow_base_props: bool = True):
        from predictionio_tpu_torch.native import core as ncore

        if base is not None:
            self.event_dict = base.event_dict
            self.entity_type_dict = base.entity_type_dict
            self.entity_dict = base.entity_dict
            self.target_dict = base.target_dict
            self._base_props = base.prop_columns or {}
        else:
            self.event_dict = IdDict()
            self.entity_type_dict = IdDict()
            self.entity_dict = IdDict()
            self.target_dict = IdDict()
            self._base_props = {}
        # False: a base property dictionary that a part does not share is
        # copied before it grows, so the base batch stays as it was
        self._grow_base_props = grow_base_props
        # per part: (batch, ids, event map, entity-type map, entity map,
        # target map); a None map: the part's codes are the target's
        self._parts: List[tuple] = []
        # key -> {"dict": target IdDict, "entries": [(row offset, column, map)]}
        self._props: Dict[str, dict] = {}
        self._props_ok = True
        self._ids_ok = True
        self._rows = 0
        # native unions only into fresh targets: seeding a handle from a
        # large base dictionary would cost O(base) a tail merge
        self._native = base is None and ncore.scan_enabled()
        self._handles: Dict[int, object] = {}
        self._handle_keep: List[IdDict] = []

    def _code_map(self, target: IdDict, part_dict: IdDict) -> Optional[np.ndarray]:
        """Union ``part_dict`` into ``target``: the int32 code of each of
        its strings there, or None where they are already the target's
        codes (the same object, or the first part into an empty target)."""
        if part_dict is target:
            return None
        if self._native:
            from predictionio_tpu_torch.native import core as ncore

            try:
                return self._code_map_native(target, part_dict)
            except Exception:
                ncore.note_fallback("error")
                self._native = False
        if not len(target):
            strings = part_dict.strings()
            target._to_str = strings
            target._to_id = {x: i for i, x in enumerate(strings)}
            target._pending = None
            return None
        n = len(part_dict)
        if not n:
            return np.empty(0, np.int32)
        # misses first, installed in bulk, then one lookup a string
        strings = part_dict.strings()
        to_id = target._index()
        miss = [x for x in strings if x not in to_id]
        if miss:
            start = len(target._to_str)
            to_id.update(zip(miss, range(start, start + len(miss))))
            target._to_str.extend(miss)
        return np.fromiter(map(to_id.__getitem__, strings), np.int32, count=n)

    def _code_map_native(self, target: IdDict, part_dict: IdDict) -> Optional[np.ndarray]:
        from predictionio_tpu_torch.native import core as ncore

        h = self._handles.get(id(target))
        if h is None:
            h = ncore.DictHandle()
            if len(target):
                blob, offs = _export_dict_blob(target)
                h.union(blob, offs)
            self._handles[id(target)] = h
            self._handle_keep.append(target)   # keeps id(target) unique
        was_empty = len(h) == 0
        blob, offs = _export_dict_blob(part_dict)
        cmap, n_new = h.union(blob, offs)
        if was_empty:
            # the part's codes are the target's: install its blob as it is
            target._append_pending(blob, offs)
            return None
        if n_new:
            new_blob, new_offs = h.export(len(h) - n_new)
            target._append_pending(new_blob, new_offs)
        return cmap

    def add(self, batch: EventBatch, ids: Optional["EventIdColumn"] = None) -> None:
        """Phase A of one part: the dictionary unions and code maps."""
        self._parts.append((
            batch, ids,
            self._code_map(self.event_dict, batch.event_dict),
            self._code_map(self.entity_type_dict, batch.entity_type_dict),
            self._code_map(self.entity_dict, batch.entity_dict),
            self._code_map(self.target_dict, batch.target_dict),
        ))
        if ids is None:
            self._ids_ok = False
        if batch.prop_columns is None:
            self._props_ok = False
        elif self._props_ok:
            for key, col in batch.prop_columns.items():
                st = self._props.get(key)
                if st is None:
                    base_col = self._base_props.get(key)
                    st = self._props[key] = {
                        "dict": base_col.dict if base_col is not None else IdDict(),
                        "entries": [],
                        "borrowed": base_col is not None and not self._grow_base_props}
                if st["borrowed"] and col.dict is not st["dict"]:
                    # the copy keeps the base's codes: earlier parts' maps hold
                    st["dict"], st["borrowed"] = st["dict"].clone(), False
                st["entries"].append((self._rows, col, self._code_map(st["dict"], col.dict)))
        self._rows += len(batch)

    @staticmethod
    def _take(cmap: np.ndarray, codes: np.ndarray, out: np.ndarray, native: bool,
              sentinel: bool) -> None:
        """``out = cmap[codes]`` (a code -1 stays -1 with ``sentinel``), in
        C where ``native``, else numpy."""
        from predictionio_tpu_torch.native import core as ncore

        if native and ncore.take_i32(cmap, codes, out, sentinel):
            return
        if sentinel:
            # code -1 reads the appended last slot, which holds -1
            cmap = np.append(cmap, np.int32(-1))
        np.take(cmap, np.asarray(codes), out=out)

    def _finish_props(self, native: bool) -> Optional[Dict[str, PropColumn]]:
        if not self._props_ok:
            return None
        out: Dict[str, PropColumn] = {}
        for key, st in self._props.items():
            entries = st["entries"]
            n = sum(len(c) for _, c, _ in entries)
            total = sum(len(c.codes) for _, c, _ in entries)
            rows = np.empty(n, np.int64)
            kind = np.empty(n, np.int8)
            num = np.empty(n, np.float64)
            str_offs = np.empty(n + 1, np.int64)
            str_offs[0] = 0
            codes = np.empty(total, np.int32)
            ep = cp = 0
            for row_off, col, cmap in entries:
                m, k = len(col), len(col.codes)
                np.add(col.rows, row_off, out=rows[ep:ep + m])
                kind[ep:ep + m] = col.kind
                num[ep:ep + m] = col.num
                np.add(col.str_offs[1:], cp, out=str_offs[ep + 1:ep + m + 1])
                if k:
                    if cmap is None:
                        codes[cp:cp + k] = col.codes
                    else:
                        self._take(cmap, col.codes, codes[cp:cp + k], native, False)
                ep += m
                cp += k
            out[key] = PropColumn(rows, kind, num, str_offs, codes, st["dict"])
        return out

    def _finish_ids(self) -> Optional["EventIdColumn"]:
        if not self._ids_ok:
            return None
        total = sum(int(ids.offs[-1]) for _, ids, *_ in self._parts)
        blob = np.empty(total, np.uint8)
        offs = np.empty(self._rows + 1, np.int64)
        offs[0] = 0
        rp = bp = 0
        for _b, ids, *_ in self._parts:
            m, k = len(ids), int(ids.offs[-1])
            np.add(ids.offs[1:], bp, out=offs[rp + 1:rp + m + 1])
            blob[bp:bp + k] = ids.blob
            rp += m
            bp += k
        return EventIdColumn(blob, offs)

    def finish(self) -> Tuple[EventBatch, Optional["EventIdColumn"]]:
        """Phase B: (the merged batch, the merged ids or None)."""
        from predictionio_tpu_torch.native import core as ncore

        n = self._rows
        ev, et, ei, ti = (np.empty(n, np.int32) for _ in range(4))
        ts = np.empty(n, np.int64)
        rt = np.empty(n, np.float32)
        # a merge of shared dictionaries (the snapshot and tail splice)
        # gathers nothing, and is no native operation
        gathers = (any(m is not None for part in self._parts for m in part[2:])
                   or any(e[2] is not None for st in self._props.values()
                          for e in st["entries"]))
        native = gathers and ncore.scan_enabled()
        if native:
            ncore.note_call("scan")
        at = 0
        for b, _ids, ev_map, et_map, ei_map, ti_map in self._parts:
            m = len(b)
            if m:
                for out_col, codes, cmap, sentinel in (
                        (ev, b.event_codes, ev_map, False),
                        (et, b.entity_type_codes, et_map, False),
                        (ei, b.entity_ids, ei_map, False),
                        (ti, b.target_ids, ti_map, True)):
                    if cmap is None:
                        out_col[at:at + m] = codes
                    else:
                        self._take(cmap, codes, out_col[at:at + m], native, sentinel)
                ts[at:at + m] = b.times_us
                rt[at:at + m] = b.ratings
            at += m
        batch = EventBatch(ev, et, ei, ti, ts, rt, self.event_dict, self.entity_type_dict,
                           self.entity_dict, self.target_dict,
                           prop_columns=self._finish_props(native))
        return batch, self._finish_ids()


# -- the PIOCOL01 container (snapshot files) -------------------------------------
#
# Layout, little-endian, as the JAX package writes it:
#   bytes 0..7      magic b"PIOCOL01"
#   bytes 8..15     uint64 header length H
#   bytes 16..16+H  JSON header (column dtypes and offsets, the string
#                   dictionaries, per-key property columns, opaque meta)
#   data blobs, each 64-byte aligned, at offsets relative to 16 + H
#
# Loads are read-only views into a memory map: no parse, no copy.

_COLUMNAR_MAGIC = b"PIOCOL01"
_ALIGN = 64
_COLS = (("event_codes", "<i4"), ("entity_type_codes", "<i4"), ("entity_ids", "<i4"),
         ("target_ids", "<i4"), ("times_us", "<i8"), ("ratings", "<f4"))
_PROP_COLS = (("rows", "<i8"), ("kind", "|i1"), ("num", "<f8"), ("str_offs", "<i8"),
              ("codes", "<i4"))


def _spec(arrays: List[np.ndarray], pos: int, arr: np.ndarray,
          dtype: str) -> Tuple[Dict, int]:
    arr = np.ascontiguousarray(arr)
    pos = (pos + _ALIGN - 1) // _ALIGN * _ALIGN
    arrays.append(arr)
    return {"dtype": dtype, "n": int(arr.shape[0]), "off": pos}, pos + arr.nbytes


def write_batch(path, batch: EventBatch, event_ids: Optional[EventIdColumn] = None,
                meta: Optional[Dict] = None) -> None:
    """Serialise ``batch`` (and its id column) into one PIOCOL01 file,
    byte for byte as the JAX package's ``write_batch`` does.  Flushed and
    fsync'd but not atomic: the caller owns the temporary name and the
    rename (``storage.snapshot``)."""
    arrays: List[np.ndarray] = []
    pos = 0
    cols = {}
    for name, dt in _COLS:
        cols[name], pos = _spec(arrays, pos, np.asarray(getattr(batch, name)).astype(dt), dt)
    ids_entry = None
    if event_ids is not None:
        blob_spec, pos = _spec(arrays, pos, np.asarray(event_ids.blob, np.uint8), "|u1")
        offs_spec, pos = _spec(arrays, pos, np.asarray(event_ids.offs).astype("<i8"), "<i8")
        ids_entry = {"blob": blob_spec, "offs": offs_spec}
    props_entry = []
    for key, col in (batch.prop_columns or {}).items():
        entry: Dict = {"dict": col.dict.to_state()}
        for name, dt in _PROP_COLS:
            entry[name], pos = _spec(arrays, pos, np.asarray(getattr(col, name)).astype(dt), dt)
        props_entry.append([key, entry])
    header = {
        "rows": len(batch),
        "cols": cols,
        "ids": ids_entry,
        "dicts": {"event": batch.event_dict.to_state(),
                  "entity_type": batch.entity_type_dict.to_state(),
                  "entity": batch.entity_dict.to_state(),
                  "target": batch.target_dict.to_state()},
        "props": props_entry,
        "meta": meta or {},
    }
    hdr = json.dumps(header, separators=(",", ":")).encode()
    data_base = 16 + len(hdr)
    with open(path, "wb") as f:
        f.write(_COLUMNAR_MAGIC)
        f.write(len(hdr).to_bytes(8, "little"))
        f.write(hdr)
        at = data_base
        for arr in arrays:
            off = (at - data_base + _ALIGN - 1) // _ALIGN * _ALIGN
            f.write(b"\0" * (data_base + off - at))
            f.write(arr.data)
            at = data_base + off + arr.nbytes
        f.flush()
        os.fsync(f.fileno())


def read_batch(path, mmap: bool = True
               ) -> Tuple[EventBatch, Optional[EventIdColumn], Dict]:
    """Load a PIOCOL01 file → (batch, ids or None, meta).

    With ``mmap`` the columns are read-only views of the mapped file:
    nothing may write into them, and a column handed to torch is copied
    first.  The header is parsed by the native scan core
    (``native/core.py``) where it is built and enabled, else by
    ``json.loads``; both give the same batch.  Raises ValueError on a torn
    or corrupt file (callers quarantine and rebuild)."""
    from predictionio_tpu_torch.native import core as ncore

    with open(path, "rb") as f:
        try:
            raw = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
        except ValueError as e:   # an empty file: a torn write
            raise ValueError(f"{path}: not a columnar snapshot: {e}") from None
    mm = np.frombuffer(raw, dtype=np.uint8)
    if mm.shape[0] < 16 or bytes(mm[:8]) != _COLUMNAR_MAGIC:
        raise ValueError(f"{path}: not a columnar snapshot (bad magic)")
    hlen = int.from_bytes(bytes(mm[8:16]), "little")
    if 16 + hlen > mm.shape[0]:
        raise ValueError(f"{path}: truncated header")
    hdr_bytes = bytes(mm[16:16 + hlen])
    if ncore.scan_enabled():
        # a declined header (an unknown layout, or corrupt) falls through
        # to json.loads, which reads it or raises the same ValueError
        nh = ncore.ColumnarHeader.parse(hdr_bytes)
        if nh is not None:
            try:
                out = _read_batch_native(path, mm, nh, hdr_bytes, 16 + hlen, mmap)
                ncore.note_call("scan")
                return out
            except ValueError:
                raise
            except Exception:
                ncore.note_fallback("error")
        else:
            ncore.note_fallback("unsupported")
    try:
        header = json.loads(hdr_bytes)
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"{path}: corrupt header: {e}") from None
    data_base = 16 + hlen

    def view(spec) -> np.ndarray:
        return _view(path, mm, data_base, (spec["n"], spec["off"]), spec["dtype"], mmap)

    c, d = header["cols"], header["dicts"]
    props = {key: PropColumn(**{name: view(entry[name]) for name, _ in _PROP_COLS},
                             dict=IdDict.from_state(entry["dict"]))
             for key, entry in header.get("props", [])}
    batch = EventBatch(
        **{name: view(c[name]) for name, _ in _COLS},
        event_dict=IdDict.from_state(d["event"]),
        entity_type_dict=IdDict.from_state(d["entity_type"]),
        entity_dict=IdDict.from_state(d["entity"]),
        target_dict=IdDict.from_state(d["target"]),
        prop_columns=props,
    )
    if len(batch) != header["rows"]:
        raise ValueError(f"{path}: row-count mismatch")
    ids = None
    if header.get("ids"):
        ids = EventIdColumn(view(header["ids"]["blob"]), view(header["ids"]["offs"]))
        if len(ids) != len(batch):
            raise ValueError(f"{path}: id column length mismatch")
    return batch, ids, header.get("meta", {})


def _view(path, mm: np.ndarray, data_base: int, spec, dtype: str, want_mmap: bool) -> np.ndarray:
    """Column ``spec`` = (n, off) of the mapped file as ``dtype``: a
    read-only view, or a copy without ``want_mmap``."""
    dt = np.dtype(dtype)
    n, off = spec
    a = data_base + off
    b = a + n * dt.itemsize
    if b > mm.shape[0]:
        raise ValueError(f"{path}: truncated column data")
    arr = mm[a:b].view(dt)
    return arr if want_mmap else np.array(arr)


def _read_batch_native(path, mm: np.ndarray, nh, hdr_bytes: bytes, data_base: int,
                       want_mmap: bool):
    """``read_batch``'s body from the native header parse ``nh``: the same
    views, the dictionaries left as undecoded blobs.  Raises the same
    ValueErrors for truncated data and length mismatches."""

    def view(spec, dtype) -> np.ndarray:
        return _view(path, mm, data_base, spec, dtype, want_mmap)

    cols = {name: view(nh.spec(i), dt) for i, (name, dt) in enumerate(_COLS)}
    props = {}
    for i in range(nh.nprops):
        arrs = {name: view(nh.prop_spec(i, w), dt) for w, (name, dt) in enumerate(_PROP_COLS)}
        props[nh.prop_key(i)] = PropColumn(**arrs, dict=IdDict.from_blob(*nh.prop_dict_blob(i)))
    batch = EventBatch(
        **cols,
        event_dict=IdDict.from_blob(*nh.dict_blob(0)),
        entity_type_dict=IdDict.from_blob(*nh.dict_blob(1)),
        entity_dict=IdDict.from_blob(*nh.dict_blob(2)),
        target_dict=IdDict.from_blob(*nh.dict_blob(3)),
        prop_columns=props,
    )
    if len(batch) != nh.rows:
        raise ValueError(f"{path}: row-count mismatch")
    ids = None
    blob_spec = nh.spec(6)
    if blob_spec is not None:
        ids = EventIdColumn(view(blob_spec, "|u1"), view(nh.spec(7), "<i8"))
        if len(ids) != len(batch):
            raise ValueError(f"{path}: id column length mismatch")
    span = nh.meta_span()
    meta = json.loads(hdr_bytes[span[0]:span[0] + span[1]]) if span is not None else {}
    return batch, ids, meta


# -- the named-array container (the model plane's arenas) ----------------------
#
# The snapshot's discipline (magic, JSON header, 64-aligned blobs, mapped
# loads) for any dict of n-D arrays: bytes 0..7 b"PIOARR01", 8..15 the
# header length H, then the JSON header {"version", "arrays": {name:
# {dtype, shape, off}}, "meta"} and the blobs at offsets relative to 16 + H.

_ARRAYS_MAGIC = b"PIOARR01"


def write_arrays(path, arrays: Dict[str, np.ndarray], meta: Optional[Dict] = None) -> None:
    """Serialise named n-D arrays into one PIOARR01 file, byte for byte as
    the JAX package's ``write_arrays`` does.  Flushed and fsync'd but not
    atomic: the caller owns the temporary name and the rename (the model
    plane renames under its publish lock)."""
    entries: Dict[str, Dict] = {}
    blobs: List[np.ndarray] = []
    pos = 0
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        pos = (pos + _ALIGN - 1) // _ALIGN * _ALIGN
        entries[name] = {"dtype": arr.dtype.str, "shape": list(arr.shape), "off": pos}
        blobs.append(arr)
        pos += arr.nbytes
    hdr = json.dumps({"version": 1, "arrays": entries, "meta": meta or {}},
                     separators=(",", ":")).encode()
    data_base = 16 + len(hdr)
    with open(path, "wb") as f:
        f.write(_ARRAYS_MAGIC)
        f.write(len(hdr).to_bytes(8, "little"))
        f.write(hdr)
        at = data_base
        for arr in blobs:
            off = (at - data_base + _ALIGN - 1) // _ALIGN * _ALIGN
            f.write(b"\0" * (data_base + off - at))
            # no tobytes() copy: a keyframe arena is hundreds of MB
            f.write(arr.data)
            at = data_base + off + arr.nbytes
        f.flush()
        os.fsync(f.fileno())


def read_arrays(path, mmap: bool = True) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Load a PIOARR01 file → ``(arrays, meta)``.

    With ``mmap`` the arrays are read-only views of one shared mapping
    (every process mapping the file shares its page cache; a write
    raises), kept alive by the views themselves; without it, copies.
    Nothing may hand such a view to torch without copying it.  Raises
    ValueError on a torn or corrupt file (callers quarantine)."""
    with open(path, "rb") as f:
        try:
            raw = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
        except ValueError as e:   # an empty file: a torn write
            raise ValueError(f"{path}: not an array container: {e}") from None
    mm = np.frombuffer(raw, dtype=np.uint8)
    if mm.shape[0] < 16 or bytes(mm[:8]) != _ARRAYS_MAGIC:
        raise ValueError(f"{path}: not an array container (bad magic)")
    hlen = int.from_bytes(bytes(mm[8:16]), "little")
    if 16 + hlen > mm.shape[0]:
        raise ValueError(f"{path}: truncated header")
    try:
        header = json.loads(bytes(mm[16:16 + hlen]))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"{path}: corrupt header: {e}") from None
    data_base = 16 + hlen
    out: Dict[str, np.ndarray] = {}
    for name, spec in header.get("arrays", {}).items():
        dt = np.dtype(spec["dtype"])
        shape = tuple(spec["shape"])
        n = int(np.prod(shape)) if shape else 1
        a = data_base + spec["off"]
        b = a + n * dt.itemsize
        if b > mm.shape[0]:
            raise ValueError(f"{path}: truncated array data ({name})")
        arr = mm[a:b].view(dt).reshape(shape)
        out[name] = arr if mmap else np.array(arr)
    return out, header.get("meta", {})


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


def category_masks(item_categories, item_dict: "IdDict"):
    """(category IdDict, [C, n_items] bool matrix) from per-item category
    lists — the device-resident form of an engine's category business
    rules (items are columns so a query ORs a few mask ROWS on device)."""
    names = sorted({c for cats in item_categories.values() for c in cats})
    cat_dict = IdDict(names)
    masks = np.zeros((len(names), len(item_dict)), bool)
    for item, cats in item_categories.items():
        iid = item_dict.id(item)
        if iid is None:
            continue
        for c in cats:
            masks[cat_dict.id(c), iid] = True
    return cat_dict, masks
