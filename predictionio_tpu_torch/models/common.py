"""Serving-side helpers shared by the engine templates.

Counterpart of ``predictionio_tpu/models/common.py``: ``opt_str_list``,
``LRUCache``, the host serve tail's top-k (``topk_order_keys``,
``host_topk_desc``) and CSR gather (``gather_csr_rows``, both through the
native serve core where it loads), ``pad_batch_rows``,
``CategoryRulesMixin`` and ``reindex_interactions``; the device staging of
``DeviceCacheMixin`` is the port's own.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.native import core as _ncore


def opt_str_list(d: Dict, key: str) -> Optional[List[str]]:
    """Wire contract for optional list fields: a present-but-empty list
    stays ``[]`` (an explicitly empty whiteList means "nothing qualifies")
    while an absent or null key is ``None`` ("unconstrained")."""
    return [str(v) for v in d[key]] if key in d and d[key] is not None else None


class LRUCache:
    """Thread-safe bounded LRU with touch-on-hit ordering.

    One lock per cache; every ``get`` hit re-ranks the entry.
    ``on_event`` (called with "hit" | "miss" | "evict", OUTSIDE the lock)
    lets a caller count cache traffic without coupling this class to a
    metrics registry; hit/miss/eviction totals are also kept on the
    instance for direct inspection.
    """

    def __init__(self, max_entries: int,
                 on_event: Optional[Callable[[str], None]] = None):
        self._max = max(int(max_entries), 1)
        self._on = on_event
        self._lock = threading.Lock()
        self._data: "collections.OrderedDict" = collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._data

    def get(self, key, default=None, count: bool = True):
        with self._lock:
            try:
                value = self._data[key]
            except KeyError:
                hit = False
                if count:
                    self.misses += 1
            else:
                self._data.move_to_end(key)
                hit = True
                if count:
                    self.hits += 1
        if count and self._on is not None:
            self._on("hit" if hit else "miss")
        return value if hit else default

    def peek(self, key, default=None):
        """``get`` without telemetry: a hit still touches the LRU order,
        but no hit/miss is counted or reported.  For probe-only readers:
        the candidate-pruned tail gathers from a cached full rule mask
        when one exists and never fills on absence, so counting its probe
        as a miss would make the cache's hit ratio meaningless."""
        return self.get(key, default, count=False)

    def put(self, key, value) -> None:
        evicted = 0
        with self._lock:
            self._data[key] = value
            self._data.move_to_end(key)
            while len(self._data) > self._max:
                self._data.popitem(last=False)
                self.evictions += 1
                evicted += 1
        if self._on is not None:
            for _ in range(evicted):
                self._on("evict")

    def get_or_build(self, key, build: Callable[[], object]):
        """``get``, else ``build()`` OUTSIDE the lock and ``put``.
        Concurrent builders of the same key may duplicate the build (the
        values are idempotent derived data) but never block builds of
        other keys; last put wins."""
        value = self.get(key)
        if value is None:
            value = build()
            self.put(key, value)
        return value

    def clear(self) -> None:
        with self._lock:
            self._data.clear()


# low-word constant per array length for host_topk_desc's composite key
# (read-only once published; dict assignment is atomic under the GIL)
_TOPK_LOW: Dict[int, np.ndarray] = {}


def _topk_low(n: int) -> np.ndarray:
    low = _TOPK_LOW.get(n)
    if low is None:
        low = np.int64(2**32 - 1) - np.arange(n, dtype=np.int64)
        if len(_TOPK_LOW) > 16:   # a serving process sees a handful of n's
            _TOPK_LOW.clear()
        _TOPK_LOW[n] = low
    return low


def topk_order_keys(s: np.ndarray) -> np.ndarray:
    """The composite int64 key per element of a float32 score vector whose
    DESCENDING order is ``host_topk_desc``'s (and ``lax.top_k``'s, and
    ``ops.topk.topk_desc``'s) total order — (value desc, index asc), every
    key distinct: the float's monotone int32 image in the high word, a
    descending index in the low word."""
    f = s.astype(np.float32)                 # fresh buffer we may clobber
    i = f.view(np.int32)
    m = i >> 31
    np.bitwise_and(m, np.int32(0x7FFFFFFF), out=m)
    np.bitwise_xor(i, m, out=i)                  # monotone float→int map
    kk = i.astype(np.int64)
    np.left_shift(kk, 32, out=kk)
    np.add(kk, _topk_low(s.shape[0]), out=kk)
    return kk


def host_topk_desc(s: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k of a 1-D float32 score vector in ``lax.top_k``'s order:
    values descending, equal values broken by the LOWER index first — at
    the k-th boundary too, and ``-0.0 < +0.0``.  Returns ``(values, int32
    indices)``.

    Serving score vectors are mostly one repeated value (zeros outside the
    user's signal, -inf outside a hard filter): ``np.argpartition``'s
    introselect worst case, with the boundary ties ambiguous.  Partitioning
    the distinct composite key of ``topk_order_keys`` fixes both.  A
    contiguous float32 vector goes through the native serve core (the same
    key, the GIL dropped) where it loads."""
    n = s.shape[0]
    k = min(int(k), n)
    if k <= 0:
        return s[:0].astype(np.float32), np.zeros(0, np.int32)
    if (s.dtype == np.float32 and s.ndim == 1
            and s.flags.c_contiguous and _ncore.serve_enabled()):
        try:
            vals, idx = _ncore.topk_f32(s, k)
            _ncore.note_call("serve")
            return vals, idx
        except Exception:
            _ncore.note_fallback("error")
    kk = topk_order_keys(s)
    if k >= n:
        order = np.argsort(kk)[::-1]
    else:
        part = np.argpartition(kk, n - k)[n - k:]
        order = part[np.argsort(kk[part])][::-1]
    return s[order], order.astype(np.int32)


def gather_csr_rows(indptr: np.ndarray, ids,
                    *cols: np.ndarray) -> Tuple[np.ndarray, ...]:
    """Concatenated CSR segments ``col[indptr[i]:indptr[i+1]]`` for every
    in-range id in ``ids``, per column, in id order (segments in id order,
    elements in storage order, so float accumulations downstream see one
    addition order).  Ids outside ``[0, len(indptr) - 1)`` and empty
    segments are dropped.  One fancy-index of ``indptr`` gives every
    (start, length) pair and one ``repeat + arange`` the flat element
    index, so each column gathers once.

    For the serve tail's column shapes — one int32 row column, optionally
    one float32 weight column — the gather runs in the native serve core
    with the GIL dropped (the same element order) where it loads."""
    if (_ncore.serve_enabled() and 1 <= len(cols) <= 2
            and all(c.ndim == 1 and c.flags.c_contiguous for c in cols)
            and cols[0].dtype == np.int32
            and (len(cols) == 1 or cols[1].dtype == np.float32)):
        try:
            o0, o1 = _ncore.csr_gather(
                indptr, ids, cols[0], cols[1] if len(cols) == 2 else None)
            _ncore.note_call("serve")
            return (o0,) if o1 is None else (o0, o1)
        except Exception:
            _ncore.note_fallback("error")
    n = len(indptr) - 1
    ids = np.asarray(ids, np.int64)
    if len(ids):
        ids = ids[(ids >= 0) & (ids < n)]
    starts = indptr[ids]
    lens = indptr[ids + 1] - starts
    nz = lens > 0
    starts, lens = starts[nz], lens[nz]
    total = int(lens.sum())
    if total == 0:
        return tuple(c[:0] for c in cols)
    flat = np.repeat(
        starts - np.concatenate(([0], np.cumsum(lens)[:-1])), lens
    ) + np.arange(total, dtype=np.int64)
    return tuple(c[flat] for c in cols)


def pad_batch_rows(x: np.ndarray) -> np.ndarray:
    """Pad a [B, ...] batch to a power-of-two row count (repeating the
    last row), so micro-batch sizes share shapes; callers slice results
    back to the true batch length."""
    from predictionio_tpu_torch.ops.als import bucket_width

    b = bucket_width(len(x), min_width=1)
    if b == len(x):
        return x
    return np.concatenate([x, np.repeat(x[-1:], b - len(x), axis=0)])


class DeviceCacheMixin:
    """Lazy per-instance device staging, rebuilt after unpickle.

    The model's device is resolved at first staging, not when the model
    is built from its pickled state: ``to_device`` names it, else the
    first staging resolves the default (``"cuda"``, which raises without
    a card).  Cached device tensors live only in ``__dict__`` under their
    cache key (models define ``__getstate__``, so they are never pickled);
    ``_device`` stages on first use, so a model pays the host→device
    transfer once, at warm() or its first query.
    """

    @property
    def device(self) -> torch.device:
        dev = self.__dict__.get("_torch_device")
        if dev is None:
            dev = self.__dict__.setdefault("_torch_device", resolve_device(None))
        return dev

    def to_device(self, device) -> "DeviceCacheMixin":
        """Serve from ``device`` (raises when CUDA is asked for and absent);
        tensors staged on another device are dropped and restaged there."""
        dev = resolve_device(device)
        if self.__dict__.get("_torch_device") != dev:
            for attr in self.__dict__.pop("_staged", ()):
                self.__dict__.pop(attr, None)
            self.__dict__["_torch_device"] = dev
        return self

    def _device(self, attr: str, build):
        dev = self.__dict__.get(attr)
        if dev is None:
            dev = build()
            self.__dict__[attr] = dev
            self.__dict__.setdefault("_staged", set()).add(attr)
        return dev


class CategoryRulesMixin(DeviceCacheMixin):
    """For models carrying category business rules: requires
    ``self.cat_masks`` ([C, n_items] bool) and ``self.item_dict``."""

    def cat_masks_device(self) -> torch.Tensor:
        """The [C, n_items] category bitmask matrix on the model's device.
        A model with no categories stages a 1-row all-False dummy so the
        rules scorer keeps one shape."""

        def build():
            m = self.cat_masks
            if m.shape[0] == 0:
                m = np.zeros((1, max(len(self.item_dict), 1)), bool)
            return torch.tensor(np.asarray(m, bool), device=self.device)

        return self._device("_cat_dev", build)


def reindex_interactions(batch, return_rows=False):
    """Compact (user, item) interaction encoding from a columnar batch.

    The batch's entity/target dictionaries cover EVERY id the scan saw
    ($set item ids, other event types, ...); training wants a dense id
    space of only the entities that actually interact.  Returns
    (user_idx, item_idx, user_dict, item_dict) with rows lacking a target
    dropped; ``return_rows`` appends the kept row indices so callers can
    subset sibling columns like event_codes consistently.
    """
    from predictionio_tpu_torch.store.columnar import IdDict

    has_t = batch.target_ids >= 0
    u_codes = batch.entity_ids[has_t]
    t_codes = batch.target_ids[has_t]
    uu = np.unique(u_codes)
    user_dict = IdDict([batch.entity_dict.str(int(c)) for c in uu])
    u_map = np.full(max(len(batch.entity_dict), 1), -1, np.int32)
    u_map[uu] = np.arange(len(uu), dtype=np.int32)
    ti = np.unique(t_codes)
    item_dict = IdDict([batch.target_dict.str(int(c)) for c in ti])
    t_map = np.full(max(len(batch.target_dict), 1), -1, np.int32)
    t_map[ti] = np.arange(len(ti), dtype=np.int32)
    out = (u_map[u_codes].astype(np.int32), t_map[t_codes].astype(np.int32),
           user_dict, item_dict)
    if return_rows:
        return out + (np.nonzero(has_t)[0],)
    return out
