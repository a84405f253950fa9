"""Serving-side helpers shared by the engine templates.

Counterpart of ``predictionio_tpu/models/common.py``: ``opt_str_list``,
``LRUCache`` (less the ``peek`` that only the JAX package's
candidate-pruned tail uses), ``CategoryRulesMixin`` and
``reindex_interactions``; the device staging of ``DeviceCacheMixin`` is
the port's own.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from predictionio_tpu_torch.device import resolve_device


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

    def get(self, key, default=None):
        with self._lock:
            try:
                value = self._data[key]
            except KeyError:
                hit = False
                self.misses += 1
            else:
                self._data.move_to_end(key)
                hit = True
                self.hits += 1
        if self._on is not None:
            self._on("hit" if hit else "miss")
        return value if hit else default

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
