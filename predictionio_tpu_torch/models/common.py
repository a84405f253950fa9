"""Serving-side helpers shared by the engine templates.

Counterpart of ``predictionio_tpu/models/common.py`` (``LRUCache``, less
the ``peek`` that only the JAX package's candidate-pruned tail uses; the
device staging of ``DeviceCacheMixin`` is the port's own).
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Optional

import torch

from predictionio_tpu_torch.device import resolve_device


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
