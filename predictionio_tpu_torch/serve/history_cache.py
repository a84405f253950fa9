"""Per-worker user-history read cache with event-append invalidation.

Counterpart of ``predictionio_tpu/serve/history_cache.py``.

The serve tail's residual cost on a RESPONSE-cache hit is the history
read itself: the response cache (serve/response_cache) keys on a
fingerprint of the user's live history, so every lookup still walks
``LEventStore.find_by_entity`` per event type (~0.5 ms) before it can
even probe.  This module memoizes that read — the raw
``target_entity_id`` strings per (app, entity, event type, limit), a
value independent of any model generation — and invalidates it on the
event-store mutations this process performs (the listener bus in
``storage.base``, notified by every event backend):

- an append for entity E bumps E's version, so only E's entries re-read;
- an event delete, channel remove, or TTL trim (entities unknown) bumps
  the global epoch, flushing everything.

The (epoch, version) token is captured BEFORE the underlying read: an
append racing the read can only make a fresh entry look stale (one
wasted re-read), never let a stale entry look fresh.

Scope: invalidation is per-worker (in-process), exactly as the storage
listener bus is.  Where another process appends to the same store (an
event server or ``pio import`` beside a ``pio deploy``, or the JAX
package writing the store this package serves), run with
``PIO_HISTORY_CACHE=off`` — the always-fresh oracle the parity tests
compare against.

Knobs: ``PIO_HISTORY_CACHE`` (on|off, default on; re-read per lookup),
``PIO_HISTORY_CACHE_MAX`` (entries, default 4096).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Tuple

from predictionio_tpu_torch.models.common import LRUCache
from predictionio_tpu_torch.obs import metrics as _obs_metrics
from predictionio_tpu_torch.storage import base as _storage_base

_REG = _obs_metrics.get_registry()
_M_LOOKUP = _REG.counter(
    "pio_history_cache_total",
    "User-history cache lookups by outcome: hit (served from cache), "
    "miss (cold key, read and filled), stale (entry invalidated by an "
    "append/epoch bump, re-read), bypass (PIO_HISTORY_CACHE=off or the "
    "read was uncacheable)")
_M_ENTRIES = _REG.gauge(
    "pio_history_cache_entries",
    "Resident user-history cache entries in this worker")

# versions dict safety valve: past this many distinct entities, reset by
# bumping the epoch (correct — everything re-reads once)
_MAX_VERSIONS = 65536


def _enabled() -> bool:
    return os.environ.get("PIO_HISTORY_CACHE", "on").strip().lower() not in (
        "off", "0", "false", "no")


class HistoryCache:
    """Bounded LRU of per-entity history reads; see module docstring."""

    def __init__(self, max_entries: Optional[int] = None):
        if max_entries is None:
            max_entries = int(os.environ.get("PIO_HISTORY_CACHE_MAX", 4096))
        self._lru = LRUCache(max_entries)
        self._lock = threading.Lock()
        self._versions: Dict[Tuple[str, str], int] = {}
        self._epoch = 0

    # -- invalidation (storage append-listener bus) --------------------------

    def on_mutation(self, entities: Optional[List[tuple]]) -> None:
        """Listener for ``storage.base.add_append_listener``:
        per-entity version bumps, or a full flush when ``entities`` is
        None (mutation whose entities are unknown)."""
        with self._lock:
            if entities is None:
                self._epoch += 1
                self._versions.clear()
                self._lru.clear()
            else:
                if len(self._versions) + len(entities) > _MAX_VERSIONS:
                    self._epoch += 1
                    self._versions.clear()
                for ent in entities:
                    self._versions[ent] = self._versions.get(ent, 0) + 1
        _M_ENTRIES.set(len(self._lru))

    # -- lookup ---------------------------------------------------------------

    def _token(self, ent: Tuple[str, str]) -> Tuple[int, int]:
        with self._lock:
            return self._epoch, self._versions.get(ent, 0)

    def user_history_targets(self, app_name: str, entity_type: str,
                             entity_id: str, event_name: str,
                             limit: Optional[int],
                             channel_name: Optional[str] = None
                             ) -> Tuple[str, ...]:
        """Raw ``target_entity_id`` strings of the entity's latest
        ``limit`` events named ``event_name`` — exactly what
        ``find_by_entity`` returns, minus the per-model id mapping that
        keeps this value cacheable across generations."""
        if not _enabled():
            _M_LOOKUP.inc(outcome="bypass")
            return self._fetch(app_name, entity_type, entity_id,
                               event_name, limit, channel_name)[0]
        key = (app_name, channel_name, entity_type, entity_id,
               event_name, limit)
        token = self._token((entity_type, entity_id))
        entry = self._lru.get(key, count=False)
        if entry is not None and entry[0] == token:
            _M_LOOKUP.inc(outcome="hit")
            return entry[1]
        value, cacheable = self._fetch(app_name, entity_type, entity_id,
                                       event_name, limit, channel_name)
        if cacheable:
            self._lru.put(key, (token, value))
            _M_ENTRIES.set(len(self._lru))
            _M_LOOKUP.inc(outcome="stale" if entry is not None else "miss")
        else:
            _M_LOOKUP.inc(outcome="bypass")
        return value

    @staticmethod
    def _fetch(app_name: str, entity_type: str, entity_id: str,
               event_name: str, limit: Optional[int],
               channel_name: Optional[str]
               ) -> Tuple[Tuple[str, ...], bool]:
        from predictionio_tpu_torch.store.event_store import LEventStore

        try:
            events = LEventStore.find_by_entity(
                app_name, entity_type, entity_id,
                channel_name=channel_name, event_names=[event_name],
                limit=limit)
        except ValueError:
            # app/channel unresolved — the oracle treats this as an empty
            # history; don't cache (the app may be created next tick)
            return (), False
        return tuple(e.target_entity_id for e in events
                     if e.target_entity_id is not None), True

    def reset_for_tests(self) -> None:
        with self._lock:
            self._epoch = 0
            self._versions.clear()
            self._lru.clear()
        _M_ENTRIES.set(0)


_CACHE = HistoryCache()
_storage_base.add_append_listener(_CACHE.on_mutation)


def get_cache() -> HistoryCache:
    return _CACHE


def user_history_targets(app_name: str, entity_type: str, entity_id: str,
                         event_name: str, limit: Optional[int],
                         channel_name: Optional[str] = None
                         ) -> Tuple[str, ...]:
    return _CACHE.user_history_targets(app_name, entity_type, entity_id,
                                       event_name, limit, channel_name)
