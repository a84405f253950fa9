"""Template-facing event read API.

Counterpart of ``predictionio_tpu/store/event_store.py`` (reference:
data/src/main/scala/io/prediction/data/store/{PEventStore,LEventStore,
Common}.scala): ``PEventStore`` for training reads (columnar here) and
``LEventStore`` for low-latency serving-time reads (the Universal
Recommender fetching a user's recent history inside ``predict``).  App
names are resolved to ids through the metadata store, exactly like the
reference's ``Common.appNameToId``.

On a segment-file backend (localfs) ``PEventStore.batch`` and
``native_batch`` read, in this order, as the JAX package does:

1. the staged cache (``_StagedCache``): a batch this process retained for
   the channel, extended by only the events appended past its watermark (a
   retrain in one process parses just the delta), or else the channel's
   columnar snapshot plus its JSON-lines tail (``snapshot_scan``), which
   it then retains.  Tombstones are honoured: a changed tombstone set
   drops the retained batch, and the snapshot read drops deleted rows by
   their event id.  ``PIO_DELTA_STAGING=off`` retains nothing;
   ``PIO_SNAPSHOT=off`` skips the snapshot;
2. without a snapshot, the native scanner over the segments, the filters
   applied on the columns (``storage.snapshot.apply_filters``);
3. a backend without segments (``memory``), a log with tombstones and no
   snapshot, or a host without a C++ compiler reads the rows in Python
   instead: the JAX package's own branch for such a store.

The cache is process-wide: ``invalidate_staging_cache()`` (or
``_STAGED.invalidate()``) forces a cold read.
"""

from __future__ import annotations

import datetime as _dt
import os
import threading
from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from predictionio_tpu_torch.events.event import Event, PropertyMap
from predictionio_tpu_torch.storage.locator import Storage, get_storage
from predictionio_tpu_torch.store.columnar import EventBatch


def _app_channel_ids(
    app_name: str, channel_name: Optional[str], storage: Storage
) -> Tuple[int, Optional[int]]:
    app = storage.apps.get_by_name(app_name)
    if app is None:
        raise ValueError(f"app {app_name!r} does not exist; create it first (pio app new)")
    channel_id: Optional[int] = None
    if channel_name is not None:
        chan = next(
            (c for c in storage.channels.get_by_app_id(app.id) if c.name == channel_name), None
        )
        if chan is None:
            raise ValueError(f"channel {channel_name!r} does not exist for app {app_name!r}")
        channel_id = chan.id
    return app.id, channel_id


def _delta_staging_enabled() -> bool:
    """``PIO_DELTA_STAGING=off`` turns the retained-batch cache off."""
    return os.environ.get("PIO_DELTA_STAGING", "").lower() not in ("off", "0", "false")


class _StagedCache:
    """Retained staging batches of this process, for delta retrains.

    Keyed by the channel's directory, each entry holds the UNFILTERED
    columnar batch of the whole log with the per-segment byte watermark,
    segment fingerprints and tombstone set it reflects.  A retrain in the
    same process stages ONLY the events past the watermark and splices
    them in on the shared-dictionary concat path; a changed tombstone set
    or log shape drops the entry (a full restage).  Entries exist only for
    stores with a snapshot layer, which supplies the watermark.
    """

    MAX_ENTRIES = 4

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, dict]" = OrderedDict()

    def staged_batch(self, backend, app_id: int,
                     channel_id: Optional[int]) -> Optional[EventBatch]:
        """The whole (app, channel) batch from the retained entry plus the
        delta, else from the backend's ``snapshot_scan`` (then retained),
        else None.  The delta splice runs under the lock, so an entry
        changes atomically; a cold read runs outside it."""
        from predictionio_tpu_torch.storage import snapshot as _snap

        key = (str(backend._chan_dir(app_id, channel_id)) if hasattr(backend, "_chan_dir")
               else f"{id(backend)}/{app_id}/{channel_id}")
        use_cache = _delta_staging_enabled()
        with self._lock:
            ent = self._entries.get(key) if use_cache else None
            if ent is not None:
                if backend.tombstone_state(app_id, channel_id) == ent["tombstones"]:
                    tail = backend.scan_tail_from(app_id, channel_id, ent["watermark"],
                                                  base=ent["batch"], heads=ent["heads"])
                    if tail is not None:
                        if tail["events"]:
                            ent["batch"] = EventBatch.concat([ent["batch"], tail["batch"]])
                            _snap.record_delta(tail["events"])
                        ent["watermark"] = tail["watermark"]
                        ent["heads"] = tail["heads"]
                        self._entries.move_to_end(key)
                        _snap.record_hit()
                        return ent["batch"]
                self._entries.pop(key, None)   # stale: a full restage below
        tomb = (backend.tombstone_state(app_id, channel_id)
                if hasattr(backend, "tombstone_state") else frozenset())
        res = backend.snapshot_scan(app_id, channel_id)
        if res is None:
            return None
        if use_cache:
            with self._lock:
                self._entries[key] = {"batch": res["batch"], "watermark": res["watermark"],
                                      "heads": res.get("heads", {}), "tombstones": tomb}
                self._entries.move_to_end(key)
                while len(self._entries) > self.MAX_ENTRIES:
                    self._entries.popitem(last=False)
        return res["batch"]

    def invalidate(self) -> None:
        with self._lock:
            self._entries.clear()


_STAGED = _StagedCache()


def invalidate_staging_cache() -> None:
    """Drop every retained staging batch (tests; releasing memory)."""
    _STAGED.invalidate()


def staging_counts() -> Dict[str, int]:
    """The cumulative staged-event counts by source (snapshot, tail,
    delta): a (re)train's reads, diffed around it, say how many events it
    staged from where."""
    from predictionio_tpu_torch.storage import snapshot as _snap

    return _snap.staged_counts()


class PEventStore:
    """Bulk training-time reads (reference: PEventStore.scala)."""

    @staticmethod
    def find(
        app_name: str,
        channel_name: Optional[str] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Optional[str] = None,
        storage: Optional[Storage] = None,
    ) -> Iterator[Event]:
        storage = storage or get_storage()
        app_id, channel_id = _app_channel_ids(app_name, channel_name, storage)
        return storage.p_events.find(
            app_id,
            channel_id=channel_id,
            start_time=start_time,
            until_time=until_time,
            entity_type=entity_type,
            event_names=event_names,
            target_entity_type=target_entity_type,
        )

    @staticmethod
    def batch(
        app_name: str,
        channel_name: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        entity_type: Optional[str] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        storage: Optional[Storage] = None,
        local_shard: bool = False,
    ) -> EventBatch:
        """Read matching events as ONE columnar batch (the device-staging
        format): ``native_batch``'s (the staged cache's, the snapshot's or
        the native scan's, in log order) on a segment backend, else the
        backend's ``find`` order.

        ``local_shard=True`` in a multi-process run reads only this
        process's share of the log (``parallel.distributed.shard_segments``):
        whole segments on the segment-file path, strided events otherwise."""
        storage = storage or get_storage()
        native = PEventStore._native_batch(
            app_name, channel_name, event_names, entity_type, start_time,
            until_time, storage, local_shard)
        if native is not None:
            return native
        events = list(PEventStore.find(
            app_name,
            channel_name=channel_name,
            event_names=event_names,
            entity_type=entity_type,
            start_time=start_time,
            until_time=until_time,
            storage=storage,
        ))
        if local_shard:
            from predictionio_tpu_torch.parallel import distributed as dist

            events = dist.shard_segments(events)
        return EventBatch.from_events(events)

    @staticmethod
    def native_batch(
        app_name: str,
        channel_name: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        entity_type: Optional[str] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        storage: Optional[Storage] = None,
    ) -> Optional[EventBatch]:
        """Columnar batch WITH full property columns from a segment
        backend, or None where there is none: a backend without segments,
        or, without a snapshot, no C++ compiler or a tombstone in the log
        (the scanner cannot see deletes).  A retained batch or a snapshot
        and its tail serve first (tombstones honoured); only a miss reaches
        the native scan.  Callers that need properties pick their read with
        it, before any row read."""
        return PEventStore._native_batch(
            app_name, channel_name, event_names, entity_type, start_time,
            until_time, storage or get_storage())

    @staticmethod
    def _native_batch(
        app_name, channel_name, event_names, entity_type, start_time,
        until_time, storage, local_shard: bool = False,
    ) -> Optional[EventBatch]:
        from predictionio_tpu_torch.native import native_available, scan_segments
        from predictionio_tpu_torch.storage import snapshot as _snap

        backend = storage.p_events
        if not hasattr(backend, "segment_paths"):
            return None
        app_id, channel_id = _app_channel_ids(app_name, channel_name, storage)
        filters = dict(event_names=event_names, entity_type=entity_type,
                       start_time=start_time, until_time=until_time)
        if not local_shard:
            # a process's share is whole raw segments: the staged batch and
            # the snapshot serve whole-log reads only
            staged = _STAGED.staged_batch(backend, app_id, channel_id)
            if staged is not None:
                return _snap.apply_filters(staged, **filters)
        if not native_available():
            return None
        paths = backend.segment_paths(app_id, channel_id)
        if not paths:
            return EventBatch.from_events([])
        # decided on state every process shares, before any sharding, so
        # every process of a run partitions the same space (segments, or
        # strided events when a tombstone sends all of them to ``find``)
        if any(t.stat().st_size > 0 for parent in {p.parent for p in paths}
               for t in parent.glob("tombstones*.txt")):
            return None
        if local_shard:
            from predictionio_tpu_torch.parallel import distributed as dist

            paths = dist.shard_segments(paths)
            if not paths:
                return EventBatch.from_events([])
        return _snap.apply_filters(scan_segments(paths), **filters)

    @staticmethod
    def aggregate_properties(
        app_name: str,
        entity_type: str,
        channel_name: Optional[str] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        storage: Optional[Storage] = None,
    ) -> Dict[str, PropertyMap]:
        """Each entity's properties folded from its ``$set``/``$unset``/
        ``$delete`` events.  On a segment backend, as in the reference: the
        special events' columnar batch (``native_batch``: property columns
        parsed in C++, or the snapshot's) folded by
        ``store.columnar.fold_properties``, so no other event is parsed in
        Python; else the backend's per-event fold."""
        from predictionio_tpu_torch.events.event import SPECIAL_EVENTS
        from predictionio_tpu_torch.store.columnar import fold_properties

        storage = storage or get_storage()
        native = PEventStore.native_batch(
            app_name, channel_name, list(SPECIAL_EVENTS), entity_type, start_time,
            until_time, storage)
        if native is not None and native.prop_columns is not None:
            return fold_properties(native)
        app_id, channel_id = _app_channel_ids(app_name, channel_name, storage)
        return storage.l_events.aggregate_properties(
            app_id,
            entity_type,
            channel_id=channel_id,
            start_time=start_time,
            until_time=until_time,
        )


class LEventStore:
    """Low-latency serving-time reads (reference: LEventStore.scala)."""

    @staticmethod
    def find_by_entity(
        app_name: str,
        entity_type: str,
        entity_id: str,
        channel_name: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Optional[str] = None,
        limit: Optional[int] = None,
        latest: bool = True,
        time_window: Optional[_dt.timedelta] = None,
        storage: Optional[Storage] = None,
    ) -> List[Event]:
        storage = storage or get_storage()
        app_id, channel_id = _app_channel_ids(app_name, channel_name, storage)
        start_time = None
        if time_window is not None:
            start_time = _dt.datetime.now(_dt.timezone.utc) - time_window
        return list(
            storage.l_events.find(
                app_id,
                channel_id=channel_id,
                entity_type=entity_type,
                entity_id=entity_id,
                event_names=event_names,
                target_entity_type=target_entity_type,
                limit=limit,
                reversed_order=latest,
                start_time=start_time,
            )
        )
