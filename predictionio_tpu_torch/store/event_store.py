"""Template-facing event read API.

Counterpart of ``predictionio_tpu/store/event_store.py`` (reference:
data/src/main/scala/io/prediction/data/store/{PEventStore,LEventStore,
Common}.scala): ``PEventStore`` for training reads (columnar here) and
``LEventStore`` for low-latency serving-time reads (the Universal
Recommender fetching a user's recent history inside ``predict``).  App
names are resolved to ids through the metadata store, exactly like the
reference's ``Common.appNameToId``.

On a segment-file backend (localfs) ``PEventStore.batch`` and
``native_batch`` parse the segments with the native scanner and filter the
columns (``apply_filters``), as the JAX package does.  A backend without
segments (``memory``), a log with tombstones, or a host without a C++
compiler reads the rows in Python instead: the JAX package's own branch
for such a store.  The JAX package's retained-batch cache and columnar
snapshots wait for ROADMAP.md, queue A, 'Columnar snapshots and the staged
cache'.
"""

from __future__ import annotations

import datetime as _dt
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

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


def apply_filters(batch: EventBatch,
                  event_names: Optional[Sequence[str]] = None,
                  entity_type: Optional[str] = None,
                  start_time: Optional[_dt.datetime] = None,
                  until_time: Optional[_dt.datetime] = None) -> EventBatch:
    """The scan filters on columns (``storage.base.match_filters``'s
    semantics for these four)."""
    mask = np.ones(len(batch), bool)
    if event_names is not None:
        codes = [batch.event_dict.id(n) for n in event_names]
        codes = [c for c in codes if c is not None]
        mask &= np.isin(batch.event_codes, np.asarray(codes, np.int32))
    if entity_type is not None:
        c = batch.entity_type_dict.id(entity_type)
        mask &= batch.entity_type_codes == (c if c is not None else -2)
    if start_time is not None:
        mask &= batch.times_us >= int(start_time.timestamp() * 1e6)
    if until_time is not None:
        mask &= batch.times_us < int(until_time.timestamp() * 1e6)
    return batch.subset(mask) if not mask.all() else batch


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
    ) -> EventBatch:
        """Read matching events as ONE columnar batch (the device-staging
        format): the native scan's, in log order, on a segment backend,
        else the backend's ``find`` order.  The JAX package's
        ``local_shard`` (multi-host reads) waits for ROADMAP.md, queue A,
        'parallel → torch.distributed'."""
        storage = storage or get_storage()
        native = PEventStore.native_batch(
            app_name, channel_name, event_names, entity_type, start_time,
            until_time, storage)
        if native is not None:
            return native
        return EventBatch.from_events(list(PEventStore.find(
            app_name,
            channel_name=channel_name,
            event_names=event_names,
            entity_type=entity_type,
            start_time=start_time,
            until_time=until_time,
            storage=storage,
        )))

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
        backend's native scan, or None where there is none: a backend
        without segments, no C++ compiler, or a tombstone in the log (the
        scanner cannot see deletes).  Callers that need properties pick
        their read with it, before any row read."""
        from predictionio_tpu_torch.native import native_available, scan_segments

        storage = storage or get_storage()
        backend = storage.p_events
        if not hasattr(backend, "segment_paths"):
            return None
        app_id, channel_id = _app_channel_ids(app_name, channel_name, storage)
        if not native_available():
            return None
        paths = backend.segment_paths(app_id, channel_id)
        if not paths:
            return EventBatch.from_events([])
        if any(t.stat().st_size > 0 for parent in {p.parent for p in paths}
               for t in parent.glob("tombstones*.txt")):
            return None
        return apply_filters(scan_segments(paths), event_names=event_names,
                             entity_type=entity_type, start_time=start_time,
                             until_time=until_time)

    @staticmethod
    def aggregate_properties(
        app_name: str,
        entity_type: str,
        channel_name: Optional[str] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        storage: Optional[Storage] = None,
    ) -> Dict[str, PropertyMap]:
        storage = storage or get_storage()
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
