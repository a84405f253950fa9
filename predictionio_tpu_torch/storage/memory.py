"""In-memory storage backend (test/dev analogue of the reference's embedded
backends used by LEventsSpec/PEventsSpec).

Counterpart of ``predictionio_tpu/storage/memory.py``: apps, access keys,
channels, engine instances and manifests, evaluation instances, model
blobs and events, with the JAX package's API: a complete source.
``MemEvents.find`` keeps the reference's semantics: an app's (and
channel's) events matching the filters, sorted by (event time, creation
time) — newest first when ``reversed_order`` — then cut to ``limit``.  It
filters before it sorts: a stable sort and a filter commute, so the order
is the reference's and only the matching events are sorted.

Deletes are in place, so ``compact`` is only the TTL trim.  ``MemEvents``
implements the delta-tail protocol (``scan_tail_from``,
``scan_events_up_to``, ``tombstone_state``) over a bucket's insertion
order, as the JAX package does: the watermark is the consumed event count
(``{"mem": n}``) and ``heads`` carries the bucket's generation.  A delete,
a ``remove``, a TTL trim or an overwrite of an existing id changes the
bucket in place and bumps its generation, which invalidates every
outstanding watermark (the holder restages, as after a compacted log).
"""

from __future__ import annotations

import datetime as _dt
import threading
import uuid
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from predictionio_tpu_torch.events.event import Event, parse_time  # noqa: F401
from predictionio_tpu_torch.storage import base
from predictionio_tpu_torch.storage.base import (
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EngineManifest,
    EvaluationInstance,
)


class MemApps(base.Apps):
    def __init__(self):
        self._apps: Dict[int, App] = {}
        self._next = 1
        self._lock = threading.Lock()

    def insert(self, app: App) -> Optional[int]:
        with self._lock:
            if any(a.name == app.name for a in self._apps.values()):
                return None
            if app.id in self._apps or app.id <= 0:
                app.id = self._next
            self._next = max(self._next, app.id) + 1
            self._apps[app.id] = app
            return app.id

    def get(self, app_id: int) -> Optional[App]:
        return self._apps.get(app_id)

    def get_by_name(self, name: str) -> Optional[App]:
        return next((a for a in self._apps.values() if a.name == name), None)

    def get_all(self) -> List[App]:
        return list(self._apps.values())

    def update(self, app: App) -> bool:
        if app.id not in self._apps:
            return False
        self._apps[app.id] = app
        return True

    def delete(self, app_id: int) -> bool:
        return self._apps.pop(app_id, None) is not None


class MemAccessKeys(base.AccessKeys):
    def __init__(self):
        self._keys: Dict[str, AccessKey] = {}

    def insert(self, access_key: AccessKey) -> Optional[str]:
        if not access_key.key:
            access_key.key = AccessKey.generate()
        self._keys[access_key.key] = access_key
        return access_key.key

    def get(self, key: str) -> Optional[AccessKey]:
        return self._keys.get(key)

    def get_by_app_id(self, app_id: int) -> List[AccessKey]:
        return [k for k in self._keys.values() if k.app_id == app_id]

    def delete(self, key: str) -> bool:
        return self._keys.pop(key, None) is not None


class MemChannels(base.Channels):
    def __init__(self):
        self._channels: Dict[int, Channel] = {}
        self._next = 1

    def insert(self, channel: Channel) -> Optional[int]:
        if any(c.name == channel.name and c.app_id == channel.app_id
               for c in self._channels.values()):
            return None
        channel.id = self._next
        self._next += 1
        self._channels[channel.id] = channel
        return channel.id

    def get(self, channel_id: int) -> Optional[Channel]:
        return self._channels.get(channel_id)

    def get_by_app_id(self, app_id: int) -> List[Channel]:
        return [c for c in self._channels.values() if c.app_id == app_id]

    def delete(self, channel_id: int) -> bool:
        return self._channels.pop(channel_id, None) is not None


class MemEngineInstances(base.EngineInstances):
    def __init__(self):
        self._instances: Dict[str, EngineInstance] = {}

    def insert(self, instance: EngineInstance) -> str:
        if not instance.id:
            instance.id = uuid.uuid4().hex
        self._instances[instance.id] = instance
        return instance.id

    def get(self, instance_id: str) -> Optional[EngineInstance]:
        return self._instances.get(instance_id)

    def update(self, instance: EngineInstance) -> bool:
        if instance.id not in self._instances:
            return False
        self._instances[instance.id] = instance
        return True

    def get_all(self) -> List[EngineInstance]:
        return list(self._instances.values())

    def delete(self, instance_id: str) -> bool:
        return self._instances.pop(instance_id, None) is not None


class MemEngineManifests(base.EngineManifests):
    def __init__(self):
        self._manifests: Dict[Tuple[str, str], EngineManifest] = {}

    def insert(self, manifest: EngineManifest) -> None:
        self._manifests[(manifest.id, manifest.version)] = manifest

    def get(self, manifest_id: str, version: str) -> Optional[EngineManifest]:
        return self._manifests.get((manifest_id, version))

    def get_all(self) -> List[EngineManifest]:
        return list(self._manifests.values())

    def delete(self, manifest_id: str, version: str) -> bool:
        return self._manifests.pop((manifest_id, version), None) is not None


class MemEvaluationInstances(base.EvaluationInstances):
    def __init__(self):
        self._instances: Dict[str, EvaluationInstance] = {}

    def insert(self, instance: EvaluationInstance) -> str:
        if not instance.id:
            instance.id = uuid.uuid4().hex
        self._instances[instance.id] = instance
        return instance.id

    def get(self, instance_id: str) -> Optional[EvaluationInstance]:
        return self._instances.get(instance_id)

    def update(self, instance: EvaluationInstance) -> bool:
        if instance.id not in self._instances:
            return False
        self._instances[instance.id] = instance
        return True

    def get_completed(self) -> List[EvaluationInstance]:
        return [i for i in self._instances.values() if i.status == "EVALCOMPLETED"]


class MemModels(base.Models):
    def __init__(self):
        self._blobs: Dict[str, bytes] = {}

    def insert(self, instance_id: str, blob: bytes) -> None:
        self._blobs[instance_id] = blob

    def get(self, instance_id: str) -> Optional[bytes]:
        return self._blobs.get(instance_id)

    def delete(self, instance_id: str) -> bool:
        return self._blobs.pop(instance_id, None) is not None


class MemEvents(base.LEvents, base.PEvents):
    """Thread-safe in-memory event store keyed by (app_id, channel_id),
    with the delta-tail protocol over each bucket's insertion order."""

    def __init__(self):
        self._events: Dict[Tuple[int, Optional[int]], Dict[str, Event]] = {}
        self._gens: Dict[Tuple[int, Optional[int]], int] = {}
        self._lock = threading.Lock()

    def _bucket(self, app_id: int, channel_id: Optional[int]) -> Dict[str, Event]:
        with self._lock:
            return self._events.setdefault((app_id, channel_id), {})

    def _bump_locked(self, key: Tuple[int, Optional[int]]) -> None:
        """An in-place change of a bucket's prefix (delete, remove, trim,
        overwrite): outstanding count watermarks no longer describe it."""
        self._gens[key] = self._gens.get(key, 0) + 1

    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        self._bucket(app_id, channel_id)
        return True

    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        with self._lock:
            key = (app_id, channel_id)
            self._bump_locked(key)
            removed = self._events.pop(key, None) is not None
        if removed:
            base.notify_append(None)   # bucket gone: invalidate everything
        return removed

    def compact(self, app_id: int, channel_id: Optional[int] = None,
                before=None) -> Dict[str, int]:
        """The TTL trim: drop events older than ``before`` (deletes are
        already in place); the same result keys as the segment backends'."""
        bucket = self._bucket(app_id, channel_id)
        with self._lock:
            doomed = []
            if before is not None:
                before = parse_time(before)
                doomed = [k for k, e in bucket.items() if e.event_time < before]
            for k in doomed:
                del bucket[k]
            if doomed:
                self._bump_locked((app_id, channel_id))
            out = {"kept": len(bucket), "expired": len(doomed), "segments": 0}
        if doomed:
            base.notify_append(None)   # TTL trim: invalidate everything
        return out

    def insert(self, event: Event, app_id: int, channel_id: Optional[int] = None) -> str:
        return self.insert_batch([event], app_id, channel_id)[0]

    def insert_batch(self, events: Sequence[Event], app_id: int,
                     channel_id: Optional[int] = None) -> List[str]:
        """``insert`` of each event in order, under one lock acquisition.
        Overwriting an existing id moves neither the count watermark nor
        the bucket's length, so it bumps the generation."""
        bucket = self._bucket(app_id, channel_id)
        with self._lock:
            overwrote = False
            for e in events:
                overwrote = overwrote or e.event_id in bucket
                bucket[e.event_id] = e
            if overwrote:
                self._bump_locked((app_id, channel_id))
        base.notify_append([(e.entity_type, e.entity_id) for e in events])
        return [e.event_id for e in events]

    def get(self, event_id: str, app_id: int, channel_id: Optional[int] = None) -> Optional[Event]:
        return self._bucket(app_id, channel_id).get(event_id)

    def delete(self, event_id: str, app_id: int, channel_id: Optional[int] = None) -> bool:
        bucket = self._bucket(app_id, channel_id)
        with self._lock:
            ok = bucket.pop(event_id, None) is not None
            if ok:
                self._bump_locked((app_id, channel_id))
        if ok:
            base.notify_append(None)   # entity unknown: invalidate all
        return ok

    # -- delta-tail protocol (count watermark + generation in heads) ---------

    def tombstone_state(self, app_id: int, channel_id: Optional[int] = None) -> frozenset:
        """Deletes are in place (no tombstones): the generation in the
        watermark's heads invalidates instead, so this is always empty."""
        return frozenset()

    def _tail_state(self, app_id: int, channel_id: Optional[int]):
        with self._lock:
            bucket = self._events.get((app_id, channel_id), {})
            return list(bucket.values()), self._gens.get((app_id, channel_id), 0)

    @staticmethod
    def _columnar(events: List[Event], base_batch=None):
        """Events → (EventBatch with property columns, EventIdColumn)
        through the snapshot tail parser's builder (the fold reads the
        property columns).  With ``base_batch`` the codes are assigned in
        its dictionaries, which grow in place (the ``scan_tail_from``
        contract)."""
        from predictionio_tpu_torch.storage.snapshot import ColumnarBuilder

        b = ColumnarBuilder(base=base_batch)
        for e in events:
            b.add(e.to_json())
        return b.finish()

    @staticmethod
    def _generation_ok(heads: Optional[Dict], gen: int) -> bool:
        return heads is None or (heads.get("mem") or {}).get("gen", 0) == gen

    def scan_tail_from(self, app_id: int, channel_id: Optional[int],
                       watermark: Dict[str, int], base=None,
                       heads: Optional[Dict] = None) -> Optional[Dict]:
        """The events past the count watermark, or None (restage) when the
        bucket changed in place since the watermark was taken."""
        events, gen = self._tail_state(app_id, channel_id)
        start = int(watermark.get("mem", 0))
        if not self._generation_ok(heads, gen) or start > len(events):
            return None
        batch, ids = self._columnar(events[start:], base_batch=base)
        return {"batch": batch, "ids": ids, "events": len(events) - start,
                "watermark": {"mem": len(events)}, "heads": {"mem": {"gen": gen}}}

    def scan_events_up_to(self, app_id: int, channel_id: Optional[int],
                          watermark: Dict[str, int],
                          heads: Optional[Dict] = None) -> Optional[Dict]:
        """The covered prefix a persisted watermark describes (a restarted
        follower's read), or None when the bucket changed since."""
        events, gen = self._tail_state(app_id, channel_id)
        end = int(watermark.get("mem", 0))
        if not self._generation_ok(heads, gen) or end > len(events):
            return None
        batch, _ = self._columnar(events[:end])
        return {"batch": batch, "events": end}

    def find(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        entity_id: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Optional[str] = None,
        target_entity_id: Optional[str] = None,
        limit: Optional[int] = None,
        reversed_order: bool = False,
    ) -> Iterator[Event]:
        with self._lock:
            events = list(self._events.get((app_id, channel_id), {}).values())
        events = [e for e in events if base.match_filters(
            e, start_time, until_time, entity_type, entity_id,
            event_names, target_entity_type, target_entity_id)]
        # a stable sort: equal times keep insertion order, also reversed
        events.sort(key=lambda e: (e.event_time, e.creation_time),
                    reverse=reversed_order)
        if limit is not None and limit >= 0:
            events = events[:limit]
        return iter(events)
