"""In-memory event store: the part UR serving reads.

Counterpart of ``predictionio_tpu/storage/memory.py`` (``MemEvents``'
``insert``/``insert_batch``/``find`` and the app registry) and of the
``Event`` record of ``predictionio_tpu/events/event.py``, reduced to what a
query's history read needs.  ``find`` keeps the reference's semantics:
an app's events, filtered by entity and event name, sorted by (event time,
creation time) — newest first when ``reversed_order`` — then cut to
``limit``.  The file-backed stores, channels, time filters, deletes and the
delta-tail protocol wait for the storage slice (ROADMAP.md, queue A,
"Storage and event store").
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import threading
import uuid
from typing import Any, Dict, Iterator, List, Optional, Sequence


def _utcnow() -> _dt.datetime:
    return _dt.datetime.now(_dt.timezone.utc)


def parse_time(v) -> _dt.datetime:
    """datetime (naive = UTC), epoch seconds, or ISO-8601 → aware UTC."""
    if isinstance(v, _dt.datetime):
        return v if v.tzinfo else v.replace(tzinfo=_dt.timezone.utc)
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return _dt.datetime.fromtimestamp(float(v), _dt.timezone.utc)
    if isinstance(v, str):
        return parse_time(_dt.datetime.fromisoformat(v.replace("Z", "+00:00")))
    raise ValueError(f"not a time: {v!r}")


@dataclasses.dataclass
class Event:
    """One event (reference: Event.scala), as the JAX package's ``Event``."""

    event: str
    entity_type: str
    entity_id: str
    target_entity_type: Optional[str] = None
    target_entity_id: Optional[str] = None
    properties: Dict[str, Any] = dataclasses.field(default_factory=dict)
    event_time: _dt.datetime = dataclasses.field(default_factory=_utcnow)
    event_id: Optional[str] = None
    creation_time: _dt.datetime = dataclasses.field(default_factory=_utcnow)

    def __post_init__(self):
        self.event_time = parse_time(self.event_time)
        self.creation_time = parse_time(self.creation_time)
        if self.event_id is None:
            self.event_id = uuid.uuid4().hex
        if not self.event or not self.entity_type or not self.entity_id:
            raise ValueError("event, entityType and entityId must be non-empty")


@dataclasses.dataclass
class App:
    id: int
    name: str


class MemApps:
    """App registry: name → id."""

    def __init__(self):
        self._by_name: Dict[str, App] = {}
        self._lock = threading.Lock()

    def insert(self, name: str) -> int:
        with self._lock:
            if name in self._by_name:
                raise ValueError(f"app {name!r} already exists")
            app = App(len(self._by_name) + 1, name)
            self._by_name[name] = app
            return app.id

    def get_by_name(self, name: str) -> Optional[App]:
        return self._by_name.get(name)


class MemEvents:
    """Thread-safe in-memory events keyed by app id."""

    def __init__(self):
        self._events: Dict[int, Dict[str, Event]] = {}
        self._lock = threading.Lock()

    def insert(self, event: Event, app_id: int) -> str:
        with self._lock:
            self._events.setdefault(app_id, {})[event.event_id] = event
        return event.event_id

    def insert_batch(self, events: Sequence[Event], app_id: int) -> List[str]:
        return [self.insert(e, app_id) for e in events]

    def find(
        self,
        app_id: int,
        entity_type: Optional[str] = None,
        entity_id: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        limit: Optional[int] = None,
        reversed_order: bool = False,
    ) -> Iterator[Event]:
        """The reference's filter (``storage/base.py:match_filters``) on
        entity and event name, in time order, at most ``limit``."""
        with self._lock:
            events = list(self._events.get(app_id, {}).values())
        # a stable sort: equal times keep insertion order, also reversed
        events.sort(key=lambda e: (e.event_time, e.creation_time),
                    reverse=reversed_order)
        n = 0
        for e in events:
            if ((entity_type is not None and e.entity_type != entity_type)
                    or (entity_id is not None and e.entity_id != entity_id)
                    or (event_names is not None and e.event not in event_names)):
                continue
            if limit is not None and 0 <= limit <= n:
                return
            yield e
            n += 1


class MemStorage:
    """The apps and events repositories of one in-memory store."""

    def __init__(self):
        self.apps = MemApps()
        self.l_events = MemEvents()


_default: Optional[MemStorage] = None
_default_lock = threading.Lock()


def get_storage() -> MemStorage:
    """The process-default store (an empty one at first use)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = MemStorage()
        return _default


def set_storage(storage: Optional[MemStorage]) -> None:
    """Bind ``storage`` as the process default (None: a fresh one next)."""
    global _default
    with _default_lock:
        _default = storage
