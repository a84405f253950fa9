"""Canonical event model.

Counterpart of ``predictionio_tpu/events/event.py`` (a copy: the port
imports nothing of the JAX package), reference Event.scala, DataMap.scala,
PropertyMap.scala and LEventAggregator.scala:

- ``Event``: entityType/entityId, event verb, optional target entity,
  free-form JSON properties, eventTime, tags, prId, creationTime.
- Special verbs ``$set`` / ``$unset`` / ``$delete`` mutate an entity's
  property snapshot; ``aggregate_properties`` folds an event stream into
  per-entity ``PropertyMap`` snapshots as the reference's
  ``LEventAggregator.aggregateProperties`` does (applied in (event time,
  creation time) order, ``$delete`` clears the entity, first-set time
  kept).

Event ids come from a pool of random bytes (``_IdPool``), 32 hex
characters as ``uuid4().hex``.  ``Event.to_json_line``/``from_json`` are
the localfs segment line format, and ``canonical_event_json`` is the
import fast path: a wire dict validated and canonicalised without an
``Event``, whose line is byte-equal to the JAX package's for the same
dict.
"""

from __future__ import annotations

import datetime as _dt
import json
import os as _os
import threading as _threading
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, Mapping, Optional

SET_EVENT = "$set"
UNSET_EVENT = "$unset"
DELETE_EVENT = "$delete"
SPECIAL_EVENTS = frozenset({SET_EVENT, UNSET_EVENT, DELETE_EVENT})


class _IdPool:
    """Pooled 128-bit random event ids: one ``os.urandom`` call serves
    4,096 ids (a getrandom syscall per id is the largest per-event cost of
    ingest).  Lock-guarded, and discarded in a fork child, so two
    processes never hand out slices of one buffer."""

    _CHUNK = 16 * 4096

    def __init__(self):
        self._lock = _threading.Lock()
        self._buf = b""
        self._off = 0

    def reset(self) -> None:
        with self._lock:
            self._buf = b""
            self._off = 0

    def next_hex(self) -> str:
        with self._lock:
            if self._off + 16 > len(self._buf):
                self._buf = _os.urandom(self._CHUNK)
                self._off = 0
            out = self._buf[self._off:self._off + 16].hex()
            self._off += 16
            return out


_id_pool = _IdPool()
if hasattr(_os, "register_at_fork"):   # absent on non-POSIX
    _os.register_at_fork(after_in_child=_id_pool.reset)


def new_event_id() -> str:
    """A fresh 32-hex-char event id (uuid4-strength randomness, pooled)."""
    return _id_pool.next_hex()


def _utcnow() -> _dt.datetime:
    return _dt.datetime.now(_dt.timezone.utc)


def parse_time(value: Any) -> _dt.datetime:
    """Parse an ISO-8601 timestamp (the reference accepts joda ISO format),
    epoch seconds or a datetime (naive = UTC); None is now."""
    if value is None:
        return _utcnow()
    if isinstance(value, _dt.datetime):
        if value.tzinfo is None:
            return value.replace(tzinfo=_dt.timezone.utc)
        return value
    if isinstance(value, (int, float)):
        return _dt.datetime.fromtimestamp(value, _dt.timezone.utc)
    s = str(value)
    if s.endswith("Z"):
        s = s[:-1] + "+00:00"
    t = _dt.datetime.fromisoformat(s)
    if t.tzinfo is None:
        t = t.replace(tzinfo=_dt.timezone.utc)
    return t


class DataMap(dict):
    """JSON property bag with typed getters (reference: DataMap.scala).

    Behaves as a plain dict; ``get_as`` raises ``KeyError`` for missing
    required fields like the reference's ``DataMap.get[T]`` and returns the
    default for ``get_opt``-style access.
    """

    def get_as(self, key: str, typ: type) -> Any:
        if key not in self:
            raise KeyError(f"required property '{key}' missing from DataMap")
        v = self[key]
        if typ is float and isinstance(v, (int, float)):
            return float(v)
        if typ is int and isinstance(v, (int, float)) and float(v).is_integer():
            return int(v)
        if not isinstance(v, typ):
            raise TypeError(f"property '{key}'={v!r} is not of type {typ.__name__}")
        return v

    def get_opt(self, key: str, default: Any = None) -> Any:
        return self.get(key, default)


class PropertyMap(DataMap):
    """Entity property snapshot with lifecycle times (reference: PropertyMap.scala)."""

    def __init__(
        self,
        fields: Optional[Mapping[str, Any]] = None,
        first_updated: Optional[_dt.datetime] = None,
        last_updated: Optional[_dt.datetime] = None,
    ):
        super().__init__(fields or {})
        now = _utcnow()
        self.first_updated = first_updated or now
        self.last_updated = last_updated or now


@dataclass
class Event:
    """A single immutable event (reference: Event.scala)."""

    event: str
    entity_type: str
    entity_id: str
    target_entity_type: Optional[str] = None
    target_entity_id: Optional[str] = None
    properties: DataMap = field(default_factory=DataMap)
    event_time: _dt.datetime = field(default_factory=_utcnow)
    tags: tuple = ()
    pr_id: Optional[str] = None
    event_id: Optional[str] = None
    creation_time: _dt.datetime = field(default_factory=_utcnow)

    def __post_init__(self):
        if not isinstance(self.properties, DataMap):
            self.properties = DataMap(self.properties)
        self.event_time = parse_time(self.event_time)
        self.creation_time = parse_time(self.creation_time)
        if self.event_id is None:
            self.event_id = new_event_id()
        self._validate()

    def _validate(self):
        if not self.event or not isinstance(self.event, str):
            raise ValueError("event must be a non-empty string")
        if not isinstance(self.event_id, str):
            raise ValueError("eventId must be a string")
        if not self.entity_type or self.entity_id is None or self.entity_id == "":
            raise ValueError("entityType and entityId must be non-empty")
        if self.event in SPECIAL_EVENTS:
            # Reference EventValidation: special events must not carry targets.
            if self.target_entity_type or self.target_entity_id:
                raise ValueError(f"{self.event} must not have a target entity")
            if self.event == UNSET_EVENT and not self.properties:
                raise ValueError("$unset requires a non-empty properties map")
        if self.event.startswith("$") and self.event not in SPECIAL_EVENTS:
            raise ValueError(f"unsupported reserved event verb {self.event!r}")

    # -- JSON wire format (reference: EventJson4sSupport.scala) --------------

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "eventId": self.event_id,
            "event": self.event,
            "entityType": self.entity_type,
            "entityId": str(self.entity_id),
            "properties": dict(self.properties),
            "eventTime": self.event_time.isoformat(),
            "creationTime": self.creation_time.isoformat(),
        }
        if self.target_entity_type is not None:
            d["targetEntityType"] = self.target_entity_type
        if self.target_entity_id is not None:
            d["targetEntityId"] = str(self.target_entity_id)
        if self.tags:
            d["tags"] = list(self.tags)
        if self.pr_id is not None:
            d["prId"] = self.pr_id
        return d

    def to_json_line(self) -> str:
        """The event's localfs segment line (no newline)."""
        return json.dumps(self.to_json(), separators=(",", ":"), sort_keys=True)

    _WIRE_FIELDS = frozenset({
        "eventId", "event", "entityType", "entityId", "targetEntityType",
        "targetEntityId", "properties", "eventTime", "creationTime",
        "tags", "prId",
    })

    @classmethod
    def from_json(cls, d: Mapping[str, Any]) -> "Event":
        unknown = set(d) - cls._WIRE_FIELDS
        if unknown:
            raise ValueError(f"unknown event fields: {sorted(unknown)}")
        if d.get("entityId") is None:
            raise ValueError("entityType and entityId must be non-empty")
        props = d.get("properties") or {}
        if not isinstance(props, Mapping):
            raise ValueError("properties must be a JSON object")
        tei = d.get("targetEntityId")
        return cls(
            event=d["event"],
            entity_type=d["entityType"],
            entity_id=str(d["entityId"]),
            target_entity_type=d.get("targetEntityType"),
            target_entity_id=str(tei) if tei is not None else None,
            properties=DataMap(props),
            event_time=parse_time(d.get("eventTime")),
            tags=tuple(d.get("tags") or ()),
            pr_id=d.get("prId"),
            event_id=d.get("eventId"),
            creation_time=(parse_time(d["creationTime"]) if d.get("creationTime")
                           else _utcnow()),
        )


def aggregate_properties(events: Iterable[Event]) -> Dict[str, PropertyMap]:
    """Fold $set/$unset/$delete events into per-entity property snapshots.

    Reference: LEventAggregator.aggregateProperties — events are applied in
    (event time, creation time) order; ``$set`` merges keys, ``$unset``
    removes the named keys, ``$delete`` drops the entity snapshot entirely.
    """
    ordered = sorted(events, key=lambda e: (e.event_time, e.creation_time))
    snap: Dict[str, PropertyMap] = {}
    for e in ordered:
        if e.event not in SPECIAL_EVENTS:
            continue
        key = e.entity_id
        if e.event == DELETE_EVENT:
            snap.pop(key, None)
            continue
        cur = snap.get(key)
        if e.event == SET_EVENT:
            if cur is None:
                cur = PropertyMap({}, first_updated=e.event_time, last_updated=e.event_time)
                snap[key] = cur
            cur.update(e.properties)
            cur.last_updated = max(cur.last_updated, e.event_time)
        elif e.event == UNSET_EVENT:
            if cur is None:
                continue
            for k in e.properties:
                cur.pop(k, None)
            cur.last_updated = max(cur.last_updated, e.event_time)
    return snap


def canonical_event_json(d: Mapping[str, Any],
                         now_iso: Optional[str] = None) -> Dict[str, Any]:
    """Validate and canonicalise one wire-format event dict without building
    an ``Event`` (the import fast path).  The same fields, coercions and
    validation as ``Event.from_json`` followed by ``to_json``: for the same
    eventId and creationTime, ``json.dumps(out, separators=(",", ":"),
    sort_keys=True)`` equals ``Event.from_json(d).to_json_line()``.

    ``now_iso`` (one ``isoformat()`` of now) fills a missing eventTime or
    creationTime, so a batch shares one clock read.
    """
    unknown = set(d) - Event._WIRE_FIELDS
    if unknown:
        raise ValueError(f"unknown event fields: {sorted(unknown)}")
    try:
        event = d["event"]
        entity_type = d["entityType"]
        entity_id = d["entityId"]
    except KeyError as e:
        raise ValueError(f"missing required event field: {e}") from None
    if not event or not isinstance(event, str):
        raise ValueError("event must be a non-empty string")
    if not entity_type or entity_id is None or entity_id == "":
        raise ValueError("entityType and entityId must be non-empty")
    props = d.get("properties") or {}
    if type(props) is not dict and not isinstance(props, Mapping):
        raise ValueError("properties must be a JSON object")
    tet = d.get("targetEntityType")
    tei = d.get("targetEntityId")
    # coerced before the special-event check, as from_json does: a target
    # id 0 becomes "0", which a $set must not carry
    tei_s = str(tei) if tei is not None else None
    if event in SPECIAL_EVENTS:
        if tet or tei_s:
            raise ValueError(f"{event} must not have a target entity")
        if event == UNSET_EVENT and not props:
            raise ValueError("$unset requires a non-empty properties map")
    if event.startswith("$") and event not in SPECIAL_EVENTS:
        raise ValueError(f"unsupported reserved event verb {event!r}")
    eid = d.get("eventId")
    if eid is not None and not isinstance(eid, str):
        raise ValueError("eventId must be a string")
    if now_iso is None:
        now_iso = _utcnow().isoformat()
    out: Dict[str, Any] = {
        # `is None`, as Event.__post_init__: an empty-string id is kept
        "eventId": eid if eid is not None else new_event_id(),
        "event": event,
        "entityType": entity_type,
        "entityId": str(entity_id),
        "properties": dict(props),
        "eventTime": (parse_time(d["eventTime"]).isoformat()
                      if d.get("eventTime") is not None else now_iso),
        "creationTime": (parse_time(d["creationTime"]).isoformat()
                         if d.get("creationTime") else now_iso),
    }
    if tet is not None:
        out["targetEntityType"] = tet
    if tei is not None:
        out["targetEntityId"] = tei_s
    if d.get("tags"):
        out["tags"] = list(d["tags"])
    if d.get("prId") is not None:
        out["prId"] = d["prId"]
    return out
