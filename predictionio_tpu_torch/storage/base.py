"""Storage interfaces (reference: data/src/main/scala/io/prediction/data/storage/).

Counterpart of ``predictionio_tpu/storage/base.py`` (a copy: the port
imports nothing of the JAX package).  The reference defines repository
interfaces — ``LEvents``, ``PEvents``, ``Models``, ``EngineInstances``,
``Apps``, ``Channels`` — each implemented by backends and located via
``Storage.scala`` from ``PIO_STORAGE_*`` env config; here they are Python
ABCs with the JAX package's signatures, access keys, engine manifests
and evaluation instances included (the ``pio`` CLI reads and writes them).

``PEvents`` has the JAX package's columnar hooks: ``snapshot_scan`` and
``snapshot_status`` (None: no snapshot, the default) and ``find_batches``,
which a segment backend with snapshots overrides.  The append-listener
bus (``add_append_listener``, ``notify_append``) tells in-process
subscribers — the serving history cache, ``serve/history_cache.py`` —
which entities an event-log mutation touched.  ``delta_tail_supported``
and ``require_delta_tail`` check an event backend for the delta-tail
protocol (``scan_tail_from``, ``scan_events_up_to``, ``tombstone_state``)
that the follow-trainer's fold mode needs; ``StoreCapabilityError`` names
the backend and the missing capability.
"""

from __future__ import annotations

import abc
import datetime as _dt
import secrets
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Sequence

from predictionio_tpu_torch.events.event import Event, PropertyMap, aggregate_properties


# ---------------------------------------------------------------------------
# Metadata records (reference: Apps.scala, Channels.scala, EngineInstances.scala)
# ---------------------------------------------------------------------------


@dataclass
class App:
    id: int
    name: str
    description: str = ""


@dataclass
class AccessKey:
    key: str
    app_id: int
    events: List[str] = field(default_factory=list)  # empty = all events allowed

    @staticmethod
    def generate() -> str:
        return secrets.token_urlsafe(32)


@dataclass
class Channel:
    id: int
    name: str
    app_id: int


@dataclass
class EngineInstance:
    id: str
    status: str  # INIT | TRAINING | COMPLETED | FAILED
    start_time: _dt.datetime
    end_time: Optional[_dt.datetime]
    engine_id: str
    engine_version: str
    engine_variant: str
    engine_factory: str
    env: Dict[str, str] = field(default_factory=dict)
    spark_conf: Dict[str, str] = field(default_factory=dict)  # kept for config parity
    data_source_params: str = "{}"
    preparator_params: str = "{}"
    algorithms_params: str = "[]"
    serving_params: str = "{}"


@dataclass
class EngineManifest:
    """Registered engine build (reference: EngineManifest.scala), written by
    ``pio build``; train and deploy resolve an engine.json through it when
    the ``--engine-json`` path does not exist.  ``files`` holds the
    engine.json path."""

    id: str
    version: str
    name: str
    description: str = ""
    files: List[str] = field(default_factory=list)
    engine_factory: str = ""


@dataclass
class EvaluationInstance:
    id: str
    status: str
    start_time: _dt.datetime
    end_time: Optional[_dt.datetime]
    evaluation_class: str
    engine_params_generator_class: str = ""
    env: Dict[str, str] = field(default_factory=dict)
    evaluator_results: str = ""
    evaluator_results_html: str = ""
    evaluator_results_json: str = ""


# ---------------------------------------------------------------------------
# Repository interfaces
# ---------------------------------------------------------------------------


# -- append listeners ---------------------------------------------------------
# In-process subscribers to event-log mutations (the serving history cache
# invalidates through this).  A listener is called with a list of
# (entity_type, entity_id) pairs just appended, or None when the mutation's
# entities are unknown or everything may have changed (event delete,
# channel remove, TTL trim, a new default storage).  Listener exceptions
# never fail a write.  The scope is this process, as the caches' is.
_APPEND_LISTENERS: List[Any] = []


def add_append_listener(fn) -> None:
    """Subscribe ``fn(entities: Optional[List[tuple]])`` to event-log
    mutations in this process (idempotent per function)."""
    if fn not in _APPEND_LISTENERS:
        _APPEND_LISTENERS.append(fn)


def notify_append(entities: Optional[List[tuple]]) -> None:
    """Called by event backends after a durable mutation; ``entities`` is
    the appended (entity_type, entity_id) pairs, or None when unknown."""
    for fn in list(_APPEND_LISTENERS):
        try:
            fn(entities)
        except Exception:
            import logging
            logging.getLogger("pio.storage").exception("append listener failed")


class Apps(abc.ABC):
    @abc.abstractmethod
    def insert(self, app: App) -> Optional[int]: ...

    @abc.abstractmethod
    def get(self, app_id: int) -> Optional[App]: ...

    @abc.abstractmethod
    def get_by_name(self, name: str) -> Optional[App]: ...

    @abc.abstractmethod
    def get_all(self) -> List[App]: ...

    @abc.abstractmethod
    def update(self, app: App) -> bool: ...

    @abc.abstractmethod
    def delete(self, app_id: int) -> bool: ...


class AccessKeys(abc.ABC):
    @abc.abstractmethod
    def insert(self, access_key: AccessKey) -> Optional[str]: ...

    @abc.abstractmethod
    def get(self, key: str) -> Optional[AccessKey]: ...

    @abc.abstractmethod
    def get_by_app_id(self, app_id: int) -> List[AccessKey]: ...

    @abc.abstractmethod
    def delete(self, key: str) -> bool: ...


class Channels(abc.ABC):
    @abc.abstractmethod
    def insert(self, channel: Channel) -> Optional[int]: ...

    @abc.abstractmethod
    def get(self, channel_id: int) -> Optional[Channel]: ...

    @abc.abstractmethod
    def get_by_app_id(self, app_id: int) -> List[Channel]: ...

    @abc.abstractmethod
    def delete(self, channel_id: int) -> bool: ...


class EngineInstances(abc.ABC):
    @abc.abstractmethod
    def insert(self, instance: EngineInstance) -> str: ...

    @abc.abstractmethod
    def get(self, instance_id: str) -> Optional[EngineInstance]: ...

    @abc.abstractmethod
    def update(self, instance: EngineInstance) -> bool: ...

    @abc.abstractmethod
    def get_all(self) -> List[EngineInstance]: ...

    def get_latest_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> Optional[EngineInstance]:
        """Latest COMPLETED instance for an engine triple (reference:
        EngineInstances.getLatestCompleted) — what `pio deploy` binds to."""
        candidates = [
            i
            for i in self.get_all()
            if i.status == "COMPLETED"
            and i.engine_id == engine_id
            and i.engine_version == engine_version
            and i.engine_variant == engine_variant
        ]
        if not candidates:
            return None
        return max(candidates, key=lambda i: i.start_time)

    @abc.abstractmethod
    def delete(self, instance_id: str) -> bool: ...


class EngineManifests(abc.ABC):
    """Engine manifests keyed by (id, version), upserted by ``pio build``
    (reference: EngineManifests.scala)."""

    @abc.abstractmethod
    def insert(self, manifest: EngineManifest) -> None: ...

    @abc.abstractmethod
    def get(self, manifest_id: str, version: str) -> Optional[EngineManifest]: ...

    @abc.abstractmethod
    def get_all(self) -> List[EngineManifest]: ...

    def update(self, manifest: EngineManifest) -> None:
        self.insert(manifest)

    @abc.abstractmethod
    def delete(self, manifest_id: str, version: str) -> bool: ...


class EvaluationInstances(abc.ABC):
    @abc.abstractmethod
    def insert(self, instance: EvaluationInstance) -> str: ...

    @abc.abstractmethod
    def get(self, instance_id: str) -> Optional[EvaluationInstance]: ...

    @abc.abstractmethod
    def update(self, instance: EvaluationInstance) -> bool: ...

    @abc.abstractmethod
    def get_completed(self) -> List[EvaluationInstance]: ...


class Models(abc.ABC):
    """Serialized model blobs keyed by engine-instance id (reference: Models.scala)."""

    @abc.abstractmethod
    def insert(self, instance_id: str, blob: bytes) -> None: ...

    @abc.abstractmethod
    def get(self, instance_id: str) -> Optional[bytes]: ...

    @abc.abstractmethod
    def delete(self, instance_id: str) -> bool: ...


# ---------------------------------------------------------------------------
# Event repositories
# ---------------------------------------------------------------------------


class LEvents(abc.ABC):
    """Serving/ingest-time event CRUD (reference: LEvents.scala), with
    synchronous ops."""

    @abc.abstractmethod
    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool: ...

    @abc.abstractmethod
    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool: ...

    @abc.abstractmethod
    def insert(self, event: Event, app_id: int, channel_id: Optional[int] = None) -> str: ...

    def insert_batch(
        self, events: Sequence[Event], app_id: int, channel_id: Optional[int] = None
    ) -> List[str]:
        return [self.insert(e, app_id, channel_id) for e in events]

    def insert_json_batch(
        self, items: Sequence, app_id: int, channel_id: Optional[int] = None
    ) -> List[dict]:
        """Insert wire-format dicts with a status each, in order:
        ``{"status": 201, "eventId": ...}`` or ``{"status": 400,
        "message": ...}``.  The valid items go in as one backend batch even
        when others fail validation.  A segment backend overrides this to
        write lines without building ``Event`` objects (localfs)."""
        results: List[Optional[dict]] = []
        valid: List[Event] = []
        for item in items:
            try:
                valid.append(Event.from_json(item))
                results.append(None)   # the eventId is filled in below
            except (ValueError, KeyError, TypeError) as e:
                results.append({"status": 400, "message": str(e)})
        ids = iter(self.insert_batch(valid, app_id, channel_id) if valid else [])
        return [r if r is not None else {"status": 201, "eventId": next(ids)}
                for r in results]

    @abc.abstractmethod
    def get(self, event_id: str, app_id: int, channel_id: Optional[int] = None) -> Optional[Event]: ...

    @abc.abstractmethod
    def delete(self, event_id: str, app_id: int, channel_id: Optional[int] = None) -> bool: ...

    @abc.abstractmethod
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
    ) -> Iterator[Event]: ...

    def aggregate_properties(
        self,
        app_id: int,
        entity_type: str,
        channel_id: Optional[int] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
    ) -> Dict[str, PropertyMap]:
        evs = self.find(
            app_id,
            channel_id=channel_id,
            start_time=start_time,
            until_time=until_time,
            entity_type=entity_type,
        )
        return aggregate_properties(evs)


def match_filters(
    e: Event,
    start_time: Optional[_dt.datetime] = None,
    until_time: Optional[_dt.datetime] = None,
    entity_type: Optional[str] = None,
    entity_id: Optional[str] = None,
    event_names: Optional[Sequence[str]] = None,
    target_entity_type: Optional[str] = None,
    target_entity_id: Optional[str] = None,
) -> bool:
    """Shared event-filter predicate used by all backends (reference semantics
    of HBEventsUtil.createScan's column filters)."""
    if start_time is not None and e.event_time < start_time:
        return False
    if until_time is not None and e.event_time >= until_time:
        return False
    if entity_type is not None and e.entity_type != entity_type:
        return False
    if entity_id is not None and e.entity_id != entity_id:
        return False
    if event_names is not None and e.event not in event_names:
        return False
    if target_entity_type is not None and e.target_entity_type != target_entity_type:
        return False
    if target_entity_id is not None and e.target_entity_id != target_entity_id:
        return False
    return True


class StoreCapabilityError(NotImplementedError):
    """An event backend was asked for an optional capability it does not
    provide (the ``scan_tail_from``/``scan_events_up_to`` delta-tail
    protocol of ``pio deploy --follow`` and delta staging), with a message
    naming the backend and the capability."""


def delta_tail_supported(backend) -> bool:
    """True when ``backend`` implements the delta-tail protocol
    (``scan_tail_from`` + ``scan_events_up_to`` + ``tombstone_state``):
    the capability the follow-trainer's fold mode requires.  The memory,
    localfs, sharedfs and sharded backends implement it; sql does not."""
    return all(
        callable(getattr(backend, name, None))
        for name in ("scan_tail_from", "scan_events_up_to", "tombstone_state"))


def require_delta_tail(backend, what: str) -> None:
    """Raise :class:`StoreCapabilityError` when ``backend`` lacks the
    delta-tail protocol."""
    if not delta_tail_supported(backend):
        raise StoreCapabilityError(
            f"{what} requires the event backend to support the delta-tail "
            f"protocol (scan_tail_from/scan_events_up_to/tombstone_state), "
            f"but {type(backend).__module__}.{type(backend).__name__} does "
            "not provide it; use a localfs, sharedfs, sharded, or memory "
            "event store, or implement the protocol on the backend")


class PEvents(abc.ABC):
    """Bulk training-time reads (reference: PEvents.scala returns
    RDD[Event]; here an event iterator that ``PEventStore.batch`` turns
    into one columnar ``EventBatch``, unless a segment backend's native
    scan serves the batch)."""

    @abc.abstractmethod
    def find(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Optional[str] = None,
    ) -> Iterator[Event]: ...

    def scan(self, app_id: int, **filters: Any) -> Iterator[Event]:
        """Unordered bulk scan; the training read never needs time order."""
        return self.find(app_id, **filters)

    # -- columnar snapshots (optional per backend) -----------------------------
    # A segment backend (localfs) persists columnar snapshots of its log and
    # serves find_batches from them; these defaults say "no snapshot".

    def snapshot_scan(self, app_id: int, channel_id: Optional[int] = None) -> Optional[Dict]:
        """{"batch", "ids", "watermark", ...} from a columnar snapshot and
        its tail, or None where the backend has none (the default)."""
        return None

    def snapshot_status(self, app_id: int, channel_id: Optional[int] = None) -> Optional[Dict]:
        """Coverage summary, or None without snapshots."""
        return None

    def find_batches(self, app_id: int, batch_size: int = 1 << 20,
                     **filters: Any) -> Iterator["EventBatch"]:  # noqa: F821
        """Columnar batches for training reads, ``batch_size`` events each
        through ``scan``; a backend with snapshots serves one batch."""
        from predictionio_tpu_torch.store.columnar import EventBatch

        buf: List[Event] = []
        for e in self.scan(app_id, **filters):
            buf.append(e)
            if len(buf) >= batch_size:
                yield EventBatch.from_events(buf)
                buf = []
        if buf:
            yield EventBatch.from_events(buf)
