"""Serving-time event reads.

Counterpart of ``LEventStore.find_by_entity`` in
``predictionio_tpu/store/event_store.py`` (reference: LEventStore.scala),
over the port's in-memory store.  Channels, time windows, target filters
and the bulk ``PEventStore`` reads wait for the storage slice (ROADMAP.md,
queue A, "Storage and event store").
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from predictionio_tpu_torch.storage.memory import Event, get_storage


class LEventStore:
    """Low-latency serving-time reads."""

    @staticmethod
    def find_by_entity(
        app_name: str,
        entity_type: str,
        entity_id: str,
        event_names: Optional[Sequence[str]] = None,
        limit: Optional[int] = None,
        latest: bool = True,
    ) -> List[Event]:
        """The entity's events in the process-default store, newest first
        when ``latest``, at most ``limit``.  Raises ``ValueError`` for an
        unknown app."""
        storage = get_storage()
        app = storage.apps.get_by_name(app_name)
        if app is None:
            raise ValueError(f"app {app_name!r} does not exist; create it first")
        return list(storage.l_events.find(
            app.id, entity_type=entity_type, entity_id=entity_id,
            event_names=event_names, limit=limit, reversed_order=latest))
