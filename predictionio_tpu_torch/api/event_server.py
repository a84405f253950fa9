"""Event Server — REST ingestion (``pio eventserver``).

Counterpart of ``predictionio_tpu/api/event_server.py`` (reference:
data/src/main/scala/io/prediction/data/api/EventServer.scala).  The
event server has no device.  The JAX package's trace, lineage, history
and healthz routes wait for ROADMAP.md, queue A, 'Observability and the
rest of the front end', and answer 404 here.

  POST   /events.json?accessKey=K[&channel=C]         single event  → 201
  POST   /batch/events.json?accessKey=K               ≤50 events, per-item status
  GET    /events.json?accessKey=K&...filters           query events
  GET    /events/<id>.json?accessKey=K                 fetch one
  DELETE /events/<id>.json?accessKey=K                 tombstone one
  GET    /                                             {"status": "alive", pid, version, workerTag}
  GET    /stats.json?accessKey=K                       per-app event counts + window stats + snapshot coverage
  GET    /metrics                                      Prometheus text (cross-worker aggregate)

Auth matches the reference: the access key names the app; a key with a
non-empty ``events`` list may only write those event types; channels resolve
by name per app.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from predictionio_tpu_torch import __version__
from predictionio_tpu_torch.api.http_util import JsonHandler, start_server
from predictionio_tpu_torch.events.event import Event, parse_time
from predictionio_tpu_torch.obs import metrics as obs_metrics
from predictionio_tpu_torch.obs.exposition import StatsCollector, metrics_payload
from predictionio_tpu_torch.storage.base import AccessKey
from predictionio_tpu_torch.storage.locator import Storage, get_storage

log = logging.getLogger("pio.eventserver")

_M_INGESTED = obs_metrics.get_registry().counter(
    "pio_events_ingested_total",
    "Events accepted (HTTP 201 / per-item 201) by app and event name")

MAX_BATCH = 50  # reference: EventServer batch limit


def _max_batch() -> int:
    """Batch-size cap: PIO_MAX_BATCH (default 50 for reference parity).

    Raising it lets high-volume importers amortize per-request HTTP cost
    over bigger group-committed appends; the request body is bounded by
    the cap × event size and buffered by the event loop before dispatch,
    so keep it comfortably under PIO_HTTP_MAX_BODY (default 64 MiB; a
    10k-event batch is ~2 MB)."""
    raw = os.environ.get("PIO_MAX_BATCH")
    if raw is None:
        return MAX_BATCH
    try:
        n = int(raw)
        if n > 0:
            return n
    except ValueError:
        pass
    # a typo'd cap silently falling back would surface only as runtime
    # 400s on big batches — say what was discarded, loudly, at startup
    log.warning("ignoring invalid PIO_MAX_BATCH=%r; using %d", raw, MAX_BATCH)
    return MAX_BATCH


class EventServerState:
    def __init__(self, storage: Optional[Storage] = None,
                 stats: Optional[bool] = None):
        self.storage = storage or get_storage()
        # stats ride the same kill switch as the metrics registry:
        # PIO_METRICS=off disables both, and /stats.json then answers 503
        # (service disabled) instead of serving frozen counters
        if stats is None:
            stats = obs_metrics.get_registry().enabled
        self.stats_enabled = stats
        self.max_batch = _max_batch()
        self.counts: Dict[int, Dict[str, int]] = {}
        # reference-parity EventServerStats windows (obs.exposition);
        # serves the statsSinceStart/statsCurrent views of /stats.json
        self.stats = StatsCollector()
        # event names are client-supplied: bound the distinct label set
        # (metric series + stats keys + counts) the way route_label
        # bounds routes, or a hostile/buggy producer posting unique
        # names grows the registry and every snapshot flush forever
        self._event_labels: set = set()
        # (accessKey, channel) → (result, stamp): the metadata store read
        # behind auth costs ~0.08 ms/request on localfs, which dominates a
        # hot ingest loop.  TTL-bounded so key revocation/channel changes
        # take effect within PIO_AUTH_CACHE_S seconds (default 2; 0 turns
        # the cache off).
        self._auth_cache: Dict[Tuple[str, str], Tuple[tuple, float]] = {}
        self._auth_ttl = float(os.environ.get("PIO_AUTH_CACHE_S", "2"))

    MAX_EVENT_LABELS = 1000

    def _bounded_label(self, name):
        if not isinstance(name, str) or not name:
            return name
        if (name not in self._event_labels
                and len(self._event_labels) >= self.MAX_EVENT_LABELS):
            return "(other)"
        self._event_labels.add(name)
        return name

    def record(self, app_id: int, event_name: str, status: int = 201,
               entity_type: Optional[str] = None) -> None:
        if not self.stats_enabled:
            return
        event_name = self._bounded_label(event_name)
        entity_type = self._bounded_label(entity_type)
        if status == 201:
            per_app = self.counts.setdefault(app_id, {})
            per_app[event_name] = per_app.get(event_name, 0) + 1
            _M_INGESTED.inc(1, app=str(app_id), event=event_name or "")
        self.stats.record(app_id, status, event=event_name,
                          entity_type=entity_type)

    def auth(self, query: Dict[str, str]) -> Tuple[Optional[AccessKey], Optional[int], Optional[str]]:
        """Returns (access_key, channel_id, error)."""
        key = query.get("accessKey")
        if not key:
            return None, None, "missing accessKey parameter"
        chan_name = query.get("channel") or ""
        if self._auth_ttl > 0:
            hit = self._auth_cache.get((key, chan_name))
            if hit is not None and time.monotonic() - hit[1] < self._auth_ttl:
                return hit[0]
        result = self._auth_uncached(key, chan_name)
        if self._auth_ttl > 0:
            if len(self._auth_cache) > 4096:   # bound invalid-key churn
                self._auth_cache.clear()
            self._auth_cache[(key, chan_name)] = (result, time.monotonic())
        return result

    def _auth_uncached(self, key: str, chan_name: str):
        ak = self.storage.access_keys.get(key)
        if ak is None:
            return None, None, "invalid accessKey"
        channel_id: Optional[int] = None
        if chan_name:
            chan = next(
                (c for c in self.storage.channels.get_by_app_id(ak.app_id) if c.name == chan_name),
                None,
            )
            if chan is None:
                return None, None, f"invalid channel {chan_name!r}"
            channel_id = chan.id
        return ak, channel_id, None


def make_handler(state: EventServerState):
    class EventHandler(JsonHandler):
        def do_GET(self):
            path, query = self.route
            if path == "/":
                # pid identifies WHICH prefork worker answered — the
                # readiness/diagnostic signal for multi-worker deployments
                # (a client probing fresh connections sees each live
                # worker's pid as the kernel load-balances the accepts).
                # version + workerTag let a rolling restart verify a
                # mixed-version worker group from outside.
                self.send_json({"status": "alive", "pid": os.getpid(),
                                "version": __version__,
                                "workerTag": obs_metrics.worker_tag()})
                return
            if path == "/metrics":
                # Prometheus text; unauthenticated like every standard
                # exporter (no event data leaves through it).  One scrape
                # of ANY worker merges every sibling's snapshot.
                self._send_raw(200, metrics_payload(),
                               ctype="text/plain; version=0.0.4; "
                                     "charset=utf-8")
                return
            if path == "/stop":
                # graceful shutdown (same contract as the query server's
                # /stop): with --workers the kernel routes this to ONE
                # listener; `pio undeploy` keeps stopping until the port
                # stops answering, and the parent tears its children down
                # via the wired server_close.  Loopback-only by default:
                # every data endpoint authenticates, so an open /stop on a
                # 0.0.0.0 bind would be an unauthenticated kill switch
                # (PIO_ALLOW_REMOTE_STOP=1 opts out behind a trusted LB).
                if (self.client_address[0] not in ("127.0.0.1", "::1")
                        and os.environ.get("PIO_ALLOW_REMOTE_STOP") != "1"):
                    self.send_error_json(
                        403, "remote /stop denied (loopback only; set "
                             "PIO_ALLOW_REMOTE_STOP=1 to allow)")
                    return
                self.send_json({"stopping": True})

                def _stop(server):
                    server.shutdown()
                    # close the listening socket too: shutdown() alone
                    # keeps accepting connections that nothing serves
                    server.server_close()

                threading.Thread(target=_stop, args=(self.server,),
                                 daemon=True).start()
                return
            ak, channel_id, err = state.auth(query)
            if err:
                self.send_error_json(401, err)
                return
            if path == "/events.json":
                self._find(ak, channel_id, query)
            elif path == "/stats.json":
                if not state.stats_enabled:
                    # disabled registry (PIO_METRICS=off): say "service
                    # off" rather than serving frozen/empty windows
                    self.send_error_json(
                        503, "stats disabled (PIO_METRICS=off)")
                    return
                # back-compat keys (appId/counts) + the reference-parity
                # window views (per-(appId, status, event/entityType)
                # since start, current window, last completed window)
                doc = state.stats.to_json(app_id=ak.app_id)
                doc["appId"] = ak.app_id
                doc["counts"] = state.counts.get(ak.app_id, {})
                # columnar-snapshot coverage of this app's channels (only
                # on backends with a snapshot layer; channels with no
                # snapshot are omitted)
                snap = self._snapshot_coverage(ak.app_id)
                if snap:
                    doc["snapshot"] = snap
                # sharded/replicated store topology (shards, per-shard
                # primary + epoch + replica lag) — only on backends that
                # expose it
                topo = getattr(state.storage.l_events,
                               "topology_status", None)
                if topo is not None:
                    try:
                        doc["storeTopology"] = topo()
                    except OSError:
                        pass
                self.send_json(doc)
            elif path.startswith("/events/") and path.endswith(".json"):
                event_id = path[len("/events/"):-len(".json")]
                e = state.storage.l_events.get(event_id, ak.app_id, channel_id)
                if e is None:
                    self.send_error_json(404, f"event {event_id} not found")
                else:
                    self.send_json(e.to_json())
            else:
                self.send_error_json(404, "not found")

        def do_POST(self):
            path, query = self.route
            ak, channel_id, err = state.auth(query)
            if err:
                self.send_error_json(401, err)
                return
            try:
                body = self.read_json()
            except json.JSONDecodeError as e:
                self.send_error_json(400, f"invalid JSON: {e}")
                return
            if path == "/events.json":
                self._insert_one(ak, channel_id, body)
            elif path == "/batch/events.json":
                self._insert_batch(ak, channel_id, body)
            elif path.startswith("/webhooks/") and path.endswith(".json"):
                self._webhook(ak, channel_id, path[len("/webhooks/"):-len(".json")], body)
            else:
                self.send_error_json(404, "not found")

        def do_DELETE(self):
            path, query = self.route
            ak, channel_id, err = state.auth(query)
            if err:
                self.send_error_json(401, err)
                return
            if path.startswith("/events/") and path.endswith(".json"):
                event_id = path[len("/events/"):-len(".json")]
                ok = state.storage.l_events.delete(event_id, ak.app_id, channel_id)
                if ok:
                    self.send_json({"message": "Found"})
                else:
                    self.send_error_json(404, f"event {event_id} not found")
            else:
                self.send_error_json(404, "not found")

        # -- impl ------------------------------------------------------------

        def _snapshot_coverage(self, app_id: int) -> Dict[str, Any]:
            """Per-channel snapshot status for /stats.json ('' = default
            channel); {} when the backend has no snapshot layer."""
            backend = state.storage.l_events
            if not hasattr(backend, "snapshot_status"):
                return {}
            out: Dict[str, Any] = {}
            st = backend.snapshot_status(app_id)
            if st is not None:
                out[""] = st
            for chan in state.storage.channels.get_by_app_id(app_id):
                st = backend.snapshot_status(app_id, chan.id)
                if st is not None:
                    out[chan.name] = st
            return out

        def _webhook(self, ak, channel_id, name, body):
            from predictionio_tpu_torch.api.webhooks import get_connector

            connector = get_connector(name)
            if connector is None:
                self.send_error_json(404, f"no webhook connector {name!r}")
                return
            if not isinstance(body, dict):
                self.send_error_json(400, "webhook body must be a JSON object")
                return
            try:
                event = connector(body)
            except (ValueError, KeyError, TypeError) as e:
                self.send_error_json(400, str(e))
                return
            err = self._check_allowed(ak, event.event)
            if err:
                self.send_error_json(403, err)
                return
            event_id = state.storage.l_events.insert(event, ak.app_id, channel_id)
            state.record(ak.app_id, event.event,
                         entity_type=event.entity_type)
            self.send_json({"eventId": event_id}, status=201)

        def _check_allowed(self, ak: AccessKey, event_name: str) -> Optional[str]:
            if ak.events and event_name not in ak.events:
                return f"accessKey is not allowed to write event {event_name!r}"
            return None

        def _insert_one(self, ak, channel_id, body):
            if not isinstance(body, dict):
                self.send_error_json(400, "event must be a JSON object")
                return
            name = body.get("event")
            err = (self._check_allowed(ak, name)
                   if isinstance(name, str) and name else None)
            if err:
                # validate-then-authorize: malformed stays 400 even when
                # the event name is also disallowed (same as the batch
                # endpoint and the old Event-object path)
                try:
                    Event.from_json(body)
                    state.record(ak.app_id, name, 403)
                    self.send_error_json(403, err)
                except (ValueError, KeyError, TypeError) as e:
                    state.record(ak.app_id, name, 400)
                    self.send_error_json(400, str(e))
                return
            # same canonical fast path as /batch/events.json: wire dict →
            # storage line without Event-object round trips (~45 µs less
            # per event; byte-identical lines by the parity contract)
            r = state.storage.l_events.insert_json_batch(
                [body], ak.app_id, channel_id)[0]
            if r["status"] != 201:
                state.record(ak.app_id, name if isinstance(name, str)
                             else None, 400)
                self.send_error_json(400, r["message"])
                return
            event_id = r["eventId"]
            state.record(ak.app_id, name,
                         entity_type=body.get("entityType"))
            if type(event_id) is str and event_id.isalnum():
                # hand-built body: alnum ids (every server-generated id is
                # hex) need no JSON escaping, and this is the single-event
                # hot loop (~8 µs per dumps)
                self._send_raw(201, b'{"eventId": "%s"}' % event_id.encode())
            else:   # client-supplied exotic id: full encoder
                self.send_json({"eventId": event_id}, status=201)

        def _insert_batch(self, ak, channel_id, body):
            if not isinstance(body, list):
                self.send_error_json(400, "batch body must be a JSON array")
                return
            if len(body) > state.max_batch:
                self.send_error_json(
                    400, f"batch size {len(body)} exceeds limit "
                         f"{state.max_batch}")
                return
            # access-key event filter first (needs only the name), then ONE
            # storage batch for everything allowed — the per-item Event
            # round trip and per-item locked append were the ingest
            # bottleneck (~70 µs + a lock acquisition per event)
            results: List[Optional[Dict[str, Any]]] = []
            allowed = []
            for item in body:
                name = item.get("event") if isinstance(item, dict) else None
                err = (self._check_allowed(ak, name)
                       if isinstance(name, str) and name else None)
                if err:
                    # validate-then-authorize, exactly like /events.json and
                    # the old per-event loop: a malformed item is 400 even
                    # when its event name is also disallowed (disallowed
                    # items are the rare case, so validating them here
                    # doesn't cost the batch fast path anything)
                    try:
                        Event.from_json(item)
                        results.append({"status": 403, "message": err})
                    except (ValueError, KeyError, TypeError) as e:
                        results.append({"status": 400, "message": str(e)})
                else:
                    allowed.append(item if isinstance(item, dict) else {})
                    results.append(None)
            inserted = state.storage.l_events.insert_json_batch(
                allowed, ak.app_id, channel_id) if allowed else []
            it = iter(inserted)
            for k, r in enumerate(results):
                if r is None:
                    results[k] = next(it)
            for item, r in zip(body, results):
                name = item.get("event") if isinstance(item, dict) else None
                etype = (item.get("entityType")
                         if isinstance(item, dict) else None)
                state.record(ak.app_id, name, r.get("status", 0),
                             entity_type=etype)
            self.send_json(results)

        def _find(self, ak, channel_id, query):
            kwargs: Dict[str, Any] = {}
            if "startTime" in query:
                kwargs["start_time"] = parse_time(query["startTime"])
            if "untilTime" in query:
                kwargs["until_time"] = parse_time(query["untilTime"])
            if "entityType" in query:
                kwargs["entity_type"] = query["entityType"]
            if "entityId" in query:
                kwargs["entity_id"] = query["entityId"]
            if "event" in query:
                kwargs["event_names"] = [query["event"]]
            if "targetEntityType" in query:
                kwargs["target_entity_type"] = query["targetEntityType"]
            if "targetEntityId" in query:
                kwargs["target_entity_id"] = query["targetEntityId"]
            limit = int(query.get("limit", 20))
            reversed_order = query.get("reversed", "false").lower() == "true"
            events = state.storage.l_events.find(
                ak.app_id, channel_id=channel_id, limit=limit,
                reversed_order=reversed_order, **kwargs,
            )
            self.send_json([e.to_json() for e in events])

    return EventHandler


def run_event_server(
    host: str = "0.0.0.0",
    port: int = 7070,
    storage: Optional[Storage] = None,
    background: bool = False,
    workers: int = 1,
    reuse_port: bool = False,
):
    """Run the event server; returns the HTTPServer (background=True) or
    blocks.

    ``workers > 1`` preforks N−1 extra OS processes all ingesting on the
    SAME port via SO_REUSEPORT (the kernel load-balances accepts) — the
    same scaling treatment as ``pio deploy --workers``.  Each worker gets
    a distinct PIO_WRITER_TAG, so the localfs event log gives every
    process its own ``seg-<tag>-NNNNN.jsonl`` segment series: appends
    never share a file descriptor, and readers scan the union.  Workers
    resolve storage from the PIO_STORAGE_* environment (a programmatic
    ``storage`` object cannot cross the process boundary).

    Caveats of the multi-process split: /stats.json counts and the auth
    cache are per-worker (the kernel routes each request to one worker),
    and a GET /stop reaches one listener — ``pio undeploy --port`` loops
    until the whole group is down.
    """
    from predictionio_tpu_torch.api import prefork

    if workers > 1 and storage is not None:
        raise ValueError(
            "eventserver --workers resolves storage from PIO_STORAGE_* env "
            "in each worker; a programmatic storage object cannot cross "
            "the process boundary")
    if workers == 1:
        prefork.maybe_watch_parent(log)   # prefork child: die when orphaned
        # prefork child spawned with a PIO_METRICS_DIR: publish this
        # worker's registry snapshots so any sibling's scrape sees us
        # (no-op — pure in-memory metrics — for a true single worker)
        obs_metrics.start_worker_flusher()
        obs_metrics.mark_worker_up()
    prev_tag = os.environ.get("PIO_WRITER_TAG")
    metrics_dir: Optional[str] = None
    if workers > 1:
        # the parent is writer w0, children w1..wN-1 — suffixed with the
        # PARENT's pid so tags stay unique across server instances: a
        # rolling restart (or accidental double start) against the same
        # store must never resume/heal the OLD group's still-active
        # segment files.  Overrides (not setdefault) an inherited tag —
        # a shell-exported PIO_WRITER_TAG shared by two groups would
        # defeat exactly that uniqueness.  Set BEFORE the state resolves
        # storage so FSEvents picks the tag up.
        os.environ["PIO_WRITER_TAG"] = f"w0-{os.getpid()}"
        # a process-default Storage built BEFORE this point (e.g. a
        # programmatic caller that seeded apps/keys via get_storage())
        # would carry an untagged FSEvents; refresh so the parent's
        # writer is guaranteed to see the tag
        storage = get_storage(refresh=True)
    state = EventServerState(storage)
    if workers > 1:
        # bind the tagged event writer NOW (Storage clients are lazy),
        # then restore the environment: a later programmatic FSEvents in
        # this process must not silently inherit this server's tag
        state.storage.l_events
        if prev_tag is None:
            os.environ.pop("PIO_WRITER_TAG", None)
        else:
            os.environ["PIO_WRITER_TAG"] = prev_tag
    httpd = start_server(make_handler(state), host, port,
                         background=background,
                         reuse_port=workers > 1 or reuse_port)
    bound_port = httpd.server_address[1]
    children: list = []
    if workers > 1:
        # cross-worker metrics: every worker snapshots its registry into
        # this directory; a scrape of ANY worker merges the whole group.
        # The dir travels to children by env (never set in the parent's
        # own environ — a later programmatic server in this process must
        # not silently join this group).
        import tempfile

        metrics_dir = tempfile.mkdtemp(prefix="pio-metrics-")
        obs_metrics.start_worker_flusher(metrics_dir, f"w0-{os.getpid()}")
        children = prefork.spawn_workers(
            workers - 1,
            lambda w: [sys.executable, "-m", "predictionio_tpu_torch.cli.main",
                       "eventserver", "--ip", host,
                       "--port", str(bound_port), "--reuse-port"],
            build_env=lambda w: {
                "PIO_WRITER_TAG": f"w{w + 1}-{os.getpid()}",
                "PIO_METRICS_DIR": metrics_dir},
            log=log,
        )
    prefork.wire_shutdown(httpd, children)
    if metrics_dir is not None:
        # AFTER wire_shutdown so this runs once the children are stopped
        # (their flushers write into the dir until they die)
        prefork.wire_metrics_cleanup(httpd, metrics_dir)
    httpd.pio_state = state   # handle for tests/tools
    httpd.pio_workers = children
    log.info("Event server listening on %s:%d", host, bound_port)
    if background:
        return httpd
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    return 0
