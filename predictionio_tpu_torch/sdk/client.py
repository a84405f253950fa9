"""Python SDK — clients for the Event Server and Query Server REST APIs.

Counterpart of ``predictionio_tpu/sdk/client.py``, sending the same
request bytes.  Reference: the PredictionIO-Python-SDK repo (EventClient /
EngineClient; separate repos speaking the same REST wire format).
stdlib-only so it is usable outside this package's environment.
"""

from __future__ import annotations

import datetime as _dt
import http.client
import itertools
import json
import os
import random
import threading
import time
import urllib.parse
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

# per-request X-Request-ID minting: unique across processes and across
# client instances in one process, cheap (no uuid4 per request).  The
# server echoes the id and keys its flight-recorder trace on it, so a
# client-side failure is joinable against the server's /traces/<rid>.json
_RID_SEED = f"sdk-{os.getpid():x}-{os.urandom(3).hex()}"
_RID_COUNTER = itertools.count(1)


def _mint_rid() -> str:
    return f"{_RID_SEED}-{next(_RID_COUNTER):x}"


class PIOError(Exception):
    def __init__(self, status: int, message: str,
                 request_id: Optional[str] = None):
        tail = f" [request-id {request_id}]" if request_id else ""
        super().__init__(f"HTTP {status}: {message}{tail}")
        self.status = status
        self.message = message
        self.request_id = request_id


def _backoff_delays(window: float):
    """Bounded exponential backoff with full jitter for reconnects: first
    retry immediate (the dropped-idle-keep-alive case), then ~50 ms
    doubling to a 1 s cap, randomized to 50–100% of the step so a client
    fleet doesn't reconnect in lockstep, until ``window`` seconds have
    elapsed.  Yields the sleep before each retry attempt (0 = retry now);
    the caller stops iterating on success."""
    deadline = time.monotonic() + max(0.0, window)
    yield 0.0
    delay = 0.05
    while time.monotonic() < deadline:
        yield min(delay, max(0.0, deadline - time.monotonic())) * (
            0.5 + random.random() * 0.5)
        delay = min(delay * 2, 1.0)


class _Conn:
    """One persistent keep-alive connection per client instance.

    Event traffic is many small requests; a fresh TCP connect per event
    (the old urllib path) caps a client at ~1.2k events/s against a local
    server, while connection reuse measures ~4-10k/s.  Connections are
    PER-THREAD (threading.local), so a client shared across N worker
    threads issues N parallel keep-alive connections instead of
    serializing on one socket.

    Retry contract: a request that provably never reached the server
    (connection refused, or the send itself failed) is retried with
    bounded exponential backoff + jitter for up to ``retry_window``
    seconds — long enough to ride through an event-store failover
    promotion window instead of erroring on the first refused connect.
    A failure AFTER the send is NEVER retried for non-idempotent methods
    (the server may have committed the event; re-sending would silently
    duplicate it) — the backoff changes nothing about that at-least-once
    contract, it only retries the provably-unprocessed cases.  Callers
    that must retry post-send failures should supply client eventIds so
    the retry is idempotent at read time."""

    def __init__(self, base_url: str, timeout: float,
                 retry_window: float = 8.0):
        u = urllib.parse.urlsplit(base_url)
        if u.scheme == "https":
            self._make = lambda: http.client.HTTPSConnection(
                u.hostname, u.port or 443, timeout=timeout)
        else:
            self._make = lambda: http.client.HTTPConnection(
                u.hostname, u.port or 80, timeout=timeout)
        self.prefix = u.path.rstrip("/")
        self.retry_window = retry_window
        self._tl = threading.local()

    def request(self, method: str, path_qs: str, body: Any = None) -> Any:
        data = json.dumps(body).encode() if body is not None else None
        rid = _mint_rid()
        headers = {"Content-Type": "application/json",
                   "X-Request-ID": rid}
        tl = self._tl
        # a long-idle keep-alive socket may have been reaped by the
        # server; reconnecting up front keeps the no-retry-after-send
        # rule below from surfacing errors for that routine case
        if (getattr(tl, "conn", None) is not None
                and time.monotonic() - tl.last_use > 30.0):
            tl.conn.close()
            tl.conn = None
        tl.last_use = time.monotonic()
        delays = _backoff_delays(self.retry_window)
        while True:
            if getattr(tl, "conn", None) is None:
                tl.conn = self._make()
            sent = False
            try:
                tl.conn.request(
                    method, self.prefix + path_qs, data, headers)
                sent = True
                resp = tl.conn.getresponse()
                payload = resp.read()
                break
            except Exception as e:
                # any failure leaves http.client's state machine
                # unusable — always drop the socket so the NEXT call
                # starts clean (a kept-but-wedged connection raises
                # CannotSendRequest forever)
                tl.conn.close()
                tl.conn = None
                # retry with backoff, but only when the request provably
                # did not reach the server: connection refused, or the
                # send itself failed (Content-Length framing means a
                # partially-received request is never processed).
                # A failure AFTER the send may mean the server already
                # processed a non-idempotent POST — re-sending would
                # silently duplicate the event, so surface it instead.
                retriable = isinstance(e, (
                    ConnectionRefusedError, ConnectionResetError,
                    BrokenPipeError, http.client.RemoteDisconnected,
                )) and (not sent or method in ("GET", "DELETE"))
                sleep = next(delays, None) if retriable else None
                if sleep is None:
                    # transport failures keep their type (callers and the
                    # retry contract depend on it); the request id rides
                    # along as an attribute for log joining
                    e.request_id = rid
                    raise
                if sleep:
                    time.sleep(sleep)
        if resp.status >= 400:
            try:
                message = json.loads(payload).get("message", "")
            except Exception:
                message = resp.reason
            raise PIOError(resp.status, message, request_id=rid)
        return json.loads(payload) if payload else None


def _event_body(
    event: str,
    entity_type: str,
    entity_id: str,
    target_entity_type: Optional[str] = None,
    target_entity_id: Optional[str] = None,
    properties: Optional[Dict[str, Any]] = None,
    event_time: Optional[_dt.datetime] = None,
) -> Dict[str, Any]:
    """One wire-format body constructor shared by the serial client and the
    pipeline, so the two paths can never diverge."""
    body: Dict[str, Any] = {
        "event": event, "entityType": entity_type, "entityId": str(entity_id),
    }
    if target_entity_type:
        body["targetEntityType"] = target_entity_type
    if target_entity_id:
        body["targetEntityId"] = str(target_entity_id)
    if properties:
        body["properties"] = properties
    if event_time:
        body["eventTime"] = event_time.isoformat()
    return body


class AsyncResult:
    """Handle for a pipelined request (reference: the official Python
    SDK's AsyncRequest/AsyncResponse pair around ``acreate_event``).

    ``result()`` drains the pipeline until this request's response has
    been read, then returns the parsed body (raising PIOError for HTTP
    errors) — responses arrive strictly in request order (HTTP/1.1)."""

    __slots__ = ("_pipe", "_value", "_error", "done", "request_id")

    def __init__(self, pipe: "EventPipeline", request_id: str = ""):
        self._pipe = pipe
        self._value: Any = None
        self._error: Optional[Exception] = None
        self.done = False
        # the X-Request-ID this request was sent with: echoed by the
        # server, keyed into its flight recorder, and carried in any
        # PIOError this handle raises
        self.request_id = request_id

    def result(self) -> Any:
        if not self.done:
            self._pipe.drain_until(self)
        if self._error is not None:
            raise self._error
        return self._value


class _Pipeline:
    """HTTP/1.1-pipelined requests over one keep-alive socket — the
    transport shared by ``EventPipeline`` (ingestion) and
    ``QueryPipeline`` (serving).

    Why: a serial client pays one full round trip per request — request
    construction, send, *wait*, read — and measures well under half of
    what the server sustains on the same box.  Pipelining keeps up to
    ``depth`` requests in flight on the wire: requests are written
    back-to-back into a userspace buffer (flushed at ``_SEND_BUF``
    bytes), and responses — strictly ordered per HTTP/1.1 — are read in
    bulk when the in-flight cap is reached.  ``depth`` bounds the
    responses the server can have queued toward us, so neither side's
    socket buffer can fill and deadlock the pair.  Against the
    event-loop front end, pipelined queries are exactly what feeds the
    cross-request micro-batcher: every request in flight on this socket
    can coalesce into one ``serve_batch_predict`` pass server-side.

    stdlib-only, single-threaded.

    Failure semantics — at-least-once ambiguity: if the server signals
    ``Connection: close`` (or the socket dies) while requests are still
    in flight, every outstanding handle fails with PIOError — but the
    server may already have COMMITTED some of those requests before
    closing; the close only guarantees their acknowledgements will never
    arrive.  A caller that retries failed event handles can therefore
    duplicate events unless it supplies its own ``eventId`` per event
    (the server stores a client-supplied id verbatim, making the retry
    idempotent at read time).  After a server-signaled close the
    pipeline refuses new sends immediately instead of writing requests
    the server will never read.
    """

    _SEND_BUF = 32 * 1024

    def __init__(self, base_url: str, depth: int = 128,
                 timeout: float = 10.0, qs: str = "",
                 retry_window: float = 8.0):
        import socket as _socket

        u = urllib.parse.urlsplit(base_url)

        def connect(port):
            # the pipeline's one TCP connect gets the same bounded
            # backoff-with-jitter as the serial client: a refused connect
            # during a failover promotion window is retried for up to
            # ``retry_window`` seconds before surfacing.  (Nothing has
            # been sent yet, so this never interacts with the
            # no-retry-after-send / at-least-once contract below.)
            delays = _backoff_delays(retry_window)
            while True:
                try:
                    return _socket.create_connection(
                        (u.hostname, port), timeout=timeout)
                except ConnectionRefusedError:
                    sleep = next(delays, None)
                    if sleep is None:
                        raise
                    if sleep:
                        time.sleep(sleep)

        if u.scheme == "https":
            import ssl

            raw = connect(u.port or 443)
            self._sock = ssl.create_default_context().wrap_socket(
                raw, server_hostname=u.hostname)
        else:
            self._sock = connect(u.port or 80)
        self._sock.setsockopt(
            _socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
        self._rfile = self._sock.makefile("rb")
        self._host = (u.hostname or "localhost").encode("ascii")
        self._prefix = u.path.rstrip("/")
        self._qs = qs
        # the deadlock-avoidance invariant (see docstring) only holds if
        # queued responses stay well under a default socket buffer
        # (~128 KiB): clamp depth so ~100 B/response can't fill it
        self._depth = max(1, min(depth, 512))
        self._buf = bytearray()
        self._pending: "deque[AsyncResult]" = deque()
        self._closed = False

    # -- request side -------------------------------------------------------

    def _send(self, method: str, path_qs: str, body: Any) -> AsyncResult:
        if self._closed:
            raise PIOError(0, "pipeline is closed")
        data = json.dumps(body).encode()
        rid = _mint_rid()
        self._buf += (
            b"%s %s HTTP/1.1\r\nHost: %s\r\nX-Request-ID: %s\r\n"
            b"Content-Type: application/json\r\nContent-Length: %d\r\n\r\n"
            % (method.encode(), (self._prefix + path_qs).encode(),
               self._host, rid.encode(), len(data))
        ) + data
        h = AsyncResult(self, request_id=rid)
        self._pending.append(h)
        if len(self._buf) >= self._SEND_BUF:
            self._flush_buf()
        if len(self._pending) >= self._depth:
            # drain half: keeps the wire busy while bounding in-flight
            self._drain(len(self._pending) - self._depth // 2)
        return h

    # -- response side ------------------------------------------------------

    def _read_response(self) -> tuple:
        """Returns (status, payload, server_closing).  ``server_closing``
        is True when the response carries ``Connection: close`` — this is
        the LAST response the server will send on this socket, so any
        requests already pipelined after it will never be answered."""
        line = self._rfile.readline(65537)
        if not line:
            raise PIOError(0, "server closed the pipelined connection")
        parts = line.decode("latin-1").split(" ", 2)
        status = int(parts[1])
        length = 0
        closing = False
        while True:
            h = self._rfile.readline(65537)
            if h in (b"\r\n", b"\n", b""):
                break
            name, _, value = h.decode("latin-1").partition(":")
            name = name.strip().lower()
            if name == "content-length":
                length = int(value.strip())
            elif name == "connection":
                closing = value.strip().lower() == "close"
        payload = self._rfile.read(length) if length else b""
        return status, payload, closing

    def _release_socket(self) -> None:
        self._closed = True
        try:
            self._rfile.close()
            self._sock.close()
        except OSError:
            pass

    def _abort(self, err: Exception) -> None:
        """Fail every outstanding handle and release the socket — after
        this, pending ``result()`` calls raise ``err`` instead of
        touching the dead/closed stream."""
        for h in self._pending:
            h.done = True
            # PIOErrors are re-minted per handle so each carries ITS
            # request id (the joinable key against server-side traces)
            h._error = (PIOError(err.status, err.message,
                                 request_id=h.request_id)
                        if isinstance(err, PIOError) else err)
        self._pending.clear()
        del self._buf[:]
        self._release_socket()

    def _flush_buf(self) -> None:
        """Send the userspace buffer; a send-side failure gets the same
        clean-abort treatment as a read-side one (fail every pending
        handle, release the socket) instead of leaving the pipeline
        half-open."""
        try:
            self._sock.sendall(self._buf)
            del self._buf[:]
        except Exception as e:
            self._abort(e)
            raise

    def _drain(self, n: int) -> None:
        if self._buf:
            self._flush_buf()
        for _ in range(min(n, len(self._pending))):
            h = self._pending.popleft()
            h.done = True
            try:
                status, payload, closing = self._read_response()
            except Exception as e:
                h._error = e
                self._abort(e)   # the stream is dead: fail the rest too
                raise
            if status >= 400:
                try:
                    message = json.loads(payload).get("message", "")
                except Exception:
                    message = ""
                h._error = PIOError(status, message,
                                    request_id=h.request_id)
            else:
                h._value = json.loads(payload) if payload else None
            if closing:
                # the server signaled Connection: close — THIS response is
                # the last one it will send.  Fail every handle already
                # pipelined after it (their requests may or may not have
                # been committed before the close; see the class docstring)
                # and refuse new sends, instead of surfacing the same
                # opaque 'server closed' error for everything later.
                self._abort(PIOError(
                    0, "server signaled Connection: close mid-pipeline; "
                       "this request was sent but will never be "
                       "acknowledged (it may or may not have been "
                       "committed — supply client eventIds to retry "
                       "idempotently)"))
                return

    def drain_until(self, handle: AsyncResult) -> None:
        try:
            idx = self._pending.index(handle)
        except ValueError:
            return      # already drained
        self._drain(idx + 1)

    def flush(self) -> None:
        """Send everything buffered and read every outstanding response."""
        self._drain(len(self._pending))

    def close(self) -> None:
        if self._closed:
            return
        try:
            self.flush()
        finally:
            self._release_socket()

    def __enter__(self) -> "_Pipeline":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # on an exception unwind don't force a flush (the stream may be
        # mid-error); fail anything still pending so a later result()
        # raises cleanly instead of draining into a closed socket
        if exc_type is not None:
            self._abort(PIOError(
                0, "pipeline aborted before this response was read"))
        else:
            self.close()


class EventPipeline(_Pipeline):
    """Pipelined single-event ingestion (reference: the official Python
    SDK's ``acreate_event`` path).  Use via ``EventClient.pipeline()``:

        with client.pipeline() as p:
            handles = [p.create_event(...) for _ in events]
        ids = [h.result()["eventId"] for h in handles]   # all done here
    """

    def __init__(self, client: "EventClient", depth: int = 128,
                 timeout: float = 10.0):
        super().__init__(client._base_url, depth=depth, timeout=timeout,
                         qs=client._qs(),
                         retry_window=client.retry_window)

    def create_event(
        self,
        event: str,
        entity_type: str,
        entity_id: str,
        target_entity_type: Optional[str] = None,
        target_entity_id: Optional[str] = None,
        properties: Optional[Dict[str, Any]] = None,
        event_time: Optional[_dt.datetime] = None,
    ) -> AsyncResult:
        body = _event_body(event, entity_type, entity_id,
                           target_entity_type, target_entity_id,
                           properties, event_time)
        return self._send("POST", f"/events.json?{self._qs}", body)

    def record_user_action_on_item(
        self, action: str, uid: str, iid: str,
        properties: Optional[Dict] = None,
    ) -> AsyncResult:
        return self.create_event(action, "user", uid, "item", iid, properties)


class QueryPipeline(_Pipeline):
    """Pipelined /queries.json against a deployed query server.  Keeps
    up to ``depth`` queries in flight on one keep-alive socket; the
    event-loop server answers them strictly in order, and concurrently
    in-flight queries coalesce through the server's cross-request
    micro-batcher when batching is enabled.  Use via
    ``EngineClient.pipeline()``:

        with engine_client.pipeline(depth=32) as p:
            handles = [p.send_query({"user": u, "num": 10}) for u in users]
        predictions = [h.result() for h in handles]
    """

    def __init__(self, client: "EngineClient", depth: int = 64,
                 timeout: float = 10.0):
        super().__init__(client._base_url, depth=depth, timeout=timeout,
                         retry_window=client.retry_window)

    def send_query(self, query: Dict[str, Any]) -> AsyncResult:
        return self._send("POST", "/queries.json", query)


class EventClient:
    """Client for the Event Server (reference: EventClient in the SDKs)."""

    def __init__(self, access_key: str, url: str = "http://localhost:7070",
                 channel: Optional[str] = None, timeout: float = 10.0,
                 retry_window: float = 8.0):
        self.access_key = access_key
        self.channel = channel
        self.timeout = timeout
        # how long connection-refused requests back off before surfacing
        # (failover promotion windows; 0 = fail fast after one retry)
        self.retry_window = retry_window
        self._base_url = url
        self._conn = _Conn(url, timeout, retry_window=retry_window)

    def pipeline(self, depth: int = 128) -> EventPipeline:
        """Open a pipelined single-event ingestion session (see
        EventPipeline).  Use when pushing many events whose ids you don't
        need synchronously — ~4x the serial keep-alive rate measured
        against a local event server."""
        return EventPipeline(self, depth=depth, timeout=self.timeout)

    def _qs(self) -> str:
        params = {"accessKey": self.access_key}
        if self.channel:
            params["channel"] = self.channel
        return urllib.parse.urlencode(params)

    def create_event(
        self,
        event: str,
        entity_type: str,
        entity_id: str,
        target_entity_type: Optional[str] = None,
        target_entity_id: Optional[str] = None,
        properties: Optional[Dict[str, Any]] = None,
        event_time: Optional[_dt.datetime] = None,
    ) -> str:
        body = _event_body(event, entity_type, entity_id,
                           target_entity_type, target_entity_id,
                           properties, event_time)
        out = self._conn.request("POST", f"/events.json?{self._qs()}", body)
        return out["eventId"]

    def create_events(self, events: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
        return self._conn.request("POST", f"/batch/events.json?{self._qs()}",
                                  list(events))

    # convenience wrappers matching the reference SDK surface
    def set_user(self, uid: str, properties: Optional[Dict] = None) -> str:
        return self.create_event("$set", "user", uid, properties=properties or {})

    def set_item(self, iid: str, properties: Optional[Dict] = None) -> str:
        return self.create_event("$set", "item", iid, properties=properties or {})

    def record_user_action_on_item(
        self, action: str, uid: str, iid: str, properties: Optional[Dict] = None
    ) -> str:
        return self.create_event(action, "user", uid, "item", iid, properties)

    def get_event(self, event_id: str) -> Dict[str, Any]:
        return self._conn.request("GET", f"/events/{event_id}.json?{self._qs()}")

    def delete_event(self, event_id: str) -> None:
        self._conn.request("DELETE", f"/events/{event_id}.json?{self._qs()}")

    def find_events(self, **filters: str) -> List[Dict[str, Any]]:
        params = {"accessKey": self.access_key, **filters}
        if self.channel:
            params["channel"] = self.channel
        qs = urllib.parse.urlencode(params)
        return self._conn.request("GET", f"/events.json?{qs}")


class EngineClient:
    """Client for a deployed engine (reference: EngineClient in the SDKs)."""

    def __init__(self, url: str = "http://localhost:8000", timeout: float = 10.0,
                 retry_window: float = 8.0):
        self.timeout = timeout
        self.retry_window = retry_window
        self._base_url = url
        self._conn = _Conn(url, timeout, retry_window=retry_window)

    def send_query(self, query: Dict[str, Any]) -> Dict[str, Any]:
        return self._conn.request("POST", "/queries.json", query)

    def pipeline(self, depth: int = 64) -> QueryPipeline:
        """Open a pipelined query session (see QueryPipeline): many
        queries in flight on one keep-alive socket, answered in order —
        the client-side feed for the server's cross-request
        micro-batcher."""
        return QueryPipeline(self, depth=depth, timeout=self.timeout)

    def freshness(self) -> Dict[str, Any]:
        """The server's ``freshness`` document: live model generation,
        last hot-swap time, and — when the deployment hosts an embedded
        follow-trainer — its lag/outcome status.  Lets a client wait for
        an appended event to become visible by polling ``generation``
        instead of replaying queries.  Served in /stats.json and on
        GET / (the fallback keeps the contract alive under
        PIO_METRICS=off, where /stats.json answers 503)."""
        try:
            doc = self._conn.request("GET", "/stats.json")
        except PIOError:
            doc = self._conn.request("GET", "/")
        return doc.get("freshness", {}) if isinstance(doc, dict) else {}

    def model_generation(self) -> int:
        """Shortcut: the live model's generation counter (0 when the
        server predates the freshness contract)."""
        try:
            return int(self.freshness().get("generation") or 0)
        except (PIOError, ValueError):
            return 0

    def lineage(self, generation: Optional[int] = None) -> Dict[str, Any]:
        """Generation lineage from the deployment: the merged record
        index (``{"records": [...]}``), or one generation's freshness
        waterfall when ``generation`` is given — every stage from
        append-observed through first-serve, contributed by whichever
        processes ran them (cross-process merge).  Lets a client measure
        its own append→servable latency end to end."""
        if generation is None:
            return self._conn.request("GET", "/lineage.json")
        return self._conn.request("GET", f"/lineage/{int(generation)}.json")

    def healthz(self) -> Dict[str, Any]:
        """The deployment's SLO burn-rate verdicts (/healthz — always
        HTTP 200; the ``status`` field carries ok | warn | burning |
        no_data)."""
        return self._conn.request("GET", "/healthz")
