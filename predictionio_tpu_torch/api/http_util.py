"""Shared HTTP plumbing of the port's REST servers (standard library only).

Counterpart of ``predictionio_tpu/api/http_util.py``: the same event-loop
front end, the same wire behaviour (refusals, their order, keep-alive,
pipelining, the body cap), the same ``pio_http_*`` instruments and
``PIO_HTTP_*`` settings, and the same flight-recorder hook in ``_execute``
(``obs/tracing.py``): the request id is minted and echoed in
``X-Request-ID``, and keys the request's trace, as there.

The front end is a nonblocking event loop, not a thread per connection
(a thread per connection convoys on the GIL and the accept queue under
concurrent load).  One selectors-based loop per prefork worker owns every
socket: it accepts,
parses request line + headers + body with plain buffer splits (no
email.parser, no per-line syscalls), and hands COMPLETE requests to a
small handler pool; responses flow back through per-connection ordered
slots, so HTTP/1.1 keep-alive and pipelining work across arbitrarily
interleaved handler completions.  Idle keep-alive connections are
reaped by the loop itself (no reaper thread per connection), slow
clients (partial headers, dribbled bodies) just occupy buffer space
until their bytes arrive or the idle timeout fires, and response heads
are assembled from preassembled per-(status, content-type) templates
with ``sendmsg`` gather writes — no per-response f-string churn.

Handler subclasses keep the BaseHTTPRequestHandler-ish surface they
already used: ``self.path``, ``self.headers.get``, ``do_GET``/``do_POST``,
``self.client_address``, ``self.server``, plus the JSON helpers.  The
request body is fully buffered before dispatch, so ``read_json`` never
blocks and an errored handler can never leave body bytes in the stream.

Tuning knobs (all env):

- ``PIO_HTTP_BACKLOG``        listen(2) backlog (default 1024)
- ``PIO_HTTP_POOL``           handler threads per worker (default ≈
                              cores, clamped to 2–16; 0 = run handlers
                              inline on the loop thread)
- ``PIO_HTTP_PIPELINE_DEPTH`` max in-flight requests per connection
                              before the loop stops reading it (64)
- ``PIO_HTTP_IDLE_S``         idle keep-alive reap timeout (120)
- ``PIO_HTTP_MAX_BODY``       request body cap in bytes (64 MiB; over
                              it: 413 + close, never buffered)
"""

from __future__ import annotations

import io
import itertools
import json
import logging
import os
import queue
import re
import selectors
import socket
import threading
import time
from collections import deque
from typing import Any, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from predictionio_tpu_torch.native import core as _ncore
from predictionio_tpu_torch.obs import tracing as _tracing
from predictionio_tpu_torch.obs.metrics import get_registry

_access_log = logging.getLogger("pio.http")

# -- request middleware instruments (obs tentpole) ---------------------------
_REG = get_registry()
_M_REQS = _REG.counter(
    "pio_http_requests_total", "HTTP requests served, by route and status")
_M_LAT = _REG.histogram(
    "pio_http_request_duration_seconds",
    "Request handling latency by route (parse to response written)")
_M_INFLIGHT = _REG.gauge(
    "pio_http_requests_in_flight", "Requests currently being handled")
_M_CONNS = _REG.gauge(
    "pio_http_connections", "Open connections held by the event loop")

# request-id generation: cheap monotonic id, unique per process
_RID = itertools.count(1)
_RID_PREFIX = f"{os.getpid():x}"
# an incoming X-Request-ID is honored only in this shape: it is echoed
# into headers, trace files, /traces/<rid>.json URLs, and /metrics
# exemplar annotations, so an unconstrained client value could corrupt
# any of those surfaces
_RID_SAFE = re.compile(r"^[A-Za-z0-9._:-]{1,64}$")

# static routes exposed verbatim; everything else is normalized (or
# bucketed) so per-id paths can't explode label cardinality
_KNOWN_ROUTES = frozenset({
    "/", "/stop", "/reload", "/metrics", "/stats.json", "/traces.json",
    "/events.json", "/batch/events.json", "/queries.json",
    "/dashboard.json", "/engine_instances.json", "/evaluations.json",
    "/snapshots.json", "/cmd/app",
})


def route_label(path: str) -> str:
    """Bounded-cardinality route label for a request path."""
    route = path.partition("?")[0]
    if route in _KNOWN_ROUTES:
        return route
    if route.startswith("/events/") and route.endswith(".json"):
        return "/events/{id}.json"
    if route.startswith("/webhooks/") and route.endswith(".json"):
        return "/webhooks/{name}.json"
    if route.startswith("/spans/") and route.endswith(".json"):
        return "/spans/{id}.json"
    if route.startswith("/traces/"):
        return ("/traces/{rid}.html" if route.endswith(".html")
                else "/traces/{rid}.json")
    if route.startswith("/cmd/app/"):
        if route.endswith("/accesskeys"):
            return "/cmd/app/{name}/accesskeys"
        if route.endswith("/data"):
            return "/cmd/app/{name}/data"
        return "/cmd/app/{name}"
    return "(other)"


class _Headers(Dict[str, str]):
    """Case-insensitive .get over lower-cased header names."""

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:  # type: ignore[override]
        return super().get(key.lower(), default)


_REASON = {
    200: "OK", 201: "Created", 400: "Bad Request", 401: "Unauthorized",
    403: "Forbidden", 404: "Not Found", 405: "Method Not Allowed",
    411: "Length Required", 413: "Payload Too Large",
    431: "Request Header Fields Too Large", 500: "Internal Server Error",
    501: "Not Implemented", 503: "Service Unavailable",
}

_CT_JSON = "application/json; charset=utf-8"
_KEEP_TAIL = b"Connection: keep-alive\r\n\r\n"
_CLOSE_TAIL = b"Connection: close\r\n\r\n"
_CONTINUE = b"HTTP/1.1 100 Continue\r\n\r\n"
# preassembled status+static-header prefixes, keyed by (status, ctype):
# the hot path joins [prefix, rid line, length line, connection tail,
# body] instead of formatting a fresh head string per response
_HEAD_CACHE: Dict[Tuple[int, str], bytes] = {}


def _head_prefix(status: int, ctype: str) -> bytes:
    pre = _HEAD_CACHE.get((status, ctype))
    if pre is None:
        pre = (f"HTTP/1.1 {status} {_REASON.get(status, '')}\r\n"
               f"Server: pio-tpu\r\n"
               f"Content-Type: {ctype}\r\n").encode("latin-1")
        if len(_HEAD_CACHE) < 256:   # bounded: ctype values are static
            _HEAD_CACHE[(status, ctype)] = pre
    return pre


# native response assembly only pays above this body size: below it the
# ctypes marshalling costs more than the single GIL-held b"".join it
# replaces (measured: 10 B–100 KiB bodies assemble 4–7× FASTER via the
# join; the native copy only approaches parity near 1 MiB, where its
# GIL-dropped memcpy also stops stalling concurrent handler threads)
_NATIVE_ASSEMBLE_MIN = 1 << 20


def assemble_response(status: int, body: bytes, ctype: str = _CT_JSON,
                      rid: str = "", close: bool = False) -> bytes:
    prefix = _head_prefix(status, ctype)
    tail = _CLOSE_TAIL if close else _KEEP_TAIL
    if len(body) >= _NATIVE_ASSEMBLE_MIN and _ncore.http_enabled():
        # native assembly: one pre-sized buffer filled with the GIL
        # dropped; value-equal to the join below (a bytearray writes and
        # compares identically)
        try:
            out = _ncore.http_assemble(
                prefix, rid.encode("latin-1") if rid else None, tail, body)
            if out is not None:
                return out
        except Exception:
            _ncore.note_fallback("error")
    parts = [prefix]
    if rid:
        parts.append(b"X-Request-ID: %s\r\n" % rid.encode("latin-1"))
    parts.append(b"Content-Length: %d\r\n" % len(body))
    parts.append(tail)
    parts.append(body)
    return b"".join(parts)


# refusal map for the native head parser: rc -> the oracle's exact
# (status, message) in its exact first-error-wins order (data_plane.cpp
# walks lines the same way the Python loop below does)
_NATIVE_REFUSALS = {
    1: (400, "malformed request line"),
    2: (400, "too many headers"),
    3: (400, "obsolete header line folding"),
    4: (400, "conflicting Content-Length headers"),
    5: (501, "Transfer-Encoding not supported"),
    6: (400, "bad Content-Length"),
}


# the C parse stops growing a Content-Length at this value
_NATIVE_CL_SATURATED = 460000000000000000


def parse_request_head(head: bytes) -> Tuple:
    """Parse one request head (the bytes before CRLFCRLF, exclusive).

    → ``("refuse", status, message)`` or
      ``("ok", command, path, version, headers, need)``.

    Dual implementation behind ``PIO_NATIVE``: the native core scans the
    buffer once with the GIL dropped and hands back spans; the Python
    path below is the oracle (and the fallback).  Both produce identical
    results for every input, including the refusal ORDER — refusal
    precedence is part of the wire contract (the comments in the Python
    walk explain why each one exists)."""
    if _ncore.http_enabled():
        try:
            rc, out, spans = _ncore.http_parse_head(head)
            _ncore.note_call("http")
            if rc:
                status, msg = _NATIVE_REFUSALS[rc]
                return ("refuse", status, msg)
            command = bytes(head[out[1]:out[1] + out[2]]).decode("latin-1")
            path = bytes(head[out[3]:out[3] + out[4]]).decode("latin-1")
            version = bytes(head[out[5]:out[5] + out[6]]).decode("latin-1")
            headers = _Headers()
            for i in range(int(out[0])):
                o = 4 * i
                name = bytes(
                    head[spans[o]:spans[o] + spans[o + 1]]
                ).decode("latin-1").lower()
                headers[name] = bytes(
                    head[spans[o + 2]:spans[o + 2] + spans[o + 3]]
                ).decode("latin-1")
            need = int(out[8]) if out[7] else 0
            if need >= _NATIVE_CL_SATURATED:
                # the C parse saturates huge lengths; the oracle's int()
                # does not (either is refused by the body cap)
                need = int(headers["content-length"])
            return ("ok", command, path, version, headers, need)
        except Exception:
            _ncore.note_fallback("error")
    return _py_parse_request_head(head)


def _py_parse_request_head(head: bytes) -> Tuple:
    lines = head.split(b"\r\n")
    try:
        command, path, version = lines[0].decode("latin-1").split(" ", 2)
    except ValueError:
        return ("refuse", 400, "malformed request line")
    if len(lines) - 1 > 100:       # stdlib's header-count cap
        return ("refuse", 400, "too many headers")
    headers = _Headers()
    for ln in lines[1:]:
        if ln[:1] in (b" ", b"\t"):
            # obs-fold continuations would otherwise parse as a
            # fresh header after .strip() — " Content-Length: 7"
            # overwriting the real one is a body-boundary desync
            # (request smuggling behind a fold-forwarding proxy).
            # RFC 9112 §5.2: reject outside message/http.
            return ("refuse", 400, "obsolete header line folding")
        name, _, value = ln.decode("latin-1").partition(":")
        name = name.strip().lower()
        value = value.strip()
        if (name == "content-length"
                and headers.get(name, value) != value):
            # repeated differing Content-Length: an intermediary
            # honoring the FIRST one would desync on our LAST-wins
            return ("refuse", 400, "conflicting Content-Length headers")
        headers[name] = value
    if headers.get("transfer-encoding") is not None:
        # we don't decode chunked bodies; silently ignoring the
        # header would leave the chunk bytes in the stream to be
        # parsed as the next pipelined request — a desync /
        # request-smuggling vector behind a chunked-forwarding
        # proxy.  RFC 9112 §6.1: respond 501 and close.  Checked
        # BEFORE Expect handling so we never send 100 Continue
        # inviting a body we are about to refuse.
        return ("refuse", 501, "Transfer-Encoding not supported")
    cl = headers.get("content-length")
    # strict 1*DIGIT per RFC 9110 — int() alone accepts '1_0',
    # ' 10 ', and non-ASCII digits, values an intermediary may
    # interpret differently and desync the body boundary on
    if cl is None:
        need = 0
    elif cl.isascii() and cl.isdigit():
        need = int(cl)
    else:
        return ("refuse", 400, "bad Content-Length")
    return ("ok", command, path, version, headers, need)


def _int_env(name: str, default: int) -> int:
    try:
        return int(os.environ[name])
    except (KeyError, ValueError):
        return default


class _Request:
    __slots__ = ("seq", "command", "path", "headers", "body", "close")

    def __init__(self, seq, command, path, headers, body, close):
        self.seq = seq
        self.command = command
        self.path = path
        self.headers = headers
        self.body = body
        self.close = close


class _Connection:
    """One accepted socket: read buffer + parse state (loop thread only)
    and ordered response slots + write queue (shared with handler
    threads under ``lock``)."""

    __slots__ = (
        "server", "sock", "addr", "fd", "lock", "inbuf", "pending_req",
        "outq", "out_off", "next_seq", "next_send", "done", "inflight",
        "inflight_bytes", "paused", "no_more_requests", "peer_eof",
        "closing", "dead", "closed", "interest", "last_activity",
        "head_cache",
    )

    def __init__(self, server: "EventLoopHTTPServer", sock, addr):
        self.server = server
        self.sock = sock
        self.addr = addr
        self.fd = sock.fileno()
        self.lock = threading.Lock()
        self.inbuf = bytearray()
        self.pending_req = None      # parsed head awaiting its body bytes
        self.outq: deque = deque()   # response byte blobs, flush order
        self.out_off = 0             # bytes of outq[0] already sent
        self.next_seq = 0            # next response slot to allocate
        self.next_send = 0           # next slot eligible to hit the wire
        self.done: Dict[int, Tuple[bytes, bool]] = {}
        self.inflight = 0            # dispatched, response not yet slotted
        self.inflight_bytes = 0      # body bytes held by dispatched reqs
        self.paused = False          # pipeline depth hit: reads suspended
        self.no_more_requests = False
        self.peer_eof = False
        self.closing = False         # close once outq drains
        self.dead = False            # socket error: close asap
        self.closed = False
        self.interest = 0            # currently-registered selector mask
        self.last_activity = time.monotonic()
        # keep-alive head-parse memo: a client reusing a connection sends
        # byte-identical heads (same method/path/headers, only the body —
        # and occasionally Content-Length — varies), so the parse result
        # is keyed by the exact head bytes (see _parse)
        self.head_cache: Dict[bytes, Tuple] = {}

    # loop thread only
    def alloc_seq(self) -> int:
        s = self.next_seq
        self.next_seq += 1
        return s

    def push_slot(self, seq: int, data: bytes, close: bool) -> None:
        """Complete response slot ``seq``; safe from any thread.  Flushes
        every consecutive completed slot inline (the common in-order case
        hits the socket without a loop round trip); leftovers are picked
        up by the loop via the wake pipe."""
        with self.lock:
            if self.closed or self.dead or self.closing:
                # closing: a close-marked response already flushed —
                # nothing may follow it on the wire, even a completion
                # that raced in while it drained
                return
            self.done[seq] = (data, close)
            progressed = False
            while self.next_send in self.done:
                d, c = self.done.pop(self.next_send)
                self.next_send += 1
                self.outq.append(d)
                progressed = True
                if c:
                    # this response ends the connection: anything already
                    # slotted after it will never be sent
                    self.closing = True
                    self.no_more_requests = True
                    self.done.clear()
                    break
            if progressed:
                self._flush_locked()
            self.last_activity = time.monotonic()
            # the loop only needs a wake-up when there is loop-side work:
            # residual bytes to register EVENT_WRITE for, or a close to
            # perform.  The common keep-alive case — response fully
            # flushed inline by the send above — skips the wake pipe's
            # two syscalls and the selector round trip entirely.
            need_wake = self.dead or self.closing or bool(self.outq)
        if need_wake:
            self.server._wake(self)

    def _flush_locked(self) -> None:
        """Send as much of outq as the kernel will take; gather writes
        via sendmsg so pipelined responses leave in one syscall."""
        if self.dead or self.closed:
            self.outq.clear()
            return
        try:
            while self.outq:
                if len(self.outq) == 1 and not self.out_off:
                    n = self.sock.send(self.outq[0])
                    self.last_activity = time.monotonic()
                else:
                    bufs = [memoryview(self.outq[0])[self.out_off:]]
                    for i, b in enumerate(self.outq):
                        if i == 0:
                            continue
                        if len(bufs) >= 16:
                            break
                        bufs.append(memoryview(b))
                    n = self.sock.sendmsg(bufs)
                    self.last_activity = time.monotonic()
                    n += self.out_off
                self.out_off = 0
                while self.outq and n >= len(self.outq[0]):
                    n -= len(self.outq[0])
                    self.outq.popleft()
                if n:
                    self.out_off = n   # kernel buffer full: partial send
                    break
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            self.dead = True
            self.outq.clear()

    # loop thread only
    def close(self) -> None:
        if self.closed:
            return
        with self.lock:
            self.closed = True
            self.outq.clear()
            self.done.clear()
        if self.interest:
            try:
                self.server._sel.unregister(self.sock)
            except (KeyError, ValueError, OSError):
                pass
            self.interest = 0
        try:
            self.sock.close()
        except OSError:
            pass
        if self.server._conns.pop(self.fd, None) is not None:
            _M_CONNS.dec()


class EventLoopHTTPServer:
    """Nonblocking event-loop HTTP server with a handler thread pool.

    API-compatible with the ``socketserver`` surface the servers and
    tests already use: ``server_address``, ``serve_forever()``,
    ``shutdown()``, ``server_close()`` (instance-patchable — prefork's
    ``wire_shutdown`` wraps it).  One instance per prefork worker;
    scale across cores with SO_REUSEPORT workers, scale within a worker
    with the pool/in-flight knobs.
    """

    allow_reuse_address = True   # honored in __init__, socketserver-style

    def __init__(self, server_address, RequestHandlerClass,
                 reuse_port: bool = False):
        self.RequestHandlerClass = RequestHandlerClass
        self.backlog = _int_env("PIO_HTTP_BACKLOG", 1024)
        self.max_body = _int_env("PIO_HTTP_MAX_BODY", 64 << 20)
        self.pipeline_depth = max(1, _int_env("PIO_HTTP_PIPELINE_DEPTH", 64))
        try:
            self.idle_timeout = float(os.environ["PIO_HTTP_IDLE_S"])
        except (KeyError, ValueError):
            self.idle_timeout = float(
                getattr(RequestHandlerClass, "timeout", 120) or 120)
        # handlers are mostly GIL-bound Python (parse → storage/model →
        # JSON): threads beyond the core count just convoy on the GIL
        # and measurably LOSE qps (pool=8 on a 2-core box: −30% at c8
        # vs pool=2), so the default tracks cores; raise it only for
        # genuinely blocking handlers (slow shared-fs storage)
        pool = _int_env("PIO_HTTP_POOL", -1)
        if pool < 0:
            pool = max(2, min(16, os.cpu_count() or 1))
        self._pool_size = pool
        self._nagle_off = getattr(
            RequestHandlerClass, "disable_nagle_algorithm", True)

        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        if self.allow_reuse_address:
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if reuse_port:
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        self._sock.bind(server_address)
        self._sock.listen(self.backlog)
        self._sock.setblocking(False)
        self.server_address = self._sock.getsockname()

        self._sel = selectors.DefaultSelector()
        self._sel.register(self._sock, selectors.EVENT_READ, "accept")
        # self-pipe: handler threads wake the loop after completing a
        # response (selector mutation is loop-thread-only)
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        self._wake_lock = threading.Lock()
        self._wake_set: set = set()
        self._wake_armed = False

        self._conns: Dict[int, _Connection] = {}
        self._tasks: "queue.SimpleQueue" = queue.SimpleQueue()
        # server-global count of queued + executing handler tasks,
        # INCLUDING the post-response middleware tail (metrics, trace
        # persistence).  Per-connection inflight can't serve as the
        # shutdown barrier: a close-marked response closes its connection
        # the moment it flushes, while the handler thread is still
        # persisting the trace — a
        # ThreadingMixIn server_close() joined handler threads, and
        # shutdown here must give the same guarantee
        self._task_cv = threading.Condition()
        self._active_tasks = 0
        self._shutdown_request = False
        self._is_shut_down = threading.Event()
        self._is_shut_down.set()
        self._close_lock = threading.Lock()
        self._closed = False
        self._last_reap = time.monotonic()
        self._pool = [
            threading.Thread(target=self._worker_loop, daemon=True,
                             name=f"pio-http-{k}")
            for k in range(self._pool_size)
        ]
        for t in self._pool:
            t.start()

    # -- lifecycle -----------------------------------------------------------

    def serve_forever(self, poll_interval: float = 0.5) -> None:
        self._is_shut_down.clear()
        timeout = min(max(poll_interval, 0.05), 1.0)
        try:
            while not self._shutdown_request:
                try:
                    events = self._sel.select(timeout)
                except (OSError, RuntimeError):
                    if self._closed or self._shutdown_request:
                        break
                    raise
                for key, mask in events:
                    tag = key.data
                    if tag == "accept":
                        self._accept()
                    elif tag == "wake":
                        self._drain_wake_pipe()
                    else:
                        self._service(tag, mask)
                self._drain_wake_set()
                self._reap_idle()
            self._final_flush()
        finally:
            self._is_shut_down.set()

    def shutdown(self) -> None:
        self._shutdown_request = True
        self._wake()
        self._is_shut_down.wait()

    def _wait_idle(self, timeout: float) -> None:
        """Block until every queued/executing handler task (including
        its middleware tail) has finished, or the timeout lapses."""
        with self._task_cv:
            self._task_cv.wait_for(lambda: self._active_tasks == 0, timeout)

    def server_close(self) -> None:
        with self._close_lock:
            if self._closed:
                return   # e.g. /stop's thread and deploy's finally racing
            self._closed = True
        # old-stack parity (ThreadingMixIn joined its handler threads on
        # close): give in-flight handlers a bounded window to finish —
        # unless WE are a pool thread (a handler closing its own server
        # must not wait on itself)
        if threading.current_thread() not in self._pool:
            self._wait_idle(10.0)
        self._shutdown_request = True
        self._wake()
        for _ in self._pool:
            self._tasks.put(None)
        try:
            self._sock.close()
        except OSError:
            pass
        for conn in list(self._conns.values()):
            conn.closed = True
            try:
                conn.sock.close()
            except OSError:
                pass
        if self._conns:
            _M_CONNS.dec(len(self._conns))
            self._conns.clear()
        try:
            self._sel.close()
        except Exception:
            pass
        for s in (self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass

    def _final_flush(self) -> None:
        """Best-effort drain after shutdown: let in-flight handler tasks
        (e.g. the /stop response itself, a trace still persisting)
        finish and their bytes leave.  Exits as soon as everything is
        idle — the deadline only bounds a wedged handler."""
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline:
            busy = self._active_tasks > 0
            for conn in list(self._conns.values()):
                with conn.lock:
                    if conn.outq and not conn.dead and not conn.closed:
                        conn._flush_locked()
                        if conn.outq:
                            busy = True
                    if conn.inflight:
                        busy = True
            if not busy:
                return
            time.sleep(0.02)

    # -- loop internals ------------------------------------------------------

    def _wake(self, conn: Optional[_Connection] = None) -> None:
        with self._wake_lock:
            if conn is not None:
                self._wake_set.add(conn)
            if self._wake_armed:
                return
            self._wake_armed = True
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass

    def _drain_wake_pipe(self) -> None:
        try:
            while self._wake_r.recv(4096):
                pass
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            return
        with self._wake_lock:
            self._wake_armed = False

    def _drain_wake_set(self) -> None:
        with self._wake_lock:
            if not self._wake_set:
                return
            pending = list(self._wake_set)
            self._wake_set.clear()
        for conn in pending:
            self._sync(conn)

    def _accept(self) -> None:
        for _ in range(64):
            try:
                sock, addr = self._sock.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            sock.setblocking(False)
            if self._nagle_off:
                # Nagle + delayed-ACK interact catastrophically with
                # keep-alive request/response traffic (~40 ms stalls);
                # measured 23 events/s serial without this, wire-speed with
                try:
                    sock.setsockopt(
                        socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                except OSError:
                    pass
            conn = _Connection(self, sock, addr)
            try:
                self._sel.register(sock, selectors.EVENT_READ, conn)
            except (ValueError, OSError):
                sock.close()
                continue
            conn.interest = selectors.EVENT_READ
            self._conns[conn.fd] = conn
            _M_CONNS.inc()

    def _service(self, conn: _Connection, mask: int) -> None:
        if conn.closed:
            return
        if mask & selectors.EVENT_WRITE:
            with conn.lock:
                conn._flush_locked()
        if mask & selectors.EVENT_READ:
            self._read(conn)
            if conn.closed:
                return
        self._sync(conn)

    def _read(self, conn: _Connection) -> None:
        try:
            data = conn.sock.recv(1 << 18)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            conn.dead = True
            return
        if not data:
            # half/full close from the peer: stop reading; pending
            # responses still flush (a pipelining client may have shut
            # down its write side), then _sync closes us
            conn.peer_eof = True
            return
        conn.last_activity = time.monotonic()
        if conn.no_more_requests:
            return   # discard bytes pipelined after a close-marked request
        conn.inbuf += data
        self._parse(conn)

    def _sync(self, conn: _Connection) -> None:
        """Loop-side state reconciliation: close finished/dead
        connections, resume paused reads, update selector interest."""
        if conn.closed:
            return
        with conn.lock:
            has_out = bool(conn.outq)
            done_for_good = (
                conn.dead
                or (conn.closing and not has_out)
                or (conn.peer_eof and conn.inflight == 0 and not has_out
                    and not conn.done))
        if done_for_good:
            conn.close()
            return
        if conn.paused:
            with conn.lock:
                resume = (conn.inflight <= self.pipeline_depth // 2
                          and conn.inflight_bytes <= self.max_body // 2)
            if resume:
                conn.paused = False
                self._parse(conn)
                if conn.closed:
                    return
        self._update_interest(conn)

    def _update_interest(self, conn: _Connection) -> None:
        want = 0
        if (not conn.no_more_requests and not conn.paused
                and not conn.peer_eof):
            want |= selectors.EVENT_READ
        with conn.lock:
            if conn.outq:
                want |= selectors.EVENT_WRITE
        if want == conn.interest:
            return
        try:
            if conn.interest == 0:
                self._sel.register(conn.sock, want, conn)
            elif want == 0:
                self._sel.unregister(conn.sock)
            else:
                self._sel.modify(conn.sock, want, conn)
            conn.interest = want
        except (KeyError, ValueError, OSError):
            conn.dead = True
            conn.close()

    def _reap_idle(self) -> None:
        now = time.monotonic()
        if now - self._last_reap < 1.0:
            return
        self._last_reap = now
        cutoff = now - self.idle_timeout
        for conn in list(self._conns.values()):
            with conn.lock:
                # inflight > 0 is the only pardon (a handler may be
                # legitimately slow): parked keep-alives, slowloris
                # partials, AND stuck writers (a peer that stopped
                # reading while outq holds its response — successful
                # flush progress refreshes last_activity) all reap once
                # their last byte of progress is older than the timeout
                idle = conn.inflight == 0 and conn.last_activity < cutoff
            if idle:
                conn.close()

    # -- parsing (loop thread only) ------------------------------------------

    def _parse(self, conn: _Connection) -> None:
        inbuf = conn.inbuf
        while not conn.no_more_requests and not conn.paused:
            if conn.pending_req is not None:
                command, path, headers, need, close_req = conn.pending_req
                if len(inbuf) < need:
                    return
                conn.pending_req = None
                body = bytes(inbuf[:need])
                del inbuf[:need]
                self._dispatch(conn, command, path, headers, body, close_req)
                if close_req:
                    conn.no_more_requests = True
                    inbuf.clear()
                    return
                continue
            while inbuf[:2] == b"\r\n":   # stray CRLFs between requests
                del inbuf[:2]
            if not inbuf:
                return
            hend = inbuf.find(b"\r\n\r\n")
            if hend < 0:
                if len(inbuf) > 65536:
                    self._refuse(conn, 431, "header section too large")
                return
            head = bytes(inbuf[:hend])
            del inbuf[:hend + 4]
            # head-level parse (request line, header walk, refusal
            # precedence) lives in parse_request_head — native core or
            # Python oracle, identical results; the connection-level
            # decisions (413 cap, close vs keep-alive, 100-continue)
            # stay here.  Keep-alive requests repeat byte-identical heads
            # (a closed-loop SDK client varies only the body), so the
            # exact head bytes memoize the whole parse — request line,
            # header walk, dict build — per connection.  Safe because
            # identical bytes parse identically and handlers treat
            # ``self.headers`` as read-only (the memoized dict is shared
            # across the connection's requests); refusals are never
            # cached (they close the connection anyway).
            res = conn.head_cache.get(head)
            if res is None:
                res = parse_request_head(head)
                if res[0] == "ok":
                    if len(conn.head_cache) >= 32:   # bound per-conn RAM
                        conn.head_cache.clear()
                    conn.head_cache[head] = res
            if res[0] == "refuse":
                # never advertises keep-alive: the refusal closes
                self._refuse(conn, res[1], res[2])
                return
            _, command, path, version, headers, need = res
            if need > self.max_body:
                # refuse before buffering, not after: the old drain-based
                # loop read oversized bodies just to discard them
                self._refuse(conn, 413, "request body too large")
                return
            conn_tok = (headers.get("connection") or "").lower()
            close_req = (
                conn_tok == "close"
                or (version == "HTTP/1.0" and conn_tok != "keep-alive"))
            if need and len(inbuf) < need:
                if (headers.get("expect") or "").lower() == "100-continue":
                    # interim response gets its own pre-completed slot so
                    # it stays ordered ahead of this request's final
                    # response but behind earlier pipelined responses
                    conn.push_slot(conn.alloc_seq(), _CONTINUE, False)
                conn.pending_req = (command, path, headers, need, close_req)
                return
            body = bytes(inbuf[:need])
            del inbuf[:need]
            self._dispatch(conn, command, path, headers, body, close_req)
            if close_req:
                # Connection: close honored mid-pipeline — requests the
                # client wrote after it are never parsed or answered
                conn.no_more_requests = True
                inbuf.clear()
                return

    def _refuse(self, conn: _Connection, status: int, message: str) -> None:
        conn.no_more_requests = True
        conn.pending_req = None
        conn.inbuf.clear()
        body = json.dumps({"message": message}).encode()
        conn.push_slot(conn.alloc_seq(),
                       assemble_response(status, body, close=True), True)

    def _dispatch(self, conn, command, path, headers, body, close_req):
        seq = conn.alloc_seq()
        with conn.lock:
            conn.inflight += 1
            conn.inflight_bytes += len(body)
            # backpressure: stop reading this conn at the request-count
            # OR buffered-body-byte cap (64 max-size bodies pipelined on
            # one socket must not pin pipeline_depth × max_body of RAM)
            if (conn.inflight >= self.pipeline_depth
                    or conn.inflight_bytes >= self.max_body):
                conn.paused = True
        with self._task_cv:
            self._active_tasks += 1
        req = _Request(seq, command, path, headers, body, close_req)
        if self._pool_size == 0:
            self._run_task(conn, req)
        else:
            self._tasks.put((conn, req))

    # -- handler execution (pool threads) ------------------------------------

    def _worker_loop(self) -> None:
        while True:
            item = self._tasks.get()
            if item is None:
                return
            self._run_task(*item)

    def _run_task(self, conn: _Connection, req: _Request) -> None:
        """Execute one request end to end, then settle the connection's
        accounting.  The in-flight decrement happens HERE — after the
        middleware tail (trace persist, metrics), not at response-send
        time — so shutdown's final flush and the idle reaper never
        observe a request as done while its trace is still being
        written."""
        try:
            self._execute(conn, req)
        except Exception:
            _access_log.exception(
                "unhandled error serving %s %s", req.command, req.path)
        finally:
            with conn.lock:
                unanswered = (req.seq >= conn.next_send
                              and req.seq not in conn.done)
            if unanswered:
                # an empty slot would wedge every later pipelined
                # response behind it, and the reaper skips connections
                # with queued slots — always settle the slot
                conn.push_slot(req.seq, assemble_response(
                    500, b'{"message": "internal server error"}',
                    close=True), True)
            with conn.lock:
                conn.inflight -= 1
                conn.inflight_bytes -= len(req.body)
                # wake the loop only when it has something to do for this
                # connection: resume a paused read, flush residual bytes,
                # or run a close decision (dead/closing, or peer_eof whose
                # close is gated on inflight hitting 0 — which this
                # decrement may just have done).  A clean keep-alive
                # response that flushed inline needs none of that.
                need_wake = (conn.paused or conn.dead or conn.closing
                             or conn.peer_eof or bool(conn.outq))
            with self._task_cv:
                self._active_tasks -= 1
                if not self._active_tasks:
                    self._task_cv.notify_all()
            if need_wake:
                self._wake(conn)

    def _execute(self, conn: _Connection, req: _Request) -> None:
        cls = self.RequestHandlerClass
        h = cls.__new__(cls)
        h.server = self
        h.connection = conn
        h.client_address = conn.addr
        h.command = req.command
        h.path = req.path
        h.headers = req.headers
        h.rfile = io.BytesIO(req.body)
        h.close_connection = req.close
        h._conn = conn
        h._seq = req.seq
        h._responded = False
        h._status_sent = 0
        h._body_unread = 0   # the loop buffered the body; stream is clean
        # request-id propagation: honor an incoming X-Request-ID (bounded)
        # or mint one PER REQUEST — pipelined requests each get their own
        rid = req.headers.get("x-request-id")
        h.request_id = (rid if rid and _RID_SAFE.match(rid)
                        else f"{_RID_PREFIX}-{next(_RID):x}")
        method = getattr(h, "do_" + req.command, None)
        # flight recorder: open a live trace keyed by the request id;
        # spans from instrumented layers accumulate via the contextvar
        # (set in THIS thread, where the handler runs), and the
        # tail-sampling keep/drop decision happens at the end
        recorder = _tracing.get_recorder()
        trace = recorder.begin(
            h.request_id, req.command,
            debug=req.headers.get("x-pio-debug") is not None)
        token = _tracing._CURRENT.set(trace) if trace is not None else None
        _M_INFLIGHT.inc()
        t0 = time.perf_counter()
        try:
            try:
                if method is None:
                    h.send_error_json(
                        501, f"Unsupported method ({req.command!r})")
                else:
                    method()
            except Exception:
                _access_log.exception("handler failed: %s %s",
                                      req.command, req.path)
                if not h._responded:
                    h.close_connection = True
                    h.send_error_json(500, "internal server error")
        finally:
            if not h._responded:
                # a handler that returned without answering would wedge
                # every later pipelined response behind its empty slot;
                # send the 500 BEFORE the instruments record so metrics,
                # stats, and the trace all see the status the client got
                h.close_connection = True
                h.send_error_json(500, "handler sent no response")
            _M_INFLIGHT.dec()
            route = route_label(req.path)
            if token is not None:
                _tracing._CURRENT.reset(token)
                recorder.finish(trace, h._status_sent or 0, route)
            # exemplar: the max-latency observation per window carries
            # its trace id, linking /metrics tails to /traces/<rid>.json
            _M_LAT.observe(time.perf_counter() - t0, route=route,
                           exemplar=h.request_id if trace is not None
                           else None)
            _M_REQS.inc(1, route=route, status=str(h._status_sent or 0))
            sc = h.stats_collector
            if sc is not None:
                sc.record(None, h._status_sent or 0, event=route)
        if _access_log.isEnabledFor(logging.DEBUG):
            _access_log.debug('"%s %s" %s rid=%s', req.command, req.path,
                              h._status_sent or "-", h.request_id)


class JsonHandler:
    """Base handler with JSON request/response helpers.

    Instantiated once per REQUEST by the event loop with the body fully
    buffered (``rfile`` is a BytesIO — ``read_json`` never blocks) and
    responses routed through the connection's ordered slots, so the same
    subclass serves serial keep-alive and pipelined clients alike."""

    server_version = "pio-tpu"
    protocol_version = "HTTP/1.1"
    # per-server-class stats.json window collector (obs.exposition
    # StatsCollector); the middleware records (status, route) into it
    stats_collector = None
    # TCP_NODELAY on accepted sockets (see _accept)
    disable_nagle_algorithm = True
    # default idle keep-alive reap seconds (PIO_HTTP_IDLE_S overrides)
    timeout = 120

    def log_message(self, fmt, *args):  # route access logs to logging
        _access_log.debug(fmt, *args)

    # -- helpers -------------------------------------------------------------

    @property
    def route(self) -> Tuple[str, Dict[str, str]]:
        path, _, qs = self.path.partition("?")
        if not qs:
            return path, {}
        if "%" in qs or "+" in qs or "#" in path:
            parsed = urlparse(self.path)
            return parsed.path, {
                k: v[0] for k, v in parse_qs(parsed.query).items()}
        # fast path: plain key=value pairs (every SDK request)
        query: Dict[str, str] = {}
        for part in qs.split("&"):
            k, _, v = part.partition("=")
            if k:
                query[k] = v
        return path, query

    def read_json(self) -> Any:
        length = int(self.headers.get("Content-Length") or 0)
        if length == 0:
            return None
        raw = self.rfile.read(length)
        self._body_unread = 0
        return json.loads(raw)

    def _send_raw(self, status: int, body: bytes,
                  ctype: str = _CT_JSON) -> None:
        if self._responded:
            _access_log.warning(
                "duplicate response (%d) for %s %s dropped",
                status, self.command, self.path)
            return
        self._responded = True
        self._status_sent = status
        rid = getattr(self, "request_id", "")
        close = self.close_connection
        self._conn.push_slot(
            self._seq, assemble_response(status, body, ctype, rid, close),
            close)

    def send_json(self, obj: Any, status: int = 200) -> None:
        self._send_raw(status, json.dumps(obj).encode())

    def send_error_json(self, status: int, message: str) -> None:
        self.send_json({"message": message}, status=status)

    def send_html(self, html: str, status: int = 200) -> None:
        self._send_raw(status, html.encode(), ctype="text/html; charset=utf-8")


def start_server(
    handler_cls, host: str, port: int, background: bool = False,
    reuse_port: bool = False,
) -> EventLoopHTTPServer:
    """``reuse_port`` binds with SO_REUSEPORT so several OS processes can
    serve one port (the prefork `pio deploy --workers N` path: the kernel
    load-balances accepts across workers — the CPython-GIL answer to
    multi-core serving, where the reference scaled by adding spray
    nodes behind a balancer).  Each worker runs one event loop plus a
    small handler pool; total concurrency is workers × pool."""
    httpd = EventLoopHTTPServer((host, port), handler_cls,
                                reuse_port=reuse_port)
    # the serving thread of a background server (None in the foreground):
    # a caller waits on it to learn that the server stopped
    httpd.thread = None
    if background:
        httpd.thread = threading.Thread(target=httpd.serve_forever, daemon=True,
                                        name="pio-http-loop")
        httpd.thread.start()
    return httpd
