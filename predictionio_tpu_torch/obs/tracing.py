"""Request flight recorder: always-on, tail-sampled HTTP request traces
(counterpart of ``predictionio_tpu/obs/tracing.py``, whose trace files
and documents it reads and writes).

Every request on the event server, query server, and dashboard opens a
live :class:`Trace` (keyed by the X-Request-ID the http_util middleware
already mints/propagates); instrumented layers append spans to it
through the ``current_trace()`` contextvar (``utils.tracing.timed``, the
storage group commit, snapshot scans, and the UR serve tail all feed
it).  At request end the :class:`FlightRecorder` makes the *tail
sampling* decision (Dapper/Canopy style — record everything cheaply,
keep only what matters):

- ``slow``    — duration ≥ ``PIO_TRACE_SLOW_MS`` (default 250 ms);
- ``error``   — response status ≥ 500 (or the connection died mid-write);
- ``debug``   — the request carried an ``X-PIO-Debug`` header;
- ``sampled`` — 1-in-``PIO_TRACE_SAMPLE_N`` uniform keep (default 1000,
  ``0`` disables), the ambient baseline that keeps /traces.json useful
  even when nothing is wrong.

Everything else is dropped at request end: a boring request costs one
small object, two contextvar ops, and one branch.

Retained traces land in a bounded per-worker ring (``PIO_TRACE_RING``,
default 128) and are persisted to ``<traces dir>/<worker tag>.json`` so
ANY worker of a prefork group (or a dashboard sharing the storage) can
answer ``/traces.json`` (index) and ``/traces/<rid>.json`` (full
waterfall) for the whole group — the same sibling-snapshot pattern as
the cross-worker /metrics merge.

Traces dir precedence (:func:`traces_dir`): ``PIO_TRACE_DIR``, else
``<PIO_METRICS_DIR>/traces`` (prefork groups), else ``<storage
localfs/sharedfs METADATA path>/traces`` (next to span journals), else
in-memory only.  Kill switch: ``PIO_TRACING=off``.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import random
import threading
import time
from collections import deque
from pathlib import Path
from typing import Dict, List, Optional

from predictionio_tpu_torch.obs import metrics as _metrics
from predictionio_tpu_torch.obs.spans import SpanCollector

_REG = _metrics.get_registry()
_M_RETAINED = _REG.counter(
    "pio_traces_retained_total",
    "Traces kept by the flight recorder, by tail-sampling reason "
    "(slow/error/debug/sampled)")
_M_EVICTED = _REG.counter(
    "pio_trace_ring_evictions_total",
    "Retained traces evicted from the ring buffer by newer ones")

_CURRENT: contextvars.ContextVar[Optional["Trace"]] = (
    contextvars.ContextVar("pio_trace", default=None))

# span/attr naming contract (linted by scripts/check_metrics_names.py):
# lowercase snake with optional dots, like metric names without the
# pio_ prefix — keeps waterfall rows greppable and dashboards stable
SPAN_NAME_PATTERN = r"^[a-z][a-z0-9_.]*$"


def current_trace() -> Optional["Trace"]:
    return _CURRENT.get()


def trace_span(name: str, **attrs):
    """Span on the current request trace, or a no-op when none is active
    — the one-liner instrumented layers use so they never import more
    than this function."""
    t = _CURRENT.get()
    if t is None:
        return contextlib.nullcontext()
    return t.span(name, **attrs)


class Trace(SpanCollector):
    """One request's live trace: span collector + request envelope."""

    def __init__(self, rid: str, method: str = "", debug: bool = False):
        super().__init__()
        self.rid = rid
        self.method = method
        self.debug = debug
        self.start = time.time()
        self._t0 = time.perf_counter()
        self.route = ""
        self.status = 0

    def to_doc(self, worker: str, reason: str) -> dict:
        dur = time.perf_counter() - self._t0
        return {
            "rid": self.rid,
            "start": self.start,
            "durationMs": round(dur * 1e3, 4),
            "method": self.method,
            "route": self.route,
            "status": self.status,
            "worker": worker,
            "reason": reason,
            "spans": self.spans(),
        }

    def duration_s(self) -> float:
        return time.perf_counter() - self._t0

    @contextlib.contextmanager
    def activate(self):
        token = _CURRENT.set(self)
        try:
            yield self
        finally:
            _CURRENT.reset(token)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def traces_dir(storage=None) -> Optional[Path]:
    """Where this process persists retained traces for siblings (see
    module docstring for the precedence); None = in-memory ring only."""
    env = os.environ.get("PIO_TRACE_DIR")
    if env:
        return Path(env)
    md = os.environ.get("PIO_METRICS_DIR")
    if md:
        return Path(md) / "traces"
    if storage is not None:
        try:
            src = storage.config.sources[storage.config.repositories["METADATA"]]
            if src.get("type") in ("localfs", "sharedfs") and src.get("path"):
                return Path(src["path"]) / "traces"
        except (KeyError, AttributeError):
            pass
    return None


class FlightRecorder:
    """Per-process retained-trace ring + the tail-sampling policy."""

    # persistence is coalesced to at most one ring write per window: a
    # retention inside the window arms a one-shot deferred flush instead
    # of rewriting the whole ring inline per request (an unauthenticated
    # X-PIO-Debug spammer must not turn every request into an O(ring)
    # disk write), so a sibling can still fetch any retained trace
    # within ~this many seconds
    PERSIST_THROTTLE_S = 0.5

    def __init__(self, ring: Optional[int] = None,
                 slow_ms: Optional[float] = None,
                 sample_n: Optional[int] = None,
                 directory: Optional[os.PathLike] = None,
                 tag: Optional[str] = None,
                 enabled: Optional[bool] = None):
        if enabled is None:
            enabled = os.environ.get("PIO_TRACING", "").lower() not in (
                "off", "0", "false")
        self.enabled = enabled
        self.slow_ms = slow_ms if slow_ms is not None else _env_float(
            "PIO_TRACE_SLOW_MS", 250.0)
        self.sample_n = sample_n if sample_n is not None else _env_int(
            "PIO_TRACE_SAMPLE_N", 1000)
        size = ring if ring is not None else max(
            _env_int("PIO_TRACE_RING", 128), 1)
        self._ring: deque = deque(maxlen=size)
        self._lock = threading.Lock()
        # serializes the snapshot+write+rename; the ring lock is never
        # held across file I/O
        self._io_lock = threading.Lock()
        self.dir: Optional[Path] = Path(directory) if directory else None
        self._tag = tag
        self._dirty = False
        self._last_persist = 0.0
        self._flush_timer: Optional[threading.Timer] = None

    @property
    def tag(self) -> str:
        return self._tag or _metrics.worker_tag()

    def configure(self, directory: Optional[os.PathLike],
                  tag: Optional[str] = None) -> None:
        with self._lock:
            self.dir = Path(directory) if directory else None
            if tag is not None:
                self._tag = tag

    # -- request lifecycle ---------------------------------------------------

    def begin(self, rid: str, method: str = "",
              debug: bool = False) -> Optional[Trace]:
        if not self.enabled:
            return None
        return Trace(rid, method, debug=debug)

    def finish(self, trace: Optional[Trace], status: int,
               route: str = "") -> Optional[str]:
        """Request-end tail-sampling decision; returns the retention
        reason, or None when the trace was dropped."""
        if trace is None:
            return None
        trace.status = status
        trace.route = route
        reason = None
        if trace.debug:
            reason = "debug"
        elif status >= 500 or status == 0:
            reason = "error"
        elif trace.duration_s() * 1e3 >= self.slow_ms:
            reason = "slow"
        elif self.sample_n > 0 and random.randrange(self.sample_n) == 0:
            reason = "sampled"
        if reason is None:
            return None
        doc = trace.to_doc(self.tag, reason)
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                _M_EVICTED.inc()
            self._ring.append(doc)
            self._dirty = True
        _M_RETAINED.inc(1, reason=reason)
        self._request_persist()
        return reason

    def record(self, doc: dict) -> None:
        """Inject a pre-built trace doc (tests)."""
        with self._lock:
            self._ring.append(doc)
            self._dirty = True
        self._persist()

    # -- persistence + cross-worker merge ------------------------------------

    def _request_persist(self) -> None:
        """Persist now when outside the throttle window; otherwise arm
        ONE deferred flush at the window's end, so bursts of retentions
        coalesce into a single ring write while a sibling can still
        fetch any retained trace within PERSIST_THROTTLE_S."""
        if self.dir is None:
            return
        delay = self.PERSIST_THROTTLE_S - (
            time.monotonic() - self._last_persist)
        if delay <= 0:
            self._persist()
            return
        with self._lock:
            if self._flush_timer is not None:
                return
            t = self._flush_timer = threading.Timer(delay, self._timer_flush)
            t.daemon = True
        t.start()

    def _timer_flush(self) -> None:
        with self._lock:
            self._flush_timer = None
        self.flush()

    def _persist(self) -> None:
        if self.dir is None:
            return
        # _io_lock serializes concurrent retentions' writes (handler
        # threads share one tag file; unserialized writers would race on
        # the tmp file and the second os.replace would lose its traces)
        with self._io_lock:
            with self._lock:
                payload = {"worker": self.tag, "flushedAt": time.time(),
                           "traces": list(self._ring)}
                self._dirty = False
            self._last_persist = time.monotonic()
            path = self.dir / f"{self.tag}.json"
            tmp = path.with_name(path.name + f".tmp{os.getpid()}")
            try:
                os.makedirs(self.dir, exist_ok=True)
                with open(tmp, "w") as f:
                    json.dump(payload, f)
                os.replace(tmp, path)
            except OSError:
                # mid-teardown dir removal: a missed persist only
                # staleness-lags the siblings' view — but the ring is
                # still dirty, so a later flush can retry
                with self._lock:
                    self._dirty = True
                with contextlib.suppress(OSError):
                    os.unlink(tmp)

    def flush(self) -> None:
        if self._dirty:
            self._persist()

    def _sibling_docs(self) -> List[dict]:
        """Every worker's persisted ring (including our own file's —
        deduped by rid later), newest files first."""
        if self.dir is None:
            return []
        self.flush()   # serve-own-retentions-immediately, like /metrics
        try:
            names = [n for n in os.listdir(self.dir) if n.endswith(".json")]
        except OSError:
            return []
        docs: List[dict] = []
        now = time.time()
        stale_after = _metrics.sibling_stale_s()
        for name in names:
            path = self.dir / name
            try:
                mtime = os.stat(path).st_mtime
            except OSError:
                continue
            if now - mtime > stale_after:
                # a dead group member's leftovers: evict from the merge
                # and reclaim the disk — but never our OWN file (the
                # live in-memory ring is merged separately and the next
                # retention re-creates it)
                if name != f"{self.tag}.json":
                    try:
                        os.unlink(path)
                        _metrics.STALE_SIBLINGS.inc(1, kind="traces")
                    except OSError:
                        pass
                continue
            try:
                with open(path) as f:
                    payload = json.load(f)
                docs.extend(payload.get("traces", ()))
            except (OSError, json.JSONDecodeError):
                continue   # sibling mid-write; next read heals
        return docs

    def _merged(self) -> List[dict]:
        by_rid: Dict[str, dict] = {}
        with self._lock:
            own = list(self._ring)
        for doc in self._sibling_docs() + own:
            prev = by_rid.get(doc.get("rid", ""))
            if prev is None or doc.get("start", 0) >= prev.get("start", 0):
                by_rid[doc.get("rid", "")] = doc
        return sorted(by_rid.values(),
                      key=lambda d: d.get("start", 0), reverse=True)

    def index(self, limit: int = 200) -> dict:
        """The /traces.json body: cross-worker merged summaries, newest
        first."""
        entries = [{k: d.get(k) for k in
                    ("rid", "start", "durationMs", "method", "route",
                     "status", "worker", "reason")}
                   | {"spanCount": len(d.get("spans", ()))}
                   for d in self._merged()[:limit]]
        return {"worker": self.tag, "traces": entries}

    def get(self, rid: str) -> Optional[dict]:
        """Full waterfall for one request id, from our ring or any
        sibling's persisted ring."""
        with self._lock:
            for doc in reversed(self._ring):
                if doc.get("rid") == rid:
                    return doc
        for doc in self._merged():
            if doc.get("rid") == rid:
                return doc
        return None


_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()


def get_recorder() -> FlightRecorder:
    global _recorder
    with _recorder_lock:
        if _recorder is None:
            _recorder = FlightRecorder()
        return _recorder


def set_recorder(recorder: Optional[FlightRecorder]) -> None:
    """Swap the process recorder (tests; None resets to lazy default)."""
    global _recorder
    with _recorder_lock:
        _recorder = recorder


def arm(storage=None, directory: Optional[os.PathLike] = None,
        tag: Optional[str] = None) -> FlightRecorder:
    """Point the process recorder at this deployment's traces dir so
    retained traces become visible to sibling workers and the dashboard.
    Servers call this at startup; a missing dir keeps the ring
    in-memory-only (endpoints still serve this process's traces)."""
    rec = get_recorder()
    rec.configure(directory if directory is not None else traces_dir(storage),
                  tag)
    return rec


def render_waterfall_text(doc: dict, width: int = 40) -> str:
    """ASCII waterfall of one trace doc (``pio trace`` output): spans
    indented by depth, bars proportional to their offset/duration within
    the request."""
    total_ms = max(float(doc.get("durationMs") or 0.0), 1e-6)
    t0 = float(doc.get("start") or 0.0)
    lines = [
        "trace %s: %s %s -> %s in %.2f ms (worker %s, kept: %s)" % (
            doc.get("rid", "?"), doc.get("method", ""), doc.get("route", ""),
            doc.get("status", 0), total_ms, doc.get("worker", "?"),
            doc.get("reason", "?"))]
    depth = {None: -1}
    for s in sorted(doc.get("spans", ()), key=lambda x: x.get("id", 0)):
        depth[s.get("id")] = d = depth.get(s.get("parent"), -1) + 1
        off_ms = max((float(s.get("start", t0)) - t0) * 1e3, 0.0)
        dur_ms = float(s.get("duration_s", 0.0)) * 1e3
        i0 = min(int(off_ms / total_ms * width), width - 1)
        i1 = min(max(int((off_ms + dur_ms) / total_ms * width), i0 + 1), width)
        bar = " " * i0 + "#" * (i1 - i0) + " " * (width - i1)
        name = "  " * d + str(s.get("name", "?"))
        err = " !" if s.get("error") else ""
        attrs = s.get("attrs") or {}
        attr_txt = (" " + " ".join(f"{k}={v}"
                                   for k, v in sorted(attrs.items()))
                    if attrs else "")
        lines.append("  %-28s %9.3f ms |%s|%s%s"
                     % (name[:28], dur_ms, bar, err, attr_txt))
    if not doc.get("spans"):
        lines.append("  (no spans recorded below the request envelope)")
    return "\n".join(lines) + "\n"


# -- shared HTTP endpoints ----------------------------------------------------

def handle_trace_request(handler, path: str) -> bool:
    """Serve /traces.json and /traces/<rid>.json on any JsonHandler
    server; returns True when the path was one of ours.  Unauthenticated
    like /metrics: traces carry route/timing structure, not event
    payloads."""
    if path == "/traces.json":
        rec = get_recorder()
        if not rec.enabled:
            handler.send_error_json(503, "tracing disabled (PIO_TRACING=off)")
            return True
        handler.send_json(rec.index())
        return True
    if path.startswith("/traces/") and path.endswith(".json"):
        rec = get_recorder()
        if not rec.enabled:
            handler.send_error_json(503, "tracing disabled (PIO_TRACING=off)")
            return True
        rid = path[len("/traces/"):-len(".json")]
        doc = rec.get(rid)
        if doc is None:
            handler.send_error_json(
                404, f"no retained trace for request id {rid!r}")
        else:
            handler.send_json(doc)
        return True
    return False
