"""Process-local metrics registry with cross-process aggregation.

Counterpart of ``predictionio_tpu/obs/metrics.py``, whose snapshots it
reads and writes: Counter / Gauge / Histogram over a thread-safe
registry, designed for the prefork SO_REUSEPORT model (``api/prefork.py``):
each worker process owns a plain in-memory registry (one lock hop and a
dict update per record), and a :class:`SnapshotFlusher` persists its
snapshot to ``<PIO_METRICS_DIR>/<tag>.json`` (tag = the worker's
``PIO_METRICS_TAG``/``PIO_WRITER_TAG``).  A scrape of ANY worker merges
every sibling's snapshot file with its own live registry
(:func:`aggregate_snapshot`), so one ``GET /metrics`` sees the whole
server group.  Counters and gauges sum across workers; histograms sum
bucket-wise.

Naming contract (enforced at registration): every metric name matches
``pio_[a-z0-9_]+`` and carries a non-empty help string.

``PIO_METRICS=off`` disables recording globally; exposition then serves
whatever was recorded before the switch.  Exemplars (a trace id on a
histogram's max observation) are kept and merged as in the JAX package;
the front end's ``_execute`` sets the request id on ``pio_http_request_duration_seconds``.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time as _time
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple

NAME_RE = re.compile(r"^pio_[a-z0-9_]+$")

# log-scaled latency buckets (seconds): 500 µs … 60 s, the envelope of a
# single-event append on one end and a cold-compile train span on the other
LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)
# power-of-two size buckets for batch/occupancy histograms
SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096)


def _label_key(labels: Dict[str, str]) -> str:
    """Canonical series key: the Prometheus label body, sorted by name.
    Doubles as the on-disk snapshot key so merge needs no re-parsing."""
    if not labels:
        return ""
    return ",".join(
        '%s="%s"' % (k, str(v).replace("\\", "\\\\").replace('"', '\\"')
                     .replace("\n", "\\n"))
        for k, v in sorted(labels.items()))


class _Metric:
    """Common series bookkeeping; subclasses define the value shape."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str):
        self._reg = registry
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series: Dict[str, object] = {}

    def _snapshot_series(self):
        with self._lock:
            return dict(self._series)

    def clear_series(self) -> None:
        """Drop every series (identity gauges on server restart within
        one process; test isolation)."""
        with self._lock:
            self._series.clear()


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if not self._reg.enabled:
            return
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        return float(self._series.get(_label_key(labels), 0.0))


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels: str) -> None:
        if not self._reg.enabled:
            return
        key = _label_key(labels)
        with self._lock:
            self._series[key] = float(value)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if not self._reg.enabled:
            return
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels: str) -> None:
        self.inc(-amount, **labels)

    def remove(self, **labels: str) -> None:
        """Drop one labeled series entirely (vs. set(0): the series
        disappears from /metrics).  For per-peer gauges whose peer went
        away — a dead replication subscriber's lag series must not
        linger at its last value and trip lag alerts forever."""
        key = _label_key(labels)
        with self._lock:
            self._series.pop(key, None)

    def value(self, **labels: str) -> float:
        return float(self._series.get(_label_key(labels), 0.0))


def _exemplar_window_s() -> float:
    try:
        return max(float(os.environ.get("PIO_EXEMPLAR_WINDOW_S", "60")), 0.1)
    except ValueError:
        return 60.0


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, registry, name, help,
                 buckets: Sequence[float] = LATENCY_BUCKETS):
        super().__init__(registry, name, help)
        self.buckets: Tuple[float, ...] = tuple(sorted(buckets))

    def observe(self, value: float, exemplar: Optional[str] = None,
                **labels: str) -> None:
        """Record an observation.  ``exemplar`` (keyword-only by
        convention; it is NOT a label) attaches a trace id: the series
        keeps the max-value observation's id per rolling
        PIO_EXEMPLAR_WINDOW_S window, linking the histogram's tail back
        to a retrievable flight-recorder trace."""
        if not self._reg.enabled:
            return
        key = _label_key(labels)
        i = bisect_left(self.buckets, value)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                # one cumulative-count slot per bucket + the +Inf slot
                s = self._series[key] = {
                    "counts": [0] * (len(self.buckets) + 1),
                    "sum": 0.0, "count": 0}
            s["counts"][i] += 1
            s["sum"] += value
            s["count"] += 1
            if exemplar:
                ex = s.get("ex")
                now = _time.time()
                if (ex is None or value >= ex[0]
                        or now - ex[2] > _exemplar_window_s()):
                    s["ex"] = [value, exemplar, now]

    def _snapshot_series(self):
        with self._lock:
            out = {}
            for k, v in self._series.items():
                d = {"counts": list(v["counts"]), "sum": v["sum"],
                     "count": v["count"]}
                if "ex" in v:
                    d["ex"] = list(v["ex"])
                out[k] = d
            return out


class MetricsRegistry:
    """Thread-safe named-metric registry.  Registration is idempotent:
    asking for an existing name returns the existing metric (and raises
    on a kind mismatch), so modules can declare their instruments at
    import time without coordinating order."""

    def __init__(self, enabled: Optional[bool] = None):
        if enabled is None:
            enabled = os.environ.get("PIO_METRICS", "").lower() not in (
                "off", "0", "false")
        self.enabled = enabled
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _register(self, cls, name: str, help: str, **kw) -> _Metric:
        if not NAME_RE.match(name):
            raise ValueError(
                f"metric name {name!r} must match {NAME_RE.pattern}")
        if not help or not help.strip():
            raise ValueError(f"metric {name!r} needs a non-empty help string")
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind}")
                return m
            m = self._metrics[name] = cls(self, name, help, **kw)
            return m

    def counter(self, name: str, help: str) -> Counter:
        return self._register(Counter, name, help)

    def gauge(self, name: str, help: str) -> Gauge:
        return self._register(Gauge, name, help)

    def histogram(self, name: str, help: str,
                  buckets: Sequence[float] = LATENCY_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help, buckets=buckets)

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def snapshot(self) -> dict:
        """JSON-able full-state dump, the unit of cross-process exchange."""
        out = {}
        for m in self.metrics():
            entry = {"type": m.kind, "help": m.help,
                     "series": m._snapshot_series()}
            if isinstance(m, Histogram):
                entry["buckets"] = list(m.buckets)
            out[m.name] = entry
        return out


def _merge_exemplar(a, b):
    """Pick the cross-worker exemplar: prefer a fresh one over a stale
    one (a dead worker's max must not pin the link forever), then the
    larger observed value."""
    if a is None:
        return b
    if b is None:
        return a
    now = _time.time()
    window = _exemplar_window_s()
    a_fresh = now - a[2] <= window
    b_fresh = now - b[2] <= window
    if a_fresh != b_fresh:
        return a if a_fresh else b
    return a if a[0] >= b[0] else b


def merge_snapshots(snapshots: Sequence[dict]) -> dict:
    """Sum snapshots across workers: counters/gauges add per series,
    histograms add bucket-wise (boundaries must agree — they come from
    the same code in every worker) and keep one exemplar per series."""
    merged: dict = {}
    for snap in snapshots:
        for name, entry in snap.items():
            tgt = merged.get(name)
            if tgt is None:
                tgt = merged[name] = {
                    "type": entry["type"], "help": entry["help"],
                    "series": {}}
                if "buckets" in entry:
                    tgt["buckets"] = list(entry["buckets"])
            for key, val in entry["series"].items():
                cur = tgt["series"].get(key)
                if entry["type"] == "histogram":
                    if cur is None:
                        cur = tgt["series"][key] = {
                            "counts": list(val["counts"]),
                            "sum": val["sum"], "count": val["count"]}
                    else:
                        cur["counts"] = [a + b for a, b in
                                         zip(cur["counts"], val["counts"])]
                        cur["sum"] += val["sum"]
                        cur["count"] += val["count"]
                    ex = _merge_exemplar(cur.get("ex"), val.get("ex"))
                    if ex is not None:
                        cur["ex"] = list(ex)
                else:
                    tgt["series"][key] = (cur or 0.0) + val
    return merged


# -- process-default registry -------------------------------------------------

_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _REGISTRY


def set_enabled(enabled: bool) -> None:
    """Runtime switch for the default registry (the bench's
    instrumentation-overhead guard toggles this)."""
    _REGISTRY.enabled = enabled


def worker_tag() -> str:
    """This process's metrics identity: the active snapshot flusher's tag
    (authoritative — the prefork parent assigns itself ``w0-<pid>``
    explicitly and restores its environment afterwards), else
    PIO_METRICS_TAG (deploy workers) or PIO_WRITER_TAG (event-server
    workers), else pid-based."""
    with _flusher_lock:
        if _flusher is not None:
            return _flusher.tag
    return (os.environ.get("PIO_METRICS_TAG")
            or os.environ.get("PIO_WRITER_TAG")
            or f"pid-{os.getpid()}")


# the prefork health view: one series per live worker, merged at scrape
WORKER_UP = _REGISTRY.gauge(
    "pio_worker_up", "1 per worker process contributing to this scrape")

# dead-worker hygiene for every sibling-file merge (/metrics snapshots,
# /traces.json rings, /lineage.json rings): files whose mtime exceeds
# PIO_OBS_SIBLING_STALE_S are a dead group member's leftovers — evicted
# (unlinked) from the merge and counted here by kind
STALE_SIBLINGS = _REGISTRY.counter(
    "pio_obs_stale_siblings_total",
    "Dead-worker sibling files evicted from cross-worker merges after "
    "PIO_OBS_SIBLING_STALE_S (default 600 s), by kind "
    "(metrics | traces | lineage)")


def sibling_stale_s() -> float:
    """PIO_OBS_SIBLING_STALE_S: sibling files older than this are
    evicted from /metrics, /traces.json, and /lineage.json merges
    (default 600 s — long enough to ride out a stop-the-world pause,
    short enough that a SIGKILLed worker's gauges don't haunt the group
    for a day)."""
    try:
        return max(float(os.environ.get("PIO_OBS_SIBLING_STALE_S", "600")),
                   1.0)
    except ValueError:
        return 600.0

# per-worker resident memory, refreshed on every snapshot flush and
# scrape: with the shared model plane, N workers mapping one arena show
# near-baseline anonymous RSS each (file-backed model pages are shared
# page cache) — the bench's plane_memory_guard reads exactly this view
PROCESS_RSS = _REGISTRY.gauge(
    "pio_process_rss_bytes",
    "Resident-set bytes of this process, one {worker} series per live "
    "worker (Linux /proc/self/statm; absent elsewhere).  NOTE: "
    "file-backed pages (mmapped model-plane arenas) count in EVERY "
    "mapping worker's RSS — sum PSS, not this, for node totals")

_PAGE_BYTES = (os.sysconf("SC_PAGE_SIZE")
               if hasattr(os, "sysconf") else 4096)


def update_process_rss(tag: Optional[str] = None) -> None:
    """Refresh this process's pio_process_rss_bytes series (no-op where
    /proc is unavailable).  ``tag`` overrides the worker label — the
    snapshot flusher passes its own (calling worker_tag() from inside
    the flusher-lock hold would deadlock)."""
    try:
        with open("/proc/self/statm") as f:
            rss = int(f.read().split()[1]) * _PAGE_BYTES
    except (OSError, ValueError, IndexError):
        return
    PROCESS_RSS.set(rss, worker=tag or worker_tag())


def mark_worker_up(tag: Optional[str] = None) -> None:
    """Declare THIS process's worker identity.  Clears previous local
    pio_worker_up series first: a process only ever IS one worker, and a
    programmatic server restarted in-process (tests) must not keep
    advertising its old tag.  Also SEEDS pio_process_rss_bytes for this
    worker: a freshly-forked worker that has served zero requests must
    still report an RSS row on the group's first scrape (the snapshot
    flusher's first flush would otherwise race the first scrape and the
    worker would be invisible to the memory dashboards)."""
    tag = tag or worker_tag()
    WORKER_UP.clear_series()
    WORKER_UP.set(1, worker=tag)
    update_process_rss(tag)


class SnapshotFlusher:
    """Background persister of the registry snapshot for cross-worker
    scrapes.  Writes ``<dir>/<tag>.json`` atomically (tmp+rename) every
    ``interval`` seconds and on demand (:meth:`flush`)."""

    def __init__(self, directory: str, tag: str,
                 registry: Optional[MetricsRegistry] = None,
                 interval: Optional[float] = None):
        self.dir = directory
        self.tag = tag
        self.registry = registry or _REGISTRY
        if interval is None:
            try:
                interval = float(os.environ.get("PIO_METRICS_FLUSH_S", "1.0"))
            except ValueError:
                interval = 1.0
        self.interval = max(interval, 0.05)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def path(self) -> str:
        return os.path.join(self.dir, f"{self.tag}.json")

    def flush(self) -> None:
        update_process_rss(self.tag)
        tmp = self.path + f".tmp{os.getpid()}"
        try:
            os.makedirs(self.dir, exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(self.registry.snapshot(), f)
            os.replace(tmp, self.path)
        except OSError:
            # the dir may be torn down mid-shutdown; a missed flush only
            # staleness-lags siblings' view, never corrupts it
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def start(self) -> None:
        if self._thread is not None:
            return
        self.flush()

        def loop():
            while not self._stop.wait(self.interval):
                self.flush()

        self._thread = threading.Thread(
            target=loop, daemon=True, name="pio-metrics-flush")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        self.flush()


_flusher: Optional[SnapshotFlusher] = None
_flusher_lock = threading.Lock()


def start_worker_flusher(directory: Optional[str] = None,
                         tag: Optional[str] = None) -> Optional[SnapshotFlusher]:
    """Arm cross-worker aggregation for this process.  No-op without a
    metrics dir (single-worker servers stay purely in-memory).  A second
    call replaces the previous flusher (programmatic servers in one
    process, e.g. tests) — the registry itself is process-global either
    way."""
    global _flusher
    directory = directory or os.environ.get("PIO_METRICS_DIR")
    if not directory:
        return None
    if tag is None:
        # resolve from env here, NOT via worker_tag() — that helper reads
        # the flusher under _flusher_lock, which this block holds
        tag = (os.environ.get("PIO_METRICS_TAG")
               or os.environ.get("PIO_WRITER_TAG")
               or f"pid-{os.getpid()}")
    with _flusher_lock:
        if _flusher is not None:
            _flusher.stop()
        _flusher = SnapshotFlusher(directory, tag)
        mark_worker_up(tag)
        _flusher.start()
        return _flusher


def stop_worker_flusher() -> None:
    global _flusher
    with _flusher_lock:
        if _flusher is not None:
            _flusher.stop()
            _flusher = None


def aggregate_snapshot(registry: Optional[MetricsRegistry] = None) -> dict:
    """The scrape view: this process's LIVE registry merged with every
    sibling worker's persisted snapshot.  Flushes our own file first so
    alternating scrapes across workers converge within one flush
    interval instead of two."""
    registry = registry or _REGISTRY
    if registry is _REGISTRY:
        update_process_rss()
    snaps = [registry.snapshot()]
    with _flusher_lock:
        fl = _flusher
    if fl is not None:
        fl.flush()
        # a sibling whose file stopped updating is dead (SIGKILLed/OOMed):
        # its counters still count — the events it acked are on disk — but
        # its GAUGES describe the current state of a process that no
        # longer exists (in-flight requests, worker_up) and must read 0,
        # or an idle server reports the dead worker's last values forever
        stale_after = max(10.0 * fl.interval, 15.0)
        evict_after = sibling_stale_s()
        try:
            names = sorted(os.listdir(fl.dir))
        except OSError:
            names = []
        now = _time.time()
        for name in names:
            if not name.endswith(".json") or name == f"{fl.tag}.json":
                continue
            path = os.path.join(fl.dir, name)
            try:
                mtime = os.stat(path).st_mtime
            except OSError:
                continue
            if now - mtime > evict_after:
                # LONG-dead sibling: merging its snapshot forever would
                # keep a killed worker's counters in every scrape until
                # the dir is torn down — evict the file (its acked work
                # already aged out of every rate window)
                try:
                    os.unlink(path)
                    STALE_SIBLINGS.inc(1, kind="metrics")
                except OSError:
                    pass
                continue
            try:
                with open(path) as f:
                    snap = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue  # sibling mid-write/teardown; next scrape heals
            if now - mtime > stale_after:
                for entry in snap.values():
                    if entry.get("type") == "gauge":
                        entry["series"] = {k: 0.0 for k in entry["series"]}
            snaps.append(snap)
    return merge_snapshots(snaps)


class SeriesView:
    """Read-only mapping of names to registry series, for code that reads
    counts as a dict (``native.core.calls["scan"]``,
    ``storage.snapshot.counts["hits"]``): ``view[name]`` is the current
    value of its (metric, labels) series as an int."""

    def __init__(self, series: Dict[str, Tuple["_Metric", Dict[str, str]]]):
        self._series = dict(series)

    def __getitem__(self, name: str) -> int:
        metric, labels = self._series[name]
        return int(metric.value(**labels))

    def __contains__(self, name) -> bool:
        return name in self._series

    def keys(self):
        return self._series.keys()

    def items(self):
        return [(k, self[k]) for k in self._series]

    def __iter__(self):
        return iter(self._series)

    def __len__(self) -> int:
        return len(self._series)

    def __repr__(self) -> str:
        return repr(dict(self.items()))
