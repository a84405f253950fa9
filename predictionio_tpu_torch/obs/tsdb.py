"""Local metrics time-series ring — Prometheus-shaped history, no
Prometheus (counterpart of ``predictionio_tpu/obs/tsdb.py``).

A :class:`MetricsSampler` thread snapshots the cross-worker aggregate
view (``metrics.aggregate_snapshot`` — the same merge a ``/metrics``
scrape performs) every ``PIO_TSDB_INTERVAL_S`` seconds into a bounded
in-memory ring (``PIO_TSDB_RING`` samples), served as
``/metrics/history.json``.  ``pio top`` renders qps/p95/lag/state-bytes
sparklines from consecutive samples, and the SLO engine
(:mod:`obs.slo`) evaluates its burn-rate windows over the same ring —
both without an external TSDB, which matches the deployment story:
one node, many workers, zero infrastructure.

Samples are *reduced*: counters/gauges keep their per-series values,
histograms keep per-series (counts, sum, count) with the bucket
boundaries hoisted once per metric — a ring of 360 samples at the
default 5 s interval is 30 minutes of history in a few MB.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from predictionio_tpu_torch.obs import metrics as _metrics


def tsdb_interval_s() -> float:
    """PIO_TSDB_INTERVAL_S: seconds between history samples (default 5)."""
    try:
        return max(float(os.environ.get("PIO_TSDB_INTERVAL_S", "5.0")), 0.1)
    except ValueError:
        return 5.0


def tsdb_ring() -> int:
    """PIO_TSDB_RING: samples kept (default 360 — 30 min at 5 s)."""
    try:
        return max(int(os.environ.get("PIO_TSDB_RING", "360")), 2)
    except ValueError:
        return 360


def reduce_snapshot(snap: dict) -> Dict[str, dict]:
    """One history sample's metric map from a full registry snapshot:
    drop help strings, keep per-series values (histograms keep their
    cumulative bucket counts — quantile-over-window needs them)."""
    out: Dict[str, dict] = {}
    for name, entry in snap.items():
        kind = entry.get("type")
        if kind == "histogram":
            out[name] = {"type": kind, "series": {
                k: {"counts": list(v["counts"]), "sum": v["sum"],
                    "count": v["count"]}
                for k, v in entry.get("series", {}).items()}}
        else:
            out[name] = {"type": kind,
                         "series": dict(entry.get("series", {}))}
    return out


class MetricsSampler:
    """Background ring of reduced metric samples + the /metrics/history
    payload.  One per process; sampling the AGGREGATE view means any
    worker's history describes the whole prefork group."""

    def __init__(self, interval: Optional[float] = None,
                 ring: Optional[int] = None):
        self.interval = interval if interval is not None else tsdb_interval_s()
        self._ring: deque = deque(maxlen=ring or tsdb_ring())
        self._buckets: Dict[str, List[float]] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def sample_now(self) -> dict:
        """Take one sample synchronously (also the thread's tick)."""
        snap = _metrics.aggregate_snapshot()
        sample = {"t": time.time(), "m": reduce_snapshot(snap)}
        with self._lock:
            for name, entry in snap.items():
                if entry.get("type") == "histogram" and "buckets" in entry:
                    self._buckets[name] = list(entry["buckets"])
            self._ring.append(sample)
        self._evaluate_slos()
        return sample

    def _evaluate_slos(self) -> None:
        """Refresh the SLO burn-rate gauges on every sample so /metrics
        carries them without anyone polling /healthz."""
        try:
            from predictionio_tpu_torch.obs import slo as _slo

            _slo.get_engine().evaluate(self.samples(), self._buckets_copy())
        except Exception:
            pass   # SLO evaluation must never kill the sampler

    def samples(self, limit: Optional[int] = None) -> List[dict]:
        with self._lock:
            out = list(self._ring)
        if limit is not None and limit > 0:
            out = out[-limit:]
        return out

    def _buckets_copy(self) -> Dict[str, List[float]]:
        with self._lock:
            return {k: list(v) for k, v in self._buckets.items()}

    def history(self, limit: int = 120) -> dict:
        """The /metrics/history.json body."""
        return {
            "worker": _metrics.worker_tag(),
            "intervalSeconds": self.interval,
            "buckets": self._buckets_copy(),
            "samples": self.samples(limit),
        }

    def start(self) -> None:
        if self._thread is not None:
            return
        self.sample_now()

        def loop():
            while not self._stop.wait(self.interval):
                try:
                    self.sample_now()
                except Exception:
                    pass   # a torn sibling file mid-merge; next tick heals

        self._thread = threading.Thread(
            target=loop, daemon=True, name="pio-tsdb-sample")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


_sampler: Optional[MetricsSampler] = None
_sampler_lock = threading.Lock()


def get_sampler() -> MetricsSampler:
    global _sampler
    with _sampler_lock:
        if _sampler is None:
            _sampler = MetricsSampler()
        return _sampler


def set_sampler(sampler: Optional[MetricsSampler]) -> None:
    """Swap the process sampler (tests; None resets to lazy default)."""
    global _sampler
    with _sampler_lock:
        if _sampler is not None and sampler is not _sampler:
            _sampler.stop()
        _sampler = sampler


def start_sampler() -> MetricsSampler:
    """Arm the history ring for this process — servers call this at
    startup, next to ``tracing.arm``; repeated calls are no-ops."""
    s = get_sampler()
    s.start()
    return s


def handle_history_request(handler, path: str) -> bool:
    """Serve /metrics/history.json on any JsonHandler server; returns
    True when the path was ours.  ``?limit=N`` bounds the sample count
    — the cluster federation scrapes with a small limit so a round
    over K nodes moves KBs, not the whole ring."""
    if path != "/metrics/history.json":
        return False
    if not _metrics.get_registry().enabled:
        handler.send_error_json(503, "metrics disabled (PIO_METRICS=off)")
        return True
    try:
        limit = int((handler.route[1] or {}).get("limit", "120"))
    except (ValueError, TypeError):
        limit = 120
    handler.send_json(get_sampler().history(limit))
    return True
