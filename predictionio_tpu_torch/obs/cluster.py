"""Cluster observability: federate subscriber metrics and lineage onto
the publisher (counterpart of ``predictionio_tpu/obs/cluster.py``).

Plane replication makes the model plane multi-node; this module makes the CLUSTER
the unit of observation.  A :class:`ClusterFederation` thread on the
publisher scrapes every replication subscriber's ``/metrics/history.json``
(endpoints are announced in the replication sync frames — no separate
service discovery) with a bounded timeout, keeps a per-node liveness
view (a node that stops answering is reported ``up: false`` with its
staleness, never silently dropped), and pulls each subscriber's recent
``/lineage/<lid>.json`` records to complete the stitched cross-node
lineage story — the ack-payload push covers ``repl.*`` stages, the pull
covers the ``install``/``first_serve`` stages that happen AFTER the
subscriber last acked.

Federated signals are re-exported as LOCAL publisher metrics so the
existing tsdb ring and SLO engine evaluate cluster health with zero new
machinery:

- ``pio_cluster_propagation_seconds`` — append → last-node
  ``first_serve``, read from stitched ``cluster_complete`` lineage
  records (NOT client-side wall clocks), observed once per lineage id;
- ``pio_cluster_qps_divergence`` / ``pio_cluster_p95_divergence`` —
  hottest/slowest node over the cluster mean (1.0 = perfectly even);
- ``pio_cluster_node_up{node}`` / ``pio_cluster_nodes`` /
  ``pio_cluster_scrapes_total{node,outcome}`` — the scrape loop's own
  health.

Served as ``/cluster/metrics.json`` (latest per-node view) and
``/cluster/history.json`` (bounded ring of federated samples) on the
publisher only; ``pio top --cluster`` renders per-node columns from
them.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from predictionio_tpu_torch.obs import lineage as _lineage
from predictionio_tpu_torch.obs import metrics as _metrics
from predictionio_tpu_torch.obs.exposition import _quantile_from_buckets
from predictionio_tpu_torch.obs.slo import (
    _series_max,
    _series_sum_hist,
    _series_total,
)

log = logging.getLogger("pio.cluster")

_REG = _metrics.get_registry()

# propagation spans network + install cadence, not request latency:
# wider buckets than LATENCY_BUCKETS, topping out at minutes
PROPAGATION_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                       10.0, 30.0, 60.0, 120.0)

_M_NODES = _REG.gauge(
    "pio_cluster_nodes",
    "Subscriber nodes this publisher has ever seen over replication "
    "(the federation scrape list; disconnects mark, never remove)")
_M_UP = _REG.gauge(
    "pio_cluster_node_up",
    "1 when the named subscriber node answered its last federation "
    "scrape, 0 otherwise — stale nodes stay visible at 0 rather than "
    "disappearing")
_M_SCRAPES = _REG.counter(
    "pio_cluster_scrapes_total",
    "Federation scrape attempts by subscriber node and outcome "
    "(ok|error; error includes a node that never announced an HTTP "
    "endpoint)")
_M_PROP = _REG.histogram(
    "pio_cluster_propagation_seconds",
    "append_observed -> LAST node's first_serve, read from stitched "
    "cluster_complete lineage records (one observation per lineage id) "
    "— the cluster-truth propagation the multinode bench reports",
    buckets=PROPAGATION_BUCKETS)
_M_QPS_DIV = _REG.gauge(
    "pio_cluster_qps_divergence",
    "Hottest node's serve qps over the cluster mean (1.0 = perfectly "
    "balanced; computed over nodes that answered their last scrape)")
_M_P95_DIV = _REG.gauge(
    "pio_cluster_p95_divergence",
    "Slowest node's serve p95 over the cluster mean (1.0 = uniform "
    "latency; computed over nodes that answered their last scrape)")


def cluster_scrape_s() -> float:
    """PIO_CLUSTER_SCRAPE_S: seconds between federation scrapes
    (default 5 — same cadence as the local tsdb ring)."""
    try:
        return max(float(os.environ.get("PIO_CLUSTER_SCRAPE_S", "5.0")),
                   0.1)
    except ValueError:
        return 5.0


def cluster_scrape_timeout_s() -> float:
    """PIO_CLUSTER_SCRAPE_TIMEOUT_S: per-node HTTP timeout (default 2).
    Bounded so one wedged node cannot stall the whole scrape round."""
    try:
        return max(float(os.environ.get(
            "PIO_CLUSTER_SCRAPE_TIMEOUT_S", "2.0")), 0.1)
    except ValueError:
        return 2.0


def cluster_ring() -> int:
    """PIO_CLUSTER_RING: federated samples kept (default 240 — 20 min
    at the 5 s default scrape)."""
    try:
        return max(int(os.environ.get("PIO_CLUSTER_RING", "240")), 2)
    except ValueError:
        return 240


def _fetch_json(url: str, timeout: float) -> Any:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8", "replace"))


def _node_stats(history: dict) -> Dict[str, Any]:
    """One node's headline numbers from its scraped history body:
    serving generation, repl lag, qps and serve p95 over the scraped
    sample window.  Missing metrics stay None (a node that serves no
    queries has no p95 — that is signal, not an error)."""
    out: Dict[str, Any] = {"generation": None, "replLag": None,
                           "qps": None, "p95": None}
    samples = history.get("samples") or []
    if not samples:
        return out
    cur = samples[-1].get("m", {})
    gen = _series_max(cur.get("pio_model_plane_generation"), "")
    if gen is not None:
        out["generation"] = int(gen)
    lag = _series_max(cur.get("pio_plane_repl_lag_generations"), "")
    if lag is not None:
        out["replLag"] = lag
    if len(samples) < 2:
        return out
    first = samples[0].get("m", {})
    dt = float(samples[-1].get("t", 0)) - float(samples[0].get("t", 0))
    if dt > 0:
        c0 = _series_total(first.get("pio_http_requests_total"), "")
        c1 = _series_total(cur.get("pio_http_requests_total"), "")
        if c1 is not None:
            delta = c1 - (c0 or 0.0)
            if delta < 0:          # a worker restarted mid-window
                delta = c1
            out["qps"] = round(delta / dt, 3)
    h1 = _series_sum_hist(cur.get("pio_http_request_duration_seconds"),
                          'route="/queries.json"')
    bounds = (history.get("buckets") or {}).get(
        "pio_http_request_duration_seconds")
    if h1 is not None and bounds:
        h0 = _series_sum_hist(
            first.get("pio_http_request_duration_seconds"),
            'route="/queries.json"')
        counts = list(h1["counts"])
        total = h1["count"]
        if h0 is not None and h0["count"] <= h1["count"]:
            counts = [a - b for a, b in zip(h1["counts"], h0["counts"])]
            total = h1["count"] - h0["count"]
        if total > 0:
            cum, pairs = 0.0, []
            for le, c in zip(list(bounds) + [float("inf")], counts):
                cum += max(c, 0)
                pairs.append((le, cum))
            out["p95"] = round(_quantile_from_buckets(
                pairs, total, 0.95), 6)
    return out


def _divergence(values: List[float]) -> float:
    """max/mean over the reporting nodes; 1.0 when fewer than two nodes
    report or nothing flows (no traffic is not an imbalance)."""
    vals = [float(v) for v in values if v is not None and v > 0]
    if len(vals) < 2:
        return 1.0
    mean = sum(vals) / len(vals)
    if mean <= 0:
        return 1.0
    return max(vals) / mean


class ClusterFederation:
    """The publisher's scrape loop over its replication peers.

    ``peers_fn`` returns the replicator's peer registry (node →
    {addr, httpPort, connected, lastSeen}); nodes are scraped whether
    or not their replication session is currently connected — a node
    mid-reconnect still serves, and a dead one must keep showing as
    down, not vanish."""

    def __init__(self, peers_fn: Callable[[], Dict[str, Dict[str, Any]]],
                 interval: Optional[float] = None,
                 timeout: Optional[float] = None,
                 ring: Optional[int] = None):
        self.peers_fn = peers_fn
        self.interval = (interval if interval is not None
                         else cluster_scrape_s())
        self.timeout = (timeout if timeout is not None
                        else cluster_scrape_timeout_s())
        self._nodes: Dict[str, Dict[str, Any]] = {}
        self._ring: deque = deque(maxlen=ring or cluster_ring())
        self._prop_seen: deque = deque(maxlen=512)
        self._prop_seen_set: set = set()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- scrape ----------------------------------------------------------------

    def scrape_once(self) -> dict:
        now = time.time()
        try:
            peers = self.peers_fn() or {}
        except Exception:
            peers = {}
        for node in sorted(peers):
            p = peers[node]
            with self._lock:
                st = self._nodes.setdefault(node, {
                    "node": node, "up": False, "lastOkAt": 0.0,
                    "error": None, "generation": None, "replLag": None,
                    "qps": None, "p95": None})
                st["connected"] = bool(p.get("connected"))
            addr = str(p.get("addr") or "127.0.0.1")
            port = int(p.get("httpPort") or 0)
            if not port:
                self._mark(node, now, ok=False,
                           error="no HTTP endpoint announced")
                continue
            base = f"http://{addr}:{port}"
            try:
                hist = _fetch_json(
                    f"{base}/metrics/history.json?limit=8", self.timeout)
                stats = _node_stats(hist if isinstance(hist, dict)
                                    else {})
                self._mark(node, now, ok=True,
                           endpoint=f"{addr}:{port}", stats=stats)
            except Exception as e:
                self._mark(node, now, ok=False,
                           endpoint=f"{addr}:{port}", error=str(e))
                continue
            try:
                self._pull_lineage(base, node)
            except Exception:
                log.debug("cluster: lineage pull from %s failed", node,
                          exc_info=True)
        _M_NODES.set(len(peers))
        self._observe_propagation()
        self._update_divergence()
        with self._lock:
            nodes = {n: dict(s) for n, s in self._nodes.items()}
        sample = {"t": now, "nodes": nodes}
        with self._lock:
            self._ring.append(sample)
        return sample

    def _mark(self, node: str, now: float, ok: bool,
              endpoint: Optional[str] = None,
              stats: Optional[Dict[str, Any]] = None,
              error: Optional[str] = None) -> None:
        with self._lock:
            st = self._nodes[node]
            if endpoint:
                st["endpoint"] = endpoint
            st["up"] = ok
            if ok:
                st["lastOkAt"] = now
                st["error"] = None
                st.update(stats or {})
            else:
                st["error"] = error
            last_ok = st.get("lastOkAt") or 0.0
            st["staleSeconds"] = (round(now - last_ok, 3)
                                  if last_ok else None)
        _M_UP.set(1.0 if ok else 0.0, node=node)
        _M_SCRAPES.inc(node=node, outcome="ok" if ok else "error")

    def _pull_lineage(self, base: str, node: str) -> None:
        """The pull half of stitching: fetch the subscriber's newest
        lineage records and merge them locally (dedupe makes the
        overlap with ack-payload push a no-op)."""
        rec = _lineage.get_lineage()
        if not rec.enabled:
            return
        idx = _fetch_json(f"{base}/lineage.json", self.timeout)
        entries = (idx.get("records") or [])[:4] \
            if isinstance(idx, dict) else []
        for e in entries:
            lid = e.get("lid")
            if not isinstance(lid, str) or not lid.startswith("ln-"):
                continue
            doc = _fetch_json(f"{base}/lineage/{lid}.json", self.timeout)
            if isinstance(doc, dict):
                rec.ingest([doc], node=node)

    def _observe_propagation(self) -> None:
        """Feed the propagation histogram from freshly-completed
        stitched records — once per lineage id, so the SLO quantile
        counts generations, not scrape rounds."""
        rec = _lineage.get_lineage()
        if not rec.enabled:
            return
        try:
            docs = rec.merged()[:16]
        except Exception:
            return
        for doc in docs:
            lid = doc.get("lid")
            if not lid or lid in self._prop_seen_set:
                continue
            _lineage.annotate_cluster(doc)
            if doc.get("outcome") != "cluster_complete":
                continue
            prop_ms = (doc.get("cluster") or {}).get("propagationMs")
            if prop_ms is None:
                continue
            if len(self._prop_seen) == self._prop_seen.maxlen:
                self._prop_seen_set.discard(self._prop_seen[0])
            self._prop_seen.append(lid)
            self._prop_seen_set.add(lid)
            _M_PROP.observe(float(prop_ms) / 1e3)

    def _update_divergence(self) -> None:
        with self._lock:
            up = [s for s in self._nodes.values() if s.get("up")]
        _M_QPS_DIV.set(_divergence([s.get("qps") for s in up]))
        _M_P95_DIV.set(_divergence([s.get("p95") for s in up]))

    # -- serving ---------------------------------------------------------------

    def metrics_doc(self) -> dict:
        """The /cluster/metrics.json body: latest per-node view."""
        with self._lock:
            nodes = {n: dict(s) for n, s in sorted(self._nodes.items())}
        return {"role": "publisher",
                "node": _lineage.cluster_node(),
                "scrapeIntervalSeconds": self.interval,
                "scrapeTimeoutSeconds": self.timeout,
                "generatedAt": time.time(),
                "nodes": nodes}

    def history_doc(self, limit: int = 120) -> dict:
        """The /cluster/history.json body: the federated sample ring."""
        with self._lock:
            samples = list(self._ring)
        if limit > 0:
            samples = samples[-limit:]
        return {"role": "publisher",
                "scrapeIntervalSeconds": self.interval,
                "samples": samples}

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return

        def loop():
            while not self._stop.wait(self.interval):
                try:
                    self.scrape_once()
                except Exception:
                    log.exception("cluster: federation scrape failed")

        self._thread = threading.Thread(
            target=loop, daemon=True, name="pio-cluster-scrape")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


# -- process singleton --------------------------------------------------------

_federation: Optional[ClusterFederation] = None
_federation_lock = threading.Lock()


def get_federation() -> Optional[ClusterFederation]:
    """The armed federation, or None on non-publisher processes (the
    /cluster endpoints 404 there — federation is publisher-only)."""
    with _federation_lock:
        return _federation


def set_federation(fed: Optional[ClusterFederation]) -> None:
    global _federation
    with _federation_lock:
        old, _federation = _federation, fed
    if old is not None and old is not fed:
        old.stop()


# -- shared HTTP endpoints ----------------------------------------------------

def handle_cluster_request(handler, path: str) -> bool:
    """Serve /cluster/metrics.json and /cluster/history.json on any
    JsonHandler server; returns True when the path was ours."""
    if path not in ("/cluster/metrics.json", "/cluster/history.json"):
        return False
    fed = get_federation()
    if fed is None:
        handler.send_error_json(
            404, "cluster federation not armed (publisher-only endpoint"
            " — deploy with --plane-publish)")
        return True
    if path == "/cluster/metrics.json":
        handler.send_json(fed.metrics_doc())
        return True
    try:
        limit = int((handler.route[1] or {}).get("limit", "120"))
    except (ValueError, TypeError):
        limit = 120
    handler.send_json(fed.history_doc(limit))
    return True
