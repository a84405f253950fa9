"""SLO burn-rate health engine over the local metrics history ring
(counterpart of ``predictionio_tpu/obs/slo.py``).

A declarative SLO table (the numbers the streaming design promises:
append→servable p99, serve p95, zero cache-audit mismatches, bounded
replica lag, bounded plane delta-chain length) evaluated over
:mod:`obs.tsdb`'s sample ring with the SRE-workbook multi-window
pattern: a FAST window (default 60 s) catches a fresh regression, a
SLOW window (default 600 s) filters one-sample blips — an SLO reads
``burning`` only when BOTH windows' burn rates exceed 1.

Burn rate = (fraction of window intervals violating the threshold) /
(error budget, default 10% of intervals), so burn 1.0 means the budget
is being consumed exactly as fast as it accrues.  Verdicts surface at
``/healthz`` (always HTTP 200 — the body carries the health, so load
balancers and humans share one endpoint) and as
``pio_slo_burn_rate{slo,window}`` gauges refreshed on every sampler
tick.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Tuple

from predictionio_tpu_torch.obs import metrics as _metrics
from predictionio_tpu_torch.obs.exposition import _quantile_from_buckets

_REG = _metrics.get_registry()
_M_BURN = _REG.gauge(
    "pio_slo_burn_rate",
    "Error-budget burn rate per {slo} and {window} (fast/slow): "
    "violating-interval fraction over the window divided by the error "
    "budget; > 1 in BOTH windows = the SLO is burning (/healthz goes "
    "red)")

# the declarative SLO table: kind decides how an interval (a pair of
# consecutive history samples) is judged against the threshold —
#   histogram_quantile: interval quantile of new observations > threshold
#   counter_delta:      counter increase over the interval > threshold
#   gauge_max:          max series value at the interval's end > threshold
# `match` filters series by a label-body substring ('' = every series)
DEFAULT_SLOS: Tuple[Dict, ...] = (
    {"name": "append_servable_p99", "kind": "histogram_quantile",
     "metric": "pio_follow_fold_duration_seconds", "match": "",
     "q": 0.99, "threshold": 10.0,
     "help": "append-to-servable fold-tick p99 <= 10 s (the freshness gate)"},
    {"name": "serve_p95", "kind": "histogram_quantile",
     "metric": "pio_http_request_duration_seconds",
     "match": 'route="/queries.json"', "q": 0.95, "threshold": 0.25,
     "help": "query latency p95 <= 250 ms"},
    {"name": "cache_audit", "kind": "counter_delta",
     "metric": "pio_serve_cache_audit_mismatch_total", "match": "",
     "threshold": 0.0,
     "help": "response-cache online audit mismatches == 0 (the "
             "zero-staleness contract)"},
    {"name": "replica_lag", "kind": "gauge_max",
     "metric": "pio_store_replica_lag_events", "match": "",
     "threshold": 10000.0,
     "help": "sharded-store replica lag <= 10k events"},
    {"name": "plane_chain", "kind": "gauge_max",
     "metric": "pio_model_plane_chain_len", "match": "",
     "threshold": 16.0,
     "help": "delta-arena chain length <= 16 (keyframe cadence healthy)"},
)

# cluster-scope rows, armed only on a replication publisher
# (``arm_cluster_slos``).  They evaluate over the SAME local sample
# ring as everything else: the federation layer re-exports its derived
# signals as local publisher metrics (obs.cluster), and the per-peer
# repl-lag gauge already lives here — no second evaluation engine.
CLUSTER_SLOS: Tuple[Dict, ...] = (
    {"name": "cluster_propagation_p99", "kind": "histogram_quantile",
     "metric": "pio_cluster_propagation_seconds", "match": "",
     "q": 0.99, "threshold": 10.0,
     "help": "append -> LAST node's first_serve p99 <= 10 s, read from "
             "stitched cluster_complete lineage records"},
    {"name": "cluster_repl_lag", "kind": "gauge_max",
     "metric": "pio_plane_repl_lag_generations", "match": "",
     "threshold": 8.0,
     "help": "slowest subscriber <= 8 generations behind the publisher"},
    {"name": "cluster_qps_divergence", "kind": "gauge_max",
     "metric": "pio_cluster_qps_divergence", "match": "",
     "threshold": 4.0,
     "help": "hottest node's serve qps <= 4x the cluster mean "
             "(load staying balanced)"},
    {"name": "cluster_p95_divergence", "kind": "gauge_max",
     "metric": "pio_cluster_p95_divergence", "match": "",
     "threshold": 4.0,
     "help": "slowest node's serve p95 <= 4x the cluster mean "
             "(no straggler node)"},
)


def arm_cluster_slos() -> "SloEngine":
    """Fold the cluster-scope rows into the process engine (replication
    publishers call this next to federation start; idempotent) — their
    verdicts then ride /healthz and pio_slo_burn_rate like any local
    SLO."""
    eng = get_engine()
    have = {s["name"] for s in eng.slos}
    extra = tuple(s for s in CLUSTER_SLOS if s["name"] not in have)
    if extra:
        eng.slos = eng.slos + extra
    return eng


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def slo_windows() -> Tuple[float, float]:
    """(fast, slow) burn windows in seconds — PIO_SLO_FAST_S /
    PIO_SLO_SLOW_S (defaults 60 / 600)."""
    return (max(_env_float("PIO_SLO_FAST_S", 60.0), 1.0),
            max(_env_float("PIO_SLO_SLOW_S", 600.0), 1.0))


def slo_budget() -> float:
    """PIO_SLO_BUDGET: allowed violating-interval fraction (default
    0.1 — one interval in ten may breach before burn reads 1)."""
    return min(max(_env_float("PIO_SLO_BUDGET", 0.1), 1e-4), 1.0)


def _series_sum_hist(entry: Optional[dict], match: str) -> Optional[dict]:
    """Slot-wise sum of every histogram series whose label body contains
    ``match``; None when nothing matches."""
    if not entry or entry.get("type") != "histogram":
        return None
    acc = None
    for key, v in entry.get("series", {}).items():
        if match and match not in key:
            continue
        if acc is None:
            acc = {"counts": list(v["counts"]), "sum": float(v["sum"]),
                   "count": int(v["count"])}
        else:
            acc["counts"] = [a + b for a, b in zip(acc["counts"],
                                                   v["counts"])]
            acc["sum"] += float(v["sum"])
            acc["count"] += int(v["count"])
    return acc


def _series_total(entry: Optional[dict], match: str) -> Optional[float]:
    if not entry or "series" not in entry:
        return None
    vals = [float(v) for k, v in entry["series"].items()
            if not match or match in k]
    return sum(vals) if vals else None


def _series_max(entry: Optional[dict], match: str) -> Optional[float]:
    if not entry or "series" not in entry:
        return None
    vals = [float(v) for k, v in entry["series"].items()
            if not match or match in k]
    return max(vals) if vals else None


def _interval_verdict(slo: Dict, prev: dict, cur: dict,
                      buckets: Dict[str, List[float]]):
    """(bad, value) for one consecutive-sample interval, or None when
    the interval carries no signal for this SLO (no series yet, or a
    quantile window with zero new observations)."""
    metric = slo["metric"]
    e_prev = prev.get("m", {}).get(metric)
    e_cur = cur.get("m", {}).get(metric)
    kind = slo["kind"]
    if kind == "gauge_max":
        v = _series_max(e_cur, slo.get("match", ""))
        if v is None:
            return None
        return v > slo["threshold"], v
    if kind == "counter_delta":
        c0 = _series_total(e_prev, slo.get("match", ""))
        c1 = _series_total(e_cur, slo.get("match", ""))
        if c1 is None:
            return None
        delta = c1 - (c0 or 0.0)
        if delta < 0:   # a worker restarted and its counter reset
            delta = c1
        return delta > slo["threshold"], delta
    if kind == "histogram_quantile":
        h1 = _series_sum_hist(e_cur, slo.get("match", ""))
        if h1 is None:
            return None
        h0 = _series_sum_hist(e_prev, slo.get("match", ""))
        counts = list(h1["counts"])
        total = h1["count"]
        if h0 is not None and h0["count"] <= h1["count"]:
            counts = [a - b for a, b in zip(h1["counts"], h0["counts"])]
            total = h1["count"] - h0["count"]
        if total <= 0:
            return None   # no new observations this interval
        bounds = buckets.get(metric)
        if not bounds:
            return None
        cum, pairs = 0.0, []
        for le, c in zip(list(bounds) + [float("inf")], counts):
            cum += max(c, 0)
            pairs.append((le, cum))
        q = _quantile_from_buckets(pairs, total, float(slo.get("q", 0.99)))
        return q > slo["threshold"], q
    return None


class SloEngine:
    """Evaluates the SLO table over a sample ring; caches the last
    verdict for /healthz and keeps the burn gauges fresh."""

    def __init__(self, slos: Optional[Tuple[Dict, ...]] = None):
        self.slos = tuple(slos if slos is not None else DEFAULT_SLOS)
        self._lock = threading.Lock()
        self._last: Optional[dict] = None

    def evaluate(self, samples: List[dict],
                 buckets: Dict[str, List[float]]) -> dict:
        fast_s, slow_s = slo_windows()
        budget = slo_budget()
        now = samples[-1]["t"] if samples else 0.0
        verdicts: Dict[str, dict] = {}
        for slo in self.slos:
            windows = {}
            last_value = None
            for wname, wlen in (("fast", fast_s), ("slow", slow_s)):
                bad = seen = 0
                for prev, cur in zip(samples, samples[1:]):
                    if now - cur["t"] > wlen:
                        continue
                    res = _interval_verdict(slo, prev, cur, buckets)
                    if res is None:
                        continue
                    seen += 1
                    if res[0]:
                        bad += 1
                    last_value = res[1]
                if seen == 0:
                    windows[wname] = {"burn": 0.0, "intervals": 0}
                    continue
                burn = (bad / seen) / budget
                windows[wname] = {"burn": round(burn, 3),
                                  "intervals": seen}
                _M_BURN.set(burn, slo=slo["name"], window=wname)
            fast = windows.get("fast", {})
            slow = windows.get("slow", {})
            if fast.get("intervals", 0) == 0 \
                    and slow.get("intervals", 0) == 0:
                verdict = "no_data"
            elif fast.get("burn", 0) > 1.0 and slow.get("burn", 0) > 1.0:
                verdict = "burning"
            elif fast.get("burn", 0) > 1.0 or slow.get("burn", 0) > 1.0:
                verdict = "warn"
            else:
                verdict = "ok"
            verdicts[slo["name"]] = {
                "verdict": verdict,
                "threshold": slo["threshold"],
                "metric": slo["metric"],
                "kind": slo["kind"],
                "lastValue": (round(last_value, 6)
                              if isinstance(last_value, float)
                              else last_value),
                "windows": windows,
                "help": slo.get("help", ""),
            }
        order = ("burning", "warn", "ok", "no_data")
        present = [v["verdict"] for v in verdicts.values()]
        status = next((s for s in order if s in present), "no_data")
        doc = {"status": status, "budget": budget,
               "windows": {"fastSeconds": fast_s, "slowSeconds": slow_s},
               "samples": len(samples), "slos": verdicts}
        with self._lock:
            self._last = doc
        return doc

    def healthz(self) -> dict:
        """The /healthz body: evaluate over the live ring (taking a
        fresh sample first so a just-started server answers from data,
        not ``no_data`` staleness)."""
        from predictionio_tpu_torch.obs import tsdb as _tsdb

        sampler = _tsdb.get_sampler()
        try:
            sampler.sample_now()
        except Exception:
            pass
        with self._lock:
            if self._last is not None:
                return self._last
        return self.evaluate(sampler.samples(), sampler._buckets_copy())


_engine: Optional[SloEngine] = None
_engine_lock = threading.Lock()


def get_engine() -> SloEngine:
    global _engine
    with _engine_lock:
        if _engine is None:
            _engine = SloEngine()
        return _engine


def set_engine(engine: Optional[SloEngine]) -> None:
    """Swap the process engine (tests; None resets to lazy default)."""
    global _engine
    with _engine_lock:
        _engine = engine


def handle_healthz_request(handler, path: str) -> bool:
    """Serve /healthz on any JsonHandler server; returns True when the
    path was ours.  Always HTTP 200 — the JSON ``status`` field carries
    the verdict (ok | warn | burning | no_data)."""
    if path != "/healthz":
        return False
    if not _metrics.get_registry().enabled:
        handler.send_json({"status": "no_data",
                           "reason": "metrics disabled (PIO_METRICS=off)"})
        return True
    handler.send_json(get_engine().healthz())
    return True
