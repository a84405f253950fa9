"""The port's metrics history ring (``obs/tsdb.py``), SLO engine
(``obs/slo.py``) and cluster federation (``obs/cluster.py``) against the
JAX package's (the parity targets are the JAX suite's
tests/test_cluster_obs.py and tests/test_lineage.py's tsdb and SLO
cases).

- ``ClusterFederation`` over two stub nodes on ephemeral ports (and a
  dead and a silent peer) gives the JAX federation's ``metrics_doc`` and
  ``history_doc``, the wall clock patched to one value in both.
- ``SloEngine.evaluate`` over the same sample list gives equal verdicts
  and burn rates, exact floats; only the two help texts the port words
  without the JAX package's history references differ (``HELP_DIFFERS``).
- ``reduce_snapshot`` gives equal output on either registry's snapshot.
- ``/healthz`` of each package's event server reads green and red alike.
- The metric families these modules register equal the JAX package's.
"""

import copy
import http.server
import json
import socket
import threading
import time

import pytest

from predictionio_tpu.api.event_server import run_event_server as jax_event_server
from predictionio_tpu.obs import cluster as jax_cluster
from predictionio_tpu.obs import metrics as jax_metrics
from predictionio_tpu.obs import slo as jax_slo
from predictionio_tpu.obs import tsdb as jax_tsdb
from predictionio_tpu_torch.api.event_server import run_event_server as port_event_server
from predictionio_tpu_torch.obs import cluster as port_cluster
from predictionio_tpu_torch.obs import metrics as port_metrics
from predictionio_tpu_torch.obs import slo as port_slo
from predictionio_tpu_torch.obs import tsdb as port_tsdb

from _torch_obs_cases import get_json, lineages, localfs_pair, request  # noqa: F401

#: the SLOs whose help text the port words without the JAX package's
#: references to the change that set each bound
HELP_DIFFERS = {"append_servable_p99", "cache_audit"}


def _history_body(generation, lag, reqs):
    def sample(t, total):
        return {"t": t, "m": {
            "pio_model_plane_generation": {"type": "gauge",
                                           "series": {'worker="w"': float(generation)}},
            "pio_plane_repl_lag_generations": {"type": "gauge",
                                               "series": {'node="x"': float(lag)}},
            "pio_http_requests_total": {
                "type": "counter", "series": {'route="/queries.json",status="200"': total}},
            "pio_http_request_duration_seconds": {
                "type": "histogram",
                "series": {'route="/queries.json"': {
                    "counts": [int(total // 2), int(total // 4),
                               int(total) - int(total // 2) - int(total // 4), 0],
                    "sum": total * 0.01, "count": int(total)}}},
        }}
    return {"worker": "w", "intervalSeconds": 5.0,
            "buckets": {"pio_http_request_duration_seconds": [0.005, 0.05, 0.5]},
            "samples": [sample(1000.0, reqs[0]), sample(1010.0, reqs[1])]}


def _node_server(body):
    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.startswith("/metrics/history.json"):
                payload = json.dumps(body).encode()
            elif self.path == "/lineage.json":
                payload = json.dumps({"records": []}).encode()
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


class _Clock:
    """A module's ``time`` with the wall clock fixed (the federation's
    staleness and sample times); the other clocks are the real ones."""

    def __init__(self, now):
        self.now = now

    def time(self):
        return self.now

    def __getattr__(self, name):
        return getattr(time, name)


@pytest.fixture()
def two_nodes():
    a = _node_server(_history_body(5, 0.0, (100.0, 200.0)))
    b = _node_server(_history_body(4, 1.0, (100.0, 400.0)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
    peers = {"node-a": {"addr": "127.0.0.1", "httpPort": a.server_address[1],
                        "connected": True},
             "node-b": {"addr": "127.0.0.1", "httpPort": b.server_address[1],
                        "connected": True},
             "dead": {"addr": "127.0.0.1", "httpPort": dead, "connected": False},
             "shy": {"addr": "127.0.0.1", "httpPort": 0, "connected": True}}
    yield peers
    for srv in (a, b):
        srv.shutdown()
        srv.server_close()


def test_federation_documents_equal_the_jax_federation(two_nodes, lineages, monkeypatch):
    docs = {}
    for name, mod in (("jax", jax_cluster), ("port", port_cluster)):
        clock = _Clock(1_000_000.0)
        monkeypatch.setattr(mod, "time", clock)
        fed = mod.ClusterFederation(lambda: two_nodes, interval=60.0, timeout=2.0, ring=8)
        fed.scrape_once()
        clock.now += 10.0
        fed.scrape_once()
        docs[name] = (fed.metrics_doc(), fed.history_doc(), fed.history_doc(limit=1))
    assert docs["port"] == docs["jax"]
    nodes = docs["port"][0]["nodes"]
    assert {n for n, d in nodes.items() if d["up"]} == {"node-a", "node-b"}
    assert "no HTTP endpoint" in nodes["shy"]["error"] and nodes["dead"]["error"]
    assert len(docs["port"][1]["samples"]) == 2 and len(docs["port"][2]["samples"]) == 1


@pytest.mark.parametrize("values", [[10.0, 10.0], [30.0, 10.0, 20.0], [10.0], [None, 0.0],
                                    [0.0, 0.0], [1e-9, 5.0]])
def test_divergence_equal(values):
    assert port_cluster._divergence(list(values)) == jax_cluster._divergence(list(values))


def _sample(t, lag, audit, reqs, slow):
    """One reduced sample: replica lag, the cache audit counter, the
    query counter and a latency histogram with ``slow`` of its requests
    in the top bucket."""
    return {"t": t, "m": {
        "pio_plane_repl_lag_generations": {"type": "gauge", "series": {'node="s"': lag}},
        "pio_store_replica_lag_events": {"type": "gauge", "series": {'shard="0"': lag * 100}},
        "pio_serve_cache_audit_mismatch_total": {"type": "counter", "series": {"": audit}},
        "pio_http_requests_total": {"type": "counter",
                                    "series": {'route="/queries.json",status="200"': reqs}},
        "pio_http_request_duration_seconds": {"type": "histogram", "series": {
            'route="/queries.json"': {"counts": [reqs - slow, 0, slow], "sum": reqs * 0.01,
                                      "count": reqs}}},
        "pio_follow_fold_duration_seconds": {"type": "histogram", "series": {
            'mode="fold"': {"counts": [reqs, slow, 0], "sum": reqs * 0.5, "count": reqs + slow}}},
        "pio_model_plane_chain_len": {"type": "gauge", "series": {'worker="w"': float(slow)}},
    }}


BUCKETS = {"pio_http_request_duration_seconds": [0.05, 0.5],
           "pio_follow_fold_duration_seconds": [1.0, 20.0]}

SAMPLE_SETS = {
    "quiet": [_sample(1000.0 + 10 * i, 0.0, 0.0, 100.0 * i, 0.0) for i in range(8)],
    "burning": [_sample(1000.0 + 10 * i, 20.0, float(i), 100.0 * i, 30.0 * i) for i in range(8)],
    "warn": ([_sample(1000.0 + 10 * i, 0.0, 0.0, 100.0 * i, 0.0) for i in range(60)]
             + [_sample(1600.0 + 10 * i, 20.0, 5.0 + i, 6000.0 + 100 * i, 40.0 * i)
                for i in range(4)]),
    "one": [_sample(1000.0, 3.0, 0.0, 10.0, 1.0)],
    "empty": [],
}


@pytest.mark.parametrize("case", sorted(SAMPLE_SETS))
def test_slo_verdicts_and_burn_rates_equal(case):
    samples = SAMPLE_SETS[case]
    slos = (jax_slo.DEFAULT_SLOS + jax_slo.CLUSTER_SLOS,
            port_slo.DEFAULT_SLOS + port_slo.CLUSTER_SLOS)
    want = jax_slo.SloEngine(slos[0]).evaluate(copy.deepcopy(samples), BUCKETS)
    got = port_slo.SloEngine(slos[1]).evaluate(copy.deepcopy(samples), BUCKETS)
    for doc in (want, got):
        for name in HELP_DIFFERS:
            doc["slos"][name].pop("help")
    assert got == want
    if case == "burning":
        assert got["status"] == "burning"


def test_slo_tables_equal_but_two_help_texts():
    for jt, pt in ((jax_slo.DEFAULT_SLOS, port_slo.DEFAULT_SLOS),
                   (jax_slo.CLUSTER_SLOS, port_slo.CLUSTER_SLOS)):
        assert [{k: v for k, v in s.items() if k != "help" or s["name"] not in HELP_DIFFERS}
                for s in pt] == [
            {k: v for k, v in s.items() if k != "help" or s["name"] not in HELP_DIFFERS}
            for s in jt]


def test_arm_cluster_slos_as_jax():
    for mod in (jax_slo, port_slo):
        mod.set_engine(None)
    try:
        names = [[s["name"] for s in mod.arm_cluster_slos().slos] for mod in (jax_slo, port_slo)]
        again = [[s["name"] for s in mod.arm_cluster_slos().slos] for mod in (jax_slo, port_slo)]
        assert names[1] == names[0] == again[0] == again[1]
    finally:
        for mod in (jax_slo, port_slo):
            mod.set_engine(None)


def _fill(registry):
    c = registry.counter("pio_probe_total", "probe counter")
    c.inc(3, route="/a")
    c.inc(1, route="/b")
    g = registry.gauge("pio_probe_gauge", "probe gauge")
    g.set(2.5, worker="w")
    h = registry.histogram("pio_probe_seconds", "probe histogram", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 5.0):
        h.observe(v, route="/a")
    return registry


@pytest.mark.parametrize("source", ["jax", "port"])
def test_reduce_snapshot_equal(source):
    reg = _fill(jax_metrics.MetricsRegistry() if source == "jax"
                else port_metrics.MetricsRegistry())
    snap = reg.snapshot()
    assert port_tsdb.reduce_snapshot(copy.deepcopy(snap)) == jax_tsdb.reduce_snapshot(
        copy.deepcopy(snap))


def _lag_samples(now, lag, n):
    return [{"t": now - 10 * (n - i), "m": {"pio_plane_repl_lag_generations": {
        "type": "gauge", "series": {'node="sub-1"': float(lag)}}}} for i in range(n)]


@pytest.mark.parametrize("lag, want", [(0.0, "ok"), (50.0, "burning")])
def test_healthz_green_and_red_as_jax(tmp_path, lag, want):
    """Each package's event server answers /healthz from its own SLO
    engine and sampler ring: a ring of healthy (red) replica-lag samples
    reads the same verdict on both."""
    lag_slo = next(s for s in jax_slo.CLUSTER_SLOS if s["name"] == "cluster_repl_lag")
    saved = []
    for slo_mod, tsdb_mod in ((jax_slo, jax_tsdb), (port_slo, port_tsdb)):
        saved.append((slo_mod, tsdb_mod))
        slo_mod.set_engine(slo_mod.SloEngine((dict(lag_slo),)))
        sampler = tsdb_mod.MetricsSampler(interval=3600.0)
        sampler._ring.extend(_lag_samples(time.time(), lag, 30))
        tsdb_mod.set_sampler(sampler)
    jstore, pstore = localfs_pair(tmp_path)
    jsrv = jax_event_server(host="127.0.0.1", port=0, storage=jstore, background=True)
    psrv = port_event_server(host="127.0.0.1", port=0, storage=pstore, background=True)
    try:
        docs = [get_json(f"http://127.0.0.1:{s.server_address[1]}/healthz")
                for s in (jsrv, psrv)]
        assert docs[1]["status"] == docs[0]["status"] == want
        assert (docs[1]["slos"]["cluster_repl_lag"]["verdict"]
                == docs[0]["slos"]["cluster_repl_lag"]["verdict"] == want)
        history = [get_json(f"http://127.0.0.1:{s.server_address[1]}/metrics/history.json"
                            "?limit=5") for s in (jsrv, psrv)]
        assert [len(h["samples"]) for h in history] == [5, 5]
        assert set(history[1]) == set(history[0])
        status = [request("GET", f"http://127.0.0.1:{s.server_address[1]}/cluster/metrics.json")
                  for s in (jsrv, psrv)]
        # the event server has no federation route: an unkeyed request
        assert status[1] == status[0] and status[0][0] == 401
    finally:
        for srv in (jsrv, psrv):
            srv.shutdown()
            srv.server_close()
        for slo_mod, tsdb_mod in saved:
            tsdb_mod.get_sampler().stop()
            tsdb_mod.set_sampler(None)
            slo_mod.set_engine(None)


def _families(mod_registry, prefixes):
    out = {}
    for m in mod_registry.get_registry().metrics():
        if m.name.startswith(prefixes):
            out[m.name] = (m.kind, m.help, tuple(getattr(m, "buckets", ()) or ()))
    return out


def test_obs_metric_families_equal_the_jax_package():
    import predictionio_tpu.workflow.core_workflow  # noqa: F401
    import predictionio_tpu_torch.workflow.core_workflow  # noqa: F401

    prefixes = ("pio_trace", "pio_lineage_", "pio_slo_", "pio_cluster_",
                "pio_train_runs_total", "pio_train_duration_seconds")
    want = _families(jax_metrics, prefixes)
    got = _families(port_metrics, prefixes)
    assert got == want
    assert {"pio_slo_burn_rate", "pio_train_runs_total", "pio_train_duration_seconds",
            "pio_cluster_propagation_seconds"} <= set(got)
