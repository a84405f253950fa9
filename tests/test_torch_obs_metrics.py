"""The port's metrics registry and exposition (``obs/metrics.py``,
``obs/exposition.py``) against the JAX package's.

The registry and exposition cases of the JAX suite's
tests/test_obs_metrics.py, each run on a port registry and a JAX registry
fed the same operations: equal snapshots, Prometheus text byte-equal
(the port renders JAX's snapshots and the JAX package the port's), equal
parses, summaries, merges and ``stats.json`` windows, and snapshot files
one package writes that the other's scrape merges.  The port's native and
snapshot counts read through the registry's families.
"""

import json
import os
import threading

import pytest

from predictionio_tpu.obs import exposition as jax_expo
from predictionio_tpu.obs import metrics as jax_metrics
from predictionio_tpu_torch.obs import exposition as port_expo
from predictionio_tpu_torch.obs import metrics as port_metrics


def _both(feed):
    """Feed a fresh JAX registry and a fresh port registry the same way:
    (jax snapshot, port snapshot)."""
    snaps = []
    for mod in (jax_metrics, port_metrics):
        reg = mod.MetricsRegistry(enabled=True)
        feed(reg)
        snaps.append(reg.snapshot())
    return snaps


def _golden(reg):
    c = reg.counter("pio_g_requests_total", "Requests served")
    c.inc(3, route="/a", status="200")
    c.inc(1, route="/b", status="404")
    reg.gauge("pio_g_in_flight", "In-flight requests").set(2)
    h = reg.histogram("pio_g_latency_seconds", "Latency", buckets=(0.01, 0.1))
    for v in (0.005, 0.05, 5.0):
        h.observe(v)


def _hostile(reg):
    c = reg.counter("pio_esc_total", "t")
    for v in ['a\\nb', 'a\nb', 'say "hi"', "back\\slash", "plain", "x,y", "é☃"]:
        c.inc(1, event=v)
    g = reg.gauge("pio_esc_gauge", "t")
    g.set(1.5, a="1")
    g.set(-2.25e20, a="2")
    g.set(1e15, a="3")
    g.dec(0.5, a="1")
    g.remove(a="3")


def _latency(reg):
    h = reg.histogram("pio_l_seconds", "latency")
    for k in range(200):
        h.observe(0.0001 * (k % 37) * (k % 11), route=f"/r{k % 3}")
    reg.histogram("pio_l_size", "sizes", buckets=port_metrics.SIZE_BUCKETS).observe(17)


def _exemplars(reg):
    h = reg.histogram("pio_ex_seconds", "with exemplars", buckets=(0.1, 1.0))
    h.observe(0.05, exemplar="rid-1", route="/q")
    h.observe(0.5, exemplar='we"ird\\id', route="/q")
    h.observe(0.2, route="/q")


FEEDS = {"golden": _golden, "hostile": _hostile, "latency": _latency,
         "exemplars": _exemplars}


def _strip_ex_times(snap):
    for entry in snap.values():
        for s in entry["series"].values():
            if isinstance(s, dict) and "ex" in s:
                s["ex"][2] = 0.0
    return snap


@pytest.mark.parametrize("feed", sorted(FEEDS))
def test_rendered_text_is_byte_equal_to_jax(feed):
    jax_snap, port_snap = (_strip_ex_times(s) for s in _both(FEEDS[feed]))
    assert port_snap == jax_snap
    text = jax_expo.render_prometheus(jax_snap)
    assert port_expo.render_prometheus(jax_snap) == text
    assert port_expo.render_prometheus(port_snap) == text
    assert port_expo.parse_prometheus_text(text) == jax_expo.parse_prometheus_text(text)
    assert port_expo.parse_exemplars(text) == jax_expo.parse_exemplars(text)
    assert port_expo.summarize_prometheus(text) == jax_expo.summarize_prometheus(text)


def test_prometheus_text_golden():
    reg = port_metrics.MetricsRegistry()
    _golden(reg)
    assert port_expo.render_prometheus(reg.snapshot()) == (
        "# HELP pio_g_in_flight In-flight requests\n"
        "# TYPE pio_g_in_flight gauge\n"
        "pio_g_in_flight 2\n"
        "# HELP pio_g_latency_seconds Latency\n"
        "# TYPE pio_g_latency_seconds histogram\n"
        'pio_g_latency_seconds_bucket{le="0.01"} 1\n'
        'pio_g_latency_seconds_bucket{le="0.1"} 2\n'
        'pio_g_latency_seconds_bucket{le="+Inf"} 3\n'
        "pio_g_latency_seconds_sum 5.055\n"
        "pio_g_latency_seconds_count 3\n"
        "# HELP pio_g_requests_total Requests served\n"
        "# TYPE pio_g_requests_total counter\n"
        'pio_g_requests_total{route="/a",status="200"} 3\n'
        'pio_g_requests_total{route="/b",status="404"} 1\n')


def test_registry_thread_safety_concurrent_increments():
    reg = port_metrics.MetricsRegistry()
    c = reg.counter("pio_tst_total", "t")
    g = reg.gauge("pio_tst_gauge", "t")
    h = reg.histogram("pio_tst_seconds", "t")

    def work():
        for k in range(5_000):
            c.inc(1, route="/x")
            g.inc(1)
            h.observe(0.001 * (k % 7))

    ts = [threading.Thread(target=work) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert c.value(route="/x") == g.value() == 40_000
    hs = reg.snapshot()["pio_tst_seconds"]["series"][""]
    assert hs["count"] == sum(hs["counts"]) == 40_000


def test_registry_name_and_help_validation():
    reg = port_metrics.MetricsRegistry()
    for name, help_ in (("http_requests_total", "no prefix"), ("pio_Bad_Case", "upper"),
                        ("pio_ok_total", "")):
        with pytest.raises(ValueError):
            reg.counter(name, help_)
    c = reg.counter("pio_ok_total", "help")
    assert reg.counter("pio_ok_total", "help") is c
    with pytest.raises(ValueError):
        reg.gauge("pio_ok_total", "kind mismatch")


def test_registry_disabled_is_a_noop(monkeypatch):
    reg = port_metrics.MetricsRegistry(enabled=False)
    c = reg.counter("pio_off_total", "t")
    c.inc(5)
    assert c.value() == 0.0
    monkeypatch.setenv("PIO_METRICS", "off")
    assert port_metrics.MetricsRegistry().enabled is False


@pytest.mark.parametrize("values", [(0.05, 0.5), (3.0, 1e-4, 7.5)])
def test_merge_snapshots_equal_jax(values):
    def make(mod, n):
        reg = mod.MetricsRegistry()
        reg.counter("pio_m_total", "t").inc(n)
        reg.gauge("pio_m_gauge", "t").set(n, w=str(n))
        reg.histogram("pio_m_seconds", "t", buckets=(0.1, 1.0)).observe(n)
        return reg.snapshot()

    jax_merged = jax_metrics.merge_snapshots([make(jax_metrics, v) for v in values])
    port_merged = port_metrics.merge_snapshots([make(port_metrics, v) for v in values])
    assert port_merged == jax_merged
    assert port_expo.render_prometheus(port_merged) == jax_expo.render_prometheus(jax_merged)


def test_stats_collector_windows_equal_jax():
    docs = []
    for mod in (jax_expo, port_expo):
        s = mod.StatsCollector(window_s=10.0)
        out = []
        for app, status, ev, et, now in ((1, 201, "buy", "user", 0.0),
                                         (1, 201, "buy", "user", 3.0),
                                         (2, 400, None, None, 4.0)):
            s.record(app, status, ev, et, now=now)
        out.append(s.to_json(now=5.0))
        s.record(1, 201, "view", "user", now=12.0)
        out.append(s.to_json(now=12.5))
        out.append(s.to_json(app_id=2, now=13.0))
        out.append(s.to_json(now=300.0))
        for d in out:
            d.pop("startTime")
            d["window"].pop("start")
        docs.append(out)
    assert docs[1] == docs[0]
    assert docs[1][1]["statsLastWindow"][0]["count"] == 2 and docs[1][3]["statsCurrent"] == []


def test_quantiles_equal_jax():
    buckets = [(0.1, 1.0), (0.5, 1.0), (1.0, 40.0), (float("inf"), 41.0)]
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
        assert port_expo._quantile_from_buckets(buckets, 41.0, q) == \
            jax_expo._quantile_from_buckets(buckets, 41.0, q)


def test_a_scrape_merges_a_jax_workers_snapshot_file(tmp_path):
    """Snapshot files are one format: a JAX flusher's file and a port
    flusher's file merge into one port scrape, and stale siblings' gauges
    read 0 while their counters still count."""
    jax_reg = jax_metrics.MetricsRegistry()
    jax_reg.counter("pio_storage_events_appended_total", "x").inc(7)
    jax_reg.gauge("pio_http_requests_in_flight", "x").set(3)
    jax_metrics.SnapshotFlusher(str(tmp_path), "jax-w", registry=jax_reg).flush()
    dead = port_metrics.MetricsRegistry()
    dead.counter("pio_storage_events_appended_total", "x").inc(5)
    dead.gauge("pio_http_requests_in_flight", "x").set(4)
    p = tmp_path / "dead-w.json"          # older than PIO_OBS_SIBLING_STALE_S:
    p.write_text(json.dumps(dead.snapshot()))   # evicted, not merged
    os.utime(p, (1e9, 1e9))
    stale = tmp_path / "stale-w.json"     # silent for over 10 flushes: its
    stale.write_text(json.dumps(dead.snapshot()))   # gauges read 0
    old = os.stat(stale).st_mtime - 100
    os.utime(stale, (old, old))
    reg = port_metrics.get_registry()
    try:
        port_metrics.start_worker_flusher(str(tmp_path), tag="port-w")
        snap = port_metrics.aggregate_snapshot(reg)
        appended = snap["pio_storage_events_appended_total"]["series"]
        own = reg.counter("pio_storage_events_appended_total", "x").value()
        assert sum(appended.values()) == own + 7 + 5
        inflight = sum(snap["pio_http_requests_in_flight"]["series"].values())
        assert inflight == 3 + reg.gauge("pio_http_requests_in_flight", "x").value()
        assert not p.exists()
        assert snap["pio_worker_up"]["series"] == {'worker="port-w"': 1.0}
    finally:
        port_metrics.stop_worker_flusher()
    assert json.loads((tmp_path / "port-w.json").read_text())["pio_worker_up"]


def test_worker_tag_resolution(monkeypatch):
    monkeypatch.delenv("PIO_METRICS_TAG", raising=False)
    monkeypatch.setenv("PIO_WRITER_TAG", "w3-99")
    assert port_metrics.worker_tag() == "w3-99"
    monkeypatch.setenv("PIO_METRICS_TAG", "m1")
    assert port_metrics.worker_tag() == "m1"
    monkeypatch.delenv("PIO_METRICS_TAG")
    monkeypatch.delenv("PIO_WRITER_TAG")
    assert port_metrics.worker_tag() == f"pid-{os.getpid()}"


def test_native_and_snapshot_counts_read_the_registry():
    """The module-level count names of PR 8 are views of the registry's
    ``pio_native_*``, ``pio_snapshot_*`` and ``pio_stage_events_total``
    families."""
    from predictionio_tpu_torch.native import core as ncore
    from predictionio_tpu_torch.storage import snapshot as snap

    reg = port_metrics.get_registry()
    before = ncore.calls["scan"]
    ncore.note_call("scan")
    assert ncore.calls["scan"] == before + 1 == int(
        reg.counter("pio_native_calls_total", "x").value(core="scan"))
    f = ncore.fallbacks["error"]
    ncore.note_fallback("error")
    assert ncore.fallbacks["error"] == f + 1 and set(ncore.fallbacks) == {
        "no_build", "error", "unsupported"}
    h, d = snap.counts["hits"], snap.staged_counts()["delta"]
    snap.record_hit()
    snap.record_delta(4)
    assert snap.counts["hits"] == h + 1
    assert snap.staged["delta"] == snap.staged_counts()["delta"] == d + 4
    text = port_expo.metrics_payload().decode()
    for family in ("pio_native_calls_total", "pio_snapshot_scan_hits_total",
                   "pio_stage_events_total"):
        assert f"# TYPE {family} counter" in text
