"""The port's event server (``api/event_server.py``) against the JAX
package's.

The same request sequences go to a JAX and a port event server, each on a
localfs store of its own with the same apps, keys and channel: statuses
and bodies must be equal, generated event ids and times aside.  Events
posted with an explicit ``eventId``, ``eventTime`` and ``creationTime``
give byte-equal segment lines, and either package reads the other's
store.  Also: the access-key and channel auth and its cache, batches,
``/stats.json`` with snapshot coverage, webhooks, the label bound,
``PIO_MAX_BATCH``, the writer's group commit, and the prefork workers of
``run_event_server(workers=2)`` (per-writer segments, a cross-worker
``/metrics``, every acknowledged event in the store), as the JAX suite's
tests/test_servers.py, tests/test_obs_metrics.py and
tests/test_multiworker_ingest.py hold them.  Every wait is bounded.
"""

import json
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from predictionio_tpu.api.event_server import run_event_server as jax_run_event_server
from predictionio_tpu.storage import AccessKey as JaxAccessKey
from predictionio_tpu.storage import App as JaxApp
from predictionio_tpu.storage import Channel as JaxChannel
from predictionio_tpu.storage.locator import Storage as JaxStorage
from predictionio_tpu.storage.locator import StorageConfig as JaxStorageConfig
from predictionio_tpu_torch.api import event_server as port_es
from predictionio_tpu_torch.storage import AccessKey, App, Channel
from predictionio_tpu_torch.storage.locator import Storage, StorageConfig, set_storage

from _torch_server_cases import WAIT_S, http, stop, wait_for

REPO = Path(__file__).resolve().parent.parent
KEY, VIEW_KEY = "KEYPARITY01", "KEYVIEWONLY1"


def _stores(tmp_path):
    def cfg(cls, path):
        return cls(sources={"FS": {"type": "localfs", "path": str(path)}},
                   repositories={r: "FS" for r in ("METADATA", "EVENTDATA", "MODELDATA")})

    jax_st = JaxStorage(cfg(JaxStorageConfig, tmp_path / "jax"))
    port_st = Storage(cfg(StorageConfig, tmp_path / "port"))
    for st, app_c, key_c, chan_c in ((jax_st, JaxApp, JaxAccessKey, JaxChannel),
                                     (port_st, App, AccessKey, Channel)):
        app_id = st.apps.insert(app_c(0, "parity"))
        st.l_events.init(app_id)
        st.access_keys.insert(key_c(KEY, app_id, []))
        st.access_keys.insert(key_c(VIEW_KEY, app_id, ["view"]))
        cid = st.channels.insert(chan_c(0, "ch1", app_id))
        st.l_events.init(app_id, cid)
    return jax_st, port_st


@pytest.fixture()
def pair(tmp_path):
    jax_st, port_st = _stores(tmp_path)
    jax_srv = jax_run_event_server(host="127.0.0.1", port=0, storage=jax_st, background=True)
    port_srv = port_es.run_event_server(host="127.0.0.1", port=0, storage=port_st,
                                        background=True)
    yield {"jax": f"http://127.0.0.1:{jax_srv.server_address[1]}",
           "port": f"http://127.0.0.1:{port_srv.server_address[1]}",
           "jax_store": jax_st, "port_store": port_st, "root": tmp_path}
    stop(jax_srv)
    stop(port_srv)


_HEX_ID = re.compile(r"^[0-9a-f]{32}$")


def _norm(doc):
    """Generated ids and every time stamp taken out; the rest as sent."""
    if isinstance(doc, list):
        return [_norm(d) for d in doc]
    if isinstance(doc, dict):
        out = {}
        for k, v in doc.items():
            if k == "eventId" and isinstance(v, str) and _HEX_ID.match(v):
                v = "<generated>"
            elif k in ("startTime", "start", "pid", "version", "workerTag") or (
                    k == "creationTime" and not v.startswith("2026-03-10")):
                v = "<varies>"
            out[k] = _norm(v)
        return out
    return doc


def _ev(i, **kw):
    """An event with explicit id and times: the same line in both stores."""
    return {"event": kw.pop("event", "view"), "entityType": "user",
            "entityId": kw.pop("user", f"u{i % 3}"), "targetEntityType": "item",
            "targetEntityId": f"i{i}", "eventId": f"fixed{i:04d}",
            "eventTime": f"2026-03-0{1 + i % 9}T10:00:0{i % 10}.123000+00:00",
            "creationTime": "2026-03-10T00:00:00+00:00",
            "properties": {"rating": i % 5, "tags": ["a", f"t{i}"], "uni": "é☃"},
            **kw}


SCENARIOS = {
    "single": [
        ("POST", "/events.json?accessKey={KEY}", _ev(1)),
        ("POST", "/events.json?accessKey={KEY}", {"event": "buy", "entityType": "user",
                                                  "entityId": "u9"}),
        ("GET", "/events/fixed0001.json?accessKey={KEY}", None),
        ("GET", "/events/missing.json?accessKey={KEY}", None),
        ("DELETE", "/events/fixed0001.json?accessKey={KEY}", None),
        ("GET", "/events/fixed0001.json?accessKey={KEY}", None),
        ("DELETE", "/events/fixed0001.json?accessKey={KEY}", None),
    ],
    "auth": [
        ("POST", "/events.json", {"event": "x"}),
        ("POST", "/events.json?accessKey=WRONG", {"event": "x"}),
        ("POST", "/events.json?accessKey={KEY}&channel=nope", _ev(2)),
        ("POST", "/events.json?accessKey={VIEW_KEY}", _ev(3, event="buy")),
        ("POST", "/events.json?accessKey={VIEW_KEY}", _ev(4)),
        ("POST", "/events.json?accessKey={VIEW_KEY}",
         {"event": "buy", "entityType": "user"}),
        ("GET", "/events.json", None),
        ("DELETE", "/events/fixed0004.json?accessKey=WRONG", None),
        ("GET", "/nope.json?accessKey={KEY}", None),
        ("POST", "/nope.json?accessKey={KEY}", {}),
    ],
    "malformed": [
        ("POST", "/events.json?accessKey={KEY}", {"event": "$set", "entityType": "user",
                                                  "entityId": "u1", "targetEntityType": "item",
                                                  "targetEntityId": "i1"}),
        ("POST", "/events.json?accessKey={KEY}", {"entityType": "user", "entityId": "u1"}),
        ("POST", "/events.json?accessKey={KEY}", ["not", "an", "object"]),
        ("POST", "/events.json?accessKey={KEY}", {"event": "view", "entityType": "user",
                                                  "entityId": "u1", "eventTime": "nope"}),
        ("POST", "/batch/events.json?accessKey={KEY}", {"not": "a list"}),
        ("POST", "/batch/events.json?accessKey={KEY}", [_ev(5)] * 51),
    ],
    "batch": [
        ("POST", "/batch/events.json?accessKey={KEY}",
         [_ev(10), _ev(11, event="buy"), {"entityType": "user", "entityId": "broken"},
          "junk", _ev(12, event="$unset", properties={"x": 1})]),
        ("POST", "/batch/events.json?accessKey={VIEW_KEY}",
         [_ev(13), _ev(14, event="buy"), {"event": "buy", "entityType": "user"}]),
        ("POST", "/batch/events.json?accessKey={KEY}", []),
        ("GET", "/events/fixed0011.json?accessKey={KEY}", None),
    ],
    "find": [
        ("POST", "/batch/events.json?accessKey={KEY}",
         [_ev(i, event="buy" if i % 2 else "view") for i in range(20, 32)]),
        ("GET", "/events.json?accessKey={KEY}&entityType=user&entityId=u1", None),
        ("GET", "/events.json?accessKey={KEY}&event=buy&limit=3", None),
        ("GET", "/events.json?accessKey={KEY}&reversed=true&limit=4", None),
        ("GET", "/events.json?accessKey={KEY}&startTime=2026-03-03T00:00:00Z"
                "&untilTime=2026-03-06T00:00:00Z&limit=-1", None),
        ("GET", "/events.json?accessKey={KEY}&targetEntityType=item&targetEntityId=i25",
         None),
    ],
    "channel": [
        ("POST", "/events.json?accessKey={KEY}&channel=ch1", _ev(40)),
        ("POST", "/batch/events.json?accessKey={KEY}&channel=ch1", [_ev(41), _ev(42)]),
        ("GET", "/events.json?accessKey={KEY}&channel=ch1", None),
        ("GET", "/events.json?accessKey={KEY}", None),
        ("GET", "/events/fixed0041.json?accessKey={KEY}&channel=ch1", None),
        ("GET", "/events/fixed0041.json?accessKey={KEY}", None),
    ],
    "webhooks": [
        ("POST", "/webhooks/segmentio.json?accessKey={KEY}",
         {"type": "track", "userId": "s1", "event": "signup",
          "timestamp": "2026-03-01T00:00:00Z", "properties": {"plan": "pro"}}),
        ("POST", "/webhooks/segmentio.json?accessKey={KEY}", {"type": "track"}),
        ("POST", "/webhooks/form.json?accessKey={KEY}",
         {"event": "like", "entityType": "user", "entityId": "f1", "color": "red",
          "eventTime": "2026-03-02T00:00:00Z"}),
        ("POST", "/webhooks/mailchimp.json?accessKey={KEY}",
         {"type": "subscribe", "fired_at": "2026-03-01 10:00:00",
          "data[email]": "a@b.c", "data[list_id]": "L1"}),
        ("POST", "/webhooks/mailchimp.json?accessKey={KEY}", {"type": "bogus"}),
        ("POST", "/webhooks/nope.json?accessKey={KEY}", {"a": 1}),
        ("POST", "/webhooks/form.json?accessKey={KEY}", ["x"]),
        ("POST", "/webhooks/form.json?accessKey={VIEW_KEY}",
         {"event": "like", "entityType": "user", "entityId": "f1"}),
        ("GET", "/events.json?accessKey={KEY}&entityType=user&entityId=f1", None),
    ],
    "stats": [
        ("POST", "/events.json?accessKey={KEY}", _ev(50)),
        ("POST", "/events.json?accessKey={KEY}", _ev(51, event="buy")),
        ("POST", "/events.json?accessKey={KEY}", {"event": "$set", "entityType": "user",
                                                  "entityId": "u1", "targetEntityId": "x"}),
        ("POST", "/events.json?accessKey={VIEW_KEY}", _ev(52, event="buy")),
        ("GET", "/stats.json?accessKey={KEY}", None),
        ("GET", "/stats.json", None),
    ],
}


def _drive(base, steps):
    out = []
    for method, path, body in steps:
        path = path.format(KEY=KEY, VIEW_KEY=VIEW_KEY)
        status, doc = http(method, base + path, body)
        out.append((method, path, status, _norm(doc)))
    return out


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_requests_answer_as_the_jax_event_server(pair, scenario):
    want = _drive(pair["jax"], SCENARIOS[scenario])
    got = _drive(pair["port"], SCENARIOS[scenario])
    assert len(got) == len(want) == len(SCENARIOS[scenario])
    for g, w in zip(got, want):
        assert g == w, (g, w)


def test_invalid_json_and_alive(pair):
    for base in (pair["jax"], pair["port"]):
        status, doc = http("GET", base + "/")
        assert status == 200 and doc["status"] == "alive" and doc["pid"] == os.getpid()
    import urllib.request

    def raw_post(base):
        req = urllib.request.Request(f"{base}/events.json?accessKey={KEY}",
                                     data=b"{not json", method="POST")
        try:
            urllib.request.urlopen(req, timeout=WAIT_S)
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())["message"].split(":")[0]

    assert raw_post(pair["port"]) == raw_post(pair["jax"]) == (400, "invalid JSON")


def _segment_lines(root, app_id=1, chan="_default"):
    d = Path(root) / "events" / f"app_{app_id}" / chan
    return {p.name: p.read_bytes() for p in sorted(d.glob("seg-*.jsonl"))}


def test_fixed_id_events_write_byte_equal_segments_both_packages_read(pair):
    """Single posts, a batch and a channel post of events with explicit
    ids and times: the two stores' segment files are byte-equal, and each
    package reads the other's store to the same events."""
    steps = [("POST", "/events.json?accessKey={KEY}", _ev(60)),
             ("POST", "/batch/events.json?accessKey={KEY}", [_ev(i) for i in range(61, 75)]),
             ("POST", "/events.json?accessKey={KEY}&channel=ch1", _ev(75)),
             ("DELETE", "/events/fixed0063.json?accessKey={KEY}", None)]
    assert _drive(pair["port"], steps) == _drive(pair["jax"], steps)
    root = pair["root"]
    jax_segs = _segment_lines(root / "jax")
    port_segs = _segment_lines(root / "port")
    assert port_segs == jax_segs and sum(v.count(b"\n") for v in port_segs.values()) == 15
    assert _segment_lines(root / "port", chan="channel_1") == _segment_lines(
        root / "jax", chan="channel_1")
    assert (root / "port/events/app_1/_default/tombstones.txt").read_text() == (
        root / "jax/events/app_1/_default/tombstones.txt").read_text()
    # either package reads the other's directory
    from predictionio_tpu.storage.localfs import FSEvents as JaxFSEvents
    from predictionio_tpu_torch.storage.localfs import FSEvents as PortFSEvents

    jax_reads_port = [e.to_json() for e in JaxFSEvents(root / "port").find(1)]
    port_reads_jax = [e.to_json() for e in PortFSEvents(root / "jax").find(1)]
    own = [e.to_json() for e in PortFSEvents(root / "port").find(1)]
    assert len(own) == 14 and own == port_reads_jax == jax_reads_port


def test_auth_cache_honours_revocation_after_its_ttl(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_AUTH_CACHE_S", "0.2")
    _, port_st = _stores(tmp_path)
    srv = port_es.run_event_server(host="127.0.0.1", port=0, storage=port_st,
                                   background=True)
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        assert http("POST", f"{base}/events.json?accessKey={KEY}", _ev(80))[0] == 201
        port_st.access_keys.delete(KEY)
        assert wait_for(lambda: http("POST", f"{base}/events.json?accessKey={KEY}",
                                     _ev(81))[0] == 401, timeout=5)
    finally:
        stop(srv)


def test_event_labels_are_bounded(tmp_path):
    _, port_st = _stores(tmp_path)
    state = port_es.EventServerState(port_st, stats=True)
    state.MAX_EVENT_LABELS = 3
    for i in range(6):
        state.record(1, f"ev{i}")
    assert set(state.counts[1]) == {"ev0", "ev1", "ev2", "(other)"}
    assert state.counts[1]["(other)"] == 3


def test_max_batch_from_the_environment(monkeypatch, caplog):
    monkeypatch.setenv("PIO_MAX_BATCH", "200")
    assert port_es._max_batch() == 200
    monkeypatch.setenv("PIO_MAX_BATCH", "x")
    assert port_es._max_batch() == port_es.MAX_BATCH == 50
    monkeypatch.delenv("PIO_MAX_BATCH")
    assert port_es._max_batch() == 50


def test_stats_json_reports_snapshot_coverage(pair):
    port_st = pair["port_store"]
    http("POST", pair["port"] + "/batch/events.json?accessKey=" + KEY,
         [_ev(i) for i in range(90, 95)])
    port_st.l_events.build_snapshot(1)
    http("POST", pair["port"] + "/events.json?accessKey=" + KEY, _ev(95))
    status, doc = http("GET", pair["port"] + "/stats.json?accessKey=" + KEY)
    assert status == 200 and doc["counts"] == {"view": 6}
    snap = doc["snapshot"][""]
    assert snap["events"] == 5 and snap["tailEvents"] == 1
    from predictionio_tpu_torch.obs import metrics as obs_metrics
    from predictionio_tpu_torch.storage import snapshot as snap_mod

    snap_mod.publish_status_gauges(snap, "app_1/_default")
    reg = obs_metrics.get_registry()
    assert reg.gauge("pio_snapshot_tail_events", "x").value(channel="app_1/_default") == 1
    assert reg.gauge("pio_snapshot_coverage_ratio", "x").value(
        channel="app_1/_default") == snap["coverage"]


def test_stats_json_answers_503_with_metrics_off(tmp_path, monkeypatch):
    _, port_st = _stores(tmp_path)
    state = port_es.EventServerState(port_st, stats=False)
    from predictionio_tpu_torch.api.http_util import start_server

    srv = start_server(port_es.make_handler(state), "127.0.0.1", 0, background=True)
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        assert http("GET", f"{base}/stats.json?accessKey={KEY}")[0] == 503
        assert http("POST", f"{base}/events.json?accessKey={KEY}", _ev(1))[0] == 201
    finally:
        stop(srv)


def test_remote_stop_is_refused_and_loopback_stop_stops(tmp_path):
    _, port_st = _stores(tmp_path)
    srv = port_es.run_event_server(host="127.0.0.1", port=0, storage=port_st,
                                   background=True)
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        assert http("GET", base + "/stop") == (200, {"stopping": True})
        srv.thread.join(timeout=WAIT_S)
        assert not srv.thread.is_alive()
    finally:
        stop(srv)


# -- the writer: group commit ---------------------------------------------------------


def test_group_commit_many_threads_exactly_once(tmp_path, monkeypatch):
    from predictionio_tpu_torch.storage import localfs

    monkeypatch.setenv("PIO_FSYNC", "always")
    monkeypatch.setattr(localfs, "SEGMENT_MAX_BYTES", 8192)
    ev = localfs.FSEvents(tmp_path)
    errs = []

    def work(t):
        try:
            for k in range(40):
                r = ev.insert_json_batch([{"event": "buy", "entityType": "user",
                                           "entityId": f"u{t}", "eventId": f"t{t}-{k}"}], 1)
                assert r[0]["status"] == 201
        except Exception as e:   # noqa: BLE001
            errs.append(e)

    ts = [threading.Thread(target=work, args=(t,)) for t in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=WAIT_S * 3)
    assert not errs and not any(t.is_alive() for t in ts)
    ids = [e.event_id for e in ev._iter_raw(1, None)]
    assert len(ids) == len(set(ids)) == 320


# -- prefork workers ----------------------------------------------------------------


def _fs_env(monkeypatch, store):
    for k, v in {"PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
                 "PIO_STORAGE_SOURCES_FS_PATH": str(store),
                 "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "FS",
                 "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "FS",
                 "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "FS",
                 "PYTHONPATH": str(REPO), "PIO_TORCH_DEVICE": "cpu"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("PIO_WRITER_TAG", raising=False)
    monkeypatch.delenv("PIO_METRICS_DIR", raising=False)
    monkeypatch.delenv("PIO_METRICS_TAG", raising=False)


def _pids(base, n):
    import urllib.request

    pids, deadline = set(), time.monotonic() + 90
    while len(pids) < n and time.monotonic() < deadline:
        try:
            with urllib.request.urlopen(base + "/", timeout=2) as r:
                pids.add(json.loads(r.read())["pid"])
        except Exception:
            time.sleep(0.2)
    return pids


def test_prefork_event_server_group_ingests_exactly_once(tmp_path, monkeypatch):
    """``run_event_server(workers=2)``: both workers answer on one port,
    each appends to its own ``seg-w<i>-<parent pid>-NNNNN.jsonl``, every
    acknowledged event is in the store once, and a scrape of either
    worker reports the group's ``pio_events_ingested_total``."""
    import http.client as httpc

    from predictionio_tpu_torch.storage.localfs import FSEvents

    store = tmp_path / "store"
    _fs_env(monkeypatch, store)
    meta = Storage(StorageConfig(
        sources={"FS": {"type": "localfs", "path": str(store)}},
        repositories={r: "FS" for r in ("METADATA", "EVENTDATA", "MODELDATA")}))
    app_id = meta.apps.insert(App(0, "pfes"))
    key = meta.access_keys.insert(AccessKey("", app_id, []))
    set_storage(None)
    httpd = port_es.run_event_server(host="127.0.0.1", port=0, background=True, workers=2)
    child = httpd.pio_workers[0]
    try:
        port = httpd.server_address[1]
        base = f"http://127.0.0.1:{port}"
        assert len(_pids(base, 2)) == 2, "the second worker never came up"
        acked, lock = [], threading.Lock()

        def client(c):
            conn = httpc.HTTPConnection("127.0.0.1", port, timeout=WAIT_S)
            for b in range(5):
                batch = [{"event": "rate", "entityType": "user", "entityId": f"u{c}",
                          "targetEntityType": "item", "targetEntityId": f"i{k}",
                          "properties": {"rating": 3}} for k in range(10)]
                conn.request("POST", f"/batch/events.json?accessKey={key}",
                             json.dumps(batch), {"Content-Type": "application/json"})
                r = conn.getresponse()
                res = json.loads(r.read())
                assert r.status == 200 and {x["status"] for x in res} == {201}
                with lock:
                    acked.extend(x["eventId"] for x in res)
            conn.close()

        ts = [threading.Thread(target=client, args=(c,)) for c in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=WAIT_S * 3)
        assert len(acked) == 200
        got = [e.event_id for e in FSEvents(store)._iter_raw(app_id, None)]
        assert sorted(got) == sorted(acked)
        chan = store / "events" / f"app_{app_id}" / "_default"
        tags = {p.name.rsplit("-", 1)[0] for p in chan.glob("seg-*.jsonl")}
        assert tags <= {f"seg-w0-{os.getpid()}", f"seg-w1-{os.getpid()}"} and tags

        def ingested():
            _, text = http("GET", base + "/metrics", raw=True)
            m = re.findall(rb'pio_events_ingested_total\{app="%d",event="rate"\} (\d+)'
                           % app_id, text)
            return m and int(m[0]) == 200

        wait_for(ingested, timeout=WAIT_S)
    finally:
        stop(httpd)
        child.wait(timeout=WAIT_S)
        set_storage(None)
    assert child.poll() is not None


def test_pio_eventserver_workers_subprocess_stops_with_undeploy(tmp_path, monkeypatch):
    """``pio eventserver --workers 2`` as a process group: it ingests, and
    ``pio undeploy`` (which keeps stopping while the port answers) takes
    the whole group down, children included."""
    store = tmp_path / "store"
    _fs_env(monkeypatch, store)
    cli = [sys.executable, "-m", "predictionio_tpu_torch.cli.main"]
    out = subprocess.run(cli + ["app", "new", "esub"], capture_output=True, text=True,
                         timeout=120, env=os.environ.copy())
    assert out.returncode == 0, out.stderr
    key = re.search(r"Access key: (\S+)", out.stdout).group(1)
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(cli + ["eventserver", "--ip", "127.0.0.1", "--port", str(port),
                                   "--workers", "2"], env=os.environ.copy())
    try:
        base = f"http://127.0.0.1:{port}"
        assert len(_pids(base, 2)) == 2
        status, res = http("POST", f"{base}/batch/events.json?accessKey={key}",
                           [{"event": "buy", "entityType": "user", "entityId": "u1",
                             "targetEntityType": "item", "targetEntityId": f"i{k}"}
                            for k in range(5)])
        assert status == 200 and [r["status"] for r in res] == [201] * 5
        und = subprocess.run(cli + ["undeploy", "--ip", "127.0.0.1", "--port", str(port)],
                             capture_output=True, text=True, timeout=120,
                             env=os.environ.copy())
        assert und.returncode == 0, (und.stdout, und.stderr)
        assert proc.wait(timeout=WAIT_S * 2) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=WAIT_S)
    # no worker outlived the group: the port refuses
    import socket as _s

    with pytest.raises(ConnectionRefusedError):
        _s.create_connection(("127.0.0.1", port), timeout=5).close()
