"""The port's query server (``workflow/create_server.py``) on the CPU:
deploy, ``/reload``, the auto-reload hot swap and its install order,
feedback, plugins, prefork workers, and the micro-batcher.

The micro-batcher cases are the JAX suite's (tests/test_servers.py:
micro-batching matches serial, the poisoned query, the soak, the departed
waiter, the short result), run against the port's ``_MicroBatcher``, and
the pipelined-queries case of tests/test_async_http.py.  The ALS engine
is trained by the port on the CPU from a memory store.  Every wait is
bounded: socket timeouts, joins with a timeout, a shrunk
``_WAIT_TIMEOUT_S`` where a waiter must give up.
"""

import gc
import json
import os
import random
import threading
import time
import types

import numpy as np
import pytest

from predictionio_tpu_torch.api.plugins import OutputBlocker, OutputSniffer
from predictionio_tpu_torch.obs import metrics as obs_metrics
from predictionio_tpu_torch.serve import response_cache
from predictionio_tpu_torch.storage import App, set_storage
from predictionio_tpu_torch.workflow import core_workflow
from predictionio_tpu_torch.workflow import create_server as cs
from predictionio_tpu_torch.workflow.create_workflow import engine_from_variant

from _torch_event_cases import port_events, port_memory_storage, rating_corpus
from _torch_server_cases import WAIT_S, connect, http, read_responses, stop, wait_for

VARIANT = {
    "id": "srv-als", "engineFactory": "recommendation",
    "datasource": {"params": {"appName": "srvals"}},
    "algorithms": [{"name": "als", "params": {"rank": 6, "numIterations": 4,
                                              "lambda": 0.05}}]}


def _flipped(specs):
    """The corpus with every rating turned round: a retrain of it ranks
    the other half of the items first."""
    return [(ev, et, eid, tt, tid, {"rating": 6.0 - p["rating"]}, t + 1e6, ct + 1e6)
            for ev, et, eid, tt, tid, p, t, ct in specs]


@pytest.fixture()
def als(tmp_path):
    store = port_memory_storage()
    set_storage(store)
    app_id = store.apps.insert(App(0, "srvals"))
    store.l_events.insert_batch(port_events(rating_corpus()), app_id)
    path = tmp_path / "engine.json"
    path.write_text(json.dumps(VARIANT))
    factory, engine, ep = engine_from_variant(VARIANT)

    def train():
        return core_workflow.run_train(engine, ep, VARIANT["id"], storage=store, device="cpu")

    first = train()
    yield {"store": store, "app_id": app_id, "path": str(path), "train": train,
           "engine": engine, "ep": ep, "factory": factory, "first": first}
    set_storage(None)


def _deploy(als, **kw):
    return cs.deploy(als["path"], host="127.0.0.1", port=0, storage=als["store"],
                     device="cpu", **kw)


def _base(httpd):
    return f"http://127.0.0.1:{httpd.server_address[1]}"


def _predict_in_process(als, bodies):
    _, models = core_workflow.load_latest_models(VARIANT["id"], storage=als["store"],
                                                 device="cpu")
    predict = als["engine"].predictor(als["ep"], models)
    return [predict(als["factory"].query_class.from_json(b)).to_json() for b in bodies]


BODIES = [{"user": f"u{u}", "num": 5} for u in range(12)] + [
    {"user": "u1", "num": 3, "unseenOnly": True}, {"user": "ghost", "num": 4}]


def test_deploy_serves_queries_info_metrics_and_stats(als):
    httpd = _deploy(als)
    try:
        base = _base(httpd)
        got = [http("POST", base + "/queries.json", b) for b in BODIES]
        assert [s for s, _ in got] == [200] * len(BODIES)
        assert [d for _, d in got] == _predict_in_process(als, BODIES)
        status, info = http("GET", base + "/")
        assert status == 200 and info["status"] == "alive" and info["pid"] == os.getpid()
        assert info["engineInstanceId"] == als["first"].id and info["modelGeneration"] == 1
        assert info["devices"] == ["cpu"] and info["queryCount"] == len(BODIES)
        assert info["microBatching"] is False   # auto on the CPU: off
        status, page = http("GET", base + "/", headers={"Accept": "text/html"}, raw=True)
        assert status == 200 and b"Engine server: srv-als" in page
        status, text = http("GET", base + "/metrics", raw=True)
        assert status == 200 and b'pio_http_requests_total{route="/queries.json"' in text
        assert b"pio_model_generation 1" in text
        status, stats = http("GET", base + "/stats.json")
        assert status == 200 and stats["engineId"] == "srv-als"
        assert stats["freshness"]["engineInstanceId"] == als["first"].id
        # the observability routes answer as the JAX query server's: the
        # flight recorder, lineage, the history ring and /healthz on every
        # server, the federation only on a replication publisher
        status, traces = http("GET", base + "/traces.json")
        assert status == 200 and set(traces) >= {"traces", "worker"}
        status, lineage = http("GET", base + "/lineage.json")
        assert status == 200 and set(lineage) >= {"records", "worker"}
        status, health = http("GET", base + "/healthz")
        assert status == 200 and health["status"] in ("ok", "warn", "burning", "no_data")
        status, history = http("GET", base + "/metrics/history.json")
        assert status == 200 and "samples" in history
        for path in ("/cluster/metrics.json", "/cluster/history.json", "/traces/none.json",
                     "/nope"):
            assert http("GET", base + path)[0] == 404, path
        assert http("POST", base + "/queries.json", ["x"])[0] == 400
        assert http("POST", base + "/nope", {})[0] == 404
    finally:
        stop(httpd)


def test_pio_deploy_serves_from_a_frozen_heap(als, monkeypatch):
    """``pio deploy`` moves its heap as imported to the permanent
    generation before it loads the engine: a full collection of the cyclic
    GC walks the engine, its models and the server, not every object of
    torch and numpy (on the card such a walk landed on a plane
    subscriber's first query), and the models it serves stay collectable
    once swapped out (ROADMAP §C.11)."""
    imported = [[]]   # a container that lived before the deploy
    servers, rcs = [], []
    real_deploy = cs.deploy

    def deploy(**kw):
        servers.append(real_deploy(storage=als["store"], **kw))
        return servers[-1]

    monkeypatch.setattr(cs, "deploy", deploy)
    args = types.SimpleNamespace(
        plane_publisher=False, engine_json=als["path"], variant="default", engine_id=None,
        engine_version="1", ip="127.0.0.1", port=0, device="cpu", feedback=False,
        auto_reload=0.0, workers=1, reuse_port=False, follow=0.0, plane_publish=False,
        plane_from=None)
    runner = threading.Thread(target=lambda: rcs.append(cs.run_server_from_args(args)))
    try:
        runner.start()
        wait_for(lambda: servers)
        httpd = servers[0]
        assert http("POST", _base(httpd) + "/queries.json", BODIES[0])[0] == 200
        assert gc.get_freeze_count() > 0
        live = {id(o) for o in gc.get_objects()}   # what a full collection walks
        assert id(imported) not in live
        assert id(httpd.pio_state.models[0]) in live
    finally:
        if servers:
            servers[0].shutdown()
        runner.join(WAIT_S)
        gc.unfreeze()
    assert rcs == [0]


def test_install_builds_a_response_cache_key_before_serving(als, monkeypatch):
    """Every install builds one response-cache key before its model serves:
    the key builder's first numpy calls may import a module, which a plane
    subscriber's first query paid on the card (ROADMAP §C.11)."""
    keys = []
    real_make_key = response_cache.make_key
    monkeypatch.setattr(response_cache, "make_key",
                        lambda *a: keys.append(a) or real_make_key(*a))
    httpd = _deploy(als)
    try:
        assert len(keys) == 1
        als["train"]()
        httpd.pio_state.reload()
        assert len(keys) == 2
    finally:
        stop(httpd)


def test_reload_installs_the_newest_instance(als):
    httpd = _deploy(als)
    try:
        base = _base(httpd)
        assert http("GET", base + "/reload") == (200, {
            "reloaded": True, "engineInstanceId": als["first"].id})
        second = als["train"]()
        assert http("GET", base + "/reload") == (200, {
            "reloaded": True, "engineInstanceId": second.id})
        assert httpd.pio_state.generation == 3
        assert http("GET", base + "/")[1]["engineInstanceId"] == second.id
    finally:
        stop(httpd)


def test_auto_reload_hot_swaps_on_retrain(als):
    """A retrain on flipped preferences reaches the running server within
    the poll interval plus the install, and its answers are the new
    model's."""
    httpd = _deploy(als, auto_reload=0.05)
    try:
        base = _base(httpd)
        before = http("POST", base + "/queries.json", BODIES[0])[1]
        als["store"].l_events.insert_batch(
            port_events(_flipped(rating_corpus()) * 3), als["app_id"])
        second = als["train"]()
        wait_for(lambda: httpd.pio_state.instance.id == second.id, timeout=WAIT_S)
        got = [http("POST", base + "/queries.json", b)[1] for b in BODIES]
        assert got == _predict_in_process(als, BODIES)
        assert got[0] != before
        assert httpd.pio_state.generation == 2
    finally:
        stop(httpd)
    assert httpd.pio_state._auto_stop.is_set()
    assert not httpd.pio_state._auto_thread.is_alive()


def test_stale_build_never_installs_over_a_newer_one(als):
    """Two reloads race: the one whose build began first finishes last and
    is dropped (its ticket predates the installed one), so the server keeps
    the newer generation."""
    httpd = _deploy(als)
    state = httpd.pio_state
    gate, entered = threading.Event(), threading.Event()
    real = als["engine"].serving_bundle
    calls = []

    def slow_first(ep, models):
        calls.append(models)
        if len(calls) == 1:
            entered.set()
            assert gate.wait(timeout=WAIT_S)
        return real(ep, models)

    try:
        state.engine.serving_bundle = slow_first
        res = {}
        t = threading.Thread(target=lambda: res.setdefault("old", state.reload()))
        t.start()
        assert entered.wait(timeout=WAIT_S)
        second = als["train"]()
        assert state.reload() == second.id          # the later build installs
        gate.set()
        t.join(timeout=WAIT_S)
        assert res["old"] is None                   # the earlier one is dropped
        assert state.instance.id == second.id and state.generation == 2
        assert state.models == list(calls[1])
    finally:
        del state.engine.serving_bundle
        stop(httpd)


def test_feedback_writes_the_served_predictions(als):
    httpd = _deploy(als, feedback=True)
    try:
        base = _base(httpd)
        answers = [http("POST", base + "/queries.json", b)[1] for b in BODIES[:5]]
    finally:
        stop(httpd)
    events = list(als["store"].l_events.find(als["app_id"], event_names=["predict"]))
    assert len(events) == 5
    assert all(e.entity_type == "pio_pr" and e.pr_id for e in events)
    got = sorted((json.dumps(e.properties["query"], sort_keys=True),
                  json.dumps(e.properties["prediction"], sort_keys=True)) for e in events)
    want = sorted((json.dumps(b, sort_keys=True), json.dumps(a, sort_keys=True))
                  for b, a in zip(BODIES[:5], answers))
    assert got == want


def test_plugins_transform_and_observe_predictions(als):
    class Top1(OutputBlocker):
        name = "top1"

        def process(self, query, prediction):
            prediction.item_scores = prediction.item_scores[:1]
            return prediction

    class Log(OutputSniffer):
        name = "log"
        seen = []

        def start(self, state):
            self.state = state

        def process(self, query, prediction):
            self.seen.append(query.user)

    log = Log()
    httpd = _deploy(als, plugins=[Top1(), log])
    try:
        base = _base(httpd)
        got = [http("POST", base + "/queries.json", b)[1] for b in BODIES[:4]]
        assert all(len(g["itemScores"]) == 1 for g in got)
        assert [g["itemScores"][0] for g in got] == [
            w["itemScores"][0] for w in _predict_in_process(als, BODIES[:4])]
        assert log.seen == ["u0", "u1", "u2", "u3"] and log.state is httpd.pio_state
        assert b"plugins: top1, log" in http("GET", base + "/", raw=True,
                                             headers={"Accept": "text/html"})[1]
    finally:
        stop(httpd)


def test_serve_batch_setting_picks_the_batcher(als, monkeypatch):
    """PIO_SERVE_BATCH: ``on`` batches, ``off`` never does and never asks
    the models for their device, ``auto`` batches only models on CUDA."""
    state = _deploy(als)
    try:
        models = state.pio_state.models
        for conf, want in (("on", True), ("off", False), ("auto", False)):
            monkeypatch.setenv("PIO_SERVE_BATCH", conf)
            assert cs._batch_wanted(models) is want, conf

        class CudaModel:
            device = __import__("torch").device("cuda")

        class Untouchable:
            @property
            def device(self):
                raise AssertionError("PIO_SERVE_BATCH=off looked at the device")

        monkeypatch.setenv("PIO_SERVE_BATCH", "auto")
        assert cs._batch_wanted([CudaModel()]) is True
        monkeypatch.setenv("PIO_SERVE_BATCH", "off")
        assert cs._batch_wanted([Untouchable()]) is False
    finally:
        stop(state)


def _concurrent(port, bodies, n_threads=6):
    import http.client as httpc

    results = {}

    def worker(w):
        conn = httpc.HTTPConnection("127.0.0.1", port, timeout=WAIT_S)
        for k in range(w, len(bodies), n_threads):
            conn.request("POST", "/queries.json", json.dumps(bodies[k]),
                         {"Content-Type": "application/json"})
            r = conn.getresponse()
            assert r.status == 200
            results[k] = json.loads(r.read())
        conn.close()

    ts = [threading.Thread(target=worker, args=(w,)) for w in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=WAIT_S * 3)
    assert not any(t.is_alive() for t in ts)
    return [results[k] for k in range(len(bodies))]


def test_serve_micro_batching_matches_serial(als, monkeypatch):
    """PIO_SERVE_BATCH=on: concurrent queries meet in the micro-batcher
    and answer as serial predict does (items equal, scores within rtol
    2e-5: the batched product sums in another order); the batch-size
    histogram counts them and no batch was re-run serially."""
    bodies = [{"user": f"u{u % 24}", "num": 5, "unseenOnly": u % 3 == 0} for u in range(48)]
    reg = obs_metrics.get_registry()
    hist = reg.histogram("pio_serve_batch_size", "x")

    def run(mode):
        monkeypatch.setenv("PIO_SERVE_BATCH", mode)
        httpd = _deploy(als)
        try:
            assert (httpd.pio_state.batcher is not None) == (mode == "on")
            return _concurrent(httpd.server_address[1], bodies)
        finally:
            stop(httpd)

    serial = run("off")
    before = dict(hist._snapshot_series().get("", {"count": 0}))
    reruns = cs._M_SERIAL_RERUNS.value()
    batched = run("on")
    assert hist._snapshot_series()[""]["count"] > before["count"]
    assert cs._M_SERIAL_RERUNS.value() == reruns
    for s, b in zip(serial, batched):
        assert [r["item"] for r in s["itemScores"]] == [r["item"] for r in b["itemScores"]]
        np.testing.assert_allclose([r["score"] for r in s["itemScores"]],
                                   [r["score"] for r in b["itemScores"]], rtol=2e-5)


def test_pipelined_queries_batch_parity(als, monkeypatch):
    """Queries pipelined on ONE socket coalesce through the batcher and
    come back in order, equal to the unbatched answers."""
    def run(mode):
        monkeypatch.setenv("PIO_SERVE_BATCH", mode)
        httpd = _deploy(als)
        try:
            s = connect(httpd.server_address[1])
            wire = b""
            for u in range(20):
                body = json.dumps({"user": f"u{u}", "num": 5}).encode()
                wire += (b"POST /queries.json HTTP/1.1\r\nHost: x\r\n"
                         b"Content-Type: application/json\r\nContent-Length: %d\r\n\r\n"
                         % len(body) + body)
            s.sendall(wire)
            out = [[r["item"] for r in json.loads(b)["itemScores"]]
                   for _, _, b in read_responses(s, 20)]
            s.close()
            return out
        finally:
            stop(httpd)

    assert run("on") == run("off")


def test_stop_route_stops_the_server(als):
    httpd = _deploy(als, auto_reload=30)
    assert http("GET", _base(httpd) + "/stop") == (200, {"stopping": True})
    httpd.thread.join(timeout=WAIT_S)
    assert not httpd.thread.is_alive()
    assert httpd.pio_state._auto_stop.is_set()
    stop(httpd)


def test_prefork_workers_share_port_and_die_with_server(tmp_path, monkeypatch):
    """deploy(workers=2) on the CPU: two processes answer on one port
    (distinct pids, the same answers), /metrics of either reports the
    group, and the child dies with the parent."""
    from pathlib import Path

    from predictionio_tpu_torch.storage.locator import Storage, StorageConfig

    store = tmp_path / "store"
    for k, v in {"PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
                 "PIO_STORAGE_SOURCES_FS_PATH": str(store),
                 "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "FS",
                 "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "FS",
                 "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "FS",
                 "PYTHONPATH": str(Path(__file__).resolve().parent.parent)}.items():
        monkeypatch.setenv(k, v)
    for k in ("PIO_METRICS_DIR", "PIO_METRICS_TAG", "PIO_WRITER_TAG"):
        monkeypatch.delenv(k, raising=False)
    st = Storage(StorageConfig(
        sources={"FS": {"type": "localfs", "path": str(store)}},
        repositories={r: "FS" for r in ("METADATA", "EVENTDATA", "MODELDATA")}))
    set_storage(st)
    app_id = st.apps.insert(App(0, "srvals"))
    st.l_events.insert_batch(port_events(rating_corpus()), app_id)
    path = tmp_path / "engine.json"
    path.write_text(json.dumps(VARIANT))
    _, engine, ep = engine_from_variant(VARIANT)
    core_workflow.run_train(engine, ep, VARIANT["id"], storage=st, device="cpu")
    set_storage(None)
    with pytest.raises(ValueError, match="storage object"):
        cs.deploy(str(path), port=0, storage=st, device="cpu", workers=2)
    httpd = cs.deploy(str(path), host="127.0.0.1", port=0, device="cpu", workers=2)
    child = httpd.pio_workers[0]
    try:
        base = _base(httpd)
        pids, answers, deadline = set(), set(), time.monotonic() + 90
        while len(pids) < 2 and time.monotonic() < deadline:
            try:
                pids.add(http("GET", base + "/")[1]["pid"])
                answers.add(json.dumps(http("POST", base + "/queries.json",
                                            BODIES[0])[1], sort_keys=True))
            except Exception:
                time.sleep(0.2)
        assert len(pids) == 2, "the second worker never came up"
        assert len(answers) == 1
        assert b"pio_worker_up" in http("GET", base + "/metrics", raw=True)[1]
    finally:
        stop(httpd)
        child.wait(timeout=WAIT_S)
        set_storage(None)
    assert child.poll() is not None


# -- the micro-batcher on its own ---------------------------------------------------


def test_micro_batcher_isolates_poisoned_query():
    """One failing query does not fail its batchmates: the batch re-runs
    serially (counted) so only the offender errors."""
    def run_one(q):
        if q == "poison":
            raise ValueError("bad query")
        return f"ok:{q}"

    batcher = cs._MicroBatcher(lambda qs: [run_one(q) for q in qs], run_one, max_batch=4)
    reruns = cs._M_SERIAL_RERUNS.value()
    results, errors = {}, {}
    gate = threading.Barrier(8)

    def worker(q):
        gate.wait(timeout=WAIT_S)
        try:
            results[q] = batcher.predict(q)
        except ValueError as e:
            errors[q] = str(e)

    qs = [f"q{i}" for i in range(7)] + ["poison"]
    ts = [threading.Thread(target=worker, args=(q,)) for q in qs]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert errors == {"poison": "bad query"}
    assert results == {f"q{i}": f"ok:q{i}" for i in range(7)}
    assert batcher._queue == [] and not batcher._leader_active
    assert cs._M_SERIAL_RERUNS.value() > reruns


def test_micro_batcher_soak():
    rng = random.Random(42)   # only the single leader calls run_batch

    def run_one(q):
        if q.endswith(":poison"):
            raise ValueError(q)
        return "ok:" + q

    def run_batch(queries):
        if rng.random() < 0.2:
            time.sleep(0.002)   # mid-flight queries coalesce into the next batch
        return [run_one(q) for q in queries]

    batcher = cs._MicroBatcher(run_batch, run_one, max_batch=6)
    n_threads, n_queries = 12, 30
    results, errors = {}, {}
    gate = threading.Barrier(n_threads)

    def worker(tid):
        trng = random.Random(tid)
        gate.wait(timeout=WAIT_S)
        for seq in range(n_queries):
            q = f"{tid}:{seq}" + (":poison" if trng.random() < 0.1 else "")
            try:
                results[q] = batcher.predict(q)
            except ValueError as e:
                errors[q] = str(e)

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(n_threads)]
    start = time.monotonic()
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts), "soak deadlocked"
    assert time.monotonic() - start < 30
    assert len(results) + len(errors) == n_threads * n_queries
    assert all(r == "ok:" + q for q, r in results.items())
    assert all(q.endswith(":poison") and e == q for q, e in errors.items())
    assert batcher._queue == [] and not batcher._leader_active


def test_micro_batcher_recovers_when_nudged_waiter_departed(monkeypatch):
    """A waiter times out and leaves during a slow batch: the leader
    releases leadership (never hands it to the departed thread), so the
    next query is served."""
    monkeypatch.setattr(cs, "_WAIT_TIMEOUT_S", 0.2)
    slow_gate = threading.Event()

    def run_batch(queries):
        if "slow" in queries:
            slow_gate.wait(timeout=10)
        return ["ok:" + q for q in queries]

    batcher = cs._MicroBatcher(run_batch, lambda q: "ok:" + q, max_batch=1)
    res, errs = {}, []

    def waiter():
        try:
            res["w"] = batcher.predict("w")
        except TimeoutError as e:
            errs.append(e)

    t1 = threading.Thread(target=lambda: res.setdefault("slow", batcher.predict("slow")))
    t1.start()
    time.sleep(0.05)
    t2 = threading.Thread(target=waiter)
    t2.start()
    t2.join(timeout=5)
    assert not t2.is_alive() and errs
    slow_gate.set()
    t1.join(timeout=5)
    assert res["slow"] == "ok:slow"
    assert batcher.predict("after") == "ok:after"
    assert batcher._queue == [] and not batcher._leader_active


def test_micro_batcher_short_batch_result_falls_back_serial():
    batcher = cs._MicroBatcher(lambda qs: ["ok:" + q for q in qs][:-1],
                               lambda q: "one:" + q, max_batch=4)
    assert batcher.predict("a") == "one:a"
    assert batcher._queue == [] and not batcher._leader_active


def test_micro_batcher_caps_the_batch():
    sizes, gate = [], threading.Event()

    def run_batch(queries):
        sizes.append(len(queries))
        if len(sizes) == 1:
            gate.wait(timeout=WAIT_S)
        return list(queries)

    batcher = cs._MicroBatcher(run_batch, lambda q: q, max_batch=3)
    out = {}
    t0 = threading.Thread(target=lambda: out.setdefault(0, batcher.predict(0)))
    t0.start()
    time.sleep(0.05)   # the first query leads and blocks in its batch
    ts = [threading.Thread(target=lambda i=i: out.setdefault(i, batcher.predict(i)))
          for i in range(1, 8)]
    for t in ts:
        t.start()
    wait_for(lambda: len(batcher._queue) == 7, timeout=WAIT_S)
    gate.set()
    for t in [t0] + ts:
        t.join(timeout=WAIT_S)
    assert out == {i: i for i in range(8)}
    assert sizes[0] == 1 and max(sizes) == 3 and sum(sizes) == 8
