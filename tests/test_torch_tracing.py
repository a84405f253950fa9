"""The port's flight recorder, span journals and ``timed`` against the JAX
package's (the parity targets are the JAX suite's tests/test_tracing.py
and tests/test_build_template_dashboard.py's journal cases).

- The same request sequence against each package's event server and query
  server (each on its own localfs store) leaves traces with equal keys,
  route, status, reason, span names, nesting and attributes; only the
  durations differ (``mask``).
- ``render_waterfall_text`` is byte-equal on the same document.
- Traces persisted by either package into one directory are listed and
  read by the other's recorder merge.
- The ``ur_predict`` span has the same laps and attributes on the same
  carried-across model, under a journal and under a trace.
- ``run_train``'s journal from either package is read by the other's
  ``read_journal``, with equal span trees.
- ``timed`` nests under a journal and under a trace; ``profile_to``
  writes a Chrome trace on the CPU.

Every read of a trace after a response polls with a deadline
(``_torch_obs_cases.poll``).  Servers bind ephemeral ports.
"""

import json
import os

import pytest

from predictionio_tpu.api.event_server import run_event_server as jax_event_server
from predictionio_tpu.obs import spans as jax_spans
from predictionio_tpu.obs import tracing as jax_tracing
from predictionio_tpu.storage import set_storage as jax_set_storage
from predictionio_tpu.workflow import core_workflow as jax_workflow
from predictionio_tpu.workflow import create_server as jax_server
from predictionio_tpu.workflow.create_workflow import engine_from_variant as jax_variant
from predictionio_tpu_torch.api.event_server import run_event_server as port_event_server
from predictionio_tpu_torch.obs import spans as port_spans
from predictionio_tpu_torch.obs import tracing as port_tracing
from predictionio_tpu_torch.storage import set_storage as port_set_storage
from predictionio_tpu_torch.utils import tracing as port_utils_tracing
from predictionio_tpu_torch.workflow import core_workflow as port_workflow
from predictionio_tpu_torch.workflow import create_server as port_server
from predictionio_tpu_torch.workflow.create_workflow import engine_from_variant as port_variant

from _torch_event_cases import fill_both, rule_corpus
from _torch_obs_cases import (
    UR_QUERIES,
    UR_VARIANT,
    fetch_trace,
    get_json,
    jax_app,
    localfs_pair,
    poll,
    port_app,
    recorders,  # noqa: F401  (fixture)
    request,
    span_tree,
    trace_shape,
)
from _torch_serve_cases import algos, make_models

DEBUG = {"X-PIO-Debug": "1"}


def _stop(httpd):
    httpd.shutdown()
    httpd.server_close()


def _event(i, event="buy"):
    return {"event": event, "entityType": "user", "entityId": f"u{i}",
            "targetEntityType": "item", "targetEntityId": f"i{i % 3}",
            "eventTime": "2026-01-0%dT00:00:00.000Z" % (1 + i % 9)}


def _event_sequence(key):
    """(rid, method, path, body, headers) of the event-server sequence: a
    single insert, a batch, a read, a refused key, a 404 and an untraced
    insert (no debug header: dropped at request end)."""
    q = f"?accessKey={key}"
    return [
        ("ev-1", "POST", "/events.json" + q, _event(1), DEBUG),
        ("ev-2", "POST", "/batch/events.json" + q, [_event(i) for i in range(2, 6)], DEBUG),
        ("ev-3", "GET", "/events.json" + q + "&limit=3", None, DEBUG),
        ("ev-4", "POST", "/events.json?accessKey=nope", _event(7), DEBUG),
        ("ev-5", "GET", "/nope", None, DEBUG),   # no key: 401 before the route
        ("ev-6", "POST", "/events.json" + q, _event(8), {}),
    ]


def test_event_server_traces_equal_the_jax_servers(tmp_path, recorders):
    jstore, pstore = localfs_pair(tmp_path)
    jax_app(jstore)
    port_app(pstore)
    jsrv = jax_event_server(host="127.0.0.1", port=0, storage=jstore, background=True)
    psrv = port_event_server(host="127.0.0.1", port=0, storage=pstore, background=True)
    try:
        bases = {"jax": f"http://127.0.0.1:{jsrv.server_address[1]}",
                 "port": f"http://127.0.0.1:{psrv.server_address[1]}"}
        seq = _event_sequence("obskey")
        for name, base in bases.items():
            got = [request(m, base + p, b, headers={"X-Request-ID": rid, **h})[0]
                   for rid, m, p, b, h in seq]
            assert got == [201, 200, 200, 401, 401, 201], (name, got)
        traced = [rid for rid, *_, h in seq if h]
        for rid in traced:
            want = trace_shape(fetch_trace(bases["jax"], rid))
            assert trace_shape(fetch_trace(bases["port"], rid)) == want, rid
        assert [n for n, *_ in trace_shape(fetch_trace(bases["port"], "ev-2"))["spans"]] == [
            "group_commit_append"]
        for name, base in bases.items():
            assert request("GET", f"{base}/traces/ev-6.json")[0] == 404, name

        def index(base):
            doc = get_json(base + "/traces.json")
            rows = sorted((t["rid"], t["route"], t["status"], t["reason"], t["method"])
                          for t in doc["traces"])
            return rows if len(rows) == len(traced) else None
        assert poll(lambda: index(bases["port"])) == poll(lambda: index(bases["jax"]))
    finally:
        _stop(jsrv)
        _stop(psrv)


def test_tracing_off_answers_503_as_jax(tmp_path, monkeypatch, recorders):
    monkeypatch.setenv("PIO_TRACING", "off")
    jax_tracing.set_recorder(jax_tracing.FlightRecorder())
    port_tracing.set_recorder(port_tracing.FlightRecorder())
    jstore, pstore = localfs_pair(tmp_path)
    jsrv = jax_event_server(host="127.0.0.1", port=0, storage=jstore, background=True)
    psrv = port_event_server(host="127.0.0.1", port=0, storage=pstore, background=True)
    try:
        for path in ("/traces.json", "/traces/x.json"):
            want = request("GET", f"http://127.0.0.1:{jsrv.server_address[1]}{path}")
            got = request("GET", f"http://127.0.0.1:{psrv.server_address[1]}{path}")
            assert got == want and got[0] == 503, path
    finally:
        _stop(jsrv)
        _stop(psrv)


WATERFALL_DOC = {
    "rid": "wf-1", "start": 1.7e9, "durationMs": 12.5, "method": "POST",
    "route": "/queries.json", "status": 200, "worker": "w0-1", "reason": "debug",
    "spans": [
        {"id": 1, "parent": None, "name": "ur_predict", "start": 1.7e9 + 0.001,
         "duration_s": 0.0105, "end": 1.7e9 + 0.0115,
         "attrs": {"tail": "device", "candidates": "off", "history_ms": 0.5}},
        {"id": 2, "parent": 1, "name": "history", "start": 1.7e9 + 0.001,
         "duration_s": 0.0005, "end": 1.7e9 + 0.0015},
        {"id": 3, "parent": 1, "name": "topk", "start": 1.7e9 + 0.0015,
         "duration_s": 0.01, "end": 1.7e9 + 0.0115, "error": True},
        {"id": 4, "parent": None, "name": "group_commit_append", "start": 1.7e9,
         "duration_s": 0.0, "end": 1.7e9},
    ],
}


@pytest.mark.parametrize("width", [40, 12, 72])
def test_waterfall_text_is_byte_equal(width):
    want = jax_tracing.render_waterfall_text(WATERFALL_DOC, width=width)
    assert port_tracing.render_waterfall_text(WATERFALL_DOC, width=width) == want
    empty = dict(WATERFALL_DOC, spans=[])
    assert (port_tracing.render_waterfall_text(empty, width=width)
            == jax_tracing.render_waterfall_text(empty, width=width))


def test_tail_sampling_reasons_as_jax():
    for kw in ({"slow_ms": 10_000, "sample_n": 0}, {"slow_ms": 0.0, "sample_n": 0},
               {"slow_ms": 10_000, "sample_n": 1}):
        jrec = jax_tracing.FlightRecorder(enabled=True, **kw)
        prec = port_tracing.FlightRecorder(enabled=True, **kw)
        for status, debug in ((200, False), (500, False), (0, False), (200, True)):
            want = jrec.finish(jrec.begin("r", "GET", debug=debug), status, "/x")
            assert prec.finish(prec.begin("r", "GET", debug=debug), status, "/x") == want


def test_persisted_traces_merge_across_packages(tmp_path):
    """One traces directory: each package's recorder persists its ring
    under its own tag, and each lists and reads the other's."""
    d = tmp_path / "traces"
    jrec = jax_tracing.FlightRecorder(slow_ms=0, sample_n=0, directory=d, tag="w0-jax")
    prec = port_tracing.FlightRecorder(slow_ms=0, sample_n=0, directory=d, tag="w1-port")
    for rec, mod, rid in ((jrec, jax_tracing, "from-jax"), (prec, port_tracing, "from-port")):
        t = rec.begin(rid, "POST")
        with t.activate():
            with mod.trace_span("group_commit_append", lines=3):
                pass
        rec.finish(t, 201, "/events.json")
        rec.flush()
    for rec in (jrec, prec):
        rows = {(t["rid"], t["worker"]) for t in rec.index()["traces"]}
        assert rows == {("from-jax", "w0-jax"), ("from-port", "w1-port")}
    for rid in ("from-jax", "from-port"):
        assert prec.get(rid) == jrec.get(rid)
        assert span_tree(prec.get(rid)["spans"]) == [
            ("group_commit_append", None, {"lines": 3}, False)]


def test_ur_predict_span_equal_on_a_carried_model(tmp_path):
    """The same query on the same model: the ``ur_predict`` span's laps and
    attributes, under a journal (read back by the other package) and
    under a trace (laps as child spans), equal the JAX package's."""
    jax_model, port_model = make_models(n_items=120, k=6, seed=3)
    jalgo, palgo = algos()
    from predictionio_tpu.models.universal_recommender import engine as jax_ur
    from predictionio_tpu_torch.models import universal_recommender as port_ur

    bodies = [{"user": "u1", "num": 5}, {"item": "i7", "num": 4},
              {"itemSet": ["i1", "i2"], "num": 3, "fields": [
                  {"name": "category", "values": ["c1"], "bias": -1}]}]
    trees = {}
    for name, algo, model, spans_mod, tracing_mod, qcls in (
            ("jax", jalgo, jax_model, jax_spans, jax_tracing, jax_ur.URQuery),
            ("port", palgo, port_model, port_spans, port_tracing, port_ur.URQuery)):
        journal = spans_mod.SpanJournal(tmp_path / f"{name}.jsonl")
        with journal.activate():
            for b in bodies:
                algo.predict(model, qcls.from_json(b))
        rec = tracing_mod.FlightRecorder(slow_ms=0, sample_n=0)
        t = rec.begin(f"{name}-q", "POST")
        with t.activate():
            algo.predict(model, qcls.from_json(bodies[0]))
        rec.finish(t, 200, "/queries.json")
        trees[name] = (tmp_path / f"{name}.jsonl", span_tree(rec.get(f"{name}-q")["spans"]))
    for path in (trees["jax"][0], trees["port"][0]):
        assert (span_tree(port_spans.read_journal(path))
                == span_tree(jax_spans.read_journal(path)))
    jtree = span_tree(jax_spans.read_journal(trees["jax"][0]))
    ptree = span_tree(port_spans.read_journal(trees["port"][0]))
    assert ptree == jtree and [n for n, *_ in ptree] == ["ur_predict"] * len(bodies)
    assert {k for _, _, a, _ in ptree for k in a} >= {"tail", "candidates", "history_ms",
                                                      "score_ms", "topk_ms"}
    assert trees["port"][1] == trees["jax"][1]
    assert [(n, p) for n, p, *_ in trees["port"][1]][:2] == [("ur_predict", None),
                                                            ("history", "ur_predict")]


def test_no_span_object_without_a_journal_or_a_trace(monkeypatch):
    """The hot path builds no span when nothing listens."""
    _, port_model = make_models(n_items=60, k=4, seed=1)
    _, palgo = algos()
    from predictionio_tpu_torch.models import universal_recommender as port_ur

    built = []
    orig = port_spans.SpanCollector.span
    monkeypatch.setattr(port_spans.SpanCollector, "span",
                        lambda self, *a, **k: built.append(a) or orig(self, *a, **k))
    assert port_tracing.current_trace() is None and port_spans.current_journal() is None
    palgo.predict(port_model, port_ur.URQuery.from_json({"user": "u2", "num": 3}))
    assert built == []


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Each package's UR trained on the same events in its own localfs
    store (each store its package's process default for the test module)."""
    root = tmp_path_factory.mktemp("obs-ur")
    jstore, pstore = localfs_pair(root)
    fill_both(jstore, pstore, "obsapp", rule_corpus([]))
    path = root / "engine.json"
    path.write_text(json.dumps(UR_VARIANT))
    jax_set_storage(jstore)
    port_set_storage(pstore)
    try:
        _, jengine, jep = jax_variant(UR_VARIANT)
        jinst = jax_workflow.run_train(jengine, jep, UR_VARIANT["id"], storage=jstore)
        _, pengine, pep = port_variant(UR_VARIANT)
        pinst = port_workflow.run_train(pengine, pep, UR_VARIANT["id"], storage=pstore,
                                        device="cpu")
        yield {"jax": jstore, "port": pstore, "path": str(path),
               "jax_instance": jinst.id, "port_instance": pinst.id}
    finally:
        jax_set_storage(None)
        port_set_storage(None)


def test_train_journals_equal_and_read_by_either(trained):
    jpath = jax_spans.journal_path(trained["jax"], trained["jax_instance"])
    ppath = port_spans.journal_path(trained["port"], trained["port_instance"])
    assert jpath.exists() and ppath.exists()
    for path in (jpath, ppath):
        assert (span_tree(port_spans.read_journal(path))
                == span_tree(jax_spans.read_journal(path)))
    jtree = span_tree(jax_spans.read_journal(jpath))
    ptree = span_tree(port_spans.read_journal(ppath))
    top = [(n, p) for n, p, *_ in ptree if p in (None, "train")]
    assert top == [("train", None), ("engine_train", "train"), ("staging_summary", "train"),
                   ("save_models", "train")]
    # the instance id differs (each store mints its own); every other
    # attribute, the staged counts included, is equal
    strip = [(n, p, {k: v for k, v in a.items() if k != "instance_id"}, e)
             for n, p, a, e in ptree if p in (None, "train")]
    want = [(n, p, {k: v for k, v in a.items() if k != "instance_id"}, e)
            for n, p, a, e in jtree if p in (None, "train")]
    assert strip == want


def test_query_server_traces_equal_the_jax_servers(trained, recorders):
    jsrv = jax_server.deploy(trained["path"], host="127.0.0.1", port=0,
                             storage=trained["jax"], background=True)
    psrv = port_server.deploy(trained["path"], host="127.0.0.1", port=0,
                              storage=trained["port"], device="cpu")
    try:
        bases = {"jax": f"http://127.0.0.1:{jsrv.server_address[1]}",
                 "port": f"http://127.0.0.1:{psrv.server_address[1]}"}
        for name, base in bases.items():
            for i, q in enumerate(UR_QUERIES + UR_QUERIES[:1]):
                status, _ = request("POST", base + "/queries.json", q,
                                    headers={"X-Request-ID": f"q-{i}", **DEBUG})
                assert status == 200, (name, q)
            assert request("POST", base + "/queries.json", ["not", "a", "query"],
                           headers={"X-Request-ID": "q-bad", **DEBUG})[0] == 400
        for rid in [f"q-{i}" for i in range(len(UR_QUERIES) + 1)] + ["q-bad"]:
            want = trace_shape(fetch_trace(bases["jax"], rid))
            got = trace_shape(fetch_trace(bases["port"], rid))
            assert got == want, rid
        laps = [n for n, p, *_ in trace_shape(fetch_trace(bases["port"], "q-0"))["spans"]]
        assert laps[0] == "ur_predict" and {"history", "score", "topk", "assemble"} <= set(laps)
        # the repeated query answers from the response cache in both
        assert trace_shape(fetch_trace(bases["port"], f"q-{len(UR_QUERIES)}"))["spans"][0][2][
            "candidates"] == "cache"
    finally:
        _stop(jsrv)
        _stop(psrv)


def test_timed_nests_under_a_journal_and_a_trace(tmp_path):
    from predictionio_tpu.utils.tracing import timed as jax_timed

    trees = []
    for timed, spans_mod, tracing_mod, tag in (
            (jax_timed, jax_spans, jax_tracing, "jax"),
            (port_utils_tracing.timed, port_spans, port_tracing, "port")):
        sink = {}
        journal = spans_mod.SpanJournal(tmp_path / f"{tag}.jsonl")
        with journal.activate():
            with timed("outer", sink):
                with timed("inner", sink):
                    pass
        rec = tracing_mod.FlightRecorder(slow_ms=0, sample_n=0)
        t = rec.begin(tag, "GET")
        with t.activate():
            with timed("outer"):
                with timed("inner"):
                    pass
        assert sink["outer.count"] == sink["inner.count"] == 1
        trees.append((span_tree(spans_mod.read_journal(tmp_path / f"{tag}.jsonl")),
                      span_tree(t.spans())))
    assert trees[1] == trees[0]
    assert trees[1][0] == [("outer", None, {}, False), ("inner", "outer", {}, False)]
    with port_utils_tracing.timed("alone"):
        pass   # no journal, no trace: the log only


def test_profile_to_writes_a_chrome_trace_on_the_cpu(tmp_path):
    import torch

    from predictionio_tpu_torch.utils import named_scope, profile_to

    with profile_to(str(tmp_path / "prof")):
        with named_scope("pio_probe"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "prof").glob("trace-*.json"))
    assert len(files) == 1
    doc = json.loads(files[0].read_text())
    names = {e.get("name") for e in doc.get("traceEvents", [])}
    assert "pio_probe" in names, sorted(n for n in names if n)[:20]
    assert os.path.getsize(files[0]) > 0
