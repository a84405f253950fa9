"""The port's dashboard (``api/dashboard.py``) and its ``pio dashboard``,
``pio trace``, ``pio lineage`` and ``pio top`` against the JAX package's
(the parity targets are the JAX suite's
tests/test_build_template_dashboard.py and the CLI cases of
tests/test_tracing.py and tests/test_lineage.py).

One localfs store is written by both packages: the JAX package imports
the events and builds a snapshot, each package trains the UR (its own
engine instance and span journal) and records a completed evaluation with
its journal, and each package's flight recorder and lineage recorder
persist a trace and a record into the store's directories.  Over it:

- ``/dashboard.json`` and the other JSON routes of the two dashboards are
  equal;
- the HTML pages are byte-equal.  The timing fields (durations, start
  times) are read from the store, the journals and the persisted traces,
  so both dashboards print the same values and no field needs a mask;
- the four commands parse as the JAX console's, and print what the JAX
  console prints against a live port server.
"""

import datetime as dt
import json
import time

import pytest

from predictionio_tpu.api.dashboard import run_dashboard as jax_dashboard
from predictionio_tpu.cli import main as jax_cli
from predictionio_tpu.obs import lineage as jax_lineage
from predictionio_tpu.obs import spans as jax_spans
from predictionio_tpu.obs import tracing as jax_tracing
from predictionio_tpu.obs import tsdb as jax_tsdb
from predictionio_tpu.storage import EvaluationInstance as JaxEvaluationInstance
from predictionio_tpu.storage import set_storage as jax_set_storage
from predictionio_tpu.workflow import core_workflow as jax_workflow
from predictionio_tpu.workflow.create_workflow import engine_from_variant as jax_variant
from predictionio_tpu_torch.api.dashboard import run_dashboard as port_dashboard
from predictionio_tpu_torch.api.event_server import run_event_server as port_event_server
from predictionio_tpu_torch.cli import main as port_cli
from predictionio_tpu_torch.obs import lineage as port_lineage
from predictionio_tpu_torch.obs import spans as port_spans
from predictionio_tpu_torch.obs import tracing as port_tracing
from predictionio_tpu_torch.obs import tsdb as port_tsdb
from predictionio_tpu_torch.storage import EvaluationInstance as PortEvaluationInstance
from predictionio_tpu_torch.storage import set_storage as port_set_storage
from predictionio_tpu_torch.workflow import core_workflow as port_workflow
from predictionio_tpu_torch.workflow.create_workflow import engine_from_variant as port_variant

from _torch_event_cases import fill_jax, port_localfs_storage, rule_corpus
from _torch_obs_cases import (
    UR_VARIANT,
    jax_localfs_storage,
    lineages,  # noqa: F401  (fixture)
    poll,
    recorders,  # noqa: F401  (fixture)
    request,
)

T0 = dt.datetime(2026, 3, 1, 12, 0, 0, tzinfo=dt.timezone.utc)


def _evaluation(cls, n):
    return cls(id="", status="EVALCOMPLETED", start_time=T0 + dt.timedelta(minutes=n),
               end_time=T0 + dt.timedelta(minutes=n, seconds=3 + n),
               evaluation_class=f"probe.Evaluation{n}",
               evaluator_results=f"HitRate: best={0.25 * n:.6f}",
               evaluator_results_json=json.dumps({"best": 0.25 * n}),
               evaluator_results_html="")


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """One localfs store written by both packages (see the module
    docstring); {"jax": JAX Storage, "port": port Storage, "dir": path}."""
    root = tmp_path_factory.mktemp("dash")
    jstore = jax_localfs_storage(root / "store")
    pstore = port_localfs_storage(root / "store")
    fill_jax(jstore, "obsapp", rule_corpus([]))
    app = jstore.apps.get_by_name("obsapp")
    jstore.l_events.build_snapshot(app.id, None)
    jax_set_storage(jstore)
    port_set_storage(pstore)
    try:
        variant = dict(UR_VARIANT)
        _, jengine, jep = jax_variant(variant)
        jax_workflow.run_train(jengine, jep, "dash-jax", storage=jstore)
        _, pengine, pep = port_variant(variant)
        port_workflow.run_train(pengine, pep, "dash-port", storage=pstore, device="cpu")
        for n, (store, cls, spans_mod) in enumerate(
                ((jstore, JaxEvaluationInstance, jax_spans),
                 (pstore, PortEvaluationInstance, port_spans)), start=1):
            iid = store.evaluation_instances.insert(_evaluation(cls, n))
            journal = spans_mod.SpanJournal(spans_mod.journal_path(store, iid))
            with journal.activate(), journal.span("eval", instance_id=iid):
                with journal.span("metric", candidate=1):
                    time.sleep(0.001)
        for mod, tag in ((jax_tracing, "w0-jax"), (port_tracing, "w0-port")):
            rec = mod.FlightRecorder(slow_ms=0, sample_n=0, directory=root / "store" / "traces",
                                     tag=tag)
            t = rec.begin(f"rid-{tag}", "POST")
            with t.activate():
                with mod.trace_span("group_commit_append"):
                    pass
            rec.finish(t, 201, "/events.json")
            rec.flush()
        pub = jax_lineage.LineageRecorder(directory=root / "store" / "lineage", tag="pub-1",
                                          enabled=True)
        worker = port_lineage.LineageRecorder(directory=root / "store" / "lineage",
                                              tag="w1-1", enabled=True)
        lid = pub.new_id()
        pub.begin(lid, start=1.7e9)
        pub.stage(lid, "append_observed", start=1.7e9, duration_s=0.01)
        pub.stage(lid, "publish", start=1.7e9 + 0.1, duration_s=0.02)
        pub.note_generation(lid, 4)
        pub.close(lid, outcome="published")
        worker.stage(lid, "install", start=1.7e9 + 0.3, duration_s=0.01, flush=True)
        worker.stage(lid, "first_serve", start=1.7e9 + 0.4, duration_s=0.005, flush=True)
        yield {"jax": jstore, "port": pstore, "dir": root / "store", "lid": lid}
    finally:
        jax_set_storage(None)
        port_set_storage(None)


@pytest.fixture()
def dashboards(shared, recorders, lineages):
    """Both dashboards over the shared store, each recorder joining the
    store's traces and lineage directories."""
    jsrv = jax_dashboard(host="127.0.0.1", port=0, storage=shared["jax"], background=True)
    psrv = port_dashboard(host="127.0.0.1", port=0, storage=shared["port"], background=True)
    yield {n: f"http://127.0.0.1:{s.server_address[1]}" for n, s in
           (("jax", jsrv), ("port", psrv))}
    for srv in (jsrv, psrv):
        srv.shutdown()
        srv.server_close()


def test_dashboard_json_equal_over_one_store(shared, dashboards):
    want = request("GET", dashboards["jax"] + "/dashboard.json")
    got = request("GET", dashboards["port"] + "/dashboard.json")
    assert got == want and got[0] == 200
    engines = {e["engineId"]: e for e in got[1]["engineInstances"]}
    assert set(engines) == {"dash-jax", "dash-port"}
    assert {e["status"] for e in engines.values()} == {"COMPLETED"}
    assert sorted(e["evaluationClass"] for e in got[1]["evaluations"]) == [
        "probe.Evaluation1", "probe.Evaluation2"]


def _routes(shared):
    engines = shared["port"].engine_instances.get_all()
    evals = shared["port"].evaluation_instances.get_completed()
    return (["/engine_instances.json", "/evaluations.json", "/snapshots.json",
             "/traces.json", "/lineage.json", "/traces/rid-w0-jax.json",
             "/lineage/4.json", f"/lineage/{shared['lid']}.json", "/spans/nope.json",
             "/nope"]
            + [f"/spans/{i.id}.json" for i in engines + evals])


def test_json_routes_equal_over_one_store(shared, dashboards):
    for path in _routes(shared):
        want = request("GET", dashboards["jax"] + path)
        got = request("GET", dashboards["port"] + path)
        if path in ("/traces.json", "/lineage.json"):
            # "worker" names the answering process's own tag
            for doc in (want[1], got[1]):
                doc.pop("worker")
        assert got == want, path
    snaps = request("GET", dashboards["port"] + "/snapshots.json")[1]["snapshots"]
    assert len(snaps) == 1 and snaps[0]["coverage"] == 1.0


@pytest.mark.parametrize("path", ["/", "/traces/rid-w0-jax.html", "/traces/rid-w0-port.html",
                                  "/lineage/4.html", "/lineage/ln-none.html"])
def test_html_pages_byte_equal(shared, dashboards, path):
    want = request("GET", dashboards["jax"] + path, raw=True)
    got = request("GET", dashboards["port"] + path, raw=True)
    assert got == want
    if path == "/":
        page = got[1].decode()
        for text in ("dash-jax", "dash-port", "probe.Evaluation2", "engine_train",
                     "save_models", "rid-w0-port", "complete"):
            assert text in page, text


# -- the console ---------------------------------------------------------------------------


def _subparser(parser, name):
    action = next(a for a in parser._actions if a.__class__.__name__ == "_SubParsersAction")
    return action.choices[name]


def _options(parser):
    return sorted((tuple(a.option_strings), a.dest, a.default, a.nargs, a.type, a.help,
                   a.__class__.__name__) for a in parser._actions)


@pytest.mark.parametrize("command", ["dashboard", "trace", "lineage", "top"])
def test_console_parses_as_jax(command):
    want = _subparser(jax_cli.build_parser(), command)
    got = _subparser(port_cli.build_parser(), command)
    assert _options(got) == _options(want)
    argv = {"dashboard": ["dashboard", "--ip", "0.0.0.0", "--port", "9"],
            "trace": ["trace", "h:1", "--rid", "r", "--slow", "--timeout", "2"],
            "lineage": ["lineage", "h:1", "--gen", "3", "--cluster"],
            "top": ["top", "h:1", "--window", "10", "--cluster"]}[command]
    jargs = vars(jax_cli.build_parser().parse_args(argv))
    pargs = vars(port_cli.build_parser().parse_args(argv))
    assert {k: v for k, v in pargs.items() if k != "func"} == {
        k: v for k, v in jargs.items() if k != "func"}


def _history_samples(now, n):
    return [{"t": now - 5.0 * (n - i), "m": {
        "pio_http_requests_total": {"type": "counter",
                                    "series": {'route="/queries.json",status="200"': 10.0 * i}},
        "pio_follow_lag_events": {"type": "gauge", "series": {"": float(i % 3)}},
        "pio_process_rss_bytes": {"type": "gauge", "series": {'worker="w"': 1e8 + 1e6 * i}},
        "pio_slo_burn_rate": {"type": "gauge",
                              "series": {'slo="serve_p95",window="fast"': 0.1 * i}}}}
            for i in range(n)]


@pytest.fixture()
def port_server(shared, recorders, lineages):
    """A live port event server over the shared store, with two retained
    traces, the shared lineage record and a history ring of six samples."""
    sampler = port_tsdb.MetricsSampler(interval=3600.0)
    sampler._ring.extend(_history_samples(time.time(), 6))
    port_tsdb.set_sampler(sampler)
    srv = port_event_server(host="127.0.0.1", port=0, storage=shared["port"],
                            background=True)
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    for rid in ("cli-1", "cli-2"):
        assert request("GET", base + "/", headers={"X-Request-ID": rid,
                                                   "X-PIO-Debug": "1"})[0] == 200
    poll(lambda: len(request("GET", base + "/traces.json")[1]["traces"]) >= 4)
    yield base
    srv.shutdown()
    srv.server_close()
    port_tsdb.get_sampler().stop()
    port_tsdb.set_sampler(None)
    jax_tsdb.set_sampler(None)


@pytest.mark.parametrize("argv", [
    ["trace"], ["trace", "--rid", "cli-1"], ["trace", "--slow"], ["trace", "--rid", "gone"],
    ["lineage"], ["lineage", "--gen", "4"], ["lineage", "--gen", "4", "--cluster"],
    ["lineage", "--gen", "99"], ["top"], ["top", "--window", "3"], ["top", "--cluster"],
], ids=lambda a: "-".join(x.strip("-") for x in a))
def test_console_prints_as_jax_against_a_port_server(port_server, argv, capsys):
    host = port_server.replace("http://", "")
    full = [argv[0], host] + argv[1:]
    rc_want = jax_cli.main(full)
    want = capsys.readouterr()
    rc_got = port_cli.main(full)
    got = capsys.readouterr()
    assert (rc_got, got.out, got.err) == (rc_want, want.out, want.err)
    if argv in (["trace", "--rid", "cli-1"], ["lineage", "--gen", "4"], ["top"]):
        assert rc_got == 0 and got.out
