"""Evaluation dashboard (counterpart of ``predictionio_tpu/api/dashboard.py``;
reference: dashboard/ module — `pio dashboard`
serves a web UI on :9000 listing completed evaluation instances with their
engine params and metric scores).

  GET /                         HTML dashboard: evaluations + engine instances
  GET /dashboard.json           same data as JSON
  GET /engine_instances.json    all engine instances
  GET /evaluations.json         completed evaluation instances
  GET /spans/<instance>.json    span journal of one train/eval run
  GET /snapshots.json           per-(app, channel) event-store snapshot coverage
  GET /lineage.json             generation lineage index (cross-process merged)
  GET /lineage/<gen>.html       one generation's freshness waterfall
  GET /metrics                  Prometheus text (incl. pio_snapshot_* gauges)
  GET /stats.json               per-(route, status) request windows
"""

from __future__ import annotations

import datetime as _dt
import html
import logging
from typing import Optional

from predictionio_tpu_torch import __version__
from predictionio_tpu_torch.api.http_util import JsonHandler, start_server
from predictionio_tpu_torch.obs import lineage as obs_lineage
from predictionio_tpu_torch.obs import spans as obs_spans
from predictionio_tpu_torch.obs import tracing as obs_tracing
from predictionio_tpu_torch.obs.exposition import StatsCollector, metrics_payload
from predictionio_tpu_torch.storage.locator import Storage, get_storage

log = logging.getLogger("pio.dashboard")


def _ei_json(i) -> dict:
    return {
        "id": i.id,
        "status": i.status,
        "startTime": i.start_time.isoformat() if i.start_time else None,
        "endTime": i.end_time.isoformat() if i.end_time else None,
        "engineId": i.engine_id,
        "engineVersion": i.engine_version,
        "engineVariant": i.engine_variant,
        "engineFactory": i.engine_factory,
    }


def _evi_json(i) -> dict:
    return {
        "id": i.id,
        "status": i.status,
        "startTime": i.start_time.isoformat() if i.start_time else None,
        "endTime": i.end_time.isoformat() if i.end_time else None,
        "evaluationClass": i.evaluation_class,
        "evaluatorResults": i.evaluator_results,
        "evaluatorResultsJSON": i.evaluator_results_json,
    }


def _start_key(i):
    # instances may have a None start_time (inserted before train started)
    return i.start_time or _dt.datetime.min.replace(tzinfo=_dt.timezone.utc)


def _duration(i) -> str:
    """Rendered end−start, '' while running or when either end is unset."""
    if not i.start_time or not i.end_time:
        return ""
    secs = (i.end_time - i.start_time).total_seconds()
    if secs >= 120:
        return f"{secs / 60:.1f} min"
    return f"{secs:.2f} s"


# journals are read per rendered row; only the newest rows get one so a
# long instance history doesn't turn GET / into thousands of file reads
_MAX_SPAN_ROWS = 25


def _span_summary(storage: Storage, instance_id: str, limit: int = 8) -> str:
    """Escaped one-line-per-span digest of a run's journal for the HTML
    table ('' when no journal was recorded)."""
    spans = obs_spans.read_journal(obs_spans.journal_path(storage, instance_id))
    if not spans:
        return ""
    spans = sorted(spans, key=lambda s: s.get("duration_s", 0.0),
                   reverse=True)[:limit]
    return "<br>".join(
        html.escape(f"{s.get('name', '?')}: {s.get('duration_s', 0.0):.3f}s")
        for s in sorted(spans, key=lambda s: s.get("id", 0)))


def _snapshot_rows(storage: Storage) -> list:
    """Per-(app, channel) columnar-snapshot coverage, with the matching
    pio_snapshot_* gauges refreshed so /metrics mirrors what's rendered.
    Empty on backends without a snapshot layer."""
    backend = storage.l_events
    if not hasattr(backend, "snapshot_status"):
        return []
    from predictionio_tpu_torch.storage import snapshot as obs_snap

    rows = []
    for app in sorted(storage.apps.get_all(), key=lambda a: a.id):
        chans = [("", None)] + [
            (c.name, c.id) for c in storage.channels.get_by_app_id(app.id)]
        for chan_name, chan_id in chans:
            status = backend.snapshot_status(app.id, chan_id)
            if status is None:
                continue
            label = f"app_{app.id}/" + (
                f"channel_{chan_id}" if chan_id is not None else "_default")
            obs_snap.publish_status_gauges(status, label)
            rows.append({"app": app.name, "channel": chan_name or "(default)",
                         **status})
    return rows


def _fmt_epoch(ts) -> str:
    try:
        return _dt.datetime.fromtimestamp(
            float(ts), _dt.timezone.utc).isoformat(timespec="seconds")
    except (TypeError, ValueError, OSError):
        return ""


def _trace_rows(limit: int = 25) -> str:
    """Recent retained traces (cross-worker merged) for the front page,
    each linking to its waterfall."""
    entries = obs_tracing.get_recorder().index(limit=limit)["traces"]
    return "".join(
        '<tr><td><a href="/traces/{rid}.html">{rid}</a></td>'
        "<td>{meth} {route}</td><td>{status}</td><td>{dur:.1f} ms</td>"
        "<td>{reason}</td><td>{worker}</td><td>{start}</td></tr>".format(
            rid=html.escape(str(e.get("rid", ""))),
            meth=html.escape(str(e.get("method", ""))),
            route=html.escape(str(e.get("route", ""))),
            status=e.get("status", 0),
            dur=float(e.get("durationMs") or 0.0),
            reason=html.escape(str(e.get("reason", ""))),
            worker=html.escape(str(e.get("worker", ""))),
            start=html.escape(_fmt_epoch(e.get("start"))[:19]),
        )
        for e in entries
    ) or "<tr><td colspan=7><i>no retained traces</i></td></tr>"


def _lineage_rows(limit: int = 25) -> str:
    """Recent generation lineage records (cross-process merged) for the
    front page, each linking to its freshness waterfall."""
    entries = obs_lineage.get_lineage().index(limit=limit)["records"]
    return "".join(
        "<tr><td>{genlink}</td><td>{lid}</td><td>{outcome}</td>"
        "<td>{dur:.1f} ms</td><td>{stages}</td><td>{origin}</td>"
        "<td>{workers}</td><td>{start}</td></tr>".format(
            genlink=('<a href="/lineage/{g}.html">{g}</a>'.format(
                g=html.escape(str(e["generation"])))
                if e.get("generation") is not None else ""),
            lid=html.escape(str(e.get("lid", ""))),
            outcome=html.escape(str(e.get("outcome", ""))),
            dur=float(e.get("durationMs") or 0.0),
            stages=e.get("stageCount", 0),
            origin=html.escape(str(e.get("origin", ""))),
            workers=html.escape(",".join(e.get("workers") or [])),
            start=html.escape(_fmt_epoch(e.get("start"))[:19]),
        )
        for e in entries
    ) or "<tr><td colspan=8><i>no lineage records</i></td></tr>"


def _render_lineage_html(doc: dict) -> str:
    """Waterfall view of one generation's lineage: every pipeline stage
    (append→fold→publish→plane→install→first serve) as an offset bar,
    child stages (cache invalidation) indented under their parent.  A
    cluster-annotated record (replication publisher) renders one lane
    per subscriber node under the shared time axis, so a lagging node
    reads as a right-shifted lane."""
    total_ms = max(float(doc.get("durationMs") or 0.0), 1e-6)
    t0 = float(doc.get("start") or 0.0)
    cluster = doc.get("cluster") or {}
    nodes_doc = cluster.get("nodes") or {}

    def stage_row(s):
        off_ms = max((float(s.get("start", t0)) - t0) * 1e3, 0.0)
        dur_ms = float(s.get("duration_s", 0.0)) * 1e3
        left = min(off_ms / total_ms * 100.0, 100.0)
        width = max(min(dur_ms / total_ms * 100.0, 100.0 - left), 0.3)
        attrs = s.get("attrs") or {}
        attr_txt = " ".join(f"{k}={v}" for k, v in sorted(attrs.items()))
        return (
            "<tr><td style='padding-left:{ind}em'>{name}</td>"
            "<td>{worker}</td><td>{dur:.3f} ms</td>"
            "<td class=wf><div class=bar "
            "style='margin-left:{left:.2f}%;width:{width:.2f}%'></div></td>"
            "<td class=attrs>{attrs}</td></tr>".format(
                ind=1.5 if s.get("parent") else 0.5,
                name=html.escape(str(s.get("stage", "?"))),
                worker=html.escape(str(s.get("worker", ""))),
                dur=dur_ms, left=left, width=width,
                attrs=html.escape(attr_txt)))

    rows = []
    if nodes_doc:
        lanes = {None: []}
        for n in nodes_doc:
            lanes[n] = []
        for s in doc.get("stages", ()):
            key = s.get("node") if s.get("node") in nodes_doc else None
            lanes[key].append(s)
        rows.append("<tr class=lane><td colspan=5>publisher "
                    "(origin {0})</td></tr>".format(
                        html.escape(str(doc.get("origin", "?")))))
        rows.extend(stage_row(s) for s in lanes[None])
        for n in sorted(nodes_doc):
            nd = nodes_doc[n]
            rows.append(
                "<tr class=lane><td colspan=5>node {0} &mdash; "
                "{1}, {2} stage(s)</td></tr>".format(
                    html.escape(str(n)),
                    html.escape(str(nd.get("status", "?"))),
                    int(nd.get("stages", 0))))
            rows.extend(stage_row(s) for s in lanes[n])
    else:
        rows.extend(stage_row(s) for s in doc.get("stages", ()))
    cl_txt = ""
    if cluster:
        cl_txt = " &middot; cluster {0}/{1} node(s)".format(
            len(cluster.get("done") or ()),
            len(cluster.get("expected") or ()))
        if cluster.get("propagationMs") is not None:
            cl_txt += " &middot; propagation %.1f ms" \
                % float(cluster["propagationMs"])
    head = ("generation {gen} &middot; {outcome} in {dur:.1f} ms "
            "(origin {origin}, workers {workers}){cl}".format(
                gen=html.escape(str(doc.get("generation", "?"))),
                outcome=html.escape(str(doc.get("outcome", "?"))),
                dur=total_ms,
                origin=html.escape(str(doc.get("origin", "?"))),
                workers=html.escape(
                    ",".join(doc.get("workers") or []) or "?"),
                cl=cl_txt))
    lid = html.escape(str(doc.get("lid", "")))
    return f"""<!DOCTYPE html>
<html><head><title>lineage {lid}</title>
<style>
 body {{ font-family: sans-serif; margin: 2em; }}
 table {{ border-collapse: collapse; width: 100%; }}
 th, td {{ border: 1px solid #ccc; padding: 4px 8px; text-align: left; }}
 td.wf {{ width: 40%; position: relative; }}
 td.attrs {{ color: #666; font-size: 85%; }}
 div.bar {{ background: #57a35a; height: 0.9em; border-radius: 2px; }}
 tr.lane td {{ background: #eef2f5; font-weight: bold; }}
</style></head>
<body><h1>Lineage {lid}</h1>
<p>{head}</p>
<table><tr><th>stage</th><th>worker</th><th>duration</th><th>waterfall</th>
<th>attrs</th></tr>
{''.join(rows) or '<tr><td colspan=5><i>no stages recorded</i></td></tr>'}
</table>
<p><a href="/lineage.json">lineage index</a>
&middot; <a href="/">dashboard</a></p>
</body></html>"""


def _render_waterfall_html(doc: dict) -> str:
    """Waterfall view of one trace: every span as an offset bar over the
    request's duration, indented by parent depth."""
    total_ms = max(float(doc.get("durationMs") or 0.0), 1e-6)
    t0 = float(doc.get("start") or 0.0)
    spans = sorted(doc.get("spans", ()), key=lambda s: s.get("id", 0))
    depth = {None: -1}
    rows = []
    for s in spans:
        depth[s.get("id")] = depth.get(s.get("parent"), -1) + 1
        off_ms = max((float(s.get("start", t0)) - t0) * 1e3, 0.0)
        dur_ms = float(s.get("duration_s", 0.0)) * 1e3
        left = min(off_ms / total_ms * 100.0, 100.0)
        width = max(min(dur_ms / total_ms * 100.0, 100.0 - left), 0.3)
        attrs = s.get("attrs") or {}
        attr_txt = " ".join(f"{k}={v}" for k, v in sorted(attrs.items()))
        rows.append(
            "<tr><td style='padding-left:{ind}em'>{name}{err}</td>"
            "<td>{dur:.3f} ms</td>"
            "<td class=wf><div class=bar "
            "style='margin-left:{left:.2f}%;width:{width:.2f}%'></div></td>"
            "<td class=attrs>{attrs}</td></tr>".format(
                ind=depth[s.get("id")] + 0.5,
                name=html.escape(str(s.get("name", "?"))),
                err=" &#9888;" if s.get("error") else "",
                dur=dur_ms, left=left, width=width,
                attrs=html.escape(attr_txt)))
    head = (f"{html.escape(str(doc.get('method', '')))} "
            f"{html.escape(str(doc.get('route', '')))} &rarr; "
            f"{doc.get('status', 0)} in {total_ms:.1f} ms "
            f"(worker {html.escape(str(doc.get('worker', '')))}, "
            f"kept: {html.escape(str(doc.get('reason', '')))})")
    return f"""<!DOCTYPE html>
<html><head><title>trace {html.escape(str(doc.get('rid', '')))}</title>
<style>
 body {{ font-family: sans-serif; margin: 2em; }}
 table {{ border-collapse: collapse; width: 100%; }}
 th, td {{ border: 1px solid #ccc; padding: 4px 8px; text-align: left; }}
 td.wf {{ width: 45%; position: relative; }}
 td.attrs {{ color: #666; font-size: 85%; }}
 div.bar {{ background: #4a90d9; height: 0.9em; border-radius: 2px; }}
</style></head>
<body><h1>Trace {html.escape(str(doc.get('rid', '')))}</h1>
<p>{head}</p>
<table><tr><th>span</th><th>duration</th><th>waterfall</th><th>attrs</th></tr>
{''.join(rows) or '<tr><td colspan=4><i>no spans recorded</i></td></tr>'}
</table>
<p><a href="/traces/{html.escape(str(doc.get('rid', '')))}.json">raw JSON</a>
&middot; <a href="/">dashboard</a></p>
</body></html>"""


def _render_html(storage: Storage) -> str:
    evals = storage.evaluation_instances.get_completed()
    engines = sorted(storage.engine_instances.get_all(),
                     key=_start_key, reverse=True)
    rows_eval = "".join(
        "<tr><td>{id}</td><td>{cls}</td><td>{start}</td><td>{dur}</td>"
        "<td>{spans}</td><td>{res}</td></tr>".format(
            id=html.escape(i.id[:12]),
            cls=html.escape(i.evaluation_class),
            start=html.escape(i.start_time.isoformat(timespec="seconds") if i.start_time else ""),
            dur=html.escape(_duration(i)),
            spans=(_span_summary(storage, i.id)
                   if k < _MAX_SPAN_ROWS else ""),
            # evaluator_results_html is framework-generated markup
            # (core_workflow._eval_results_html), not user input
            res=i.evaluator_results_html
            or "<pre>" + html.escape((i.evaluator_results or "")[:2000]) + "</pre>",
        )
        for k, i in enumerate(sorted(evals, key=_start_key, reverse=True))
    ) or "<tr><td colspan=6><i>no completed evaluations</i></td></tr>"
    rows_engine = "".join(
        "<tr><td>{id}</td><td>{eng}</td><td>{status}</td><td>{start}</td>"
        "<td>{dur}</td><td>{spans}</td></tr>".format(
            id=html.escape(i.id[:12]),
            eng=html.escape(f"{i.engine_id} v{i.engine_version} ({i.engine_variant})"),
            status=html.escape(i.status),
            start=html.escape(i.start_time.isoformat(timespec="seconds") if i.start_time else ""),
            dur=html.escape(_duration(i)),
            spans=(_span_summary(storage, i.id)
                   if k < _MAX_SPAN_ROWS else ""),
        )
        for k, i in enumerate(engines)
    ) or "<tr><td colspan=6><i>no engine instances</i></td></tr>"
    rows_snap = "".join(
        "<tr><td>{app}</td><td>{chan}</td><td>{ev}</td><td>{tail}</td>"
        "<td>{cov:.1%}</td><td>{built}</td><td>{dur}</td></tr>".format(
            app=html.escape(r["app"]), chan=html.escape(r["channel"]),
            ev=r["events"], tail=r["tailEvents"], cov=r["coverage"],
            built=html.escape((r.get("builtAt") or "")[:19]),
            dur=(f"{r['buildSeconds']:.3f} s"
                 if r.get("buildSeconds") is not None else ""),
        )
        for r in _snapshot_rows(storage)
    ) or "<tr><td colspan=7><i>no columnar snapshots</i></td></tr>"
    return f"""<!DOCTYPE html>
<html><head><title>PredictionIO-TPU Dashboard</title>
<style>
 body {{ font-family: sans-serif; margin: 2em; }}
 table {{ border-collapse: collapse; width: 100%; margin-bottom: 2em; }}
 th, td {{ border: 1px solid #ccc; padding: 6px 10px; text-align: left;
           vertical-align: top; }}
 th {{ background: #f0f0f0; }}
 pre {{ margin: 0; white-space: pre-wrap; }}
</style></head>
<body>
<h1>PredictionIO-TPU Dashboard <small>v{html.escape(__version__)}</small></h1>
<h2>Completed evaluations</h2>
<table><tr><th>id</th><th>evaluation</th><th>started</th><th>duration</th>
<th>spans</th><th>results</th></tr>
{rows_eval}</table>
<h2>Engine instances</h2>
<table><tr><th>id</th><th>engine</th><th>status</th><th>started</th>
<th>duration</th><th>train spans</th></tr>
{rows_engine}</table>
<h2>Event-store snapshots</h2>
<table><tr><th>app</th><th>channel</th><th>events in snapshot</th>
<th>events in tail</th><th>coverage</th><th>built</th>
<th>build time</th></tr>
{rows_snap}</table>
<h2>Recent traces <small>(flight recorder)</small></h2>
<table><tr><th>request id</th><th>route</th><th>status</th><th>duration</th>
<th>kept</th><th>worker</th><th>started</th></tr>
{_trace_rows()}</table>
<h2>Generation lineage <small>(append &rarr; servable)</small></h2>
<table><tr><th>generation</th><th>lineage id</th><th>outcome</th>
<th>duration</th><th>stages</th><th>origin</th><th>workers</th>
<th>started</th></tr>
{_lineage_rows()}</table>
<p><a href="/metrics">/metrics</a> &middot;
<a href="/stats.json">/stats.json</a> &middot;
<a href="/snapshots.json">/snapshots.json</a> &middot;
<a href="/traces.json">/traces.json</a> &middot;
<a href="/lineage.json">/lineage.json</a></p>
</body></html>"""


def make_handler(storage: Storage):
    class DashboardHandler(JsonHandler):
        stats_collector = StatsCollector()

        def do_GET(self):
            path, _ = self.route
            if path == "/":
                self.send_html(_render_html(storage))
            elif path == "/dashboard.json":
                self.send_json({
                    "evaluations": [_evi_json(i) for i in
                                    storage.evaluation_instances.get_completed()],
                    "engineInstances": [_ei_json(i) for i in
                                        storage.engine_instances.get_all()],
                })
            elif path == "/engine_instances.json":
                self.send_json({"engineInstances": [
                    _ei_json(i) for i in storage.engine_instances.get_all()
                ]})
            elif path == "/evaluations.json":
                self.send_json({"evaluations": [
                    _evi_json(i) for i in storage.evaluation_instances.get_completed()
                ]})
            elif path == "/snapshots.json":
                # also refreshes the pio_snapshot_* gauges this process
                # exports, so scraping /metrics right after sees the
                # same coverage the JSON reports
                self.send_json({"snapshots": _snapshot_rows(storage)})
            elif obs_tracing.handle_trace_request(self, path):
                pass   # /traces.json + /traces/{rid}.json
            elif obs_lineage.handle_lineage_request(self, path):
                pass   # /lineage.json + /lineage/{gen|ln-id}.json
            elif path.startswith("/lineage/") and path.endswith(".html"):
                token = path[len("/lineage/"):-len(".html")]
                rec = obs_lineage.get_lineage()
                doc = (rec.get_generation(int(token)) if token.isdigit()
                       else rec.get(token))
                if doc is None:
                    self.send_error_json(
                        404, f"no lineage record for {token!r}")
                else:
                    self.send_html(_render_lineage_html(doc))
            elif path.startswith("/traces/") and path.endswith(".html"):
                rid = path[len("/traces/"):-len(".html")]
                doc = obs_tracing.get_recorder().get(rid)
                if doc is None:
                    self.send_error_json(
                        404, f"no retained trace for request id {rid!r}")
                else:
                    self.send_html(_render_waterfall_html(doc))
            elif path.startswith("/spans/") and path.endswith(".json"):
                instance_id = path[len("/spans/"):-len(".json")]
                spans = obs_spans.read_journal(
                    obs_spans.journal_path(storage, instance_id))
                if not spans:
                    self.send_error_json(
                        404, f"no span journal for {instance_id!r}")
                else:
                    self.send_json({"instanceId": instance_id,
                                    "spans": spans})
            elif path == "/metrics":
                self._send_raw(200, metrics_payload(),
                               ctype="text/plain; version=0.0.4; "
                                     "charset=utf-8")
            elif path == "/stats.json":
                self.send_json(self.stats_collector.to_json())
            else:
                self.send_error_json(404, "not found")

    return DashboardHandler


def run_dashboard(
    host: str = "127.0.0.1",
    port: int = 9000,
    storage: Optional[Storage] = None,
    background: bool = False,
):
    storage = storage or get_storage()
    # join the deployment's traces + lineage dirs so the tables can show
    # records retained by the event/query servers sharing this storage
    obs_tracing.arm(storage=storage)
    obs_lineage.arm(storage=storage)
    httpd = start_server(make_handler(storage), host, port, background=background)
    log.info("Dashboard listening on %s:%d", host, httpd.server_address[1])
    if background:
        return httpd
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    return 0
