"""`pio` command-line console of the port.

    python -m predictionio_tpu_torch.cli.main <command> ...

Counterpart of ``predictionio_tpu/cli/main.py`` (reference:
tools/.../console/Console.scala and bin/pio):

  app new|list|show|delete|data-delete|compact   applications, log compaction
  accesskey new|list|delete                      access keys
  channel new|delete                             channels
  snapshot <app> [--channel] [--status]          columnar snapshot of the event log
  import / export                                JSON-lines event files
  template list|new                              built-in template gallery / scaffolding
  build                                          check engine.json, register its manifest
  train / deploy / undeploy / eval               the DASE workflow (train --follow and
                                                 deploy --follow: the follow-trainer;
                                                 deploy --plane-publish / --plane-from:
                                                 model-plane replication)
  plane-subscribe --from HOST:PORT --plane-dir D  a standalone replication subscriber
  eventserver / adminserver                      REST ingestion / admin API
  metrics <url>                                  pretty-print a server's /metrics
  dashboard [--ip] [--port]                      evaluations, trains and their spans (HTML)
  trace <url> [--rid|--slow]                     a server's flight recorder / a waterfall
  lineage <url> [--gen|--lid] [--cluster]        generation lineage / a freshness waterfall
  top <url> [--window] [--cluster]               sparklines of the metrics history ring
  status / version

The device is the counterpart of the JAX package's ``PIO_JAX_PLATFORM``:
``PIO_TORCH_DEVICE=cpu|cuda`` (default ``cuda``), read here once and
handed to ``train`` and ``deploy`` as their ``device``; ``cuda`` without a
card raises, and nothing falls back to the CPU.  Every subcommand of the
JAX console exists here.
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import socket
import sys
import time
import urllib.error
import urllib.request
from typing import List, Optional

from predictionio_tpu_torch import __version__
from predictionio_tpu_torch.storage import AccessKey, App, Channel, get_storage


def _error(message: str) -> int:
    print(f"Error: {message}", file=sys.stderr)
    return 1


def _cmd_version(args) -> int:
    print(__version__)
    return 0


def _cmd_status(args) -> int:
    import torch

    st = get_storage()
    print("PredictionIO (PyTorch port) status:")
    print(f"  version: {__version__}")
    for repo, source in st.config.repositories.items():
        spec = st.config.sources[source]
        print(f"  {repo.lower()}: source={source} type={spec.get('type')} "
              f"path={spec.get('path', '-')}")
    try:
        print(f"  apps: {len(st.apps.get_all())}")
    except Exception as e:
        print(f"  storage ERROR: {e}")
        return 1
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}")
    if torch.cuda.is_available():
        print(f"  cuda devices: {torch.cuda.device_count()} "
              f"({torch.cuda.get_device_name(0)})")
    else:
        print("  cuda devices: none")
    print(f"  PIO_TORCH_DEVICE={args.device}")
    print("(sanity check: all storage repositories reachable)")
    return 0


def _resolve_app(st, name: str):
    app = st.apps.get_by_name(name)
    if app is None:
        print(f"Error: app {name!r} does not exist.", file=sys.stderr)
    return app


def _resolve_channel(st, app, channel_name: Optional[str]):
    """None → the default channel; an unknown name → (None, False), the
    error printed."""
    if not channel_name:
        return None, True
    chan = next((c for c in st.channels.get_by_app_id(app.id) if c.name == channel_name), None)
    if chan is None:
        print(f"Error: channel {channel_name!r} does not exist.", file=sys.stderr)
        return None, False
    return chan.id, True


def _cmd_app(args) -> int:
    st = get_storage()
    if args.app_command == "new":
        app_id = st.apps.insert(App(args.id or 0, args.name, args.description or ""))
        if app_id is None:
            return _error(f"app {args.name!r} already exists.")
        st.l_events.init(app_id)
        key = st.access_keys.insert(AccessKey("", app_id, []))
        print(f"Created app {args.name!r} with id {app_id}.")
        print(f"Access key: {key}")
        return 0
    if args.app_command == "list":
        for a in sorted(st.apps.get_all(), key=lambda a: a.id):
            print(f"  {a.id}  {a.name}  {a.description}")
        return 0
    app = _resolve_app(st, args.name)
    if app is None:
        return 1
    if args.app_command == "show":
        print(f"  id: {app.id}\n  name: {app.name}\n  description: {app.description}")
        for k in st.access_keys.get_by_app_id(app.id):
            events = ",".join(k.events) if k.events else "(all)"
            print(f"  access key: {k.key}  events: {events}")
        for c in st.channels.get_by_app_id(app.id):
            print(f"  channel: {c.id} {c.name}")
        return 0
    if args.app_command == "delete":
        for k in st.access_keys.get_by_app_id(app.id):
            st.access_keys.delete(k.key)
        for c in st.channels.get_by_app_id(app.id):
            st.l_events.remove(app.id, c.id)
            st.channels.delete(c.id)
        st.l_events.remove(app.id)
        st.apps.delete(app.id)
        print(f"Deleted app {args.name!r}.")
        return 0
    if args.app_command == "data-delete":
        st.l_events.remove(app.id)
        st.l_events.init(app.id)
        print(f"Deleted all events of app {args.name!r}.")
        return 0
    if args.app_command == "compact":
        channel_id, ok = _resolve_channel(st, app, args.channel)
        if not ok:
            return 1
        before = None
        if args.before:
            from predictionio_tpu_torch.events.event import parse_time

            try:
                before = parse_time(args.before)
            except (ValueError, TypeError) as e:
                return _error(f"invalid --before date: {e}")
        stats = st.l_events.compact(app.id, channel_id, before=before)
        print(f"Compacted app {args.name!r}: kept {stats['kept']} events, "
              f"expired {stats['expired']}, {stats['segments']} segment(s).")
        return 0
    raise AssertionError(args.app_command)


def _cmd_accesskey(args) -> int:
    st = get_storage()
    if args.ak_command == "delete":
        ok = st.access_keys.delete(args.key)
        print("Deleted." if ok else "Error: key not found.")
        return 0 if ok else 1
    app = _resolve_app(st, args.app_name)
    if app is None:
        return 1
    if args.ak_command == "new":
        key = st.access_keys.insert(AccessKey("", app.id, args.events or []))
        print(f"Created access key: {key}")
        return 0
    if args.ak_command == "list":
        for k in st.access_keys.get_by_app_id(app.id):
            events = ",".join(k.events) if k.events else "(all)"
            print(f"  {k.key}  events: {events}")
        return 0
    raise AssertionError(args.ak_command)


def _cmd_channel(args) -> int:
    st = get_storage()
    app = _resolve_app(st, args.app_name)
    if app is None:
        return 1
    if args.ch_command == "new":
        cid = st.channels.insert(Channel(0, args.name, app.id))
        if cid is None:
            return _error(f"channel {args.name!r} already exists.")
        st.l_events.init(app.id, cid)
        print(f"Created channel {args.name!r} with id {cid}.")
        return 0
    if args.ch_command == "delete":
        channel_id, ok = _resolve_channel(st, app, args.name)
        if not ok:
            return 1
        st.l_events.remove(app.id, channel_id)
        st.channels.delete(channel_id)
        print(f"Deleted channel {args.name!r}.")
        return 0
    raise AssertionError(args.ch_command)


def _app_from_args(st, args):
    app = st.apps.get(args.appid) if args.appid else _resolve_app(st, args.app_name)
    if app is None:
        print("Error: app not found.", file=sys.stderr)
    return app


def _cmd_import(args) -> int:
    """Bulk-load a JSON-lines event file (reference: tools Import) through
    ``insert_json_batch`` in chunks of 10,000 lines.  A bad line stops the
    import with its line number; earlier chunks (and, for a validation
    error, the valid lines of its chunk) stay committed: re-run after
    ``pio app data-delete`` for a clean slate."""
    st = get_storage()
    app = _app_from_args(st, args)
    if app is None:
        return 1
    channel_id, ok = _resolve_channel(st, app, args.channel)
    if not ok:
        return 1
    count = 0
    batch = []          # [(line number, wire dict)]

    def flush() -> bool:
        nonlocal count
        results = st.l_events.insert_json_batch([d for _, d in batch], app.id, channel_id)
        for (lineno, _), r in zip(batch, results):
            if r.get("status") != 201:
                print(f"Error: line {lineno}: {r.get('message')}", file=sys.stderr)
                return False
        count += len(batch)
        return True

    with open(args.input) as f:
        for lineno, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                batch.append((lineno, json.loads(line)))
            except json.JSONDecodeError as e:
                return _error(f"line {lineno}: invalid JSON: {e}")
            if len(batch) >= 10000:
                if not flush():
                    return 1
                batch = []
    if batch and not flush():
        return 1
    where = f"app {app.id}" + (f" channel {args.channel}" if args.channel else "")
    print(f"Imported {count} events to {where}.")
    return 0


def _cmd_export(args) -> int:
    st = get_storage()
    app = _app_from_args(st, args)
    if app is None:
        return 1
    channel_id, ok = _resolve_channel(st, app, args.channel)
    if not ok:
        return 1
    count = 0
    with open(args.output, "w") as f:
        for e in st.p_events.find(app.id, channel_id=channel_id):
            f.write(e.to_json_line() + "\n")
            count += 1
    print(f"Exported {count} events from app {app.id} to {args.output}.")
    return 0


def _cmd_build(args) -> int:
    from predictionio_tpu_torch.workflow.create_workflow import run_build_from_args

    return run_build_from_args(args)


def _cmd_train(args) -> int:
    from predictionio_tpu_torch.workflow.create_workflow import run_train_from_args

    return run_train_from_args(args)


def _cmd_eval(args) -> int:
    from predictionio_tpu_torch.workflow.create_workflow import run_eval_from_args

    return run_eval_from_args(args)


def _cmd_template(args) -> int:
    from predictionio_tpu_torch.cli import templates

    if args.template_command == "list":
        for name, desc in templates.list_templates().items():
            print(f"  {name:24s} {desc}")
        return 0
    try:
        dest = templates.scaffold(args.template, args.directory)
    except (ValueError, FileExistsError) as e:
        return _error(str(e))
    print(f"Created {args.template} engine in {dest}/ (engine.json, README.md).")
    return 0


def _cmd_deploy(args) -> int:
    from predictionio_tpu_torch.workflow.create_server import run_server_from_args

    return run_server_from_args(args)


def _cmd_plane_subscribe(args) -> int:
    """A standalone replication subscriber: mirror the publisher's plane
    into ``--plane-dir`` until interrupted.  The node's servers watch that
    directory (``PIO_MODEL_PLANE_DIR``) as they would a local publisher's."""
    from predictionio_tpu_torch.streaming.replicate import PlaneSubscriber

    try:
        sub = PlaneSubscriber(args.plane_dir, args.source, node=args.node)
        sub.start()
    except (RuntimeError, ValueError) as e:
        return _error(str(e))
    print(f"plane-subscribe: mirroring {args.source} into {args.plane_dir} "
          f"(node {sub.node})", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        sub.stop()
    return 0


def _cmd_eventserver(args) -> int:
    from predictionio_tpu_torch.api.event_server import run_event_server

    try:
        return run_event_server(host=args.ip, port=args.port, workers=args.workers,
                                reuse_port=args.reuse_port)
    except Exception as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1


def _cmd_adminserver(args) -> int:
    from predictionio_tpu_torch.api.admin import run_admin_server

    return run_admin_server(host=args.ip, port=args.port)


def _cmd_metrics(args) -> int:
    """``pio metrics <url>``: scrape a server's /metrics and pretty-print
    it (counters and gauges per series, histograms as count/sum/avg with
    bucket-interpolated p50/p95/p99).  Any pio server works; one worker of
    a prefork group reports the whole group."""
    from predictionio_tpu_torch.obs.exposition import summarize_prometheus

    url = args.url if "://" in args.url else f"http://{args.url}"
    if not url.endswith("/metrics"):
        url = url.rstrip("/") + "/metrics"
    try:
        with urllib.request.urlopen(url, timeout=args.timeout) as resp:
            text = resp.read().decode("utf-8", "replace")
    except (urllib.error.URLError, OSError) as e:
        print(f"Error: cannot scrape {url}: {e}", file=sys.stderr)
        return 1
    sys.stdout.write(text if args.raw else summarize_prometheus(text))
    return 0


def _port_state(ip: str, port: int, timeout: float) -> str:
    """'live' when something accepts a TCP connection on the port, or
    resets it (a listener closing under the handshake: probe again),
    'dead' when it is refused, 'unknown' otherwise (filtered)."""
    try:
        with socket.create_connection((ip, port), timeout=timeout):
            return "live"
    except ConnectionResetError:
        return "live"
    except ConnectionRefusedError:
        return "dead"
    except OSError:
        return "unknown"


#: seconds a stopped listener gets to close before ``pio undeploy`` takes
#: the port's next answer for another worker of a prefork group
_UNDEPLOY_SETTLE_S = 1.0


def _cmd_undeploy(args) -> int:
    """Stop a deployed query server (or event server) through its
    ``/stop`` (reference Console.undeploy contacts the server rather than
    killing a pid), then wait until its port refuses connections.

    With ``--workers N`` several processes share the port and the kernel
    routes each /stop to ONE of them (the parent stops its children when
    it stops), so while the port still answers after a listener had time
    to close, it stops again, up to 34 times."""
    url = f"http://{args.ip}:{args.port}/stop"
    deadline = time.monotonic() + args.timeout
    for attempt in range(34):   # far above any sane --workers count
        try:
            with urllib.request.urlopen(url, timeout=args.timeout) as resp:
                resp.read()
        except urllib.error.HTTPError as e:
            print(f"Server at {args.ip}:{args.port} rejected /stop (HTTP {e.code}) "
                  "— is this a query server?")
            return 1
        except urllib.error.URLError as e:
            if attempt == 0:
                print(f"No deployment reachable at {args.ip}:{args.port}: {e.reason}")
                return 1
            # a later /stop met the group closing: the probe below decides
        except (ConnectionError, TimeoutError, OSError, http.client.HTTPException):
            pass   # the server may close mid-answer to its own /stop
        settle = time.monotonic() + _UNDEPLOY_SETTLE_S
        while True:
            state = _port_state(args.ip, args.port, args.timeout)
            if state == "dead":
                print(f"Undeployed {args.ip}:{args.port}.")
                return 0
            if state == "unknown":
                print(f"Could not verify that {args.ip}:{args.port} stopped "
                      "(the port is unreachable)")
                return 1
            now = time.monotonic()
            if now >= settle:
                break   # another worker of the group answers: stop it too
            if now >= deadline:
                print(f"Could not verify that {args.ip}:{args.port} stopped (within "
                      f"--timeout {args.timeout:g}s)")
                return 1
            time.sleep(0.1)
        deadline = time.monotonic() + args.timeout
    print(f"Could not verify that {args.ip}:{args.port} stopped (after 34 stops)")
    return 1


def _cmd_snapshot(args) -> int:
    """``pio snapshot <app>``: fold the event log into a columnar snapshot,
    so a cold ``pio train`` maps columns instead of parsing every line;
    ``--status`` reports the coverage without building.  Safe beside live
    appends: only the lines complete at build time are covered, and the
    tail is parsed at train time."""
    st = get_storage()
    app = _resolve_app(st, args.name)
    if app is None:
        return 1
    channel_id, ok = _resolve_channel(st, app, args.channel)
    if not ok:
        return 1
    backend = st.l_events
    if not hasattr(backend, "build_snapshot"):
        return _error("this event backend does not support columnar snapshots "
                      "(localfs only).")
    where = f"app {args.name!r}" + (f" channel {args.channel!r}" if args.channel else "")
    if args.status:
        status = backend.snapshot_status(app.id, channel_id)
        if status is None:
            print(f"No snapshot for {where}.")
            return 0
        print(f"Snapshot status for {where}:")
        print(f"  file: {status['snapshot']}  (built {status['builtAt']}, "
              f"{status['buildSeconds']:.3f}s, writer {status['writer']})")
        print(f"  events: {status['events']} in snapshot, {status['tailEvents']} in JSONL "
              f"tail ({status['tailBytes']} bytes)")
        print(f"  coverage: {status['coverage']:.4f} over {status['segmentsCovered']} "
              "segment(s)")
        return 0
    try:
        stats = backend.build_snapshot(app.id, channel_id)
    except RuntimeError as e:
        return _error(str(e))
    print(f"Built snapshot for {where}: {stats['events']} events from {stats['segments']} "
          f"segment(s) in {stats['build_s']:.3f}s ({stats['snapshot']}).")
    return 0


def _cmd_dashboard(args) -> int:
    from predictionio_tpu_torch.api.dashboard import run_dashboard

    return run_dashboard(host=args.ip, port=args.port)


def _cmd_trace(args) -> int:
    """`pio trace <url>` — browse a server's flight recorder: the
    retained-trace index by default, one request's full waterfall with
    `--rid`, or the slowest retained request's waterfall with `--slow`.
    Any pio server works; one worker of a prefork group answers for the
    whole group (cross-worker merge)."""
    import urllib.error
    import urllib.request

    from predictionio_tpu_torch.obs.tracing import render_waterfall_text

    base = args.url
    if "://" not in base:
        base = f"http://{base}"
    base = base.rstrip("/")
    for suffix in ("/traces.json", "/traces"):
        if base.endswith(suffix):
            base = base[: -len(suffix)]

    def fetch(path):
        with urllib.request.urlopen(base + path, timeout=args.timeout) as r:
            return json.loads(r.read().decode("utf-8", "replace"))

    try:
        if args.rid:
            doc = fetch(f"/traces/{args.rid}.json")
            sys.stdout.write(render_waterfall_text(doc))
            return 0
        index = fetch("/traces.json")
        traces = index.get("traces", [])
        if args.slow:
            if not traces:
                print("No retained traces (nothing slow/errored/sampled "
                      "yet — send a request with an X-PIO-Debug header to "
                      "force one).", file=sys.stderr)
                return 1
            slowest = max(traces,
                          key=lambda t: float(t.get("durationMs") or 0.0))
            doc = fetch(f"/traces/{slowest['rid']}.json")
            sys.stdout.write(render_waterfall_text(doc))
            return 0
        print(f"{len(traces)} retained trace(s) "
              f"(answered by worker {index.get('worker', '?')}):")
        for t in traces:
            print("  %-28s %7.1f ms  %s %-24s %s  kept=%s worker=%s"
                  % (t.get("rid", "?"), float(t.get("durationMs") or 0.0),
                     t.get("method", ""), t.get("route", ""),
                     t.get("status", 0), t.get("reason", "?"),
                     t.get("worker", "?")))
        if traces:
            print(f"(pio trace {args.url} --rid <id> renders a waterfall)")
        return 0
    except urllib.error.HTTPError as e:
        try:
            msg = json.loads(e.read()).get("message", "")
        except Exception:
            msg = str(e)
        print(f"Error: {base}: HTTP {e.code}: {msg}", file=sys.stderr)
        return 1
    except (urllib.error.URLError, OSError, ValueError) as e:
        print(f"Error: cannot reach {base}: {e}", file=sys.stderr)
        return 1


def _cmd_lineage(args) -> int:
    """`pio lineage <url>` — browse a deployment's generation lineage:
    the merged record index by default, one generation's freshness
    waterfall (append-observed → fold → publish → plane write → watcher
    wake → compose → install → first serve) with `--gen` or `--lid`.
    Any worker of a prefork group answers for the whole group (the
    records are merged across the publisher and every worker)."""
    import urllib.error
    import urllib.request

    from predictionio_tpu_torch.obs.lineage import (
        render_lineage_cluster_text,
        render_lineage_text,
    )

    base = args.url
    if "://" not in base:
        base = f"http://{base}"
    base = base.rstrip("/")
    for suffix in ("/lineage.json", "/lineage"):
        if base.endswith(suffix):
            base = base[: -len(suffix)]

    def fetch(path):
        with urllib.request.urlopen(base + path, timeout=args.timeout) as r:
            return json.loads(r.read().decode("utf-8", "replace"))

    try:
        token = args.gen if args.gen is not None else args.lid
        if token is not None:
            doc = fetch(f"/lineage/{token}.json")
            if args.cluster:
                sys.stdout.write(render_lineage_cluster_text(doc))
            else:
                sys.stdout.write(render_lineage_text(doc))
            return 0
        index = fetch("/lineage.json")
        records = index.get("records", [])
        print(f"{len(records)} lineage record(s) "
              f"(answered by worker {index.get('worker', '?')}):")
        for r in records:
            cl = r.get("cluster") or {}
            cl_txt = (" cluster=%d/%d" % (cl.get("done", 0),
                                          cl.get("expected", 0))
                      if cl else "")
            print("  gen %-6s %-18s %-16s %8.1f ms  %2d stages  "
                  "origin=%s workers=%s%s"
                  % (r.get("generation", "?"), r.get("lid", "?"),
                     r.get("outcome", "?"),
                     float(r.get("durationMs") or 0.0),
                     r.get("stageCount", 0), r.get("origin", "?"),
                     ",".join(r.get("workers") or []), cl_txt))
        if records:
            print(f"(pio lineage {args.url} --gen <generation> renders a "
                  "waterfall)")
        return 0
    except urllib.error.HTTPError as e:
        try:
            msg = json.loads(e.read()).get("message", "")
        except Exception:
            msg = str(e)
        print(f"Error: {base}: HTTP {e.code}: {msg}", file=sys.stderr)
        return 1
    except (urllib.error.URLError, OSError, ValueError) as e:
        print(f"Error: cannot reach {base}: {e}", file=sys.stderr)
        return 1


_SPARK_BLOCKS = "▁▂▃▄▅▆▇█"


def _sparkline(vals) -> str:
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    if hi - lo < 1e-12:
        return _SPARK_BLOCKS[0] * len(vals)
    return "".join(
        _SPARK_BLOCKS[int((v - lo) / (hi - lo) * (len(_SPARK_BLOCKS) - 1))]
        for v in vals)


def _cmd_top_cluster(args, base: str) -> int:
    """`pio top <url> --cluster` — the publisher's federated per-node
    view (/cluster/metrics.json + /cluster/history.json): one row per
    subscriber node with liveness, generation, lag, qps and p95, plus a
    qps sparkline per node over the federated ring."""
    import urllib.error
    import urllib.request

    def fetch(path):
        with urllib.request.urlopen(base + path, timeout=args.timeout) as r:
            return json.loads(r.read().decode("utf-8", "replace"))

    try:
        doc = fetch("/cluster/metrics.json")
        history = fetch(f"/cluster/history.json?limit={args.window}")
    except urllib.error.HTTPError as e:
        try:
            msg = json.loads(e.read()).get("message", "")
        except Exception:
            msg = str(e)
        print(f"Error: {base}: HTTP {e.code}: {msg}", file=sys.stderr)
        return 1
    except (urllib.error.URLError, OSError, ValueError) as e:
        print(f"Error: cannot reach {base}: {e}", file=sys.stderr)
        return 1
    nodes = doc.get("nodes") or {}
    samples = history.get("samples") or []
    print(f"{base}  —  cluster of {len(nodes)} subscriber node(s), "
          f"scraped every {doc.get('scrapeIntervalSeconds', '?')}s "
          f"(publisher node {doc.get('node') or '?'})")
    if not nodes:
        print("  (no subscribers have connected to this publisher yet)")
        return 0
    fmt = "  %-20s %-4s %6s %5s %9s %9s %8s"
    print(fmt % ("node", "up", "gen", "lag", "qps", "p95 ms", "stale s"))
    for name in sorted(nodes):
        n = nodes[name]

        def num(v, scale=1.0, pat="%.1f"):
            return pat % (float(v) * scale) if v is not None else "-"

        print(fmt % (
            name[:20], "yes" if n.get("up") else "NO",
            "%d" % n["generation"] if n.get("generation") is not None
            else "-",
            num(n.get("replLag"), pat="%.0f"), num(n.get("qps")),
            num(n.get("p95"), 1e3), num(n.get("staleSeconds")))
            + (f"  ({n.get('error')})" if n.get("error") else ""))
        qps = [((s.get("nodes") or {}).get(name) or {}).get("qps")
               for s in samples]
        qps = [float(v) for v in qps if v is not None]
        if len(qps) >= 2:
            print("    qps %s" % _sparkline(qps))
    return 0


def _cmd_top(args) -> int:
    """`pio top <url>` — one-shot terminal view of a server's recent
    history (/metrics/history.json: the local time-series ring): a
    sparkline + latest value per key signal.  No Prometheus needed.
    `--cluster` switches to the publisher's federated per-node view."""
    import urllib.error
    import urllib.request

    base = args.url
    if "://" not in base:
        base = f"http://{base}"
    base = base.rstrip("/")
    if args.cluster:
        return _cmd_top_cluster(args, base)
    url = base + "/metrics/history.json"
    try:
        with urllib.request.urlopen(url, timeout=args.timeout) as r:
            history = json.loads(r.read().decode("utf-8", "replace"))
    except urllib.error.HTTPError as e:
        print(f"Error: {url}: HTTP {e.code}", file=sys.stderr)
        return 1
    except (urllib.error.URLError, OSError, ValueError) as e:
        print(f"Error: cannot reach {url}: {e}", file=sys.stderr)
        return 1
    samples = history.get("samples", [])[-args.window:]
    if len(samples) < 2:
        print("Not enough history yet (the sampler ticks every "
              f"{history.get('intervalSeconds', '?')} s) — try again "
              "shortly.")
        return 1

    def series_vals(metric, reducer, match=""):
        out = []
        for s in samples:
            entry = (s.get("m") or {}).get(metric)
            vals = [float(v) for k, v in (entry or {}).get(
                "series", {}).items()
                if not match or match in k] if entry else []
            out.append(reducer(vals) if vals else 0.0)
        return out

    def rate(vals):
        rates = []
        for (p, c), (tp, tc) in zip(
                zip(vals, vals[1:]),
                zip((s["t"] for s in samples),
                    (s["t"] for s in samples[1:]))):
            dt = max(tc - tp, 1e-9)
            rates.append(max(c - p, 0.0) / dt)
        return rates

    rows = [
        ("req/s", rate(series_vals("pio_http_requests_total", sum)),
         "{:.1f}"),
        ("events ingested/s",
         rate(series_vals("pio_events_ingested_total", sum)), "{:.1f}"),
        ("folds/s", rate(series_vals("pio_follow_folds_total", sum)),
         "{:.2f}"),
        ("fold lag (events)",
         series_vals("pio_follow_lag_events", max)[1:], "{:.0f}"),
        ("state MB",
         [v / 1e6 for v in
          series_vals("pio_follow_state_bytes", max)[1:]], "{:.1f}"),
        ("rss MB (sum)",
         [v / 1e6 for v in
          series_vals("pio_process_rss_bytes", sum)[1:]], "{:.0f}"),
        ("plane chain len",
         series_vals("pio_model_plane_chain_len", max)[1:], "{:.0f}"),
        ("cache entries",
         series_vals("pio_serve_cache_entries", sum)[1:], "{:.0f}"),
        ("slo burn (fast, max)",
         series_vals("pio_slo_burn_rate", max, match='window="fast"')[1:],
         "{:.2f}"),
    ]
    span_s = samples[-1]["t"] - samples[0]["t"]
    print(f"{base}  —  {len(samples)} samples over {span_s:.0f}s "
          f"(worker {history.get('worker', '?')})")
    for label, vals, fmt in rows:
        if not vals:
            continue
        last = fmt.format(vals[-1])
        print(f"  {label:<22} {_sparkline(vals)}  {last}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pio", description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="command", required=True)

    sub.add_parser("version").set_defaults(func=_cmd_version)
    sub.add_parser("status").set_defaults(func=_cmd_status)

    app = sub.add_parser("app")
    app_sub = app.add_subparsers(dest="app_command", required=True)
    ap_new = app_sub.add_parser("new")
    ap_new.add_argument("name")
    ap_new.add_argument("--id", type=int, default=0)
    ap_new.add_argument("--description", default="")
    app_sub.add_parser("list")
    for name in ("show", "delete", "data-delete"):
        app_sub.add_parser(name).add_argument("name")
    cp = app_sub.add_parser(
        "compact", help="rewrite the event log without tombstoned (and, with --before, "
                        "expired) events; run with ingest paused")
    cp.add_argument("name")
    cp.add_argument("--channel", default=None)
    cp.add_argument("--before", default=None,
                    help="also expire events older than this ISO-8601 instant")
    app.set_defaults(func=_cmd_app)

    ak = sub.add_parser("accesskey")
    ak_sub = ak.add_subparsers(dest="ak_command", required=True)
    ak_new = ak_sub.add_parser("new")
    ak_new.add_argument("app_name")
    ak_new.add_argument("events", nargs="*")
    ak_sub.add_parser("list").add_argument("app_name")
    ak_sub.add_parser("delete").add_argument("key")
    ak.set_defaults(func=_cmd_accesskey)

    ch = sub.add_parser("channel")
    ch_sub = ch.add_subparsers(dest="ch_command", required=True)
    for name in ("new", "delete"):
        sp = ch_sub.add_parser(name)
        sp.add_argument("app_name")
        sp.add_argument("name")
    ch.set_defaults(func=_cmd_channel)

    sn = sub.add_parser("snapshot", help="build a columnar event-store snapshot "
                                         "(memory-mapped training reads); --status "
                                         "reports its coverage")
    sn.add_argument("name")
    sn.add_argument("--channel", default=None)
    sn.add_argument("--status", action="store_true",
                    help="report the snapshot's coverage instead of building")
    sn.set_defaults(func=_cmd_snapshot)

    for name, func, arg in (("import", _cmd_import, "--input"),
                            ("export", _cmd_export, "--output")):
        sp = sub.add_parser(name)
        sp.add_argument("--appid", type=int, default=0)
        sp.add_argument("--app-name", default=None)
        sp.add_argument("--channel", default=None)
        sp.add_argument(arg, required=True)
        sp.set_defaults(func=func)

    def engine_args(sp):
        sp.add_argument("--engine-json", default="engine.json")
        sp.add_argument("--engine-id", default=None)
        sp.add_argument("--engine-version", default="1")
        sp.add_argument("--variant", default="default")

    bd = sub.add_parser("build")
    engine_args(bd)
    bd.set_defaults(func=_cmd_build)

    tp = sub.add_parser("template")
    tp_sub = tp.add_subparsers(dest="template_command", required=True)
    tp_sub.add_parser("list")
    tp_new = tp_sub.add_parser("new")
    tp_new.add_argument("template")
    tp_new.add_argument("directory")
    tp.set_defaults(func=_cmd_template)

    ev = sub.add_parser("eval")
    ev.add_argument("evaluation_class")
    ev.add_argument("params_generator", nargs="?", default=None,
                    help="dotted path to an EngineParamsGenerator supplying "
                         "the candidate grid (reference: pio eval's second arg)")
    ev.add_argument("--engine-json", default="engine.json")
    ev.set_defaults(func=_cmd_eval)

    tr = sub.add_parser("train")
    engine_args(tr)
    tr.add_argument("--stop-after-read", action="store_true",
                    help="check the data source, then stop (reference stopAfterRead)")
    tr.add_argument("--stop-after-prepare", action="store_true",
                    help="run the data source and preparator, then stop")
    tr.add_argument("--follow", action="store_true",
                    help="stay resident after training: tail the event store and "
                         "publish an incrementally folded model generation "
                         "whenever new events arrive (pair deployments with "
                         "--auto-reload to pick them up)")
    tr.add_argument("--follow-interval", type=float, default=0.0, metavar="SECS",
                    help="seconds between follow ticks (default "
                         "PIO_FOLLOW_INTERVAL_S or 2)")
    tr.set_defaults(func=_cmd_train)

    dp = sub.add_parser("deploy")
    engine_args(dp)
    dp.add_argument("--ip", default="0.0.0.0")
    dp.add_argument("--port", type=int, default=8000)
    # accepted and not read, as in the JAX package: the server deploys the
    # latest COMPLETED instance of the engine variant
    dp.add_argument("--engine-instance-id", default=None)
    dp.add_argument("--feedback", action="store_true",
                    help="write every answered query back as a predict event")
    dp.add_argument("--auto-reload", type=float, default=0.0, metavar="SECS",
                    help="poll for a newer COMPLETED instance every SECS and "
                         "hot-swap it in")
    dp.add_argument("--workers", type=int, default=1,
                    help="prefork N processes serving this port (CPU only)")
    dp.add_argument("--reuse-port", action="store_true",
                    help=argparse.SUPPRESS)   # a prefork child
    dp.add_argument("--follow", type=float, default=0.0, metavar="SECS",
                    help="host an embedded follow-trainer: tail the event store "
                         "every SECS and hot-swap each folded generation")
    dp.add_argument("--plane-publisher", action="store_true",
                    help=argparse.SUPPRESS)   # a prefork plane group's fold process
    dp.add_argument("--plane-publish", default=None, metavar="[HOST:]PORT",
                    help="also stream this node's model plane to replication "
                         "subscribers on [HOST:]PORT")
    dp.add_argument("--plane-from", default=None, metavar="HOST:PORT",
                    help="be a replication subscriber: serve the node-local plane "
                         "(PIO_MODEL_PLANE_DIR) the publisher at HOST:PORT feeds "
                         "(conflicts with --follow)")
    dp.set_defaults(func=_cmd_deploy)

    ps = sub.add_parser("plane-subscribe",
                        help="mirror a publisher's model plane into a local directory")
    ps.add_argument("--from", dest="source", required=True, metavar="HOST:PORT",
                    help="the publisher (deploy --plane-publish)")
    ps.add_argument("--plane-dir", required=True,
                    help="the node-local plane directory (the servers' "
                         "PIO_MODEL_PLANE_DIR)")
    ps.add_argument("--node", default=None,
                    help="the name reported to the publisher (default hostname-pid)")
    ps.set_defaults(func=_cmd_plane_subscribe)

    ud = sub.add_parser("undeploy")
    ud.add_argument("--ip", default="127.0.0.1")
    ud.add_argument("--port", type=int, default=8000)
    ud.add_argument("--timeout", type=float, default=10.0)
    ud.set_defaults(func=_cmd_undeploy)

    es = sub.add_parser("eventserver")
    es.add_argument("--ip", default="0.0.0.0")
    es.add_argument("--port", type=int, default=7070)
    es.add_argument("--workers", type=int, default=1,
                    help="prefork N processes ingesting on this port; each "
                         "appends to its own seg-<tag>-NNNNN.jsonl segments")
    es.add_argument("--reuse-port", action="store_true",
                    help=argparse.SUPPRESS)   # a prefork child
    es.set_defaults(func=_cmd_eventserver)

    adm = sub.add_parser("adminserver")
    adm.add_argument("--ip", default="127.0.0.1")
    adm.add_argument("--port", type=int, default=7071)
    adm.set_defaults(func=_cmd_adminserver)

    mt = sub.add_parser("metrics", help="scrape a server's /metrics and pretty-print it")
    mt.add_argument("url", help="server base URL or host:port")
    mt.add_argument("--timeout", type=float, default=10.0)
    mt.add_argument("--raw", action="store_true",
                    help="print the raw Prometheus text instead")
    mt.set_defaults(func=_cmd_metrics)

    db = sub.add_parser("dashboard")
    db.add_argument("--ip", default="127.0.0.1")
    db.add_argument("--port", type=int, default=9000)
    db.set_defaults(func=_cmd_dashboard)

    tc = sub.add_parser(
        "trace",
        help="browse a server's request flight recorder "
             "(/traces.json index; --rid/--slow render a waterfall)")
    tc.add_argument("url",
                    help="server base URL or host:port (e.g. "
                         "http://127.0.0.1:8000 or 127.0.0.1:8000)")
    tc.add_argument("--rid", default=None,
                    help="render the waterfall of this request id")
    tc.add_argument("--slow", action="store_true",
                    help="render the slowest retained trace's waterfall")
    tc.add_argument("--timeout", type=float, default=10.0)
    tc.set_defaults(func=_cmd_trace)

    ln = sub.add_parser(
        "lineage",
        help="browse a deployment's generation lineage "
             "(/lineage.json index; --gen/--lid render a freshness "
             "waterfall)")
    ln.add_argument("url",
                    help="server base URL or host:port (e.g. "
                         "http://127.0.0.1:8000 or 127.0.0.1:8000)")
    ln.add_argument("--gen", default=None,
                    help="render the waterfall of this plane/model "
                         "generation")
    ln.add_argument("--lid", default=None,
                    help="render the waterfall of this lineage id "
                         "(ln-...)")
    ln.add_argument("--cluster", action="store_true",
                    help="render the stitched cross-node waterfall with "
                         "one lane per subscriber node (publisher URL)")
    ln.add_argument("--timeout", type=float, default=10.0)
    ln.set_defaults(func=_cmd_lineage)

    tp = sub.add_parser(
        "top",
        help="sparkline view of a server's recent metrics history "
             "(/metrics/history.json ring)")
    tp.add_argument("url",
                    help="server base URL or host:port (e.g. "
                         "http://127.0.0.1:8000 or 127.0.0.1:8000)")
    tp.add_argument("--window", type=int, default=60,
                    help="samples to render (default 60)")
    tp.add_argument("--cluster", action="store_true",
                    help="federated per-node view from the publisher's "
                         "/cluster/metrics.json + /cluster/history.json")
    tp.add_argument("--timeout", type=float, default=10.0)
    tp.set_defaults(func=_cmd_top)

    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    args.device = os.environ.get("PIO_TORCH_DEVICE", "cuda")
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
