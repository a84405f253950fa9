"""Query server: the serving core of ``pio deploy``.

Counterpart of the query-serving core of
``predictionio_tpu/workflow/create_server.py`` (reference:
core/.../workflow/CreateServer.scala):

  POST /queries.json   query → predict → serve → JSON prediction
  GET  /               engine info
  GET  /stop           stop serving (``pio undeploy``)

``deploy_models`` serves models already in memory on the stdlib
``http.server.ThreadingHTTPServer``; ``deploy`` loads the latest COMPLETED
engine instance of an engine.json from the model store and serves it the
same way, and ``run_server_from_args`` is ``pio deploy``: it serves in the
foreground until ``GET /stop`` or SIGINT.  The event-loop front end,
prefork workers, the micro-batcher, the caches, observability, hot reload,
feedback, the follow-trainer and the model plane wait for later slices
(ROADMAP.md, queue A).
"""

from __future__ import annotations

import datetime as _dt
import json
import logging
import os
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Sequence

from predictionio_tpu_torch.storage.locator import Storage

log = logging.getLogger("pio.queryserver")


def _to_jsonable(obj: Any) -> Any:
    if hasattr(obj, "to_json"):
        return obj.to_json()
    if isinstance(obj, (dict, list, str, int, float, bool)) or obj is None:
        return obj
    if hasattr(obj, "__dict__"):
        return obj.__dict__
    return str(obj)


class QueryServerState:
    """The deployed engine, its params and models, and the predictor built
    from them (one component construction + warm pass)."""

    def __init__(self, engine, engine_params, models: Sequence[Any],
                 query_class: Optional[type] = None):
        self.engine = engine
        self.engine_params = engine_params
        self.models = list(models)
        self.query_class = query_class
        self.predictor = engine.predictor(engine_params, self.models)
        self._lock = threading.Lock()
        self.query_count = 0
        self.started = _dt.datetime.now(_dt.timezone.utc)

    def parse_query(self, body: Dict) -> Any:
        if self.query_class is not None and hasattr(self.query_class, "from_json"):
            return self.query_class.from_json(body)
        return body

    def predict(self, body: Dict) -> Any:
        prediction = self.predictor(self.parse_query(body))
        with self._lock:
            self.query_count += 1
        return prediction

    def info(self) -> Dict:
        return {
            "status": "alive",
            "pid": os.getpid(),
            "engine": type(self.engine).__name__,
            "algorithms": [name for name, _ in
                           self.engine_params.algorithm_params_list],
            "devices": sorted({str(m.device) for m in self.models if hasattr(m, "device")}),
            "queryCount": self.query_count,
            "startedAt": self.started.isoformat(),
        }


def make_handler(state: QueryServerState):
    class QueryHandler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"   # keep-alive: every reply has a length

        def log_message(self, fmt, *args):   # no per-request stderr line
            pass

        def _send_json(self, status: int, doc: Any) -> None:
            body = json.dumps(doc).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_error_json(self, status: int, message: str) -> None:
            self._send_json(status, {"message": message})

        def do_GET(self):
            path = self.path.split("?", 1)[0]
            if path == "/":
                self._send_json(200, state.info())
            elif path == "/stop":
                self._send_json(200, {"stopping": True})

                def _stop(server):
                    server.shutdown()
                    # close the listening socket too: after shutdown() alone
                    # connections would be accepted and never served
                    server.server_close()

                threading.Thread(target=_stop, args=(self.server,), daemon=True).start()
            else:
                self._send_error_json(404, "not found")

        def do_POST(self):
            length = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(length)
            if self.path.split("?", 1)[0] != "/queries.json":
                self._send_error_json(404, "not found")
                return
            try:
                body = json.loads(raw or b"null")
            except json.JSONDecodeError as e:
                self._send_error_json(400, f"invalid JSON: {e}")
                return
            if not isinstance(body, dict):
                self._send_error_json(400, "query must be a JSON object")
                return
            try:
                prediction = state.predict(body)
            except (KeyError, ValueError, TypeError) as e:
                self._send_error_json(400, f"bad query: {e}")
                return
            except Exception as e:  # engine failure: report, keep serving
                log.exception("prediction failed")
                self._send_error_json(500, f"prediction failed: {e}")
                return
            self._send_json(200, _to_jsonable(prediction))

    return QueryHandler


def deploy_models(engine, engine_params, models: Sequence[Any],
                  host: str = "127.0.0.1", port: int = 0,
                  query_class: Optional[type] = None) -> ThreadingHTTPServer:
    """Serve ``models`` on ``host:port`` (0 = any free port) from a daemon
    thread (``server.thread``) and return the server;
    ``server.server_address`` has the bound port, ``server.state`` the
    ``QueryServerState``.  Stop it with ``server.shutdown();
    server.server_close()``, or ``GET /stop``."""
    state = QueryServerState(engine, engine_params, models, query_class)
    server = ThreadingHTTPServer((host, port), make_handler(state))
    server.daemon_threads = True
    server.state = state
    server.thread = threading.Thread(target=server.serve_forever, daemon=True,
                                     name="pio-query-server")
    server.thread.start()
    return server


ROADMAP_SERVER = "ROADMAP.md, queue A, 'Event-loop server and micro-batcher'"
ROADMAP_STREAMING = "ROADMAP.md, queue A, 'Streaming'"


def deploy(
    engine_json: str = "engine.json",
    variant: str = "default",
    engine_id: Optional[str] = None,
    engine_version: str = "1",
    host: str = "0.0.0.0",
    port: int = 8000,
    storage: Optional[Storage] = None,
    device="cuda",
    feedback: bool = False,
    auto_reload: float = 0.0,
    workers: int = 1,
    follow: float = 0.0,
    plane_publish: Optional[str] = None,
    plane_from: Optional[str] = None,
) -> ThreadingHTTPServer:
    """Serve the latest COMPLETED instance of ``engine_json``'s engine
    (``variant`` is the engine variant it was trained under) from the
    model store, its models on ``device``: the server runs in a daemon
    thread, as ``deploy_models``'s does.  Raises when CUDA is asked for
    and absent, and for every option the port cannot honour yet, naming
    its ROADMAP item."""
    from predictionio_tpu_torch.workflow import core_workflow
    from predictionio_tpu_torch.workflow.create_workflow import (
        engine_from_variant,
        load_engine_variant,
        resolve_engine_id,
    )

    for given, option, item in (
            (workers != 1, "workers", ROADMAP_SERVER),
            (auto_reload, "auto_reload", ROADMAP_SERVER),
            (feedback, "feedback", ROADMAP_SERVER),
            (follow, "follow", ROADMAP_STREAMING),
            (plane_publish, "plane_publish", ROADMAP_STREAMING),
            (plane_from, "plane_from", ROADMAP_STREAMING)):
        if given:
            raise NotImplementedError(
                f"deploy {option}= is not ported yet ({item})")
    doc = load_engine_variant(engine_json, variant)
    factory, engine, engine_params = engine_from_variant(doc)
    eid = resolve_engine_id(engine_id, doc, factory)
    instance, models = core_workflow.load_latest_models(
        eid, engine_version, variant, storage=storage, device=device)
    log.info("deploying engine instance %s of %s", instance.id, eid)
    _warm_entity_index(engine_params)
    server = deploy_models(engine, engine_params, models, host=host, port=port,
                           query_class=getattr(factory, "query_class", None))
    server.state.instance = instance
    return server


def _warm_entity_index(engine_params) -> None:
    """Build the serving history read's per-entity index (a localfs
    store's; other backends lack the hook) before the server listens, so
    the first query does not parse the whole log.  The JAX package builds
    it off-thread once the server listens, and its first queries wait for
    it."""
    from predictionio_tpu_torch.storage.locator import get_storage

    app_name = getattr(getattr(engine_params, "data_source_params", None), "app_name", None)
    storage = get_storage()   # the history read's store, as in LEventStore
    warm = getattr(storage.l_events, "warm_entity_index", None)
    app = storage.apps.get_by_name(app_name) if app_name and warm else None
    if app is not None:
        warm(app.id)


def run_server_from_args(args) -> int:
    """``pio deploy``: serve in the foreground until ``GET /stop`` (``pio
    undeploy``) or SIGINT, on ``args.device`` (the CLI's
    ``PIO_TORCH_DEVICE``)."""
    from predictionio_tpu_torch.workflow.create_workflow import resolve_variant_path

    try:
        server = deploy(
            engine_json=resolve_variant_path(args),
            variant=args.variant,
            engine_id=args.engine_id,
            engine_version=args.engine_version,
            host=args.ip,
            port=args.port,
            device=args.device,
            feedback=args.feedback,
            auto_reload=args.auto_reload,
            workers=args.workers,
            follow=args.follow,
            plane_publish=args.plane_publish,
            plane_from=args.plane_from,
        )
    except Exception as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    host, port = server.server_address[:2]
    print(f"Engine instance {server.state.instance.id} deployed at "
          f"http://{host}:{port} (stop with pio undeploy --port {port})", flush=True)
    try:
        while server.thread.is_alive():
            server.thread.join(0.5)   # a timed join lets SIGINT through
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        server.server_close()
    return 0
