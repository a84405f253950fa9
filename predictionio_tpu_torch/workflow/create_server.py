"""Query server: the serving core of ``pio deploy``.

Counterpart of the query-serving core of
``predictionio_tpu/workflow/create_server.py`` (reference:
core/.../workflow/CreateServer.scala):

  POST /queries.json   query → predict → serve → JSON prediction
  GET  /               engine info

It serves models already in memory on the stdlib
``http.server.ThreadingHTTPServer``.  The event-loop front end, the
micro-batcher, the caches, observability, the model plane and the
storage-backed ``pio deploy --engine-json`` wait for later slices
(ROADMAP.md, queue A).
"""

from __future__ import annotations

import datetime as _dt
import json
import logging
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Sequence

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
            if self.path.split("?", 1)[0] == "/":
                self._send_json(200, state.info())
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
    thread and return the server; ``server.server_address`` has the bound
    port, ``server.state`` the ``QueryServerState``.  Stop it with
    ``server.shutdown(); server.server_close()``."""
    state = QueryServerState(engine, engine_params, models, query_class)
    server = ThreadingHTTPServer((host, port), make_handler(state))
    server.daemon_threads = True
    server.state = state
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="pio-query-server").start()
    return server
