"""The port's Python SDK (``sdk/client.py``) and ``utils/config.py``
against the JAX package's (the parity targets are the SDK cases of the
JAX suite's tests/test_async_http.py and tests/test_servers.py, and
tests/test_aux_subsystems.py's ``load_pio_env`` case).

- The same calls through each package's ``EventClient``,
  ``EngineClient``, ``EventPipeline`` and ``QueryPipeline`` send the same
  request bytes, captured on a raw socket (the request-id seed of both
  modules set to one value, the counters restarted).
- The backoff schedule of a refused connection is the same under one
  random seed and one clock.
- The port's clients against the JAX servers, and the JAX clients against
  the port's, answer what the servers' own package's clients answer.
- ``load_pio_env`` parses, interpolates and searches as the JAX loader.
"""

import datetime as dt
import itertools
import json
import random
import socket
import threading

import pytest

from predictionio_tpu import sdk as jax_sdk
from predictionio_tpu.api.event_server import run_event_server as jax_event_server
from predictionio_tpu.sdk import client as jax_client
from predictionio_tpu.utils.config import load_pio_env as jax_load_pio_env
from predictionio_tpu_torch import sdk as port_sdk
from predictionio_tpu_torch.api.event_server import run_event_server as port_event_server
from predictionio_tpu_torch.sdk import client as port_client
from predictionio_tpu_torch.utils import load_pio_env as port_load_pio_env

from _torch_obs_cases import jax_app, localfs_pair, port_app

WHEN = dt.datetime(2026, 2, 3, 4, 5, 6, tzinfo=dt.timezone.utc)


def _canned(method, path):
    """The capture server's answer to one request: (status, JSON body)."""
    if path.startswith("/events.json") and method == "POST":
        return 201, {"eventId": "e-1"}
    if path.startswith("/batch/events.json"):
        return 200, [{"status": 201, "eventId": "b-1"}, {"status": 201, "eventId": "b-2"}]
    if path.startswith("/events/") and method == "GET":
        return 200, {"eventId": "e-1", "event": "buy"}
    if path.startswith("/events/") and method == "DELETE":
        return 200, {"message": "Found"}
    if path.startswith("/events.json"):
        return 200, [{"eventId": "e-1"}]
    if path == "/queries.json":
        return 200, {"itemScores": [{"item": "i1", "score": 1.0}]}
    if path == "/stats.json":
        return 503, {"message": "stats disabled (PIO_METRICS=off)"}
    if path == "/":
        return 200, {"status": "alive", "freshness": {"generation": 3}}
    if path.startswith("/lineage"):
        return 200, {"records": []}
    if path == "/healthz":
        return 200, {"status": "ok"}
    return 404, {"message": "not found"}


class Capture:
    """A raw keep-alive HTTP server on an ephemeral port that records every
    request's bytes and answers each from ``_canned``, in order."""

    def __init__(self):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(16)
        self.port = self.sock.getsockname()[1]
        self.requests = []
        self._lock = threading.Lock()
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,), daemon=True).start()

    def _serve(self, conn):
        buf = b""
        conn.settimeout(20.0)
        try:
            while True:
                while b"\r\n\r\n" not in buf:
                    chunk = conn.recv(65536)
                    if not chunk:
                        return
                    buf += chunk
                head, _, rest = buf.partition(b"\r\n\r\n")
                length = 0
                for line in head.split(b"\r\n")[1:]:
                    name, _, value = line.partition(b":")
                    if name.strip().lower() == b"content-length":
                        length = int(value)
                while len(rest) < length:
                    rest += conn.recv(65536)
                raw, buf = head + b"\r\n\r\n" + rest[:length], rest[length:]
                with self._lock:
                    self.requests.append(raw)
                method, path = head.split(b" ")[:2]
                status, body = _canned(method.decode(), path.decode().split("?")[0])
                payload = json.dumps(body).encode()
                conn.sendall(b"HTTP/1.1 %d X\r\nContent-Type: application/json\r\n"
                             b"Content-Length: %d\r\n\r\n" % (status, len(payload)) + payload)
        except OSError:
            return
        finally:
            conn.close()

    def close(self):
        self.sock.close()


def _drive(sdk, url):
    """One call of every client method and both pipelines; their results."""
    out = []
    ev = sdk.EventClient("k", url, channel="c1")
    out.append(ev.create_event("buy", "user", "u1", "item", "i1", {"n": 1}, WHEN))
    out.append(ev.create_events([{"event": "view", "entityType": "user", "entityId": "u2"}]))
    out.append(ev.set_user("u3", {"age": 3}))
    out.append(ev.set_item("i4"))
    out.append(ev.record_user_action_on_item("rate", "u5", "i5", {"rating": 4}))
    out.append(ev.get_event("e-1"))
    out.append(ev.delete_event("e-1"))
    out.append(ev.find_events(entityType="user", limit="2"))
    eng = sdk.EngineClient(url)
    out.append(eng.send_query({"user": "u1", "num": 2}))
    out.append(eng.freshness())
    out.append(eng.model_generation())
    out.append(eng.lineage())
    out.append(eng.lineage(4))
    out.append(eng.healthz())
    with ev.pipeline(depth=4) as pipe:
        hs = [pipe.create_event("buy", "user", f"u{i}", "item", "i1", event_time=WHEN)
              for i in range(6)]
        hs.append(pipe.record_user_action_on_item("view", "u9", "i9"))
    out.append([h.result() for h in hs])
    with eng.pipeline(depth=3) as qp:
        qs = [qp.send_query({"user": f"u{i}", "num": 1}) for i in range(5)]
    out.append([h.result() for h in qs])
    try:
        ev._conn.request("GET", "/nope")
    except sdk.PIOError as e:
        out.append((e.status, e.message, e.request_id))
    return out


def _reset_rids(monkeypatch):
    for mod in (jax_client, port_client):
        monkeypatch.setattr(mod, "_RID_SEED", "sdk-test")
        monkeypatch.setattr(mod, "_RID_COUNTER", itertools.count(1))


def test_request_bytes_equal_the_jax_sdk(monkeypatch):
    got = {}
    for name, sdk in (("jax", jax_sdk), ("port", port_sdk)):
        _reset_rids(monkeypatch)
        cap = Capture()
        try:
            answers = _drive(sdk, f"http://127.0.0.1:{cap.port}")
        finally:
            cap.close()
        # the pipeline and the serial path use separate sockets; order the
        # capture by request id (the minting order), not by arrival
        got[name] = (answers, sorted(cap.requests, key=lambda r: r.split(
            b"X-Request-ID: ", 1)[-1].split(b"\r\n")[0].split(b"-")[-1].rjust(8, b"0")))
    assert got["port"][0] == got["jax"][0]
    assert len(got["port"][1]) == len(got["jax"][1]) == 29
    for g, w in zip(got["port"][1], got["jax"][1]):
        # the Host header names the capture server's port, one per run
        assert _host_free(g) == _host_free(w)


def _host_free(raw):
    return b"\r\n".join(ln for ln in raw.split(b"\r\n") if not ln.startswith(b"Host: "))


def test_backoff_schedule_equal(monkeypatch):
    delays = []
    for mod in (jax_client, port_client):
        clock = iter(i * 0.01 for i in range(10_000))
        monkeypatch.setattr(mod.time, "monotonic", lambda: next(clock))
        random.seed(17)
        delays.append(list(mod._backoff_delays(2.0)))
    assert delays[1] == delays[0] and delays[0][0] == 0.0 and len(delays[0]) > 3


def test_error_types_as_jax():
    for name in ("PIOError", "AsyncResult", "EventClient", "EngineClient", "EventPipeline",
                 "QueryPipeline"):
        assert hasattr(port_sdk, name)
    e = port_sdk.PIOError(404, "gone", request_id="r-1")
    w = jax_sdk.PIOError(404, "gone", request_id="r-1")
    assert (str(e), e.status, e.message, e.request_id) == (
        str(w), w.status, w.message, w.request_id)


def test_clients_of_either_package_against_either_server(tmp_path):
    jstore, pstore = localfs_pair(tmp_path)
    jax_app(jstore)
    port_app(pstore)
    servers = {"jax": jax_event_server(host="127.0.0.1", port=0, storage=jstore,
                                       background=True),
               "port": port_event_server(host="127.0.0.1", port=0, storage=pstore,
                                         background=True)}
    try:
        for name, srv in servers.items():
            url = f"http://127.0.0.1:{srv.server_address[1]}"
            answers = {}
            for cname, sdk in (("jax", jax_sdk), ("port", port_sdk)):
                ev = sdk.EventClient("obskey", url)
                eid = ev.create_event("buy", "user", f"{cname}-u", "item", "i1", {"q": 2}, WHEN)
                got = ev.get_event(eid)
                assert got.pop("eventId") == eid
                batch = ev.create_events([
                    {"event": "view", "entityType": "user", "entityId": f"{cname}-v",
                     "eventTime": WHEN.isoformat()}, {"event": "bad"}])
                with ev.pipeline(depth=2) as pipe:
                    hs = [pipe.create_event("rate", "user", f"{cname}-p{i}", "item", "i2",
                                            {"rating": i}, WHEN) for i in range(3)]
                piped = [bool(h.result()) for h in hs]
                found = ev.find_events(entityType="user", entityId=f"{cname}-u")
                ev.delete_event(eid)
                with pytest.raises(sdk.PIOError) as err:
                    ev.get_event(eid)
                with pytest.raises(sdk.PIOError) as refused:
                    sdk.EventClient("nokey", url).create_event("buy", "user", "x")
                answers[cname] = {
                    "event": {k: v for k, v in got.items()
                              if k not in ("creationTime", "entityId")},
                    "batch": [(r["status"], "eventId" in r) for r in batch],
                    "piped": piped, "found": len(found),
                    "gone": err.value.status, "refused": (refused.value.status,
                                                          refused.value.message)}
            assert answers["port"] == answers["jax"], name
    finally:
        for srv in servers.values():
            srv.shutdown()
            srv.server_close()


ENV_FILE = """# pio-env.sh
export PIO_STORAGE_SOURCES_FS_TYPE=localfs
PIO_FS_BASEDIR=${HOME_DIR}/store
PIO_STORAGE_SOURCES_FS_PATH="$PIO_FS_BASEDIR/data"
PIO_QUOTED='literal ${NOT_EXPANDED}'
export PIO_EMPTY=
not a line
PIO_UNKNOWN_REF=${MISSING}-x
"""


def test_load_pio_env_as_jax(tmp_path, monkeypatch):
    path = tmp_path / "pio-env.sh"
    path.write_text(ENV_FILE)
    base = {"HOME_DIR": "/h"}
    want = jax_load_pio_env(str(path), apply=False, base=dict(base))
    assert port_load_pio_env(str(path), apply=False, base=dict(base)) == want
    assert want["PIO_STORAGE_SOURCES_FS_PATH"] == "/h/store/data"
    assert want["PIO_QUOTED"] == "literal ${NOT_EXPANDED}"
    # the search order: $PIO_ENV_FILE, then ./conf/pio-env.sh
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("PIO_ENV_FILE", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert port_load_pio_env(apply=False) == jax_load_pio_env(apply=False) == {}
    (tmp_path / "conf").mkdir()
    (tmp_path / "conf" / "pio-env.sh").write_text("PIO_X=1\n")
    assert port_load_pio_env(apply=False) == jax_load_pio_env(apply=False) == {"PIO_X": "1"}
    monkeypatch.setenv("PIO_ENV_FILE", str(path))
    assert port_load_pio_env(apply=False) == jax_load_pio_env(apply=False)
    monkeypatch.delenv("PIO_Y", raising=False)
    (tmp_path / "conf" / "pio-env.sh").write_text("PIO_Y=2\n")
    monkeypatch.delenv("PIO_ENV_FILE")
    assert port_load_pio_env() == {"PIO_Y": "2"}
    import os
    assert os.environ["PIO_Y"] == "2"
    monkeypatch.delenv("PIO_Y")
