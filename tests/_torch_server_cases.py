"""Shared helpers of the port's server tests (tests/test_torch_http.py,
tests/test_torch_event_server.py, tests/test_torch_servers.py): raw-socket
HTTP, small JSON requests with bounded waits, and the port's event server
on a fresh memory store."""

import json
import socket
import time
import urllib.error
import urllib.request

from predictionio_tpu_torch.api.event_server import run_event_server
from predictionio_tpu_torch.storage import AccessKey, App

from _torch_event_cases import port_memory_storage

#: every socket and request of these tests waits at most this long
WAIT_S = 20.0


def connect(port):
    s = socket.create_connection(("127.0.0.1", port), timeout=WAIT_S)
    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return s


def read_responses(sock, n, timeout=WAIT_S):
    """Exactly ``n`` HTTP responses off ``sock``: [(status, headers with
    lower-cased names, body bytes)] in wire order."""
    sock.settimeout(timeout)
    buf, out = b"", []
    while len(out) < n:
        while b"\r\n\r\n" not in buf:
            chunk = sock.recv(65536)
            if not chunk:
                raise AssertionError(f"connection closed after {len(out)}/{n} responses")
            buf += chunk
        head, _, buf = buf.partition(b"\r\n\r\n")
        lines = head.decode("latin-1").split("\r\n")
        status = int(lines[0].split(" ", 2)[1])
        headers = {}
        for ln in lines[1:]:
            name, _, value = ln.partition(":")
            headers[name.strip().lower()] = value.strip()
        length = int(headers.get("content-length", 0))
        while len(buf) < length:
            chunk = sock.recv(65536)
            if not chunk:
                raise AssertionError("closed mid-body")
            buf += chunk
        out.append((status, headers, buf[:length]))
        buf = buf[length:]
    return out


def read_to_close(sock, timeout=WAIT_S):
    sock.settimeout(timeout)
    data = b""
    while True:
        chunk = sock.recv(65536)
        if not chunk:
            return data
        data += chunk


def http(method, url, body=None, headers=None, raw=False):
    """(status, parsed JSON body, or the bytes with ``raw``)."""
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=WAIT_S) as resp:
            payload = resp.read()
            status = resp.status
    except urllib.error.HTTPError as e:
        payload, status = e.read(), e.code
    return status, (payload if raw else json.loads(payload or b"null"))


def post_event_bytes(key, eid="u1"):
    body = json.dumps({"event": "buy", "entityType": "user", "entityId": eid,
                       "targetEntityType": "item", "targetEntityId": "i1"}).encode()
    return (b"POST /events.json?accessKey=" + key.encode()
            + b" HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
            b"Content-Length: %d\r\n\r\n" % len(body) + body)


def port_event_server(app="httpapp", storage=None):
    """The port's event server on 127.0.0.1:0 over a fresh memory store:
    (server, port, access key, storage)."""
    storage = storage or port_memory_storage()
    app_id = storage.apps.insert(App(0, app))
    key = storage.access_keys.insert(AccessKey("", app_id, []))
    httpd = run_event_server(host="127.0.0.1", port=0, storage=storage, background=True)
    return httpd, httpd.server_address[1], key, storage


def stop(httpd):
    httpd.shutdown()
    httpd.server_close()


def wait_for(cond, timeout=WAIT_S, every=0.05):
    """Poll ``cond()`` until it is truthy (returned) or ``timeout`` lapses
    (AssertionError)."""
    deadline = time.monotonic() + timeout
    while True:
        got = cond()
        if got:
            return got
        if time.monotonic() > deadline:
            raise AssertionError("condition not met within %.0f s" % timeout)
        time.sleep(every)
