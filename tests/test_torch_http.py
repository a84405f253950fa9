"""The port's event-loop HTTP front end (``api/http_util.py``) against the
JAX package's.

Request-head parse: the port's native parse (``native/data_plane.cpp``'s
HTTP core) and its Python parse equal the JAX ``_py_parse_request_head``
on a seeded fuzz corpus, refusals and their order included (the refusal
order is part of the wire contract).  Response assembly and route labels
are byte-equal to JAX's.  The keep-alive, pipelining, slow-client,
body-cap, header-cap and ``Transfer-Encoding`` cases of the JAX suite's
tests/test_async_http.py and tests/test_servers.py run against the
port's event server on a memory store.  Every socket read is bounded.
"""

import json
import socket
import struct
import time

import numpy as np
import pytest

from predictionio_tpu.api import http_util as jax_http
from predictionio_tpu_torch.api import http_util as port_http
from predictionio_tpu_torch.native import core as ncore

from _torch_server_cases import (
    connect,
    port_event_server,
    post_event_bytes,
    read_responses,
    read_to_close,
    stop,
)

# -- request-head parse ----------------------------------------------------------

_METHODS = [b"GET", b"POST", b"DELETE", b"PUT", b"get", b"", b"P\xe9ST"]
_PATHS = [b"/", b"/events.json?accessKey=k&channel=c", b"/queries.json", b"/a%20b",
          b"*", b"/x y", b""]
_VERSIONS = [b"HTTP/1.1", b"HTTP/1.0", b"HTTP/2", b"", b"HTTP/1.1 extra"]
_NAMES = [b"Host", b"Content-Length", b"content-length", b"CONTENT-LENGTH",
          b" Content-Length", b"Content-Length ", b"Transfer-Encoding",
          b"transfer-encoding", b"Connection", b"Expect", b"X-Request-ID",
          b"X-\xe9t\xe9", b"Accept", b"", b"NoColon"]
_VALUES = [b"5", b"10", b"0", b"1_0", b" 10 ", b"\xa010\x85", b"\xd9\xa3", b"", b"abc",
           b"-1", b"+5", b"keep-alive", b"close", b"100-continue", b"chunked",
           b"a:b:c", b"99999999999999999999999"]


def _fuzz_head(rng) -> bytes:
    """One request head (the bytes before CRLFCRLF): mostly well formed,
    with every refusal of the wire contract and its neighbours mixed in."""
    kind = rng.integers(0, 10)
    if kind == 0:   # a request line with fewer than two spaces
        line = rng.choice([b"GET /", b"GARBAGE", b"", b"GET\t/\tHTTP/1.1"])
    else:
        line = b" ".join([_METHODS[rng.integers(len(_METHODS))],
                          _PATHS[rng.integers(len(_PATHS))],
                          _VERSIONS[rng.integers(len(_VERSIONS))]])
    n = int(rng.choice([0, 1, 2, 3, 5, 8, 99, 100, 101]))
    lines = [line]
    for _ in range(n):
        name = _NAMES[rng.integers(len(_NAMES))]
        value = _VALUES[rng.integers(len(_VALUES))]
        sep = [b": ", b":", b" : ", b""][rng.integers(4)]
        ln = name + sep + value if name != b"NoColon" else b"NoColon " + value
        r = rng.random()
        if r < 0.03:
            ln = b" " + ln           # obs-fold continuation
        elif r < 0.05:
            ln = b"\t" + ln
        elif r < 0.07:
            ln = b""                 # an empty line inside the head
        lines.append(ln)
    head = b"\r\n".join(lines)
    if rng.random() < 0.1:
        head += b"\r\n"              # ends exactly on a CRLF
    if rng.random() < 0.05:
        head = head.replace(b"\r\n", b"\n", 1)   # a bare LF
    return head


def _norm(res):
    if res[0] == "refuse":
        return res
    _, command, path, version, headers, need = res
    return ("ok", command, path, version, dict(headers), need)


_EDGES = [
    b"GET / HTTP/1.1",
    b"GET / HTTP/1.1\r\nHost: x",
    b"POST /events.json HTTP/1.1\r\nContent-Length: 27\r\nContent-Length: 27",
    b"POST /events.json HTTP/1.1\r\nContent-Length: 27\r\nContent-Length: 7",
    b"POST /events.json HTTP/1.1\r\nContent-Length: 27\r\nX-Foo: bar\r\n Content-Length: 7",
    b"POST / HTTP/1.1\r\nTransfer-Encoding: chunked\r\nContent-Length: 1_0",
    b"POST / HTTP/1.1\r\nContent-Length: 1_0\r\nTransfer-Encoding: chunked",
    b"POST / HTTP/1.1\r\n\tX: y\r\nTransfer-Encoding: chunked",
    b"GARBAGE\r\nTransfer-Encoding: chunked",
    b"GET / HTTP/1.1\r\n" + b"\r\n".join(b"X-F-%d: y" % i for i in range(100)),
    b"GET / HTTP/1.1\r\n" + b"\r\n".join(b"X-F-%d: y" % i for i in range(101)),
    b"GET / HTTP/1.1\r\n",
    b"GET / HTTP/1.1\r\n\r\n",
    b"",
    b"POST / HTTP/1.1\r\nContent-Length: \xa012\x85",
    b"POST / HTTP/1.1\r\nContent-Length: \xd9\xa3",
    b"POST / HTTP/1.1\r\nContent-Length:",
    b"POST / HTTP/1.1\r\ncontent-length: 3\r\nCONTENT-LENGTH: 3 ",
]


@pytest.mark.parametrize("native", ["on", "off"])
def test_parse_head_edges_match_the_jax_oracle(native, monkeypatch):
    monkeypatch.setenv("PIO_NATIVE", native)
    if native == "on":
        assert port_http._ncore.http_enabled(), "the port's HTTP core did not build"
    for head in _EDGES:
        want = _norm(jax_http._py_parse_request_head(head))
        assert _norm(port_http.parse_request_head(head)) == want, head
        assert _norm(port_http._py_parse_request_head(head)) == want, head


@pytest.mark.parametrize("seed", range(6))
def test_parse_head_fuzz_matches_the_jax_oracle(seed, monkeypatch):
    """A seeded corpus of 300 heads: the port's native parse, its Python
    parse and the JAX oracle agree on every field and every refusal."""
    monkeypatch.setenv("PIO_NATIVE", "on")
    assert ncore.http_enabled()
    rng = np.random.default_rng(seed)
    calls = ncore.calls["http"]
    refused = set()
    for _ in range(300):
        head = _fuzz_head(rng)
        want = _norm(jax_http._py_parse_request_head(head))
        assert _norm(port_http.parse_request_head(head)) == want, head
        assert _norm(port_http._py_parse_request_head(head)) == want, head
        if want[0] == "refuse":
            refused.add(want[2])
    assert ncore.calls["http"] == calls + 300   # every parse went native
    assert len(refused) >= 4, refused            # the corpus reaches the refusals


def test_native_refusal_map_is_the_jax_map():
    assert port_http._NATIVE_REFUSALS == jax_http._NATIVE_REFUSALS


# -- response assembly, route labels ------------------------------------------------

@pytest.mark.parametrize("status,rid,close,size", [
    (200, "", False, 0), (201, "abc-1", False, 17), (404, "r", True, 5),
    (413, "", True, 40), (200, "big-1", False, (1 << 20) + 3),
    (500, "", True, (1 << 20) + 11)])
def test_assemble_response_is_byte_equal_to_jax(status, rid, close, size, monkeypatch):
    """Below 1 MiB the join, above it the native assembly (PIO_NATIVE
    on): the same bytes as the JAX package's."""
    monkeypatch.setenv("PIO_NATIVE", "on")
    body = bytes(np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8))
    want = jax_http.assemble_response(status, body, rid=rid, close=close)
    got = port_http.assemble_response(status, body, rid=rid, close=close)
    assert bytes(got) == bytes(want)
    html = port_http.assemble_response(status, body, "text/html; charset=utf-8", rid, close)
    assert bytes(html) == bytes(jax_http.assemble_response(
        status, body, "text/html; charset=utf-8", rid, close))


def test_route_labels_match_jax():
    paths = ["/", "/stop", "/reload", "/metrics", "/stats.json", "/queries.json",
             "/events.json?accessKey=k", "/batch/events.json", "/events/abc.json",
             "/webhooks/segmentio.json", "/traces/r1.json", "/traces/r1.html",
             "/spans/x.json", "/cmd/app", "/cmd/app/a", "/cmd/app/a/accesskeys",
             "/cmd/app/a/data", "/nope", "/events/x", ""]
    assert [port_http.route_label(p) for p in paths] == [jax_http.route_label(p) for p in paths]


# -- the event loop on the port's event server --------------------------------------


@pytest.fixture()
def es():
    httpd, port, key, storage = port_event_server("asyncapp")
    yield {"port": port, "key": key, "storage": storage}
    stop(httpd)


def test_slowloris_partial_header_does_not_stall_others(es):
    slow = connect(es["port"])
    slow.sendall(b"GET / HT")          # a partial request line
    fast = connect(es["port"])
    t0 = time.perf_counter()
    fast.sendall(post_event_bytes(es["key"]))
    (status, _h, _b), = read_responses(fast, 1)
    assert status == 201 and time.perf_counter() - t0 < 5.0
    slow.sendall(b"TP/1.1\r\nHost: x\r\n\r\n")
    (status, _h, _b), = read_responses(slow, 1)
    assert status == 200
    slow.close()
    fast.close()


def test_partial_body_completes_and_others_proceed(es):
    body = json.dumps({"event": "buy", "entityType": "user", "entityId": "slowbody",
                       "targetEntityType": "item", "targetEntityId": "i9"}).encode()
    head = (b"POST /events.json?accessKey=" + es["key"].encode()
            + b" HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
            b"Content-Length: %d\r\n\r\n" % len(body))
    slow = connect(es["port"])
    slow.sendall(head + body[: len(body) // 2])
    fast = connect(es["port"])
    fast.sendall(post_event_bytes(es["key"], eid="fastu"))
    (status, _h, _b), = read_responses(fast, 1)
    assert status == 201
    fast.close()
    slow.sendall(body[len(body) // 2:])
    (status, _h, payload), = read_responses(slow, 1)
    assert status == 201 and b"eventId" in payload
    slow.close()


def test_idle_connection_reaped_by_loop(monkeypatch):
    monkeypatch.setenv("PIO_HTTP_IDLE_S", "1")
    httpd, port, _key, _st = port_event_server("reapapp")
    try:
        s = connect(port)
        s.sendall(b"GET / HT")
        t0 = time.perf_counter()
        assert read_to_close(s, timeout=10) == b""   # closed, no response owed
        assert time.perf_counter() - t0 < 8.0
        s.close()
    finally:
        stop(httpd)


def test_mid_response_disconnect_does_not_poison_server(es):
    for _ in range(3):
        c = connect(es["port"])
        c.sendall(post_event_bytes(es["key"], eid="ghost"))
        c.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
        c.close()                      # RST: the server's write fails
    time.sleep(0.2)
    ok = connect(es["port"])
    ok.sendall(post_event_bytes(es["key"], eid="alive"))
    (status, _h, _b), = read_responses(ok, 1)
    assert status == 201
    ok.close()


def test_pipelined_responses_ordered_with_distinct_rids(es):
    wire = (post_event_bytes(es["key"], eid="p1")
            + b"GET / HTTP/1.1\r\nHost: x\r\n\r\n"
            + b"GET /nope.json HTTP/1.1\r\nHost: x\r\n\r\n"
            + post_event_bytes(es["key"], eid="p2"))
    s = connect(es["port"])
    s.sendall(wire)
    resps = read_responses(s, 4)
    assert [r[0] for r in resps] == [201, 200, 401, 201]   # auth precedes routing
    rids = [r[1].get("x-request-id") for r in resps]
    assert all(rids) and len(set(rids)) == 4, rids
    s.close()


def test_pipelined_client_rids_echoed_in_order(es):
    reqs = b"".join(b"GET / HTTP/1.1\r\nHost: x\r\nX-Request-ID: pipe-%d\r\n\r\n" % k
                    for k in range(5))
    s = connect(es["port"])
    s.sendall(reqs)
    assert [r[1]["x-request-id"] for r in read_responses(s, 5)] == [
        f"pipe-{k}" for k in range(5)]
    s.close()


def test_connection_close_honored_mid_pipeline(es):
    wire = (b"GET / HTTP/1.1\r\nHost: x\r\n\r\n"
            + b"GET / HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n"
            + post_event_bytes(es["key"], eid="never-processed"))
    s = connect(es["port"])
    s.sendall(wire)
    resps = read_responses(s, 2)
    assert (resps[0][0], resps[0][1]["connection"]) == (200, "keep-alive")
    assert (resps[1][0], resps[1][1]["connection"]) == (200, "close")
    assert read_to_close(s) == b""
    s.close()
    assert not list(es["storage"].l_events.find(
        es["storage"].apps.get_by_name("asyncapp").id, entity_type="user",
        entity_id="never-processed"))


@pytest.mark.parametrize("wire,status", [
    (b"GARBAGE\r\n\r\n", 400),
    (b"POST /events.json HTTP/1.1\r\nHost: x\r\nContent-Length: 1_0\r\n\r\n", 400),
    (b"GET / HTTP/1.1\r\nHost: x\r\n"
     + b"".join(b"X-F-%d: y\r\n" % i for i in range(150)) + b"\r\n", 400),
    (b"POST /events.json HTTP/1.1\r\nHost: x\r\n"
     b"Content-Length: 27\r\nX-Foo: bar\r\n Content-Length: 7\r\n\r\n", 400),
    (b"POST /events.json HTTP/1.1\r\nHost: x\r\n"
     b"Content-Length: 27\r\nContent-Length: 7\r\n\r\n", 400),
    (b"POST /events.json HTTP/1.1\r\nHost: x\r\nTransfer-Encoding: chunked\r\n\r\n"
     b"5\r\nhello\r\n0\r\n\r\n", 501),
    (b"GET / HTTP/1.1\r\nX-Big: " + b"a" * 70000, 431),
])
def test_early_errors_close_and_never_advertise_keepalive(es, wire, status):
    """Malformed request lines, bad and conflicting Content-Length, header
    folding, over 100 headers (400), Transfer-Encoding (501) and a head
    over 64 KiB (431): the refusal says close and the socket closes."""
    s = connect(es["port"])
    s.sendall(wire)
    (got, headers, body), = read_responses(s, 1)
    assert got == status, wire[:40]
    assert headers["connection"] == "close"
    assert json.loads(body)["message"]
    assert read_to_close(s) == b""
    s.close()


def test_pipeline_after_close_marked_request_is_discarded(es):
    wire = (b"GET / HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n"
            + post_event_bytes(es["key"], eid="smuggled"))
    s = connect(es["port"])
    s.sendall(wire)
    (status, headers, _b), = read_responses(s, 1)
    assert status == 200 and headers["connection"] == "close"
    assert read_to_close(s) == b""
    s.close()
    check = connect(es["port"])
    check.sendall(b"GET /events.json?accessKey=" + es["key"].encode()
                  + b"&entityId=smuggled&entityType=user HTTP/1.1\r\nHost: x\r\n\r\n")
    (status, _h, payload), = read_responses(check, 1)
    assert status == 200 and json.loads(payload) == []
    check.close()


def test_expect_100_continue_interim_response(es):
    body = json.dumps({"event": "buy", "entityType": "user", "entityId": "expects",
                       "targetEntityType": "item", "targetEntityId": "i1"}).encode()
    s = connect(es["port"])
    s.sendall(b"POST /events.json?accessKey=" + es["key"].encode()
              + b" HTTP/1.1\r\nHost: x\r\nExpect: 100-continue\r\n"
              b"Content-Type: application/json\r\nContent-Length: %d\r\n\r\n" % len(body))
    s.settimeout(10)
    buf = b""
    while b"\r\n\r\n" not in buf:
        buf += s.recv(65536)
    assert buf.startswith(b"HTTP/1.1 100 Continue")
    s.sendall(body)
    (status, _h, payload), = read_responses(s, 1)
    assert status == 201 and b"eventId" in payload
    s.close()


def test_oversized_body_refused_without_buffering(monkeypatch):
    monkeypatch.setenv("PIO_HTTP_MAX_BODY", "1024")
    httpd, port, key, _st = port_event_server("bigapp")
    try:
        s = connect(port)
        s.sendall(b"POST /events.json?accessKey=" + key.encode()
                  + b" HTTP/1.1\r\nHost: x\r\nContent-Length: 10485760\r\n\r\n")
        (status, headers, _b), = read_responses(s, 1)
        assert status == 413 and headers["connection"] == "close"
        s.close()
    finally:
        stop(httpd)


def test_keepalive_unread_body_drained(es):
    """An early 401 leaves no body bytes in the stream: the next request
    on the same keep-alive connection parses from its request line."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", es["port"], timeout=20)
    body = json.dumps({"event": "buy", "entityType": "user", "entityId": "u1"})
    conn.request("POST", "/events.json?accessKey=WRONG", body,
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    assert r.status == 401
    r.read()
    conn.request("POST", f"/events.json?accessKey={es['key']}", body,
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    assert r.status == 201 and json.loads(r.read())["eventId"]
    conn.close()


def test_http_pipelined_requests_in_one_segment(es):
    s = connect(es["port"])
    one = post_event_bytes(es["key"])
    s.sendall(one + one)
    resps = read_responses(s, 2)
    assert [r[0] for r in resps] == [201, 201]
    assert all(b'"eventId"' in r[2] for r in resps)
    s.close()


def test_handler_pool_size_follows_the_setting(monkeypatch):
    """PIO_HTTP_POOL sets the handler threads (the micro-batch's cap on a
    query server); 0 runs handlers on the loop thread; the default is the
    core count clamped to 2-16, as in the JAX package."""
    import os

    for env, want in (("32", 32), ("0", 0), (None, max(2, min(16, os.cpu_count() or 1)))):
        if env is None:
            monkeypatch.delenv("PIO_HTTP_POOL", raising=False)
        else:
            monkeypatch.setenv("PIO_HTTP_POOL", env)
        httpd, port, key, _st = port_event_server(f"pool{env}")
        try:
            assert httpd._pool_size == want
            s = connect(port)
            s.sendall(post_event_bytes(key))
            assert read_responses(s, 1)[0][0] == 201
            s.close()
        finally:
            stop(httpd)
