"""Shared cases of the port's observability tests (tests/test_torch_tracing.py,
tests/test_torch_lineage.py, tests/test_torch_cluster_obs.py,
tests/test_torch_dashboard.py, tests/test_torch_sdk.py): both packages'
localfs stores, each package's flight recorder and lineage recorder fresh
around a test, a UR engine trained by each package on the same events,
polling with a deadline, and the masks that take the timing fields out of
a trace, a span journal or a lineage record before two packages' documents
are compared.

A trace or lineage record is finished after the response bytes are
queued (``http_util._execute`` records it in its middleware tail), so a
test that reads one after a response polls for it (``poll``) instead of
reading once.
"""

import json
import time
import urllib.error
import urllib.request

import pytest

from predictionio_tpu.obs import lineage as jax_lineage
from predictionio_tpu.obs import tracing as jax_tracing
from predictionio_tpu.storage import AccessKey as JaxAccessKey
from predictionio_tpu.storage import App as JaxApp
from predictionio_tpu.storage.locator import Storage as JaxStorage
from predictionio_tpu.storage.locator import StorageConfig as JaxStorageConfig
from predictionio_tpu_torch.obs import lineage as port_lineage
from predictionio_tpu_torch.obs import tracing as port_tracing
from predictionio_tpu_torch.storage import AccessKey as PortAccessKey
from predictionio_tpu_torch.storage import App as PortApp

from _torch_event_cases import port_localfs_storage

#: every poll of a trace, a lineage record or a server waits at most this long
DEADLINE_S = 5.0
#: socket timeout of every request these tests send
WAIT_S = 20.0

#: fields of a trace, journal span or lineage record that hold times; masked
#: before two packages' documents are compared (durations differ run to run)
TIME_KEYS = frozenset({"start", "end", "duration_s", "durationMs", "ts", "t",
                       "startedAt", "endedAt", "publishedAt", "lastSeen",
                       "offsetMs", "spanMs", "warm_s"})


def poll(fn, timeout=DEADLINE_S, every=0.02):
    """``fn()`` once it is truthy; AssertionError after ``timeout`` s."""
    deadline = time.monotonic() + timeout
    while True:
        got = fn()
        if got:
            return got
        if time.monotonic() > deadline:
            raise AssertionError(f"not there within {timeout} s")
        time.sleep(every)


def jax_localfs_storage(path):
    return JaxStorage(JaxStorageConfig(
        sources={"FS": {"type": "localfs", "path": str(path)}},
        repositories={r: "FS" for r in ("METADATA", "EVENTDATA", "MODELDATA")}))


def localfs_pair(tmp_path):
    """(JAX store, port store), each on its own localfs directory."""
    return (jax_localfs_storage(tmp_path / "jax-store"),
            port_localfs_storage(tmp_path / "port-store"))


def app_with_key(store, name, key, app_cls, key_cls):
    app_id = store.apps.insert(app_cls(0, name))
    store.access_keys.insert(key_cls(key, app_id, []))
    return app_id


def jax_app(store, name="obsapp", key="obskey"):
    return app_with_key(store, name, key, JaxApp, JaxAccessKey)


def port_app(store, name="obsapp", key="obskey"):
    return app_with_key(store, name, key, PortApp, PortAccessKey)


@pytest.fixture()
def recorders():
    """A fresh flight recorder in each package (retain by debug header
    only), restored to the lazy default afterwards; {"jax": .., "port": ..}."""
    out = {"jax": jax_tracing.FlightRecorder(slow_ms=10_000, sample_n=0),
           "port": port_tracing.FlightRecorder(slow_ms=10_000, sample_n=0)}
    jax_tracing.set_recorder(out["jax"])
    port_tracing.set_recorder(out["port"])
    yield out
    jax_tracing.set_recorder(None)
    port_tracing.set_recorder(None)


@pytest.fixture()
def lineages():
    """A fresh in-memory lineage recorder in each package, restored to the
    lazy default afterwards; {"jax": .., "port": ..}."""
    out = {"jax": jax_lineage.LineageRecorder(), "port": port_lineage.LineageRecorder()}
    jax_lineage.set_lineage(out["jax"])
    port_lineage.set_lineage(out["port"])
    yield out
    jax_lineage.set_lineage(None)
    port_lineage.set_lineage(None)
    jax_lineage.set_cluster_provider(None)
    port_lineage.set_cluster_provider(None)


def request(method, url, body=None, headers=None, raw=False):
    """(status, parsed JSON body, or the bytes with ``raw``)."""
    data = (body if isinstance(body, bytes) else json.dumps(body).encode()
            ) if body is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=WAIT_S) as resp:
            payload, status = resp.read(), resp.status
    except urllib.error.HTTPError as e:
        payload, status = e.read(), e.code
    return status, (payload if raw else json.loads(payload or b"null"))


def get_json(url):
    status, doc = request("GET", url)
    assert status == 200, (url, status, doc)
    return doc


def fetch_trace(base, rid):
    """``/traces/<rid>.json`` of the server at ``base``, polled until the
    middleware tail has recorded it."""
    def got():
        status, doc = request("GET", f"{base}/traces/{rid}.json")
        return doc if status == 200 else None
    return poll(got)


def mask(doc):
    """``doc`` with every timing field (``TIME_KEYS``, ``*_ms``) replaced
    by its type's name, recursively."""
    if isinstance(doc, dict):
        return {k: (type(v).__name__ if (k in TIME_KEYS or k.endswith("_ms"))
                    else mask(v)) for k, v in doc.items()}
    if isinstance(doc, list):
        return [mask(v) for v in doc]
    return doc


def span_tree(spans):
    """A trace's or journal's spans as (name, parent's name, masked attrs,
    error) in id order: the shape two packages must share."""
    by_id = {s["id"]: s for s in spans}
    return [(s["name"], by_id[s["parent"]]["name"] if s.get("parent") in by_id else None,
             mask(s.get("attrs") or {}), bool(s.get("error")))
            for s in sorted(spans, key=lambda s: s["id"])]


def trace_shape(doc):
    """A retained trace without its timings and worker tag."""
    return {"keys": sorted(doc), "rid": doc["rid"], "method": doc["method"],
            "route": doc["route"], "status": doc["status"], "reason": doc["reason"],
            "spans": span_tree(doc["spans"])}


UR_VARIANT = {
    "id": "obs-ur", "engineFactory": "universal_recommender",
    "datasource": {"params": {"appName": "obsapp", "eventNames": ["purchase", "view"]}},
    "algorithms": [{"name": "ur", "params": {
        "appName": "obsapp", "maxCorrelatorsPerItem": 8}}],
}

UR_QUERIES = [{"user": "u1", "num": 4}, {"user": "u20", "num": 3},
              {"item": "e1", "num": 3}, {"user": "stranger", "num": 2}]
