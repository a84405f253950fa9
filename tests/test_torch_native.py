"""The port's native event-log scanner and native training read against the
JAX package's.

``scan_segments`` of both packages runs on the same segment files (unicode
escapes and raw UTF-8, a missing ``targetEntityId``, numeric, bool, null,
list and nested properties, a torn last line): the columns, dictionaries
and property columns are equal.  ``PEventStore.native_batch`` of both on
one store, written by either package, is equal, filters included; with a
tombstone both return None and read rows.  Two processes building the
scanner at once both load it.  Without a C++ compiler the port reads rows.
The UR's ``read_training`` through the native branch equals its row branch
(up to the order of dictionary codes, which follows the log there and the
time order here) and the JAX package's native branch exactly.  Everything
compares exactly.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from predictionio_tpu.models.universal_recommender import engine as jax_ur
from predictionio_tpu.native import scanner as jax_scanner
from predictionio_tpu.storage import App as JaxApp
from predictionio_tpu.storage import set_storage as jax_set_storage
from predictionio_tpu.storage.locator import Storage as JaxStorage
from predictionio_tpu.storage.locator import StorageConfig as JaxStorageConfig
from predictionio_tpu.store import columnar as jax_columnar
from predictionio_tpu.store.event_store import PEventStore as JaxPEventStore
from predictionio_tpu.storage.snapshot import apply_filters as jax_apply_filters
from predictionio_tpu_torch.models.universal_recommender import engine as ur
from predictionio_tpu_torch.native import build as port_build
from predictionio_tpu_torch.native import scanner
from predictionio_tpu_torch.storage import App, Storage, StorageConfig, set_storage
from predictionio_tpu_torch.store import columnar
from predictionio_tpu_torch.store.event_store import PEventStore, apply_filters

from _torch_event_cases import T0, jax_events, port_events, seeded_corpus

REPO = Path(__file__).resolve().parents[1]
SEEDS = [0, 1, 2]


@pytest.fixture(autouse=True)
def _scanners():
    if port_build.compiler() is None:
        pytest.skip("no C++ compiler")
    if not jax_scanner.native_available():
        # the JAX build writes one shared temporary file and may lose a race
        # to another process's build, whose library is in place by now
        jax_scanner._load_failed = False
        if not jax_scanner.native_available():
            pytest.skip("the JAX package's scanner did not build")


LINES = [
    {"eventId": "a1", "event": "view", "entityType": "user", "entityId": "u1",
     "targetEntityType": "item", "targetEntityId": "i1", "properties": {"rating": 4.5},
     "eventTime": "2026-01-01T00:00:00+00:00", "creationTime": "2026-01-01T00:00:00+00:00"},
    {"eventId": "a2", "event": "$set", "entityType": "item", "entityId": "i1",
     "properties": {"title": "café ☃ \U0001f600", "price": 12, "ratio": 0.25,
                    "on": True, "off": False, "none": None, "tags": ["x", "yé", 3, 2.5],
                    "nested": {"a": [1, {"b": "c"}]}, "empty": [], "neg": -7},
     "eventTime": "2026-01-02T03:04:05.678901+00:00",
     "creationTime": "2026-01-02T03:04:05+00:00"},
    {"eventId": "a3", "event": "buy", "entityType": "user", "entityId": "uü2",
     "eventTime": "2026-01-03T00:00:00Z", "creationTime": "2026-01-03T00:00:00Z"},
    {"eventId": "a4", "event": "$unset", "entityType": "item", "entityId": "i1",
     "properties": {"price": None}, "eventTime": "2026-01-04T00:00:00+01:00",
     "creationTime": "2026-01-04T00:00:00+01:00"},
    {"eventId": "a5", "event": "view", "entityType": "user", "entityId": "u1",
     "targetEntityType": "item", "targetEntityId": "ié2", "properties": {"rating": 3},
     "eventTime": "2026-01-05T00:00:00+00:00", "creationTime": "2026-01-05T00:00:00+00:00"},
]


def _write_segments(d: Path, torn: bool) -> list:
    """Three segments: compact JSON with \\u escapes, raw UTF-8 with
    spaces, and a last one whose final line is torn."""
    d.mkdir(parents=True, exist_ok=True)
    paths = [d / f"seg-{k:05d}.jsonl" for k in range(3)]
    paths[0].write_text("".join(json.dumps(x, separators=(",", ":"), sort_keys=True) + "\n"
                                for x in LINES[:3]))
    paths[1].write_text("".join(json.dumps(x, ensure_ascii=False) + "\n" for x in LINES[2:]),
                        encoding="utf-8")
    tail = json.dumps(LINES[0], sort_keys=True) + "\n"
    if torn:
        tail += json.dumps(LINES[1])[:40]
    paths[2].write_text(tail)
    return paths


def _assert_same_batch(got, want):
    for col in ("event_codes", "entity_type_codes", "entity_ids", "target_ids",
                "times_us", "ratings"):
        g, w = getattr(got, col), getattr(want, col)
        assert g.dtype == w.dtype, col
        np.testing.assert_array_equal(g, w, err_msg=col)
    for d in ("event_dict", "entity_type_dict", "entity_dict", "target_dict"):
        assert getattr(got, d).strings() == getattr(want, d).strings(), d
    assert (got.prop_columns is None) == (want.prop_columns is None)
    if want.prop_columns is None:
        return
    assert list(got.prop_columns) == list(want.prop_columns)
    for key, w in want.prop_columns.items():
        g = got.prop_columns[key]
        for f in ("rows", "kind", "num", "str_offs", "codes"):
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype, (key, f)
            np.testing.assert_array_equal(a, b, err_msg=f"{key}.{f}")
        assert g.dict.strings() == w.dict.strings(), key
        assert [g.value_at(j) for j in range(len(g))] == [w.value_at(j) for j in range(len(w))]


@pytest.mark.parametrize("torn", [False, True])
def test_scan_segments_matches_jax(tmp_path, torn):
    paths = _write_segments(tmp_path, torn)
    served = scanner.scans_served
    got = scanner.scan_segments(paths)
    assert scanner.scans_served == served + 1
    _assert_same_batch(got, jax_scanner.scan_segments(paths))
    assert len(got) == 7
    assert got.target_ids[2] == -1   # no targetEntityId


@pytest.mark.parametrize("threads", [1, 2, 8])
def test_scan_segments_thread_count_changes_nothing(tmp_path, threads):
    paths = _write_segments(tmp_path, torn=True)
    _assert_same_batch(scanner.scan_segments(paths, n_threads=threads),
                       jax_scanner.scan_segments(paths, n_threads=1))


def _jax_store(tmp_path, seed, n_batches=4, writer="jax"):
    """A store written by the JAX package (or by the port), several
    segments, read by both packages' stores."""
    import predictionio_tpu.storage.localfs as jax_localfs
    import predictionio_tpu_torch.storage.localfs as port_localfs

    src = {"type": "localfs", "path": str(tmp_path / "store")}
    cfg = dict(sources={"S": src},
               repositories={"METADATA": "S", "EVENTDATA": "S", "MODELDATA": "S"})
    jax_store, port_store = JaxStorage(JaxStorageConfig(**cfg)), Storage(StorageConfig(**cfg))
    app_id = jax_store.apps.insert(JaxApp(0, "nat"))
    if writer == "jax":
        mod, store, events = jax_localfs, jax_store, jax_events(seeded_corpus(seed))
    else:
        mod, store, events = port_localfs, port_store, port_events(seeded_corpus(seed))
    old = mod.SEGMENT_MAX_BYTES
    mod.SEGMENT_MAX_BYTES = 16384
    try:
        step = -(-len(events) // n_batches)
        for k in range(0, len(events), step):
            store.l_events.insert_batch(events[k:k + step], app_id)
    finally:
        mod.SEGMENT_MAX_BYTES = old
    return jax_store, port_store, app_id


NATIVE_FILTERS = [{}, {"event_names": ["purchase"]}, {"event_names": ["$set", "view", "nope"]},
                  {"entity_type": "item"}, {"entity_type": "nobody"},
                  {"start_time": "T+3000", "until_time": "T+9000"}]


def _filters(f):
    import datetime as dt

    out = dict(f)
    for k in ("start_time", "until_time"):
        if k in out:
            out[k] = dt.datetime.fromtimestamp(T0 + float(out[k][2:]), dt.timezone.utc)
    return out


@pytest.mark.parametrize("seed, writer", [(0, "jax"), (1, "port"), (2, "jax")])
def test_native_batch_matches_jax_on_one_store(tmp_path, seed, writer):
    """The native batch of one store, written by either package, is the
    same in both."""
    jax_store, port_store, _ = _jax_store(tmp_path, seed, writer=writer)
    assert len(port_store.l_events.segment_paths(1)) > 1
    for f in NATIVE_FILTERS:
        got = PEventStore.native_batch("nat", storage=port_store, **_filters(f))
        want = JaxPEventStore.native_batch("nat", storage=jax_store, **_filters(f))
        _assert_same_batch(got, want)
        _assert_same_batch(PEventStore.batch("nat", storage=port_store, **_filters(f)), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_a_tombstone_sends_both_packages_to_the_row_path(tmp_path, seed):
    jax_store, port_store, app_id = _jax_store(tmp_path, seed)
    assert port_store.l_events.delete("ev0000005", app_id)
    assert PEventStore.native_batch("nat", storage=port_store) is None
    assert JaxPEventStore.native_batch("nat", storage=jax_store) is None
    for f in NATIVE_FILTERS[:4]:
        got = PEventStore.batch("nat", storage=port_store, **_filters(f))
        want = JaxPEventStore.batch("nat", storage=jax_store, **_filters(f))
        assert got.prop_columns is None
        _assert_same_batch(got, dataclasses.replace(want, prop_columns=None))


def test_memory_store_has_no_native_batch():
    store = Storage(StorageConfig.memory())
    store.apps.insert(App(0, "m"))
    assert PEventStore.native_batch("m", storage=store) is None


def test_no_compiler_reads_rows(tmp_path, monkeypatch):
    """Without a C++ compiler ``native_available()`` is False and the
    training read takes the row path, as in the JAX package."""
    _, port_store, _ = _jax_store(tmp_path, 0)
    monkeypatch.setattr(port_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(port_build, "compiler", lambda: None)
    monkeypatch.setattr(scanner, "_lib", None)
    monkeypatch.setattr(scanner, "_load_failed", False)
    assert not scanner.native_available()
    assert PEventStore.native_batch("nat", storage=port_store) is None
    batch = PEventStore.batch("nat", storage=port_store)
    assert batch.prop_columns is None and len(batch) == len(
        list(port_store.l_events.find(1)))


_BUILD_RACE = r"""
import sys, time
from pathlib import Path
from predictionio_tpu_torch.native import build, scanner
build.BUILD_DIR = Path(sys.argv[1])
while time.time() < float(sys.argv[2]):
    time.sleep(0.005)
assert scanner.native_available(), "the scanner did not load"
print("loaded", scanner._lib._name)
"""


def test_two_processes_building_at_once_both_load(tmp_path):
    import time

    start = time.time() + 3.0
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_RACE, str(tmp_path / "b"),
                               str(start)], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.startswith("loaded")
    built = list((tmp_path / "b").iterdir())
    assert [p.suffix for p in built] == [".so"], built   # no temporary left


# -- columnar pieces ----------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_properties_and_filters_match_jax(tmp_path, seed):
    jax_store, port_store, _ = _jax_store(tmp_path, seed)
    paths = port_store.l_events.segment_paths(1)
    got, want = scanner.scan_segments(paths), jax_scanner.scan_segments(paths)
    for et in (None, "item", "user", "nobody"):
        g, w = columnar.fold_properties(got, et), jax_columnar.fold_properties(want, et)
        assert g == w
        for k in w:
            assert (g[k].first_updated, g[k].last_updated) == (
                w[k].first_updated, w[k].last_updated)
    assert columnar.fold_properties(got, "item") == port_store.l_events.aggregate_properties(
        1, "item")
    for f in NATIVE_FILTERS:
        _assert_same_batch(apply_filters(got, **_filters(f)),
                           jax_apply_filters(want, **_filters(f)))


@pytest.mark.parametrize("seed", SEEDS)
def test_concat_matches_jax(tmp_path, seed):
    """Batches with their own dictionaries are re-coded (the JAX package's
    ``BatchMerger`` order); batches that share them concatenate as they
    are."""
    _, port_store, _ = _jax_store(tmp_path, seed)
    paths = port_store.l_events.segment_paths(1)
    ports = [scanner.scan_segments([p]) for p in paths]
    jaxs = [jax_scanner.scan_segments([p]) for p in paths]
    _assert_same_batch(columnar.EventBatch.concat(ports), jax_columnar.EventBatch.concat(jaxs))
    whole = scanner.scan_segments(paths)
    mask = np.arange(len(whole)) % 3 == 0
    parts = [whole.subset(mask), whole.subset(~mask)]
    jwhole = jax_scanner.scan_segments(paths)
    _assert_same_batch(columnar.EventBatch.concat(parts),
                       jax_columnar.EventBatch.concat([jwhole.subset(mask),
                                                       jwhole.subset(~mask)]))


# -- the UR's training read ---------------------------------------------------


def _triples(td):
    """URTrainingData without its code order: per event type, the sorted
    (user, item, time) triples."""
    users = td.user_dict.strings()
    out = {}
    for name, (u, i, items, t) in td.interactions.items():
        out[name] = sorted(zip((users[x] for x in u), (items.str(int(x)) for x in i),
                               t.tolist()))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_ur_read_training_native_matches_rows_and_jax(tmp_path, monkeypatch, seed):
    jax_store, port_store, _ = _jax_store(tmp_path, seed)
    set_storage(port_store)
    jax_set_storage(jax_store)
    try:
        params = dict(app_name="nat", event_names=["purchase", "view"])
        served = scanner.scans_served
        native = ur.URDataSource(ur.URDataSourceParams(**params)).read_training()
        assert scanner.scans_served == served + 1
        want = jax_ur.URDataSource(jax_ur.URDataSourceParams(**params)).read_training()
        assert native.user_dict.to_state() == want.user_dict.to_state()
        for name, (wu, wi, wd, wt) in want.interactions.items():
            gu, gi, gd, gt = native.interactions[name]
            for g, w in ((gu, wu), (gi, wi), (gt, wt)):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
            assert gd.to_state() == wd.to_state()
        assert native.item_properties == want.item_properties and native.item_properties
        monkeypatch.setattr(scanner, "native_available", lambda: False)
        import predictionio_tpu_torch.native as port_native

        monkeypatch.setattr(port_native, "native_available", lambda: False)
        rows = ur.URDataSource(ur.URDataSourceParams(**params)).read_training()
        assert scanner.scans_served == served + 1
        assert _triples(rows) == _triples(native)
        assert rows.item_properties == native.item_properties
    finally:
        set_storage(None)
        jax_set_storage(None)
