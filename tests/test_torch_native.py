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
time order here) and the JAX package's native branch exactly.  The scan
core's header parse (``native/core.py``, ``data_plane.cpp``) reads a
PIOCOL01 file to the batch ``json.loads`` reads under ``PIO_NATIVE=on``
and ``off``, and the JAX ``read_batch``'s, lone surrogates included; with
the build simulated away the Python parse answers and the denial counts
once.  Everything compares exactly.
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
from predictionio_tpu_torch.native import core as ncore
from predictionio_tpu_torch.native import scanner
from predictionio_tpu_torch.storage import App, Storage, StorageConfig, set_storage
from predictionio_tpu_torch.store import columnar
from predictionio_tpu_torch.storage.snapshot import apply_filters
from predictionio_tpu_torch.store.event_store import PEventStore

from _torch_event_cases import T0, assert_same_batch, jax_events, port_events, seeded_corpus

REPO = Path(__file__).resolve().parents[1]
SEEDS = [0, 1, 2]


def _port_only(test):
    """A test of the port's own header-parse core: it runs whether or not
    the JAX package's scanner built."""
    test.port_only = True
    return test


@pytest.fixture(autouse=True)
def _scanners(request):
    if port_build.compiler() is None:
        pytest.skip("no C++ compiler")
    if getattr(request.function, "port_only", False):
        return
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


@pytest.mark.parametrize("torn", [False, True])
def test_scan_segments_matches_jax(tmp_path, torn):
    paths = _write_segments(tmp_path, torn)
    served = scanner.scans_served
    got = scanner.scan_segments(paths)
    assert scanner.scans_served == served + 1
    assert_same_batch(got, jax_scanner.scan_segments(paths))
    assert len(got) == 7
    assert got.target_ids[2] == -1   # no targetEntityId


@pytest.mark.parametrize("threads", [1, 2, 8])
def test_scan_segments_thread_count_changes_nothing(tmp_path, threads):
    paths = _write_segments(tmp_path, torn=True)
    assert_same_batch(scanner.scan_segments(paths, n_threads=threads),
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
        assert_same_batch(got, want)
        assert_same_batch(PEventStore.batch("nat", storage=port_store, **_filters(f)), want)


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
        assert_same_batch(got, dataclasses.replace(want, prop_columns=None))


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


def test_scanner_warns_as_jax_when_native_is_unavailable(tmp_path, monkeypatch, caplog):
    """A scanner that cannot build says so once through ``pio.native``, as
    the JAX scanner does, and the reads take the Python path."""
    monkeypatch.setattr(port_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(port_build, "compiler", lambda: None)

    def no_compiler(*args):
        raise OSError("no compiler")

    monkeypatch.setattr(jax_scanner._native_build, "build", no_compiler)
    for mod in (scanner, jax_scanner):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_load_failed", False)
    with caplog.at_level("WARNING", logger="pio.native"):
        assert not scanner.native_available() and not scanner.native_available()
        ours = [r.getMessage() for r in caplog.records if r.module == "scanner"]
        assert not jax_scanner.native_available()
    theirs = [r.getMessage() for r in caplog.records if r.module == "scanner"][len(ours):]
    assert scanner.log.name == jax_scanner.log.name == "pio.native"
    assert len(ours) == len(theirs) == 1
    assert ours[0].startswith("native scanner unavailable")
    assert theirs[0].startswith("native scanner unavailable")


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
        assert_same_batch(apply_filters(got, **_filters(f)),
                           jax_apply_filters(want, **_filters(f)))


@pytest.mark.parametrize("seed", SEEDS)
def test_pevent_store_aggregate_properties_folds_the_native_batch(tmp_path, monkeypatch,
                                                                  seed):
    """``PEventStore.aggregate_properties`` on localfs folds the special
    events' native batch, as the JAX package's does: the same maps as the
    per-event fold and as JAX, without parsing the log in Python."""
    jax_store, port_store, app_id = _jax_store(tmp_path, seed)
    for et in ("item", "user", "nobody"):
        want = JaxPEventStore.aggregate_properties("nat", et, storage=jax_store)
        rows = port_store.l_events.aggregate_properties(app_id, et)
        monkeypatch.setattr(type(port_store.l_events), "aggregate_properties",
                            lambda *a, **k: pytest.fail("the per-event fold ran"))
        got = PEventStore.aggregate_properties("nat", et, storage=port_store)
        monkeypatch.undo()
        assert got == rows == want
        for k in want:
            assert (got[k].first_updated, got[k].last_updated) == (
                want[k].first_updated, want[k].last_updated)


@pytest.mark.parametrize("seed", SEEDS)
def test_concat_matches_jax(tmp_path, seed):
    """Batches with their own dictionaries are re-coded (the JAX package's
    ``BatchMerger`` order); batches that share them concatenate as they
    are."""
    _, port_store, _ = _jax_store(tmp_path, seed)
    paths = port_store.l_events.segment_paths(1)
    ports = [scanner.scan_segments([p]) for p in paths]
    jaxs = [jax_scanner.scan_segments([p]) for p in paths]
    assert_same_batch(columnar.EventBatch.concat(ports), jax_columnar.EventBatch.concat(jaxs))
    whole = scanner.scan_segments(paths)
    mask = np.arange(len(whole)) % 3 == 0
    parts = [whole.subset(mask), whole.subset(~mask)]
    jwhole = jax_scanner.scan_segments(paths)
    assert_same_batch(columnar.EventBatch.concat(parts),
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


# -- the scan core's header parse ------------------------------------------------------


def _rand_str(rng):
    if rng.random() < 0.2:
        return "".join(rng.choice(list("héllo😀日本 ñ\"\\" + "abcXYZ"))
                       for _ in range(rng.integers(1, 8)))
    return "".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz"))
                   for _ in range(rng.integers(1, 10)))


def _random_container(path, n, seed):
    """A port-written PIOCOL01 file of ``n`` random events with property
    columns, event ids and meta; returns the batch written."""
    from predictionio_tpu_torch.storage.snapshot import ColumnarBuilder

    rng = np.random.default_rng(seed)
    b = ColumnarBuilder()
    for k in range(n):
        name = str(rng.choice(["buy", "view", "$set"]))
        d = {"event": name, "entityType": str(rng.choice(["user", "item"])),
             "entityId": f"u{rng.integers(0, max(n // 2, 1))}", "eventId": f"ev-{k}-{_rand_str(rng)}",
             "eventTime": f"2024-01-01T00:00:{k % 60:02d}+00:00"}
        if name != "$set" and rng.random() < 0.7:
            d["targetEntityId"] = f"i{rng.integers(0, 50)}"
        if rng.random() < 0.5:
            d["properties"] = {"rating": float(rng.random() * 5), "tag": _rand_str(rng),
                               "tags": [_rand_str(rng)], "on": bool(rng.random() < 0.5)}
        b.add(d)
    batch, ids = b.finish()
    columnar.write_batch(path, batch, ids, meta={"watermark": {"s": 12}, "é": [1.5]})
    return batch, ids


@_port_only
@pytest.mark.parametrize("seed", [3, 4])
def test_read_batch_native_and_python_parse_agree(tmp_path, monkeypatch, seed):
    p = tmp_path / "batch.pioc"
    batch, ids = _random_container(p, 400, seed)
    monkeypatch.setenv("PIO_NATIVE", "off")
    b0, i0, m0 = columnar.read_batch(p)
    monkeypatch.setenv("PIO_NATIVE", "on")
    calls = ncore.calls["scan"]
    b1, i1, m1 = columnar.read_batch(p)
    assert ncore.calls["scan"] == calls + 1
    jb, ji, jm = jax_columnar.read_batch(p)
    for got in (b0, b1):
        assert_same_batch(got, jb)
        assert_same_batch(got, batch)
    assert i0.tolist() == i1.tolist() == ji.tolist() == ids.tolist()
    assert m0 == m1 == jm == {"watermark": {"s": 12}, "é": [1.5]}


@_port_only
def test_read_batch_lone_surrogate_strings(tmp_path, monkeypatch):
    """JSON carries lone surrogates (Python's own json writes them); the
    native parse decodes them as ``surrogatepass`` does."""
    batch, _ = _random_container(tmp_path / "x.pioc", 8, 2)
    strings = ["ok", "bad\ud800end", "café", "\udfff", "\U0001f600\udc00"]
    batch = dataclasses.replace(batch, entity_dict=columnar.IdDict(strings))
    p = tmp_path / "surr.pioc"
    columnar.write_batch(p, batch)
    monkeypatch.setenv("PIO_NATIVE", "off")
    b0, _, _ = columnar.read_batch(p)
    monkeypatch.setenv("PIO_NATIVE", "on")
    calls = ncore.calls["scan"]
    b1, _, _ = columnar.read_batch(p)
    assert ncore.calls["scan"] == calls + 1
    jb, _, _ = jax_columnar.read_batch(p)
    assert b0.entity_dict.strings() == b1.entity_dict.strings() == jb.entity_dict.strings() \
        == strings


@_port_only
def test_no_toolchain_simulation(tmp_path, monkeypatch):
    """With the build gone, ``PIO_NATIVE=on`` reads through the Python parse
    with no change in the answer, and counts the denial once."""
    p = tmp_path / "x.pioc"
    _random_container(p, 60, 9)
    monkeypatch.setenv("PIO_NATIVE", "off")
    b0, i0, m0 = columnar.read_batch(p)
    monkeypatch.setattr(port_build, "load", lambda *a, **k: None)
    ncore.reset_for_tests()
    try:
        monkeypatch.setenv("PIO_NATIVE", "on")
        calls, denied = ncore.calls["scan"], ncore.fallbacks["no_build"]
        b1, i1, m1 = columnar.read_batch(p)
        columnar.read_batch(p)
        assert_same_batch(b1, b0)
        assert i1.tolist() == i0.tolist() and m1 == m0
        assert ncore.fallbacks["no_build"] == denied + 1   # once a core, not a call
        assert ncore.calls["scan"] == calls and ncore.active is False
    finally:
        ncore.reset_for_tests()


# -- the serve core (csr_gather, unique_i32, score_accum, topk_f32) -------------------


def _csr(rng, n_rows, nnz):
    counts = np.bincount(rng.integers(0, n_rows, nnz), minlength=n_rows)
    counts[rng.integers(0, n_rows, n_rows // 4)] = 0      # empty segments
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    rows = rng.integers(0, 5_000, int(indptr[-1])).astype(np.int32)
    w = (rng.random(int(indptr[-1])) * 4).astype(np.float32)
    return indptr, rows, w


@_port_only
@pytest.mark.parametrize("seed", SEEDS)
def test_serve_core_matches_numpy_oracle_and_jax(seed, monkeypatch):
    """Each serve-core call bit for bit its numpy oracle (``PIO_NATIVE=off``)
    and the JAX ``models.common`` on the same inputs: the CSR gather (ids
    out of range, repeated and empty segments), the unique union, the score
    accumulation with and without weights and a type weight, and the
    top-k's total order (ties, ±0.0, -inf)."""
    from predictionio_tpu.models import common as jax_common
    from predictionio_tpu_torch.models import common

    rng = np.random.default_rng(seed)
    indptr, rows, w = _csr(rng, 800, 20_000)
    ids = np.concatenate([rng.integers(-3, 803, 60), [5, 5]]).astype(np.int64)
    calls = ncore.calls["serve"]
    got = common.gather_csr_rows(indptr, ids, rows, w)
    assert ncore.calls["serve"] == calls + 1
    monkeypatch.setenv("PIO_NATIVE", "off")
    want = common.gather_csr_rows(indptr, ids, rows, w)
    jax_want = jax_common.gather_csr_rows(indptr, ids, rows, w)
    monkeypatch.delenv("PIO_NATIVE")
    for g, o, j in zip(got, want, jax_want):
        assert g.dtype == o.dtype == j.dtype
        np.testing.assert_array_equal(g, o)
        np.testing.assert_array_equal(g, j)
    (only_rows,) = common.gather_csr_rows(indptr, ids, rows)
    np.testing.assert_array_equal(only_rows, got[0])
    cand = ncore.unique_i32(got[0])
    np.testing.assert_array_equal(cand, np.unique(got[0]))
    assert len(ncore.unique_i32(np.zeros(0, np.int32))) == 0
    # two event types' sums over the union, as the UR's host scorer adds them
    other = rng.integers(0, 5_000, 3_000).astype(np.int32)
    cand = np.unique(np.concatenate([got[0], other])).astype(np.int32)
    for weights, type_w in ((got[1], 1.0), (None, 1.5), (got[1], 0.3)):
        out = np.empty(len(cand), np.float32)
        scratch = np.empty(len(cand), np.float64)
        ncore.score_accum(cand, got[0], weights, type_w, scratch, out, True)
        ncore.score_accum(cand, other, None, 2.0, scratch, out, False)
        rel = np.searchsorted(cand, got[0])
        s1 = (np.bincount(rel, weights=weights, minlength=len(cand)) if weights is not None
              else np.bincount(rel, minlength=len(cand))).astype(np.float32)
        if type_w != 1.0:
            s1 *= type_w
        s2 = np.bincount(np.searchsorted(cand, other), minlength=len(cand)).astype(np.float32)
        s2 *= 2.0
        np.testing.assert_array_equal(out.view(np.int32), (s1 + s2).view(np.int32))
    scores = np.round(rng.random(6_000).astype(np.float32) * 3) / 2
    scores[rng.integers(0, 6_000, 600)] = -np.inf
    scores[rng.integers(0, 6_000, 600)] = -0.0
    for k in (1, 37, 600, 6_000, 7_000):
        v, i = ncore.topk_f32(scores, k)
        jv, ji = jax_common.host_topk_desc(scores, k)
        monkeypatch.setenv("PIO_NATIVE", "off")
        ov, oi = common.host_topk_desc(scores, k)
        monkeypatch.delenv("PIO_NATIVE")
        np.testing.assert_array_equal(i, oi)
        np.testing.assert_array_equal(i, ji)
        np.testing.assert_array_equal(v.view(np.int32), ov.view(np.int32))


@_port_only
def test_serve_core_abi_and_fallback(monkeypatch):
    """The library reports ABI 4 (a stale build is never loaded); with no
    compiler the serve gate is closed and the oracle answers, counted once
    as ``no_build``."""
    from predictionio_tpu_torch.models import common

    assert ncore.lib().dp_abi_version() == ncore._ABI_VERSION == 4
    assert ncore.serve_enabled()
    monkeypatch.setattr(port_build, "load", lambda src, stem: None)
    ncore.reset_for_tests()
    try:
        before = ncore.fallbacks["no_build"]
        assert not ncore.serve_enabled()
        v, i = common.host_topk_desc(np.array([1.0, 3.0, 3.0], np.float32), 2)
        np.testing.assert_array_equal(i, [1, 2])
        assert ncore.fallbacks["no_build"] == before + 1
    finally:
        monkeypatch.undo()
        ncore.reset_for_tests()
    assert ncore.serve_enabled()
