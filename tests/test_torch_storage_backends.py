"""The JAX ``tests/test_storage.py`` cases run on both packages, over every
backend the locator builds: memory, localfs, sql (in memory and in a file),
sharedfs and sharded (3 shards x 2 replicas).

Each case runs the same operations on a JAX store and a port store of the
same type (each in its own directory) and holds the port's answers equal to
the JAX package's: ids, records, ``find`` in its order, columnar batches
with their dictionaries in the same order.  Cases on one directory hold what
one package wrote against what the other reads (localfs, a SQLite file,
sharedfs, sharded).  The sharedfs and sql cases of the JAX suite
(concurrent writers, the native scan, crash-safe app inserts, channel-id
probes, multi-writer compaction, durability across reopens, the delta-tail
capability) run here too.
"""

import datetime as dt

import numpy as np
import pytest

from _torch_event_cases import (
    assert_same_batch,
    jax_events,
    port_events,
    seeded_corpus,
)
from predictionio_tpu.events import DataMap as JaxDataMap
from predictionio_tpu.events import Event as JaxEvent
from predictionio_tpu.storage import AccessKey as JaxAccessKey
from predictionio_tpu.storage import App as JaxApp
from predictionio_tpu.storage import Channel as JaxChannel
from predictionio_tpu.storage import EngineInstance as JaxEngineInstance
from predictionio_tpu.storage.locator import Storage as JaxStorage
from predictionio_tpu.storage.locator import StorageConfig as JaxStorageConfig
from predictionio_tpu_torch.events.event import DataMap, Event
from predictionio_tpu_torch.storage import (
    AccessKey,
    App,
    Channel,
    EngineInstance,
    Storage,
    StorageConfig,
    base,
    locator,
)

BACKENDS = ["memory", "localfs", "sql", "sqlfile", "sharedfs", "sharded"]
FILE_BACKENDS = ["localfs", "sqlfile", "sharedfs", "sharded"]
REPOS = ("METADATA", "EVENTDATA", "MODELDATA")


def ts(h):
    return dt.datetime(2026, 1, 1, h, tzinfo=dt.timezone.utc)


def _src(kind, root):
    """The JAX suite's ``storage`` fixture's source of ``kind`` under ``root``."""
    if kind == "memory":
        return {"type": "memory"}
    if kind == "localfs":
        return {"type": "localfs", "path": str(root / "store")}
    if kind == "sql":
        return {"type": "sql", "path": ":memory:"}
    if kind == "sharedfs":
        return {"type": "sharedfs", "path": str(root / "shared")}
    if kind == "sharded":
        return {"type": "sharded", "path": str(root / "sharded"), "shards": "3",
                "replicas": "2"}
    return {"type": "sql", "path": str(root / "pio.db")}


def _cfg(kind, root):
    return dict(sources={"S": _src(kind, root)}, repositories={r: "S" for r in REPOS})


class Pkg:
    """One package's storage and its constructors."""

    def __init__(self, name, storage):
        self.name, self.st = name, storage
        jax = name == "jax"
        self.App = JaxApp if jax else App
        self.AccessKey = JaxAccessKey if jax else AccessKey
        self.Channel = JaxChannel if jax else Channel
        self.EngineInstance = JaxEngineInstance if jax else EngineInstance
        self.Event = JaxEvent if jax else Event
        self.DataMap = JaxDataMap if jax else DataMap
        self.events = jax_events if jax else port_events

    def close(self):
        ev = self.st.l_events
        if hasattr(ev, "close"):
            ev.close()


@pytest.fixture(params=BACKENDS)
def pair(request, tmp_path):
    """(JAX, port): the same backend type, each package in its own directory."""
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
    j = Pkg("jax", JaxStorage(JaxStorageConfig(**_cfg(request.param, tmp_path / "jax"))))
    p = Pkg("port", Storage(StorageConfig(**_cfg(request.param, tmp_path / "port"))))
    yield j, p
    p.close()
    j.close()


@pytest.fixture(params=FILE_BACKENDS)
def shared_dir(request, tmp_path):
    """(kind, JAX, port) over ONE directory of a file-backed backend."""
    cfg = _cfg(request.param, tmp_path)
    j = Pkg("jax", JaxStorage(JaxStorageConfig(**cfg)))
    p = Pkg("port", Storage(StorageConfig(**cfg)))
    yield request.param, j, p
    p.close()
    j.close()


def _both(pair, fn):
    """``fn`` on the JAX side and on the port side; the two results."""
    j, p = pair
    return fn(j), fn(p)


def _ev_key(e):
    return (e.event_id, e.event, e.entity_type, e.entity_id, e.target_entity_type,
            e.target_entity_id, dict(e.properties), e.event_time, e.creation_time)


# -- the JAX suite's generic cases --------------------------------------------------------


def test_apps_crud(pair):
    def run(k):
        st = k.st
        app_id = st.apps.insert(k.App(0, "myapp", "desc"))
        out = [app_id, st.apps.get(app_id).name, st.apps.get_by_name("myapp").id,
               st.apps.insert(k.App(0, "myapp"))]
        app2 = st.apps.insert(k.App(0, "other"))
        out += [app2 != app_id, sorted(a.name for a in st.apps.get_all()),
                st.apps.delete(app2), st.apps.get(app2)]
        return out

    got, want = _both(pair, run)
    assert got == want
    assert want[0] is not None and want[3] is None


def test_access_keys_and_channels(pair):
    def run(k):
        st = k.st
        app_id = st.apps.insert(k.App(0, "a1"))
        key = st.access_keys.insert(k.AccessKey("", app_id, ["buy"]))
        ak = st.access_keys.get(key)
        ch = st.channels.insert(k.Channel(0, "backfill", app_id))
        return [ak.app_id, ak.events, len(st.access_keys.get_by_app_id(app_id)),
                ch, st.channels.get(ch).name,
                st.channels.insert(k.Channel(0, "backfill", app_id)),
                st.channels.get_by_app_id(app_id)[0].id,
                st.access_keys.delete(key), st.access_keys.get(key)]

    got, want = _both(pair, run)
    assert got == want


def _crud_events(k):
    return [
        k.Event(event="view", entity_type="user", entity_id="u1", target_entity_type="item",
                target_entity_id="i1", event_time=ts(1), event_id="v1", creation_time=ts(1)),
        k.Event(event="buy", entity_type="user", entity_id="u1", target_entity_type="item",
                target_entity_id="i2", event_time=ts(2), event_id="b1", creation_time=ts(2)),
        k.Event(event="view", entity_type="user", entity_id="u2", target_entity_type="item",
                target_entity_id="i1", event_time=ts(3), event_id="v2", creation_time=ts(3)),
        k.Event(event="$set", entity_type="item", entity_id="i1",
                properties=k.DataMap({"cat": "x"}), event_time=ts(4), event_id="s1",
                creation_time=ts(4)),
    ]


def test_events_crud_and_filters(pair):
    def run(k):
        ev = k.st.l_events
        ev.init(1)
        ids = ev.insert_batch(_crud_events(k), 1)
        out = [ids, _ev_key(ev.get(ids[0], 1))]
        for kw in ({}, {"event_names": ["view"]}, {"entity_type": "user", "entity_id": "u1"},
                   {"start_time": ts(2), "until_time": ts(4)}, {"reversed_order": True},
                   {"limit": 2}, {"target_entity_id": "i1"}):
            out.append([_ev_key(e) for e in ev.find(1, **kw)])
        ev.insert(k.Event(event="view", entity_type="user", entity_id="u9", event_time=ts(1),
                          event_id="c7", creation_time=ts(1)), 1, channel_id=7)
        out += [len(list(ev.find(1))), [e.event_id for e in ev.find(1, channel_id=7)]]
        out += [ev.delete(ids[1], 1), [e.event_id for e in ev.find(1)], ev.get(ids[1], 1)]
        return out

    got, want = _both(pair, run)
    assert got == want
    assert len(want[2]) == 4 and want[-1] is None


def test_aggregate_via_storage(pair):
    def run(k):
        ev = k.st.l_events
        ev.init(2)
        for q, (et, eid, props, h) in enumerate([("item", "i1", {"a": 1}, 1),
                                                 ("item", "i1", {"b": 2}, 2),
                                                 ("user", "u1", {"z": 3}, 1)]):
            ev.insert(k.Event(event="$set", entity_type=et, entity_id=eid,
                              properties=k.DataMap(props), event_time=ts(h),
                              event_id=f"p{q}", creation_time=ts(h)), 2)
        snap = ev.aggregate_properties(2, "item")
        return {key: (dict(pm), pm.first_updated, pm.last_updated) for key, pm in snap.items()}

    got, want = _both(pair, run)
    assert got == want and want["i1"][0] == {"a": 1, "b": 2}


def test_engine_instances(pair):
    def run(k):
        st = k.st.engine_instances
        inst = k.EngineInstance(id="", status="INIT", start_time=ts(1), end_time=None,
                                engine_id="e1", engine_version="1", engine_variant="default",
                                engine_factory="f", data_source_params='{"x": 1}')
        iid = st.insert(inst)
        got = st.get(iid)
        out = [got.status, got.start_time, got.data_source_params]
        got.status, got.end_time = "COMPLETED", ts(2)
        out.append(st.update(got))
        latest = st.get_latest_completed("e1", "1", "default")
        out += [latest.id == iid, latest.end_time]
        iid2 = st.insert(k.EngineInstance(
            id="", status="COMPLETED", start_time=ts(5), end_time=ts(6), engine_id="e1",
            engine_version="1", engine_variant="default", engine_factory="f"))
        out += [st.get_latest_completed("e1", "1", "default").id == iid2,
                len(st.get_all()), st.delete(iid), st.get(iid)]
        return out

    got, want = _both(pair, run)
    assert got == want


def test_models_blob_store(pair):
    def run(k):
        st = k.st.models
        st.insert("abc123", b"\x00\x01binary")
        return [st.get("abc123"), st.delete("abc123"), st.get("abc123")]

    got, want = _both(pair, run)
    assert got == want == [b"\x00\x01binary", True, None]


def test_pevents_find_batches(pair):
    """10 events in batches of 4 (a snapshot-first backend serves one
    merged batch): the same batches in both packages."""
    def run(k):
        ev = k.st.l_events
        ev.init(3)
        for q in range(10):
            ev.insert(k.Event(event="view", entity_type="user", entity_id=f"u{q % 3}",
                              target_entity_type="item", target_entity_id=f"i{q % 4}",
                              event_time=ts(q % 23), event_id=f"e{q}",
                              creation_time=ts(q % 23)), 3)
        return list(k.st.p_events.find_batches(3, batch_size=4))

    got, want = _both(pair, run)
    assert [len(b) for b in got] == [len(b) for b in want]
    assert sum(len(b) for b in want) == 10
    for g, w in zip(got, want):
        assert_same_batch(g, w)


def test_compact_all_backends(pair):
    def run(k):
        ev = k.st.l_events
        ev.init(9)
        ev.insert_batch([k.Event(event="buy", entity_type="user", entity_id=f"u{q}",
                                 event_time=ts(q % 20), event_id=f"e{q}",
                                 creation_time=ts(q % 20)) for q in range(20)], 9)
        stats = ev.compact(9, before=ts(10))
        return stats, [_ev_key(e) for e in ev.find(9)]

    got, want = _both(pair, run)
    assert got == want
    stats, left = want
    assert stats["expired"] > 0 and stats["kept"] == len(left)


@pytest.mark.parametrize("seed", [1, 2])
def test_seeded_corpus_reads_the_same(pair, seed):
    """A seeded corpus (out of time order, repeated times, property events):
    ``find`` in its order and limits, and ``find_batches`` with and without
    event names, equal in both packages on every backend."""
    specs = seeded_corpus(seed)

    def run(k):
        app_id = k.st.apps.insert(k.App(0, "corpus"))
        k.st.l_events.insert_batch(k.events(specs), app_id)
        ev = k.st.l_events
        out = {"find": [_ev_key(e) for e in ev.find(app_id)],
               "rev": [e.event_id for e in ev.find(app_id, limit=25, reversed_order=True)],
               "entity": [e.event_id for e in ev.find(app_id, entity_type="user",
                                                      entity_id="u3")],
               "named": [e.event_id for e in ev.find(app_id, event_names=["view"],
                                                     limit=30)]}
        out["batches"] = list(k.st.p_events.find_batches(app_id))
        out["batches_named"] = list(k.st.p_events.find_batches(
            app_id, event_names=["purchase", "view"]))
        return out

    got, want = _both(pair, run)
    for key in ("find", "rev", "entity", "named"):
        assert got[key] == want[key], key
    for key in ("batches", "batches_named"):
        assert len(got[key]) == len(want[key])
        for g, w in zip(got[key], want[key]):
            assert_same_batch(g, w)


@pytest.mark.parametrize("direction", ["jax_writes", "port_writes"])
def test_one_directory_reads_the_same_in_both(shared_dir, direction):
    """One package writes a file-backed store (metadata, events, a model
    blob, an engine instance); the other reads every record and event back
    as the writer does."""
    kind, j, p = shared_dir
    w, r = (j, p) if direction == "jax_writes" else (p, j)
    app_id = w.st.apps.insert(w.App(0, "both", "desc"))
    key = w.st.access_keys.insert(w.AccessKey("k-" + direction, app_id, ["view"]))
    ch = w.st.channels.insert(w.Channel(0, "side", app_id))
    w.st.l_events.insert_batch(w.events(seeded_corpus(3)), app_id)
    w.st.l_events.insert_batch(w.events(seeded_corpus(4)[:40]), app_id, ch)
    w.st.models.insert("m1", b"\x00blob")
    iid = w.st.engine_instances.insert(w.EngineInstance(
        id="", status="COMPLETED", start_time=ts(1), end_time=ts(2), engine_id="e",
        engine_version="1", engine_variant="v", engine_factory="f"))
    for k in (w, r):
        st = k.st
        assert st.apps.get(app_id).name == "both" and st.apps.get_by_name("both").id == app_id
        assert st.access_keys.get(key).events == ["view"]
        assert st.channels.get(ch).name == "side"
        assert st.models.get("m1") == b"\x00blob"
        inst = st.engine_instances.get_latest_completed("e", "1", "v")
        assert inst.id == iid and inst.end_time == ts(2)
    assert [_ev_key(e) for e in r.st.l_events.find(app_id)] == [
        _ev_key(e) for e in w.st.l_events.find(app_id)]
    assert [_ev_key(e) for e in r.st.l_events.find(app_id, channel_id=ch)] == [
        _ev_key(e) for e in w.st.l_events.find(app_id, channel_id=ch)]
    for kw in ({}, {"event_names": ["purchase", "view"]}):
        g, wb = (list(k.st.p_events.find_batches(app_id, **kw)) for k in (r, w))
        assert len(g) == len(wb)
        for a, b in zip(g, wb):
            assert_same_batch(a, b)
    assert r.st.l_events.aggregate_properties(app_id, "item") == \
        w.st.l_events.aggregate_properties(app_id, "item")


def test_jax_event_server_writes_read_the_same(shared_dir):
    """Events the JAX event server appended (its own ids and creation times)
    through each file-backed store read the same in the port: ``find`` in
    its order and the columnar batch."""
    from _torch_event_cases import jax_event_server_writes

    kind, j, p = shared_dir
    app_id = jax_event_server_writes(j.st, "served", seeded_corpus(14)[:150])
    assert [_ev_key(e) for e in p.st.l_events.find(app_id)] == [
        _ev_key(e) for e in j.st.l_events.find(app_id)]
    g, w = (list(k.st.p_events.find_batches(app_id)) for k in (p, j))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert_same_batch(a, b)


def test_delta_tail_on_the_backends_that_have_it(shared_dir):
    """``scan_tail_from`` / ``scan_events_up_to`` / ``tombstone_state`` on
    one directory: the port's reads equal the JAX package's (sql has no
    delta tail in either package)."""
    kind, j, p = shared_dir
    assert base.delta_tail_supported(p.st.l_events) == (kind != "sqlfile")
    if kind == "sqlfile":
        return
    app_id = j.st.apps.insert(JaxApp(0, "tail"))
    j.st.l_events.insert_batch(jax_events(seeded_corpus(5)), app_id)
    first = [k.st.l_events.scan_tail_from(app_id, None, {}, base=None, heads=None)
             for k in (p, j)]
    for a, b in ((first[0], first[1]),):
        assert_same_batch(a["batch"], b["batch"])
        assert a["watermark"] == b["watermark"] and a["events"] == b["events"]
    p.st.l_events.insert_batch(port_events(seeded_corpus(6)[:50]), app_id)
    ev_id = next(iter(j.st.l_events.find(app_id))).event_id
    tails = [k.st.l_events.scan_tail_from(app_id, None, f["watermark"], base=None,
                                          heads=f.get("heads"))
             for k, f in zip((p, j), first)]
    assert_same_batch(tails[0]["batch"], tails[1]["batch"])
    assert tails[0]["events"] == tails[1]["events"] == 50
    upto = [k.st.l_events.scan_events_up_to(app_id, None, t["watermark"],
                                            heads=t.get("heads"))
            for k, t in zip((p, j), tails)]
    assert_same_batch(upto[0]["batch"], upto[1]["batch"])
    assert p.st.l_events.delete(ev_id, app_id)
    assert p.st.l_events.tombstone_state(app_id) == j.st.l_events.tombstone_state(app_id) \
        == frozenset({ev_id})


# -- sql ------------------------------------------------------------------------------------


def test_sql_backend_durable_across_reopen(tmp_path):
    """A second client over the same database file sees everything the first
    wrote; a file the JAX package wrote reads the same in the port."""
    from predictionio_tpu.storage.sql import SQLSource as JaxSQLSource
    from predictionio_tpu_torch.storage.sql import SQLSource

    for name, cls, ev_cls, app_cls in (("port", SQLSource, Event, App),
                                       ("jax", JaxSQLSource, JaxEvent, JaxApp)):
        db = str(tmp_path / f"{name}.db")
        s1 = cls(db)
        app_id = s1.apps.insert(app_cls(0, "durable"))
        s1.events.insert(ev_cls(event="buy", entity_type="user", entity_id="u1",
                                event_time=ts(1), event_id="x1", creation_time=ts(1)), app_id)
        s1.models.insert("m1", b"blob")
        s1.client.conn.close()
        s2 = SQLSource(db)
        assert s2.apps.get_by_name("durable").id == app_id
        assert [_ev_key(e) for e in s2.events.find(app_id)] == [
            _ev_key(e) for e in JaxSQLSource(db).events.find(app_id)]
        assert s2.models.get("m1") == b"blob"


def test_sql_timestamps_round_trip_as_jax(tmp_path):
    """``_ts`` / ``_from_ts``: the stored REAL and the time read back are the
    JAX package's, microseconds and naive times included."""
    from predictionio_tpu.storage import sql as jax_sql
    from predictionio_tpu_torch.storage import sql

    rng = np.random.default_rng(3)
    for _ in range(200):
        t = dt.datetime(2000, 1, 1, tzinfo=dt.timezone.utc) + dt.timedelta(
            microseconds=int(rng.integers(0, 10**15)))
        for v in (t, t.replace(tzinfo=None), t.astimezone(dt.timezone(dt.timedelta(hours=5)))):
            assert sql._ts(v) == jax_sql._ts(v)
            assert sql._from_ts(sql._ts(v)) == jax_sql._from_ts(jax_sql._ts(v))


def test_sql_scan_streams_unordered_with_pushdown(tmp_path):
    """``scan`` (no ORDER BY, a cursor fetched in pages) and ``find`` with
    the WHERE pushdown answer as the JAX SQL store does."""
    from predictionio_tpu.storage.sql import SQLSource as JaxSQLSource
    from predictionio_tpu_torch.storage.sql import SQLSource

    specs = seeded_corpus(8)
    stores = [SQLSource(str(tmp_path / "p.db")), JaxSQLSource(str(tmp_path / "j.db"))]
    stores[0].events.insert_batch(port_events(specs), 1)
    stores[1].events.insert_batch(jax_events(specs), 1)
    for kw in ({}, {"event_names": ["purchase"]}, {"event_names": []},
               {"entity_type": "item", "start_time": ts(0)}, {"target_entity_type": "item"}):
        got, want = ([_ev_key(e) for e in s.events.scan(1, **kw)] for s in stores)
        assert got == want, kw
    for kw in ({"limit": 10, "reversed_order": True}, {"entity_type": "user", "entity_id": "u2"},
               {"target_entity_id": "i3"}):
        got, want = ([_ev_key(e) for e in s.events.find(1, **kw)] for s in stores)
        assert got == want, kw


def test_delta_tail_capability_helpers(tmp_path):
    """The capability probe and its error for a backend without the delta
    tail: sql has none, the others do."""
    from predictionio_tpu_torch.storage import memory
    from predictionio_tpu_torch.storage.localfs import FSEvents
    from predictionio_tpu_torch.storage.sharded import ShardedEvents
    from predictionio_tpu_torch.storage.sharedfs import SharedFSEvents
    from predictionio_tpu_torch.storage.sql import SQLSource

    sh = ShardedEvents(tmp_path / "sh", shards=2, replicas=1)
    try:
        for ev in (memory.MemEvents(), FSEvents(tmp_path / "fs"),
                   SharedFSEvents(tmp_path / "shared"), sh):
            assert base.delta_tail_supported(ev)
    finally:
        sh.close()
    sql_events = SQLSource(":memory:").events
    assert not base.delta_tail_supported(sql_events)
    with pytest.raises(base.StoreCapabilityError) as ei:
        base.require_delta_tail(sql_events, "pio deploy --follow")
    assert "scan_tail_from" in str(ei.value) and "SQLEvents" in str(ei.value)


# -- sharedfs -------------------------------------------------------------------------------


def _shared_events(root, tag):
    from predictionio_tpu_torch.storage import sharedfs

    return sharedfs.SharedFSEvents(root / "shared", writer_tag=tag)


def test_sharedfs_concurrent_writers_one_log(tmp_path):
    """Two writers (two hosts) ingest one (app, channel); every reader sees
    the union, segments never collide, a tombstone of one hides the event
    for all, and the JAX reader sees the same log."""
    from predictionio_tpu.storage import sharedfs as jax_sharedfs
    from predictionio_tpu_torch.storage import sharedfs

    w1, w2 = _shared_events(tmp_path, "hostA-1"), _shared_events(tmp_path, "hostB-2")
    for k in range(30):
        (w1 if k % 2 else w2).insert_batch(
            [Event(event="buy", entity_type="user", entity_id=f"u{k}",
                   target_entity_type="item", target_entity_id=f"i{k % 7}",
                   event_time=ts(k % 20), event_id=f"e{k}", creation_time=ts(k % 20))], 1)
    reader = sharedfs.SharedFSEvents(tmp_path / "shared")
    jreader = jax_sharedfs.SharedFSEvents(tmp_path / "shared")
    assert sum(1 for _ in reader._iter_raw(1, None)) == 30
    assert {s.name.split("-")[1] for s in reader.segment_paths(1)} == {"hostA", "hostB"}
    assert reader.segment_paths(1) == jreader.segment_paths(1)
    victim = next(reader._iter_raw(1, None)).event_id
    assert w2.delete(victim, 1)
    assert all(e.event_id != victim for e in reader._iter_raw(1, None))
    assert [e.event_id for e in reader.find(1)] == [e.event_id for e in jreader.find(1)]
    assert sharedfs.writer_id().endswith(f"-{__import__('os').getpid()}")
    assert sharedfs.writer_id() == jax_sharedfs.writer_id()


def test_sharedfs_native_scan_and_training(tmp_path):
    """The native scanner and the staged read run over per-writer sharedfs
    segments: ``PEventStore.batch`` equals the JAX package's on the same
    prefix, property columns included."""
    from predictionio_tpu.store.event_store import PEventStore as JaxPEventStore
    from predictionio_tpu_torch.native import scanner
    from predictionio_tpu_torch.store.event_store import PEventStore

    if not scanner.native_available():
        pytest.skip("no C++ compiler: the native scanner did not build")
    cfg = _cfg("sharedfs", tmp_path)
    storage, jstorage = Storage(StorageConfig(**cfg)), JaxStorage(JaxStorageConfig(**cfg))
    app_id = storage.apps.insert(App(0, "shapp"))
    storage.l_events.insert_batch(port_events(seeded_corpus(12)), app_id)
    served = scanner.scans_served
    batch = PEventStore.batch("shapp", storage=storage)
    assert scanner.scans_served == served + 1
    assert len(batch) == len(seeded_corpus(12)) and batch.prop_columns is not None
    assert_same_batch(batch, JaxPEventStore.batch("shapp", storage=jstorage))


def test_sharedfs_app_insert_crash_recovery(tmp_path):
    """A crash between the name claim and the id claim leaves a record a
    retry completes, with the id the JAX package would give."""
    from predictionio_tpu.storage import sharedfs as jax_sharedfs
    from predictionio_tpu_torch.storage import sharedfs

    got = {}
    for name, mod, app_cls in (("port", sharedfs, App), ("jax", jax_sharedfs, JaxApp)):
        apps = mod.SharedApps(tmp_path / name)
        apps._names.put_new(mod._safe_name("wedged"), {"id": 0, "name": "wedged",
                                                       "description": ""})
        assert apps.get_by_name("wedged") is None
        app_id = apps.insert(app_cls(0, "wedged", "retried"))
        assert app_id and apps.get_by_name("wedged").id == app_id
        assert apps.get(app_id).name == "wedged"
        got[name] = (app_id, apps.insert(app_cls(0, "wedged")))
    assert got["port"] == got["jax"] and got["port"][1] is None


def test_sharedfs_channel_id_collision_probes(tmp_path, monkeypatch):
    """Two channels whose hash ids collide get distinct (probed) ids."""
    from predictionio_tpu_torch.storage import sharedfs

    chans = sharedfs.SharedChannels(tmp_path / "shared")
    monkeypatch.setattr(sharedfs.zlib, "crc32", lambda b: 42)
    c1 = chans.insert(Channel(0, "one", 1))
    c2 = chans.insert(Channel(0, "two", 1))
    assert c1 and c2 and c1 != c2
    assert chans.get(c1).name == "one" and chans.get(c2).name == "two"
    assert chans.delete(c1) and chans.get(c1) is None and chans.get(c2).name == "two"


def test_sharedfs_record_names_and_ids_equal_jax(tmp_path):
    """The record file names (``_safe_name``) and claimed ids are the JAX
    package's, so either package reads the other's records."""
    from predictionio_tpu.storage import sharedfs as jax_sharedfs
    from predictionio_tpu_torch.storage import sharedfs

    for s in ("app", "ü-nicode ☃", "a/b\\c", "x" * 80, ""):
        assert sharedfs._safe_name(s) == jax_sharedfs._safe_name(s)
    names = ["a1", "a2", "shop", "☃"]
    port_apps = sharedfs.SharedApps(tmp_path / "p")
    jax_apps = jax_sharedfs.SharedApps(tmp_path / "j")
    assert [port_apps.insert(App(0, n)) for n in names] == [
        jax_apps.insert(JaxApp(0, n)) for n in names]
    assert sorted(p.name for p in (tmp_path / "p").rglob("*.json")) == sorted(
        p.name for p in (tmp_path / "j").rglob("*.json"))


def test_compact_on_sharedfs_multiwriter(tmp_path, monkeypatch):
    from predictionio_tpu_torch.storage import localfs as lfs
    from predictionio_tpu_torch.storage import sharedfs

    monkeypatch.setattr(lfs, "SEGMENT_MAX_BYTES", 2048)
    w1 = sharedfs.SharedFSEvents(tmp_path / "sh", writer_tag="hostA-1")
    w2 = sharedfs.SharedFSEvents(tmp_path / "sh", writer_tag="hostB-2")
    for k in range(40):
        (w1 if k % 2 else w2).insert_batch(
            [Event(event="buy", entity_type="user", entity_id=f"u{k}",
                   target_entity_type="item", target_entity_id=f"i{k % 5}")], 1)
    victim = next(w1._iter_raw(1, None)).event_id
    assert w2.delete(victim, 1)
    assert w1.compact(1)["kept"] == 39
    assert sum(1 for _ in sharedfs.SharedFSEvents(tmp_path / "sh")._iter_raw(1, None)) == 39


def test_sharedfs_shared_snapshot_serves_every_host(tmp_path):
    """A snapshot one host builds on the prefix serves another host's read
    (and the JAX package's), the tail past it spliced."""
    from predictionio_tpu.storage import sharedfs as jax_sharedfs

    w1 = _shared_events(tmp_path, "hostA-1")
    w1.insert_batch(port_events(seeded_corpus(13)[:200]), 1)
    w1.build_snapshot(1)
    _shared_events(tmp_path, "hostB-2").insert_batch(port_events(seeded_corpus(13)[200:]), 1)
    r = _shared_events(tmp_path, "hostC-3").snapshot_scan(1)
    jr = jax_sharedfs.SharedFSEvents(tmp_path / "shared").snapshot_scan(1)
    assert r["snap_events"] == 200 and r["tail_events"] == len(seeded_corpus(13)) - 200
    assert_same_batch(r["batch"], jr["batch"])
    assert r["watermark"] == jr["watermark"]


# -- sharded --------------------------------------------------------------------------------


def test_cross_shard_merged_scan_keeps_prop_columns(tmp_path):
    """Each shard's snapshot owns its property dictionaries; the merged scan
    re-codes them into one and folds the same properties as an unsharded
    store, and as the JAX package's merged scan."""
    from predictionio_tpu.storage.sharded import ShardedEvents as JaxShardedEvents
    from predictionio_tpu_torch.storage.localfs import FSEvents
    from predictionio_tpu_torch.storage.sharded import ShardedEvents
    from predictionio_tpu_torch.store.columnar import fold_properties

    def events(k_):
        out = []
        for k in range(12):
            out.append(k_.Event(event="$set", entity_type="item", entity_id=f"i{k}",
                                properties=k_.DataMap({"category": f"c{k % 5}",
                                                       "tags": [f"t{k % 3}", "common"],
                                                       "stock": k}),
                                event_id=f"s{k}", event_time=ts(1), creation_time=ts(1)))
            out.append(k_.Event(event="buy", entity_type="user", entity_id=f"u{k % 4}",
                                target_entity_type="item", target_entity_id=f"i{k}",
                                event_id=f"b{k}", event_time=ts(2), creation_time=ts(2)))
        return out

    port_k = Pkg("port", None)
    jax_k = Pkg("jax", None)
    sh = ShardedEvents(str(tmp_path / "sh"), shards=3, replicas=1)
    jsh = JaxShardedEvents(str(tmp_path / "jsh"), shards=3, replicas=1)
    ref = FSEvents(str(tmp_path / "ref"))
    try:
        for ev, k_ in ((sh, port_k), (ref, port_k), (jsh, jax_k)):
            ev.init(7)
            ev.insert_batch(events(k_), 7)
        sh.build_snapshot(7)
        jsh.build_snapshot(7)
        res = sh.snapshot_scan(7)
        batch = res["batch"]
        assert batch.prop_columns
        got = {k: dict(v) for k, v in fold_properties(batch, "item").items()}
        want = {k: dict(v) for k, v in fold_properties(
            ref.scan_tail_from(7, None, {}, base=None, heads=None)["batch"], "item").items()}
        assert got == want
        col = batch.prop_columns["category"]
        assert {col.value_at(j) for j in range(len(col))} == {f"c{k}" for k in range(5)}
        stock = batch.prop_columns["stock"]
        assert sorted(int(stock.num[j]) for j in range(len(stock))) == list(range(12))
        assert_same_batch(batch, jsh.snapshot_scan(7)["batch"])
    finally:
        sh.close()
        jsh.close()


# -- the locator ----------------------------------------------------------------------------


@pytest.mark.parametrize("typ", BACKENDS)
def test_locator_builds_every_source_type(typ, tmp_path):
    """Every source type of the JAX locator builds in the port's, from the
    ``PIO_STORAGE_*`` environment (``_SHARDS`` and ``_REPLICAS`` for
    sharded), to the JAX package's classes' counterparts."""
    import os

    src = _src(typ, tmp_path)
    env = {f"PIO_STORAGE_SOURCES_X_{k.upper()}": v for k, v in src.items()}
    env.update({f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "X" for r in REPOS})
    storage = Storage(StorageConfig.from_env(env))
    jstorage = JaxStorage(JaxStorageConfig.from_env(env))
    try:
        for repo in ("apps", "access_keys", "channels", "engine_instances",
                     "engine_manifests", "evaluation_instances", "models", "l_events"):
            assert type(getattr(storage, repo)).__name__ == type(getattr(jstorage, repo)).__name__
        assert storage.l_events is storage.p_events
        if typ == "sharded":
            assert (storage.l_events.n_shards, storage.l_events.replicas) == (3, 2)
        assert storage.apps.insert(App(0, "a")) is not None
    finally:
        for s in (storage, jstorage):
            if hasattr(s.l_events, "close"):
                s.l_events.close()
    assert not [n for n in vars(locator) if n.startswith("NOT_")]
    with pytest.raises(ValueError, match="unknown storage source type"):
        bad = {**env, "PIO_STORAGE_SOURCES_X_TYPE": "hbase"}
        Storage(StorageConfig.from_env(bad)).apps
    assert os.environ.get("PIO_STORAGE_SOURCES_X_TYPE") is None
