"""The port's localfs store against the JAX package's.

The localfs and all-backend cases of ``tests/test_storage.py`` run against
the port, each case that runs on both backends parametrised over the
port's ``memory`` and ``localfs`` sources.  Then the two packages share one
store directory: a store written by the JAX ``FSEvents`` reads the same in
the port (``find``, ``get``, the entity index, ``aggregate_properties``)
and one written by the port reads the same in the JAX package; with fixed
event ids and creation times, both write the same segment bytes, from
``Event`` objects and from wire dicts (``insert_json_batch``).  Times and
counts compare exactly.
"""

import datetime as dt
import fcntl
import json
import shutil

import numpy as np
import pytest

from predictionio_tpu.events.event import Event as JaxEvent
from predictionio_tpu.events.event import canonical_event_json as jax_canonical
from predictionio_tpu.storage import App as JaxApp
from predictionio_tpu.storage import localfs as jax_localfs
from predictionio_tpu.storage.locator import Storage as JaxStorage
from predictionio_tpu.storage.locator import StorageConfig as JaxStorageConfig
from predictionio_tpu_torch.events.event import DataMap, Event, canonical_event_json
from predictionio_tpu_torch.storage import (
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EngineManifest,
    EvaluationInstance,
    Storage,
    StorageConfig,
    set_storage,
)
from predictionio_tpu_torch.storage import localfs as lfs
from predictionio_tpu_torch.storage.localfs import FSEvents

from _torch_event_cases import jax_event_server_writes, jax_events, port_events, seeded_corpus

SEEDS = [0, 1, 2]


def ts(h):
    return dt.datetime(2026, 1, 1, h, tzinfo=dt.timezone.utc)


def _config(src):
    return dict(sources={"S": src},
                repositories={"METADATA": "S", "EVENTDATA": "S", "MODELDATA": "S"})


@pytest.fixture(params=["memory", "localfs"])
def storage(request, tmp_path):
    src = ({"type": "memory"} if request.param == "memory"
           else {"type": "localfs", "path": str(tmp_path / "store")})
    return Storage(StorageConfig(**_config(src)))


def _stores(path):
    """(JAX store, port store) over one localfs directory."""
    src = {"type": "localfs", "path": str(path)}
    return JaxStorage(JaxStorageConfig(**_config(src))), Storage(StorageConfig(**_config(src)))


def _key(e):
    """Every field of an event, comparable across the two packages."""
    return (e.event_id, e.event, e.entity_type, e.entity_id, e.target_entity_type,
            e.target_entity_id, dict(e.properties), e.event_time, e.creation_time,
            tuple(e.tags), e.pr_id)


# -- the cases of tests/test_storage.py -------------------------------------------------


def test_apps_crud(storage):
    app_id = storage.apps.insert(App(0, "myapp", "desc"))
    assert app_id is not None
    assert storage.apps.get(app_id).name == "myapp"
    assert storage.apps.get_by_name("myapp").id == app_id
    assert storage.apps.insert(App(0, "myapp")) is None  # duplicate name
    app2 = storage.apps.insert(App(0, "other"))
    assert app2 != app_id
    assert {a.name for a in storage.apps.get_all()} == {"myapp", "other"}
    assert storage.apps.delete(app2)
    assert storage.apps.get(app2) is None


def test_access_keys_and_channels(storage):
    app_id = storage.apps.insert(App(0, "a1"))
    key = storage.access_keys.insert(AccessKey("", app_id, ["buy"]))
    assert storage.access_keys.get(key).app_id == app_id
    assert storage.access_keys.get(key).events == ["buy"]
    assert len(storage.access_keys.get_by_app_id(app_id)) == 1
    assert storage.access_keys.delete(key) and storage.access_keys.get(key) is None

    ch = storage.channels.insert(Channel(0, "backfill", app_id))
    assert storage.channels.get(ch).name == "backfill"
    assert storage.channels.insert(Channel(0, "backfill", app_id)) is None
    assert storage.channels.get_by_app_id(app_id)[0].id == ch


def test_events_crud_and_filters(storage):
    ev = storage.l_events
    ev.init(1)
    events = [
        Event(event="view", entity_type="user", entity_id="u1",
              target_entity_type="item", target_entity_id="i1", event_time=ts(1)),
        Event(event="buy", entity_type="user", entity_id="u1",
              target_entity_type="item", target_entity_id="i2", event_time=ts(2)),
        Event(event="view", entity_type="user", entity_id="u2",
              target_entity_type="item", target_entity_id="i1", event_time=ts(3)),
        Event(event="$set", entity_type="item", entity_id="i1",
              properties=DataMap({"cat": "x"}), event_time=ts(4)),
    ]
    ids = ev.insert_batch(events, 1)
    assert len(ids) == 4
    got = ev.get(ids[0], 1)
    assert got.event == "view" and got.target_entity_id == "i1"

    assert len(list(ev.find(1))) == 4
    assert len(list(ev.find(1, event_names=["view"]))) == 2
    assert len(list(ev.find(1, entity_type="user", entity_id="u1"))) == 2
    assert len(list(ev.find(1, start_time=ts(2), until_time=ts(4)))) == 2
    assert [e.event for e in ev.find(1, reversed_order=True)][0] == "$set"
    assert len(list(ev.find(1, limit=2))) == 2
    assert len(list(ev.find(1, target_entity_id="i1"))) == 2

    # channel isolation
    ev.insert(Event(event="view", entity_type="user", entity_id="u9",
                    event_time=ts(1)), 1, channel_id=7)
    assert len(list(ev.find(1))) == 4
    assert len(list(ev.find(1, channel_id=7))) == 1

    assert ev.delete(ids[1], 1)
    assert not ev.delete(ids[1], 1)
    assert len(list(ev.find(1))) == 3
    assert ev.get(ids[1], 1) is None


def test_insert_json_batch_statuses(storage):
    """Valid wire dicts go in as one batch, each invalid one answers 400 in
    its place."""
    ev = storage.l_events
    items = [{"event": "buy", "entityType": "user", "entityId": 7,
              "targetEntityType": "item", "targetEntityId": 0, "eventTime": ts(1).isoformat()},
             {"event": "$set", "entityType": "item", "entityId": "i1",
              "targetEntityId": "x"},
             {"event": "view", "entityType": "user"},
             {"event": "$bogus", "entityType": "user", "entityId": "u"},
             {"event": "view", "entityType": "user", "entityId": "u2", "extra": 1},
             {"event": "rate", "entityType": "user", "entityId": "u3",
              "properties": {"rating": 4}, "eventId": "fixed-id"}]
    res = ev.insert_json_batch(items, 1)
    assert [r["status"] for r in res] == [201, 400, 400, 400, 400, 201]
    assert res[5]["eventId"] == "fixed-id"
    got = {e.event_id: e for e in ev.find(1)}
    assert set(got) == {res[0]["eventId"], "fixed-id"}
    assert got[res[0]["eventId"]].entity_id == "7"
    assert got[res[0]["eventId"]].target_entity_id == "0"
    assert got["fixed-id"].properties == {"rating": 4}


def test_aggregate_via_storage(storage):
    ev = storage.l_events
    ev.init(2)
    ev.insert(Event(event="$set", entity_type="item", entity_id="i1",
                    properties=DataMap({"a": 1}), event_time=ts(1)), 2)
    ev.insert(Event(event="$set", entity_type="item", entity_id="i1",
                    properties=DataMap({"b": 2}), event_time=ts(2)), 2)
    ev.insert(Event(event="$set", entity_type="user", entity_id="u1",
                    properties=DataMap({"z": 3}), event_time=ts(1)), 2)
    snap = ev.aggregate_properties(2, "item")
    assert snap == {"i1": {"a": 1, "b": 2}}


def test_engine_instances(storage):
    inst = EngineInstance(
        id="", status="INIT", start_time=ts(1), end_time=None,
        engine_id="e1", engine_version="1", engine_variant="default",
        engine_factory="f",
    )
    iid = storage.engine_instances.insert(inst)
    got = storage.engine_instances.get(iid)
    assert got.status == "INIT"
    got.status = "COMPLETED"
    got.end_time = ts(2)
    assert storage.engine_instances.update(got)
    latest = storage.engine_instances.get_latest_completed("e1", "1", "default")
    assert latest is not None and latest.id == iid
    inst2 = EngineInstance(
        id="", status="COMPLETED", start_time=ts(5), end_time=ts(6),
        engine_id="e1", engine_version="1", engine_variant="default",
        engine_factory="f",
    )
    iid2 = storage.engine_instances.insert(inst2)
    assert storage.engine_instances.get_latest_completed("e1", "1", "default").id == iid2
    assert storage.engine_instances.delete(iid)
    assert storage.engine_instances.get(iid) is None


def test_engine_manifests_and_evaluation_instances(storage):
    m = EngineManifest(id="e1", version="1", name="n", files=["/x/engine.json"],
                       engine_factory="universal_recommender")
    storage.engine_manifests.insert(m)
    storage.engine_manifests.insert(EngineManifest(id="e1", version="1", name="n2"))
    assert storage.engine_manifests.get("e1", "1").name == "n2"   # an upsert
    assert len(storage.engine_manifests.get_all()) == 1
    assert storage.engine_manifests.delete("e1", "1")
    assert storage.engine_manifests.get("e1", "1") is None
    ev = EvaluationInstance(id="", status="EVALCOMPLETED", start_time=ts(1),
                            end_time=ts(2), evaluation_class="x.Eval")
    eid = storage.evaluation_instances.insert(ev)
    assert storage.evaluation_instances.get(eid).evaluation_class == "x.Eval"
    assert [i.id for i in storage.evaluation_instances.get_completed()] == [eid]


def test_models_blob_store(storage):
    storage.models.insert("abc123", b"\x00\x01binary")
    assert storage.models.get("abc123") == b"\x00\x01binary"
    assert storage.models.delete("abc123")
    assert storage.models.get("abc123") is None


def test_compact_all_backends(storage):
    """compact() exists on both backends: localfs rewrites the log; memory
    (in-place deletes) is the TTL trim."""
    ev = storage.l_events
    ev.init(9)
    ev.insert_batch(
        [Event(event="buy", entity_type="user", entity_id=f"u{k}",
               event_time=ts(k % 20)) for k in range(20)], 9)
    stats = ev.compact(9, before=ts(10))
    assert stats["expired"] > 0
    left = list(ev.find(9))
    assert left and all(e.event_time >= ts(10) for e in left)
    assert stats["kept"] == len(left)


def test_localfs_entity_index(tmp_path, monkeypatch):
    """The per-entity find uses the incremental index: right across appends
    from a second handle (another process), segment rotations and
    tombstones."""
    monkeypatch.setattr(lfs, "SEGMENT_MAX_BYTES", 600)   # force rotation
    ev = FSEvents(tmp_path)
    ev.init(1)
    for k in range(40):
        ev.insert(Event(event="view", entity_type="user", entity_id=f"u{k % 4}",
                        target_entity_type="item", target_entity_id=f"i{k}"), 1)
    assert len(ev.segment_paths(1)) > 1
    got = list(ev.find(1, entity_type="user", entity_id="u1"))
    assert len(got) == 10 and all(e.entity_id == "u1" for e in got)

    writer = FSEvents(tmp_path)
    writer.insert(Event(event="view", entity_type="user", entity_id="u1",
                        target_entity_type="item", target_entity_id="i99"), 1)
    got = list(ev.find(1, entity_type="user", entity_id="u1"))
    assert len(got) == 11 and any(e.target_entity_id == "i99" for e in got)

    victim = got[0].event_id
    assert ev.delete(victim, 1)
    got = list(ev.find(1, entity_type="user", entity_id="u1"))
    assert len(got) == 10 and victim not in [e.event_id for e in got]

    latest = list(ev.find(1, entity_type="user", entity_id="u1", limit=3,
                          reversed_order=True))
    times = [e.event_time for e in latest]
    assert len(latest) == 3 and times == sorted(times, reverse=True)


def test_localfs_entity_index_survives_reimport(tmp_path):
    """A data-delete and re-import through another handle must not leave
    the index pointing into dead bytes."""
    reader = FSEvents(tmp_path)
    reader.init(1)
    writer = FSEvents(tmp_path)   # a separate handle = a separate process
    writer.insert_batch([Event(event="view", entity_type="user", entity_id="u1",
                               target_entity_type="item", target_entity_id=f"old{k}")
                         for k in range(20)], 1)
    assert len(list(reader.find(1, entity_type="user", entity_id="u1"))) == 20
    writer.remove(1)
    writer.init(1)
    writer.insert_batch([Event(event="view", entity_type="user", entity_id="u1",
                               target_entity_type="item", target_entity_id="new0")], 1)
    got = list(reader.find(1, entity_type="user", entity_id="u1"))
    assert [e.target_entity_id for e in got] == ["new0"]
    writer.remove(1)   # a LARGER log: old offsets would point mid-file
    writer.init(1)
    writer.insert_batch([Event(event="view", entity_type="user", entity_id="u1",
                               target_entity_type="item", target_entity_id=f"big{k}")
                         for k in range(40)], 1)
    got = list(reader.find(1, entity_type="user", entity_id="u1"))
    assert len(got) == 40 and all(e.target_entity_id.startswith("big") for e in got)


@pytest.mark.parametrize("policy", ["rotate", "always", "interval:5", "never"])
def test_segment_writer_rotation_and_fsync_policies(tmp_path, monkeypatch, policy):
    """The kept-open writer rotates at the size cap and keeps every event
    under each PIO_FSYNC policy."""
    monkeypatch.setattr(lfs, "SEGMENT_MAX_BYTES", 4096)
    monkeypatch.setenv("PIO_FSYNC", policy)
    ev = FSEvents(tmp_path)
    ids = []
    for k in range(40):
        ids.extend(ev.insert_batch(
            [Event(event="buy", entity_type="user", entity_id=f"u{k}",
                   target_entity_type="item", target_entity_id=f"i{j}")
             for j in range(5)], app_id=1))
    assert len(ev.segment_paths(1)) > 1, f"no rotation under {policy}"
    assert sum(1 for _ in ev._iter_raw(1, None)) == 200 and len(set(ids)) == 200


def test_torn_tail_is_skipped_then_healed(tmp_path):
    """An unterminated last line (a writer killed mid-append) is skipped by
    reads and truncated when a writer opens the segment again, in both
    packages."""
    ev = FSEvents(tmp_path)
    ev.insert_batch([Event(event="buy", entity_type="user", entity_id=f"u{k}")
                     for k in range(3)], 1)
    seg = ev.segment_paths(1)[-1]
    with open(seg, "a") as f:
        f.write('{"event":"buy","entityType":"user","enti')
    for reader in (FSEvents(tmp_path), jax_localfs.FSEvents(tmp_path)):
        assert [e.entity_id for e in reader._iter_raw(1, None)] == ["u0", "u1", "u2"]
    FSEvents(tmp_path).insert(Event(event="buy", entity_type="user", entity_id="u3"), 1)
    assert seg.read_text().count("\n") == 4
    assert [e.entity_id for e in jax_localfs.FSEvents(tmp_path)._iter_raw(1, None)] == [
        "u0", "u1", "u2", "u3"]


def test_writer_survives_external_data_delete(tmp_path):
    """Events written after another process deletes the channel's data land
    in a fresh segment, not an unlinked inode."""
    ev = FSEvents(tmp_path)
    ev.insert(Event(event="buy", entity_type="user", entity_id="u1"), 1)
    shutil.rmtree(ev._chan_dir(1, None))
    ev2 = FSEvents(tmp_path)
    ev.insert(Event(event="buy", entity_type="user", entity_id="u2"), 1)
    assert [e.entity_id for e in ev2._iter_raw(1, None)] == ["u2"]


def test_compact_drops_tombstones_and_expired(tmp_path, monkeypatch):
    monkeypatch.setattr(lfs, "SEGMENT_MAX_BYTES", 2048)
    ev = FSEvents(tmp_path)
    ids = []
    for k in range(60):
        ids.extend(ev.insert_batch(
            [Event(event="buy", entity_type="user", entity_id=f"u{k}",
                   target_entity_type="item", target_entity_id=f"i{k % 7}",
                   event_time=ts(k % 23))], 1))
    for eid in ids[:5]:
        assert ev.delete(eid, 1)
    assert len(ev.segment_paths(1)) > 1
    stats = ev.compact(1, before=ts(3))   # expire hours 0-2
    live = list(ev._iter_raw(1, None))
    assert stats["kept"] == len(live) and stats["expired"] > 0
    assert all(e.event_id not in ids[:5] for e in live)
    assert all(e.event_time >= ts(3) for e in live)
    assert not list((tmp_path / "events").rglob("tombstones*.txt"))
    assert len(list(ev.find(1, entity_type="user", entity_id="u30"))) == 1
    ev.insert(Event(event="buy", entity_type="user", entity_id="fresh"), 1)
    assert any(e.entity_id == "fresh" for e in ev._iter_raw(1, None))
    # the JAX package reads the compacted log the same
    assert [e.event_id for e in jax_localfs.FSEvents(tmp_path)._iter_raw(1, None)] == [
        e.event_id for e in ev._iter_raw(1, None)]


def test_compact_cli(tmp_path):
    from predictionio_tpu_torch.cli.main import main as pio_main

    storage = Storage(StorageConfig(**_config({"type": "localfs",
                                               "path": str(tmp_path / "store")})))
    set_storage(storage)
    try:
        app_id = storage.apps.insert(App(0, "capp"))
        storage.l_events.insert_batch(
            [Event(event="buy", entity_type="user", entity_id=f"u{k}",
                   event_time=ts(k % 20)) for k in range(30)], app_id)
        assert pio_main(["app", "compact", "capp", "--before", ts(10).isoformat()]) == 0
        left = list(storage.l_events.find(app_id))
        assert left and all(e.event_time >= ts(10) for e in left)
    finally:
        set_storage(None)


def test_compact_crash_recovery_both_phases(tmp_path):
    """A compaction killed mid-run heals on the next read: 'prepare' rolls
    back to the original log, 'commit' forward to the compacted one."""
    ev = FSEvents(tmp_path)
    ids = ev.insert_batch([Event(event="buy", entity_type="user", entity_id=f"u{k}")
                           for k in range(20)], 1)
    assert ev.delete(ids[0], 1)
    d = ev._chan_dir(1, None)

    (d / ev._COMPACT_INTENT).write_text(json.dumps(
        {"phase": "prepare", "tag": "deadbeef",
         "old": [p.name for p in ev._list_segments(d)]}))
    (d / ".seg-deadbeef-00000.jsonl.tmp").write_text("partial garbage\n")
    got = list(FSEvents(tmp_path)._iter_raw(1, None))
    assert len(got) == 19
    assert not list(d.glob("*deadbeef*"))
    assert not (d / ev._COMPACT_INTENT).exists()

    (d / ".seg-cafe0001-00000.jsonl.tmp").write_text(
        "".join(e.to_json_line() + "\n" for e in got[:7]))
    (d / ev._COMPACT_INTENT).write_text(json.dumps(
        {"phase": "commit", "tag": "cafe0001",
         "old": [p.name for p in ev._list_segments(d)]}))
    reader = FSEvents(tmp_path)
    assert len(list(reader._iter_raw(1, None))) == 7
    assert not (d / ev._COMPACT_INTENT).exists()
    assert all(p.name.startswith("seg-cafe0001-") for p in reader._list_segments(d))


def test_recovery_never_touches_live_compaction(tmp_path):
    """A reader that sees the intent of a LIVE compaction (flock held)
    leaves it alone; a second compactor is refused."""
    ev = FSEvents(tmp_path)
    ev.insert_batch([Event(event="buy", entity_type="user", entity_id=f"u{k}")
                     for k in range(10)], 1)
    d = ev._chan_dir(1, None)
    (d / ev._COMPACT_INTENT).write_text(json.dumps(
        {"phase": "prepare", "tag": "live0001",
         "old": [p.name for p in ev._list_segments(d)]}))
    hidden = d / ".seg-live0001-00000.jsonl.tmp"
    hidden.write_text("in progress\n")
    lockf = open(d / ev._COMPACT_LOCK, "a")
    fcntl.flock(lockf.fileno(), fcntl.LOCK_EX)
    try:
        reader = FSEvents(tmp_path)
        assert reader.segment_paths(1)
        assert hidden.exists() and (d / ev._COMPACT_INTENT).exists()
        assert len(list(reader._iter_raw(1, None))) == 10
        with pytest.raises(RuntimeError, match="in progress"):
            reader.compact(1)
    finally:
        fcntl.flock(lockf.fileno(), fcntl.LOCK_UN)
        lockf.close()
    reader2 = FSEvents(tmp_path)
    reader2.segment_paths(1)
    assert not hidden.exists() and not (d / ev._COMPACT_INTENT).exists()
    assert len(list(reader2._iter_raw(1, None))) == 10


def test_insert_after_crashed_commit_recovers_first(tmp_path):
    """An insert after a commit-phase crash must not land in a superseded
    segment that the roll-forward then unlinks."""
    ev = FSEvents(tmp_path)
    ev.insert_batch([Event(event="buy", entity_type="user", entity_id=f"u{k}")
                     for k in range(8)], 1)
    d = ev._chan_dir(1, None)
    survivors = list(ev._iter_raw(1, None))[:5]
    (d / ".seg-cafe0002-00000.jsonl.tmp").write_text(
        "".join(e.to_json_line() + "\n" for e in survivors))
    (d / ev._COMPACT_INTENT).write_text(json.dumps(
        {"phase": "commit", "tag": "cafe0002",
         "old": [p.name for p in ev._list_segments(d)]}))
    FSEvents(tmp_path).insert(Event(event="buy", entity_type="user", entity_id="POSTCRASH"), 1)
    got = [e.entity_id for e in FSEvents(tmp_path)._iter_raw(1, None)]
    assert "POSTCRASH" in got and len(got) == 6


def test_delete_finds_events_as_the_jax_delete_does(tmp_path, monkeypatch):
    """The port's delete looks a plain id up by its bytes; its answers are
    the JAX delete's (a full parse): ids inside longer ids and property
    values, escaped and non-ASCII ids, a torn last line, tombstoned ids."""
    monkeypatch.setattr(lfs, "SEGMENT_MAX_BYTES", 600)
    monkeypatch.setattr(jax_localfs, "SEGMENT_MAX_BYTES", 600)
    ids = ["ab", "abc", "x.y-z_1", "é/1", 'q"uote', "in-prop", "torn"]
    specs = [("buy", "user", f"u{k}", "item", "i1", {"note": "in-prop-not" if k == 0 else k},
              ts(k), ts(k)) for k in range(len(ids))]
    stores = {}
    for name, mod, make in (("port", lfs, port_events), ("jax", jax_localfs, jax_events)):
        ev = mod.FSEvents(tmp_path / name)
        evs = make(specs)
        for e, eid in zip(evs, ids):
            e.event_id = eid
        for k in range(0, len(evs) - 1, 2):
            ev.insert_batch(evs[k:k + 2], 1)
        seg = sorted(ev._chan_dir(1, None).glob("seg-*.jsonl"))[-1]
        with open(seg, "a") as f:   # a writer killed mid-append
            f.write(evs[-1].to_json_line()[:50])
        stores[name] = ev
    for eid in ["ab", "b", "abc", "x.y-z_1", "é/1", 'q"uote', "in-prop", "torn", "nope", "ab"]:
        assert stores["port"].delete(eid, 1) == stores["jax"].delete(eid, 1), eid
    assert ([e.event_id for e in stores["port"].find(1)]
            == [e.event_id for e in stores["jax"].find(1)] == [])


def test_snapshot_requests_raise_naming_the_roadmap(tmp_path):
    """Snapshot requests raised naming ROADMAP's item until the snapshots
    were ported; now they build and report (tests/test_torch_snapshot.py
    holds them against the JAX package)."""
    ev = FSEvents(tmp_path)
    assert ev.snapshot_status(1) is None
    assert ev.build_snapshot(1)["events"] == 0
    ev.insert(Event(event="buy", entity_type="user", entity_id="u1"), 1)
    status = ev.snapshot_status(1)
    assert (status["events"], status["tailEvents"], status["coverage"]) == (0, 1, 0.0)


# -- one store directory, both packages -----------------------------------------------


FILTERS = [{}, {"event_names": ["view"]}, {"entity_type": "item"},
           {"entity_type": "user", "entity_id": "u3"},
           {"target_entity_id": "i4"}, {"limit": 7, "reversed_order": True},
           {"start_time": dt.datetime.fromtimestamp(1_780_003_000, dt.timezone.utc),
            "until_time": dt.datetime.fromtimestamp(1_780_009_000, dt.timezone.utc)}]


def _assert_reads_alike(jax_ev, port_ev, app_id, specs):
    for f in FILTERS:
        got = [_key(e) for e in port_ev.find(app_id, **f)]
        assert got == [_key(e) for e in jax_ev.find(app_id, **f)], f
        assert got, f
    for k in (0, len(specs) // 2, len(specs) - 1):
        assert _key(port_ev.get(f"ev{k:07d}", app_id)) == _key(jax_ev.get(f"ev{k:07d}", app_id))
    for et in ("item", "user"):
        want = jax_ev.aggregate_properties(app_id, et)
        got = port_ev.aggregate_properties(app_id, et)
        assert got == want and got
        for k in want:
            assert (got[k].first_updated, got[k].last_updated) == (
                want[k].first_updated, want[k].last_updated)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_store_written_by_one_package_reads_the_same_in_the_other(tmp_path, monkeypatch,
                                                                     seed, writer):
    for mod in (lfs, jax_localfs):
        monkeypatch.setattr(mod, "SEGMENT_MAX_BYTES", 8192)   # several segments
    jax_store, port_store = _stores(tmp_path / "store")
    specs = seeded_corpus(seed)
    if writer == "jax":
        app_id = jax_store.apps.insert(JaxApp(0, "x"))
        for k in range(0, len(specs), 50):
            jax_store.l_events.insert_batch(jax_events(specs)[k:k + 50], app_id)
        jax_store.l_events.delete("ev0000003", app_id)
    else:
        app_id = port_store.apps.insert(App(0, "x"))
        for k in range(0, len(specs), 50):
            port_store.l_events.insert_batch(port_events(specs)[k:k + 50], app_id)
        port_store.l_events.delete("ev0000003", app_id)
    assert port_store.apps.get_by_name("x").id == jax_store.apps.get_by_name("x").id == app_id
    assert len(port_store.l_events.segment_paths(app_id)) > 1
    _assert_reads_alike(jax_store.l_events, port_store.l_events, app_id, specs)
    assert port_store.l_events.get("ev0000003", app_id) is None


@pytest.mark.parametrize("seed", SEEDS)
def test_segment_bytes_equal_for_the_same_events(tmp_path, seed):
    """Fixed event ids and creation times: the two packages write the same
    bytes, from Event objects and from wire dicts."""
    specs = seeded_corpus(seed)
    jax_ev, port_ev = jax_localfs.FSEvents(tmp_path / "j"), FSEvents(tmp_path / "p")
    jax_ev.insert_batch(jax_events(specs), 1)
    port_ev.insert_batch(port_events(specs), 1)
    wire = [e.to_json() for e in port_events(specs)]
    rng = np.random.default_rng(seed)
    for d in wire:   # the wire forms a client may send
        if rng.random() < 0.3:
            d["eventTime"] = d["eventTime"].replace("+00:00", "Z")
        if rng.random() < 0.2 and d.get("targetEntityId"):
            d["targetEntityId"] = int(d["targetEntityId"][1:])
        if rng.random() < 0.2:
            d["entityId"] = d["entityId"][1:] + "é☃"
    jax_res = jax_ev.insert_json_batch(wire, 2)
    port_res = port_ev.insert_json_batch(wire, 2)
    assert port_res == jax_res
    for app in (1, 2):
        j, p = jax_ev.segment_paths(app), port_ev.segment_paths(app)
        assert [x.name for x in p] == [x.name for x in j]
        assert [x.read_bytes() for x in p] == [x.read_bytes() for x in j]


@pytest.mark.parametrize("seed", SEEDS)
def test_canonical_event_json_matches_jax(seed):
    rng = np.random.default_rng(seed)
    now = "2026-01-01T00:00:00+00:00"
    for e in port_events(seeded_corpus(seed))[:60]:
        d = e.to_json()
        if rng.random() < 0.5:
            d.pop("creationTime")
        if rng.random() < 0.3:
            d.pop("eventTime")
        if rng.random() < 0.2:
            d["tags"] = ["a", "b"]
            d["prId"] = "pr1"
        got, want = canonical_event_json(d, now), jax_canonical(d, now)
        assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
        line = Event.from_json(got).to_json_line()
        assert line == JaxEvent.from_json(want).to_json_line()
        assert line == json.dumps(got, separators=(",", ":"), sort_keys=True)


# -- writer tags and the group commit --------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_tagged_writers_name_their_segments_as_the_jax_package(tmp_path, monkeypatch, seed):
    """With a writer tag each package appends only to its own
    ``seg-<tag>-NNNNN.jsonl`` and tombstones into ``tombstones-<tag>.txt``;
    the port's tagged files are byte-equal to the JAX package's, and
    either package reads the union of both writers' files."""
    import threading

    monkeypatch.setattr(lfs, "SEGMENT_MAX_BYTES", 4096)
    monkeypatch.setattr(jax_localfs, "SEGMENT_MAX_BYTES", 4096)
    corpus = seeded_corpus(seed)
    half = len(corpus) // 2
    for root, mod, evs in ((tmp_path / "port", lfs, port_events(corpus)),
                           (tmp_path / "jax", jax_localfs, jax_events(corpus))):
        w = mod.FSEvents(root, writer_tag="w1-77")
        for k in range(0, half, 10):
            w.insert_batch(evs[k:min(k + 10, half)], 1)
        other = mod.FSEvents(root, writer_tag="w2-77")
        threads = [threading.Thread(target=other.insert_batch, args=([e], 1))
                   for e in evs[half:]]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert w.delete(evs[0].event_id, 1)
        assert other.delete(evs[-1].event_id, 1)
        for wr in (w, other):
            for seg_writer in wr._writers.values():
                seg_writer.close()
    chan = ("events", "app_1", "_default")
    port_dir, jax_dir = tmp_path.joinpath("port", *chan), tmp_path.joinpath("jax", *chan)
    names = sorted(p.name for p in port_dir.glob("seg-*.jsonl"))
    assert {n.rsplit("-", 1)[0] for n in names} == {"seg-w1-77", "seg-w2-77"}
    # the first writer's sequential batches: the same files, byte for byte
    # (the second's concurrent appends rotate where their commits fall)
    w1 = [n for n in names if n.startswith("seg-w1-77")]
    assert len(w1) > 1 and w1 == sorted(p.name for p in jax_dir.glob("seg-w1-77-*.jsonl"))
    assert [(port_dir / n).read_bytes() for n in w1] == [(jax_dir / n).read_bytes() for n in w1]
    for tag in ("w1-77", "w2-77"):
        assert (port_dir / f"tombstones-{tag}.txt").read_text() == (
            jax_dir / f"tombstones-{tag}.txt").read_text()
    # concurrent appends of the second writer land in either order
    want = sorted(e.to_json_line() for e in jax_localfs.FSEvents(tmp_path / "jax").find(1))
    assert len(want) == len(corpus) - 2
    assert sorted(e.to_json_line() for e in FSEvents(tmp_path / "jax").find(1)) == want
    assert sorted(e.to_json_line() for e in jax_localfs.FSEvents(tmp_path / "port").find(1)) \
        == want
    assert sorted(e.to_json_line() for e in FSEvents(tmp_path / "port").find(1)) == want


def test_writer_tag_from_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_WRITER_TAG", "w0-12/../x y")
    assert lfs._env_writer_tag() == jax_localfs._env_writer_tag() == "w0-12xy"
    ev = FSEvents(tmp_path)
    ev.insert(Event(event="buy", entity_type="user", entity_id="u"), 1)
    assert [p.name for p in (tmp_path / "events/app_1/_default").glob("seg-*")] == [
        "seg-w0-12xy-00000.jsonl"]
    assert ev.build_snapshot(1)["events"] == 1
    from predictionio_tpu_torch.storage import snapshot as snap

    assert snap.snapshot_status(tmp_path / "events/app_1/_default")["writer"] == "w0-12xy"
    monkeypatch.setenv("PIO_WRITER_TAG", "--")
    assert lfs._env_writer_tag() is None


def test_a_tag_never_claims_a_dash_extended_tags_segments(tmp_path):
    """Tag ``bulk`` must not resume (and heal) the live segment of tag
    ``bulk-2``: it opens its own series."""
    a = FSEvents(tmp_path, writer_tag="bulk-2")
    a.insert(Event(event="buy", entity_type="user", entity_id="u", event_id="x1"), 1)
    b = FSEvents(tmp_path, writer_tag="bulk")
    b.insert(Event(event="buy", entity_type="user", entity_id="v", event_id="x2"), 1)
    d = tmp_path / "events/app_1/_default"
    assert sorted(p.name for p in d.glob("seg-*")) == [
        "seg-bulk-00000.jsonl", "seg-bulk-2-00000.jsonl"]


def test_group_commit_many_threads_exactly_once_across_rotation(tmp_path, monkeypatch):
    import threading

    from predictionio_tpu_torch.obs import metrics as obs_metrics

    monkeypatch.setenv("PIO_FSYNC", "always")
    monkeypatch.setattr(lfs, "SEGMENT_MAX_BYTES", 8192)
    group = obs_metrics.get_registry().histogram("pio_storage_group_commit_batch_size", "x")
    before = group._snapshot_series().get("", {"count": 0, "sum": 0})
    ev = FSEvents(tmp_path)
    errs = []

    def work(t):
        try:
            for k in range(40):
                r = ev.insert_json_batch([{"event": "buy", "entityType": "user",
                                           "entityId": f"u{t}", "eventId": f"t{t}-{k}"}], 1)
                assert r[0]["status"] == 201
        except Exception as e:   # noqa: BLE001
            errs.append(e)

    ts = [threading.Thread(target=work, args=(t,)) for t in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not errs and not any(t.is_alive() for t in ts)
    ids = [e.event_id for e in ev._iter_raw(1, None)]
    assert len(ids) == len(set(ids)) == 320
    assert len(list((tmp_path / "events/app_1/_default").glob("seg-*.jsonl"))) > 1
    after = group._snapshot_series()[""]
    assert after["sum"] - before["sum"] == 320            # every buffer committed once
    assert after["count"] - before["count"] <= 320         # some commits held several


def test_append_error_nacks_the_whole_group(tmp_path, monkeypatch):
    """A failed write raises in every thread whose lines it held, and the
    group commits again once the fault clears."""
    import threading

    ev = FSEvents(tmp_path)
    boom = {"on": True}
    orig = lfs._SegmentWriter.append
    gate = threading.Barrier(4)

    def flaky(self, text):
        if boom["on"]:
            raise OSError(28, "No space left on device")
        return orig(self, text)

    monkeypatch.setattr(lfs._SegmentWriter, "append", flaky)
    errs = []

    def work(k):
        gate.wait(timeout=30)
        try:
            ev.insert(Event(event="buy", entity_type="user", entity_id=f"u{k}"), 1)
        except OSError as e:
            errs.append(e)

    ts = [threading.Thread(target=work, args=(k,)) for k in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert len(errs) == 4
    boom["on"] = False
    ev.insert(Event(event="buy", entity_type="user", entity_id="ok", event_id="recovered"), 1)
    assert {e.event_id for e in ev._iter_raw(1, None)} == {"recovered"}


def test_fs_events_read_what_the_jax_event_server_wrote(tmp_path):
    """Events posted to the JAX event server, which appends them to its
    localfs store: the port's ``FSEvents`` finds the same events, field
    for field, as the JAX one."""
    root = tmp_path / "store"
    jax_store = JaxStorage(JaxStorageConfig(
        sources={"S": {"type": "localfs", "path": str(root)}},
        repositories={r: "S" for r in ("METADATA", "EVENTDATA", "MODELDATA")}))
    app_id = jax_event_server_writes(jax_store, "serverapp", seeded_corpus(4))
    got = [e.to_json_line() for e in FSEvents(root).find(app_id)]
    want = [e.to_json_line() for e in jax_localfs.FSEvents(root).find(app_id)]
    assert got == want and len(got) > 400
