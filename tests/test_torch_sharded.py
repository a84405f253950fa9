"""The port's sharded, replicated event store (``storage/sharded.py``),
``store/columnar.BatchMerger`` and the native dictionary handles, held
against the JAX package on the same inputs.

- Routing: ``shard_of`` equals the JAX one on seeded ids (non-ASCII and
  lone surrogates included).
- Cross-package stores: a 2-shard, 2-replica store that one package wrote
  (``insert_batch``, or the JAX event server) reads the same in the other
  through ``find``, ``find_batches`` (snapshot and tail), ``scan_tail_from``
  and ``scan_events_up_to``: the same batch, the same dictionaries in the
  same order, the same event ids; ``topology.json`` and ``acked.json`` are
  the same documents.
- The counterparts of the JAX ``tests/test_store_failover.py`` (routing,
  ``insert_json_batch``'s order, the semi-sync barrier, promotion and
  re-sync, the epoch fence, namespaced watermarks, the staged cache's delta
  retrain, ``storeTopology``) and ``tests/test_parallel_scan.py`` (parallel
  against the serial oracle, the merged snapshot, tails merged into the base
  dictionaries, a partition mid-fan-out, the heap merge, the knob), each run
  on both packages where a result can be compared.
- The fold over a two-shard tail: bit-exact against a port retrain reading
  the same store, and the JAX fold's tables within 1e-4 (ids equal but at
  ties).
- The CLI: ``pio app new`` → ``import`` → ``train`` → ``deploy(follow=)``
  with EVENTDATA on ``sharded``, METADATA on ``sql`` and MODELDATA on
  ``sharedfs``, from the locator's environment variables.
"""

import datetime as dt
import json
import os
import shutil
import urllib.request

import numpy as np
import pytest

from _torch_event_cases import (
    assert_same_batch,
    jax_event_server_writes,
    jax_events,
    port_events,
    seeded_corpus,
)
from predictionio_tpu.storage import App as JaxApp
from predictionio_tpu.storage import sharded as jax_sharded
from predictionio_tpu.storage.locator import Storage as JaxStorage
from predictionio_tpu.storage.locator import StorageConfig as JaxStorageConfig
from predictionio_tpu.store import columnar as jax_columnar
from predictionio_tpu_torch.native import core as ncore
from predictionio_tpu_torch.storage import App, AccessKey
from predictionio_tpu_torch.storage import localfs
from predictionio_tpu_torch.storage import sharded
from predictionio_tpu_torch.storage.locator import Storage, StorageConfig
from predictionio_tpu_torch.store.columnar import BatchMerger, EventBatch

REPOS = ("METADATA", "EVENTDATA", "MODELDATA")


def _sharded_cfg(root, shards=2, replicas=2):
    return dict(sources={"S": {"type": "sharded", "path": str(root),
                               "shards": str(shards), "replicas": str(replicas)}},
                repositories={r: "S" for r in REPOS})


@pytest.fixture()
def stores(tmp_path):
    """(JAX storage, port storage) over ONE 2-shard, 2-replica directory."""
    cfg = _sharded_cfg(tmp_path / "st")
    j, p = JaxStorage(JaxStorageConfig(**cfg)), Storage(StorageConfig(**cfg))
    yield j, p
    for s in (p, j):
        s.l_events.close()


@pytest.fixture()
def fsync_always(monkeypatch):
    monkeypatch.setenv("PIO_FSYNC", "always")


def _close(*events):
    for ev in events:
        ev.close()


def canon(batch, ids=None):
    """Decoded rows, row order included (the JAX parallel-scan suite's view)."""
    idl = ids.tolist() if ids is not None else [None] * len(batch)
    rows = []
    for j in range(len(batch)):
        props = {}
        if batch.prop_columns is not None:
            for key, col in batch.prop_columns.items():
                pos = int(np.searchsorted(col.rows, j))
                if pos < len(col) and col.rows[pos] == j:
                    props[key] = col.value_at(pos)
        t, r = int(batch.target_ids[j]), float(batch.ratings[j])
        rows.append((idl[j], batch.event_dict.str(int(batch.event_codes[j])),
                     batch.entity_type_dict.str(int(batch.entity_type_codes[j])),
                     batch.entity_dict.str(int(batch.entity_ids[j])),
                     batch.target_dict.str(t) if t >= 0 else None,
                     int(batch.times_us[j]), None if np.isnan(r) else r,
                     tuple(sorted(props.items()))))
    return rows


def _same_res(got, want):
    """Two scan results (either package's): the batch, ids, watermark, heads."""
    assert got is not None and want is not None
    assert_same_batch(got["batch"], want["batch"])
    if want.get("ids") is None:
        assert got.get("ids") is None
    else:
        assert got["ids"].tolist() == want["ids"].tolist()
    assert got["watermark"] == want["watermark"]
    assert got.get("heads", {}) == want.get("heads", {})
    assert got["events"] == want["events"]


def _wire(k, rng):
    """The JAX parallel-scan suite's wire event: property values that differ
    by entity, so the shards' property dictionaries disagree."""
    d = {"event": ("buy", "view", "$set")[k % 3],
         "entityType": "user" if k % 3 != 2 else "item",
         "entityId": f"u{k % 13}" if k % 3 != 2 else f"i{k % 7}",
         "eventId": f"e{k}",
         "eventTime": (dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
                       + dt.timedelta(seconds=k)).isoformat(),
         "creationTime": (dt.datetime(2026, 1, 2, tzinfo=dt.timezone.utc)
                          + dt.timedelta(seconds=k)).isoformat()}
    if k % 3 != 2:
        d["targetEntityType"] = "item"
        d["targetEntityId"] = f"i{k % 29}"
    if k % 4:
        d["properties"] = {"rating": int(rng.integers(0, 6)), "color": f"c{rng.integers(0, 9)}",
                           "tags": [f"t{rng.integers(0, 5)}" for _ in range(k % 3)]}
    return d


def _ingest(ev, n, prefix="e", app_id=1):
    t0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
    res = ev.insert_json_batch([{"event": "buy", "entityType": "user", "entityId": f"u{k}",
                                 "eventId": f"{prefix}{k}",
                                 "eventTime": (t0 + dt.timedelta(seconds=k)).isoformat(),
                                 "creationTime": (t0 + dt.timedelta(seconds=k)).isoformat()}
                                for k in range(n)], app_id)
    assert all(r["status"] == 201 for r in res), res
    return {f"{prefix}{k}" for k in range(n)}


def _store3(cls, root):
    """The JAX suite's ``store3``: 3 shards, 240 wire events, 4 tombstones."""
    ev = cls(root, shards=3, replicas=1)
    rng = np.random.default_rng(12)
    res = ev.insert_json_batch([_wire(k, rng) for k in range(240)], 1)
    assert all(r["status"] == 201 for r in res)
    for k in (3, 17, 101, 200):
        assert ev.delete(f"e{k}", 1)
    return ev


@pytest.fixture()
def store3_pair(tmp_path, monkeypatch):
    """The same store3 built by each package in its own directory."""
    monkeypatch.setenv("PIO_FSYNC", "rotate")
    j = _store3(jax_sharded.ShardedEvents, tmp_path / "jax")
    p = _store3(sharded.ShardedEvents, tmp_path / "port")
    yield j, p
    _close(p, j)


# -- routing ---------------------------------------------------------------------------


def _seeded_ids(seed, n):
    rng = np.random.default_rng(seed)
    alphabet = list("abcxyz0189-_.:/ ") + ["é", "☃", "\U0001f600", "\ud800", "\x00"]
    return [("user", "item", "ü-type")[int(rng.integers(3))]
            and "".join(alphabet[int(c)] for c in rng.integers(0, len(alphabet),
                                                              int(rng.integers(0, 12))))
            for _ in range(n)]


@pytest.mark.parametrize("n", [2, 3, 8])
def test_shard_of_equals_jax(n):
    """CRC32 over ``entityType\\x00entityId`` (utf-8, surrogatepass): the port
    routes 10,000 seeded ids exactly as the JAX package does."""
    rng = np.random.default_rng(n)
    types = ["user", "item", "ü-type", ""]
    ids = _seeded_ids(100 + n, 10_000)
    got, want = [], []
    for eid in ids:
        et = types[int(rng.integers(len(types)))]
        got.append(sharded.shard_of(et, eid, n))
        want.append(jax_sharded.shard_of(et, eid, n))
    assert got == want
    assert set(got) == set(range(n))
    assert sharded.shard_of("user", "u1", 1) == 0


def test_routing_is_stable_and_partitions(tmp_path):
    """Every entity lands on the shard the hash names, in both packages'
    stores; the scans' unions are complete; an entity read touches one
    shard and answers as the JAX store does."""
    evs = {}
    for name, cls in (("jax", jax_sharded.ShardedEvents), ("port", sharded.ShardedEvents)):
        ev = evs[name] = cls(tmp_path / name, shards=4, replicas=1)
        ids = _ingest(ev, 64)
        for k in range(64):
            want = sharded.shard_of("user", f"u{k}", 4)
            d = tmp_path / name / f"shard_{want:02d}" / "a" / "events" / "app_1" / "_default"
            assert f'"eventId":"e{k}"' in "".join(p.read_text() for p in d.glob("seg-*.jsonl"))
        assert {e.event_id for e in ev.scan(1)} == ids
    for name in evs:
        got = list(evs[name].find(1, entity_type="user", entity_id="u5"))
        assert [e.event_id for e in got] == ["e5"]
    # the two packages wrote the same bytes a shard
    for k in range(4):
        rel = f"shard_{k:02d}/a/events/app_1/_default"
        a = {p.name: p.read_bytes() for p in (tmp_path / "jax" / rel).glob("seg-*.jsonl")}
        b = {p.name: p.read_bytes() for p in (tmp_path / "port" / rel).glob("seg-*.jsonl")}
        assert a == b
    _close(*evs.values())


def test_insert_json_batch_preserves_order_and_statuses(tmp_path):
    """Results in input order with the statuses the JAX store gives, though
    the batch is split over shards."""
    items = []
    for k in range(12):
        items.append({"event": "buy", "entityType": "user", "entityId": f"u{k}",
                      "eventId": f"e{k}"})
        if k % 4 == 3:
            items.append({"entityType": "user", "entityId": "broken"})
    j = jax_sharded.ShardedEvents(tmp_path / "j", shards=3, replicas=1)
    p = sharded.ShardedEvents(tmp_path / "p", shards=3, replicas=1)
    got, want = p.insert_json_batch(items, 1), j.insert_json_batch(items, 1)
    assert len(got) == len(items)
    assert [r["status"] for r in got] == [r["status"] for r in want]
    for item, r in zip(items, got):
        if "event" in item:
            assert r == {"status": 201, "eventId": item["eventId"]}
        else:
            assert r["status"] == 400
    _close(p, j)


# -- the semi-sync barrier, promotion, the fence --------------------------------------


def test_acked_event_is_on_both_nodes(tmp_path, fsync_always):
    """By the time an insert returns, the replica holds byte-identical copies
    of every acknowledged segment, and ``acked.json`` is the JAX store's
    document for the same events."""
    for name, cls in (("jax", jax_sharded.ShardedEvents), ("port", sharded.ShardedEvents)):
        ev = cls(tmp_path / name, shards=2, replicas=2)
        _ingest(ev, 30)
        ev.close()
    for k in (0, 1):
        docs = {}
        for name in ("jax", "port"):
            root = tmp_path / name / f"shard_{k:02d}"
            proot, rroot = root / "a", root / "b"
            segs = sorted(p.relative_to(proot)
                          for p in proot.glob("events/app_1/_default/seg-*.jsonl"))
            assert segs, f"shard {k} empty"
            acked = json.loads((rroot / "repl" / "acked.json").read_text())
            for rel in segs:
                assert (rroot / rel).read_bytes() == (proot / rel).read_bytes()
                assert acked[str(rel)]["off"] == (proot / rel).stat().st_size
            docs[name] = (acked, json.loads((root / "topology.json").read_text()))
        assert docs["port"] == docs["jax"]


def test_promotion_preserves_acked_and_resyncs(tmp_path, fsync_always):
    """Both primaries taken away from a store the JAX package wrote: the
    port's store promotes, serves every acknowledged event once, keeps
    ingesting, and the re-sync drains the lag to 0 with the lost node
    recreated byte for byte."""
    j = jax_sharded.ShardedEvents(tmp_path / "store", shards=2, replicas=2)
    ids = _ingest(j, 40)
    j.close()
    root = tmp_path / "store"
    for k in (0, 1):
        shutil.move(str(root / f"shard_{k:02d}" / "a"), str(root / f"shard_{k:02d}" / "a.lost"))
    ev = sharded.ShardedEvents(root, shards=2, replicas=2)
    promos = sharded._M_PROMOTIONS.value(shard="0", reason="primary-missing")
    try:
        assert sorted(e.event_id for e in ev.scan(1)) == sorted(ids)
        topo = ev.topology_status()
        assert all(p["primary"] == "b" and p["epoch"] == 1 for p in topo["perShard"])
        assert sharded._M_PROMOTIONS.value(shard="0", reason="primary-missing") == promos + 1
        ids |= _ingest(ev, 10, prefix="post")
        import time

        deadline = time.time() + 10
        while time.time() < deadline:
            topo = ev.topology_status()
            if all(p["replicaLagEvents"] == 0 for p in topo["perShard"]):
                break
            time.sleep(0.05)
        assert all(p["replicaLagEvents"] == 0 for p in topo["perShard"])
        assert {e.event_id for e in ev.scan(1)} == ids
        for k in (0, 1):
            proot, rroot = root / f"shard_{k:02d}" / "b", root / f"shard_{k:02d}" / "a"
            for seg in proot.glob("events/app_1/_default/seg-*.jsonl"):
                assert (rroot / seg.relative_to(proot)).read_bytes() == seg.read_bytes()
        # the JAX package reads the promoted topology the same way
        j2 = jax_sharded.ShardedEvents(root, shards=2, replicas=2)
        try:
            assert [e.event_id for e in j2.find(1)] == [e.event_id for e in ev.find(1)]
            assert j2.topology_status()["perShard"][0]["primary"] == "b"
        finally:
            j2.close()
    finally:
        ev.close()


def test_fenced_writer_cannot_ack_after_promotion(tmp_path, fsync_always):
    """A writer on the demoted node is fenced at its next commit (the group
    NACKs); the store retries the write on the new primary."""
    ev = sharded.ShardedEvents(tmp_path / "store", shards=2, replicas=2)
    try:
        _ingest(ev, 4)
        shard = ev._shards[0]
        stale = shard.events()
        shard.promote("test")
        with pytest.raises(OSError, match="fenced"):
            stale.insert_json_batch([{"event": "buy", "entityType": "user", "entityId": "uX",
                                      "eventId": "fenced-1"}], 1)
        u0 = next(f"u{j}" for j in range(100) if sharded.shard_of("user", f"u{j}", 2) == 0)
        res = ev.insert_json_batch([{"event": "buy", "entityType": "user", "entityId": u0,
                                     "eventId": "fenced-2"}], 1)
        assert res[0]["status"] == 201
        ids = {e.event_id for e in ev.scan(1)}
        assert "fenced-2" in ids and "fenced-1" not in ids
    finally:
        ev.close()


def test_ack_timeout_nacks_without_failover(tmp_path, monkeypatch):
    """A replica that never acknowledges NACKs the group (``_AckTimeout``)
    and never promotes, as in the JAX package."""
    monkeypatch.setenv("PIO_STORE_ACK_TIMEOUT_S", "0.2")
    monkeypatch.setattr(sharded._ShardFollower, "sync", lambda self: 0)
    ev = sharded.ShardedEvents(tmp_path / "store", shards=1, replicas=2)
    try:
        with pytest.raises(sharded._AckTimeout):
            ev.insert_json_batch([{"event": "buy", "entityType": "user", "entityId": "u1",
                                   "eventId": "x1"}], 1)
        assert ev._shards[0].topology(force=True)["epoch"] == 0
    finally:
        ev.close()


def test_ack_knobs_parse_as_jax(monkeypatch):
    for var, fns in (("PIO_STORE_ACK_REPLICAS", ("_ack_replicas",)),
                     ("PIO_STORE_ACK_TIMEOUT_S", ("_ack_timeout",)),
                     ("PIO_STORE_REPL_POLL_S", ("_poll_s",))):
        for value in (None, "0", "2", "0.5", "bad"):
            if value is None:
                monkeypatch.delenv(var, raising=False)
            else:
                monkeypatch.setenv(var, value)
            for fn in fns:
                assert getattr(sharded, fn)() == getattr(jax_sharded, fn)(), (var, value)


def test_async_replication_acks_on_the_primary_alone(tmp_path, monkeypatch):
    """``PIO_STORE_ACK_REPLICAS=0``: the write does not wait for the replica,
    which catches up on its own."""
    monkeypatch.setenv("PIO_STORE_ACK_REPLICAS", "0")
    ev = sharded.ShardedEvents(tmp_path / "store", shards=2, replicas=2)
    try:
        _ingest(ev, 10)
        import time

        deadline = time.time() + 10
        while time.time() < deadline and any(
                p["replicaLagEvents"] for p in ev.topology_status()["perShard"]):
            time.sleep(0.05)
        assert all(p["replicaLagEvents"] == 0 for p in ev.topology_status()["perShard"])
    finally:
        ev.close()


# -- cross-package stores ---------------------------------------------------------------


def _scan_all(storage, app_id):
    ev = storage.l_events
    return {
        "find": [(e.event_id, e.event, e.entity_id, e.target_entity_id)
                 for e in ev.find(app_id)],
        "find_limit_rev": [e.event_id for e in ev.find(app_id, limit=17,
                                                       reversed_order=True)],
        "find_entity": [e.event_id for e in ev.find(app_id, entity_type="user",
                                                    entity_id="u3")],
        "batches": list(storage.p_events.find_batches(app_id)),
        "batches_named": list(storage.p_events.find_batches(
            app_id, event_names=["purchase", "view"])),
        "tail": ev.scan_tail_from(app_id, None, {}, base=None, heads=None),
        "props": ev.aggregate_properties(app_id, "item"),
    }


def _assert_same_reads(got, want):
    for k in ("find", "find_limit_rev", "find_entity", "props"):
        assert got[k] == want[k], k
    for k in ("batches", "batches_named"):
        assert len(got[k]) == len(want[k]) == 1
        assert_same_batch(got[k][0], want[k][0])
    _same_res(got["tail"], want["tail"])


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("snapshot", [False, True])
def test_cross_package_store_reads_the_same(stores, writer, snapshot):
    """A 2-shard, 2-replica store that one package wrote reads the same in
    both: ``find`` (merged, limited, reversed, by entity), ``find_batches``
    from the fan-out or the merged snapshot with its tail, ``scan_tail_from``,
    ``scan_events_up_to`` and ``aggregate_properties``."""
    j, p = stores
    specs = seeded_corpus(7)
    w = j if writer == "jax" else p
    app_id = w.apps.insert((JaxApp if writer == "jax" else App)(0, "xapp"))
    events = jax_events(specs) if writer == "jax" else port_events(specs)
    w.l_events.insert_batch(events[:300], app_id)
    if snapshot:
        w.l_events.build_snapshot(app_id)
    w.l_events.insert_batch(events[300:], app_id)   # a tail past the snapshot
    got, want = _scan_all(p, app_id), _scan_all(j, app_id)
    _assert_same_reads(got, want)
    wm, heads = want["tail"]["watermark"], want["tail"]["heads"]
    assert all("|" in key for key in wm)
    _same_res({**p.l_events.scan_events_up_to(app_id, None, wm, heads=heads),
               "watermark": wm, "heads": heads},
              {**j.l_events.scan_events_up_to(app_id, None, wm, heads=heads),
               "watermark": wm, "heads": heads})
    if snapshot:
        g, wnt = p.l_events.snapshot_scan(app_id), j.l_events.snapshot_scan(app_id)
        assert g["snap_events"] == wnt["snap_events"] == 300
        _same_res(g, wnt)
        assert p.l_events.snapshot_status(app_id) == j.l_events.snapshot_status(app_id)


def test_jax_event_server_store_reads_the_same(tmp_path):
    """Events the JAX event server wrote into a sharded store (its own ids
    and creation times) read the same through the port."""
    cfg = _sharded_cfg(tmp_path / "st")
    j = JaxStorage(JaxStorageConfig(**cfg))
    try:
        app_id = jax_event_server_writes(j, "esapp", seeded_corpus(5)[:200])
        p = Storage(StorageConfig(**cfg))
        try:
            _assert_same_reads(_scan_all(p, app_id), _scan_all(j, app_id))
            topo = [json.loads((tmp_path / "st" / f"shard_{k:02d}" / "topology.json")
                               .read_text()) for k in (0, 1)]
            assert topo == [{"epoch": 0, "primary": "a"}] * 2
            assert p.l_events.topology_status() == j.l_events.topology_status()
        finally:
            p.l_events.close()
    finally:
        j.l_events.close()


def test_both_packages_write_the_same_files(tmp_path, fsync_always):
    """The same events through either package's ``insert_batch``: the same
    segment bytes, ``acked.json`` and ``topology.json`` on every node."""
    specs = seeded_corpus(9)
    for name, cls, evs in (("jax", jax_sharded.ShardedEvents, jax_events(specs)),
                           ("port", sharded.ShardedEvents, port_events(specs))):
        ev = cls(tmp_path / name, shards=2, replicas=2)
        ev.insert_batch(evs, 1)
        ev.close()

    def files(root):
        return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
                if p.is_file() and p.name != "repl.lock"}

    a, b = files(tmp_path / "jax"), files(tmp_path / "port")
    assert a.keys() == b.keys()
    for rel in a:
        if rel.endswith(".json"):
            assert json.loads(a[rel]) == json.loads(b[rel]), rel
        else:
            assert a[rel] == b[rel], rel


def test_a_localfs_watermark_restages_on_a_sharded_store(stores):
    """A watermark without the shard namespace (a localfs follower's) splits
    to None: a full restage, never a wrong fold; a watermark naming a shard
    past the store's count too."""
    j, p = stores
    p.l_events.insert_batch(port_events(seeded_corpus(2)[:50]), 1)
    for wm in ({"seg-00000.jsonl": 10}, {"7|seg-00000.jsonl": 3}, {"x|seg": 1}):
        assert p.l_events._split_marks(wm, None) is None
        assert p.l_events.scan_tail_from(1, None, wm) is None
        assert p.l_events.scan_events_up_to(1, None, wm) is None
        assert j.l_events.scan_tail_from(1, None, wm) is None
    assert p.l_events._split_marks({"1|seg-00000.jsonl": 5}, {"0|seg": {"n": 1}}) == (
        [{}, {"seg-00000.jsonl": 5}], [{"seg": {"n": 1}}, {}])


def test_delete_replicates_the_tombstone(tmp_path, fsync_always):
    """A delete's tombstone is on the replica when it returns, and the event
    is gone from both packages' reads."""
    ev = sharded.ShardedEvents(tmp_path / "st", shards=2, replicas=2)
    try:
        _ingest(ev, 12)
        assert ev.delete("e3", 1) and not ev.delete("e3", 1) and not ev.delete("nope", 1)
        k = sharded.shard_of("user", "u3", 2)
        root = tmp_path / "st" / f"shard_{k:02d}"
        tombs = list((root / "b").glob("events/app_1/_default/tombstones*.txt"))
        assert tombs and "e3" in tombs[0].read_text()
        assert ev.get("e3", 1) is None and ev.get("e4", 1).event_id == "e4"
        assert ev.tombstone_state(1) == frozenset({"e3"})
        j = jax_sharded.ShardedEvents(tmp_path / "st", shards=2, replicas=2)
        try:
            assert [e.event_id for e in j.find(1)] == [e.event_id for e in ev.find(1)]
            assert j.tombstone_state(1) == ev.tombstone_state(1)
        finally:
            j.close()
    finally:
        ev.close()


def test_compact_and_remove_across_shards(tmp_path):
    """``compact`` sums the shards' counts as the JAX store does; ``remove``
    drops every node and the merged snapshot."""
    outs = {}
    for name, cls in (("jax", jax_sharded.ShardedEvents), ("port", sharded.ShardedEvents)):
        ev = cls(tmp_path / name, shards=3, replicas=2)
        ev.insert_json_batch([{"event": "buy", "entityType": "user", "entityId": f"u{k}",
                               "eventId": f"e{k}",
                               "eventTime": f"2026-01-01T{k % 20:02d}:00:00+00:00"}
                              for k in range(20)], 1)
        ev.delete("e5", 1)
        ev.build_snapshot(1)
        stats = ev.compact(1, before=dt.datetime(2026, 1, 1, 10, tzinfo=dt.timezone.utc))
        left = [e.event_id for e in ev.find(1)]
        removed = ev.remove(1)
        outs[name] = (stats, left, removed, list(ev.find(1)))
        assert not ev._chan_dir(1, None).exists()
        ev.close()
    assert outs["port"] == outs["jax"]
    assert outs["port"][0]["kept"] == len(outs["port"][1])


# -- the staged cache, the delta protocol, storeTopology --------------------------------


def test_delta_staging_namespaced_watermarks(stores):
    """``snapshot_scan`` → ``scan_tail_from`` with shard-namespaced
    watermarks: the delta is exactly the appended suffix, in both
    packages."""
    j, p = stores
    _ingest(p.l_events, 20)
    for ev in (p.l_events, j.l_events):
        snap = ev.snapshot_scan(1, None)
        assert snap["events"] == 20 and all("|" in k for k in snap["watermark"])
        tail = ev.scan_tail_from(1, None, snap["watermark"], base=snap["batch"],
                                 heads=snap["heads"])
        assert tail["events"] == 0
    snaps = [ev.snapshot_scan(1, None) for ev in (p.l_events, j.l_events)]
    _same_res(*snaps)
    _ingest(p.l_events, 5, prefix="d")
    tails = [ev.scan_tail_from(1, None, s["watermark"], base=None, heads=s["heads"])
             for ev, s in zip((p.l_events, j.l_events), snaps)]
    _same_res(*tails)
    assert sorted(tails[0]["ids"].tolist()) == sorted(f"d{k}" for k in range(5))
    bound = p.l_events.scan_events_up_to(1, None, snaps[0]["watermark"],
                                         heads=snaps[0]["heads"])
    assert bound["events"] == 20


def test_staged_cache_delta_retrain_on_sharded(tmp_path):
    """``PEventStore.batch`` on a sharded store: the first read stages the
    log, the second only the delta (the namespaced watermark), and both
    equal the JAX package's reads."""
    from predictionio_tpu.store import event_store as jax_event_store
    from predictionio_tpu_torch.storage import snapshot as snap
    from predictionio_tpu_torch.store import event_store

    cfg = StorageConfig(**_sharded_cfg(tmp_path / "st", replicas=1))
    storage = Storage(cfg)
    jax_storage = JaxStorage(JaxStorageConfig(**_sharded_cfg(tmp_path / "st", replicas=1)))
    try:
        app_id = storage.apps.insert(App(0, "shardapp"))
        _ingest(storage.l_events, 25, app_id=app_id)
        event_store.invalidate_staging_cache()
        jax_event_store.invalidate_staging_cache()
        b1 = event_store.PEventStore.batch("shardapp", storage=storage)
        assert len(b1) == 25
        assert_same_batch(b1, jax_event_store.PEventStore.batch("shardapp",
                                                                storage=jax_storage))
        before = snap.staged_counts()["delta"]
        _ingest(storage.l_events, 7, prefix="d", app_id=app_id)
        b2 = event_store.PEventStore.batch("shardapp", storage=storage)
        assert len(b2) == 32 and snap.staged_counts()["delta"] - before == 7
        assert_same_batch(b2, jax_event_store.PEventStore.batch("shardapp",
                                                                storage=jax_storage))
    finally:
        event_store.invalidate_staging_cache()
        jax_event_store.invalidate_staging_cache()
        storage.l_events.close()
        jax_storage.l_events.close()


def test_stats_json_store_topology(tmp_path):
    """The port's event server over a sharded store: ``/stats.json`` carries
    ``storeTopology`` as the JAX store reports it."""
    from predictionio_tpu_torch.api.event_server import run_event_server

    storage = Storage(StorageConfig(**_sharded_cfg(tmp_path / "st")))
    httpd = None
    try:
        app_id = storage.apps.insert(App(0, "topoapp"))
        key = storage.access_keys.insert(AccessKey("", app_id, []))
        _ingest(storage.l_events, 10, app_id=app_id)
        httpd = run_event_server(host="127.0.0.1", port=0, storage=storage, background=True)
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(f"{base}/stats.json?accessKey={key}", timeout=10) as r:
            doc = json.loads(r.read())
        topo = doc["storeTopology"]
        assert topo["shards"] == 2 and topo["replicas"] == 2
        assert [s["shard"] for s in topo["perShard"]] == [0, 1]
        j = jax_sharded.ShardedEvents(tmp_path / "st", shards=2, replicas=2)
        try:
            assert topo == j.topology_status()
        finally:
            j.close()
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        storage.l_events.close()


# -- the parallel scan -------------------------------------------------------------------


def _drop_merged(ev):
    shutil.rmtree(ev._chan_dir(1, None), ignore_errors=True)


def test_parallel_matches_serial_oracle(store3_pair, monkeypatch):
    """The fan-out merge at 4 workers is bit-exact against the 1-worker
    oracle (rows, codes, ids, watermarks), with one shard on the full-parse
    fallback, and equals the JAX package's fan-out."""
    j, p = store3_pair
    for ev in (j, p):
        ev.build_snapshot(1)
        _drop_merged(ev)
        shutil.rmtree(ev._shards[2].node_root("a") / "events" / "app_1" / "_default"
                      / "snapshot")
    monkeypatch.setenv("PIO_SCAN_WORKERS", "4")
    par = p._fanout_snapshot_scan(1)
    assert int(sharded._M_SCAN_WORKERS.value()) == 3       # capped at the shards
    monkeypatch.setenv("PIO_SCAN_WORKERS", "1")
    ser = p._fanout_snapshot_scan(1)
    assert par["events"] == ser["events"] == 236
    assert par["watermark"] == ser["watermark"] and par["heads"] == ser["heads"]
    assert canon(par["batch"], par["ids"]) == canon(ser["batch"], ser["ids"])
    for col in ("event_codes", "entity_type_codes", "entity_ids", "target_ids", "times_us"):
        assert np.array_equal(getattr(par["batch"], col), getattr(ser["batch"], col)), col
    assert np.array_equal(par["ids"].blob, ser["ids"].blob)
    _same_res(par, j._fanout_snapshot_scan(1))


def test_merged_snapshot_serves_and_tracks_staleness(store3_pair, monkeypatch):
    """The merged cross-shard snapshot serves what the live fan-out would,
    splices tails, masks late tombstones, falls back when a segment is
    recreated, and every read equals the JAX package's."""
    j, p = store3_pair
    monkeypatch.setenv("PIO_SCAN_WORKERS", "4")
    for ev in (j, p):
        ev.build_snapshot(1)
    merged = p.snapshot_scan(1)
    assert merged["snap_events"] == 236 and merged["tail_events"] == 0
    _same_res(merged, j.snapshot_scan(1))
    live = p._fanout_snapshot_scan(1)
    assert sorted(canon(merged["batch"], merged["ids"])) == sorted(canon(live["batch"],
                                                                         live["ids"]))
    new = [{"event": "buy", "entityType": "user", "entityId": f"u{q}",
            "targetEntityType": "item", "targetEntityId": "iNEW", "eventId": f"n{q}",
            "properties": {"color": "brand-new"},
            "eventTime": "2026-03-01T00:00:00+00:00",
            "creationTime": "2026-03-01T00:00:00+00:00"} for q in range(9)]
    for ev in (j, p):
        ev.insert_json_batch(new, 1)
    res = p.snapshot_scan(1)
    assert res["snap_events"] == 236 and res["tail_events"] == 9
    _same_res(res, j.snapshot_scan(1))
    for ev in (j, p):
        assert ev.delete("e30", 1)
    res = p.snapshot_scan(1)
    assert res["events"] == 244 and "e30" not in {r[0] for r in canon(res["batch"], res["ids"])}
    _same_res(res, j.snapshot_scan(1))
    for ev in (j, p):
        chan = ev._shards[0].node_root("a") / "events" / "app_1" / "_default"
        seg = sorted(chan.glob("seg-*.jsonl"))[0]
        seg.write_bytes(b'{"event":"buy","entityType":"user","entityId":"uZ",'
                        b'"eventId":"zz0","eventTime":"2026-01-01T00:00:00Z"}\n')
    res2 = p.snapshot_scan(1)
    assert "zz0" in {r[0] for r in canon(res2["batch"], res2.get("ids"))}
    want2 = j.snapshot_scan(1)
    assert canon(res2["batch"], res2.get("ids")) == canon(want2["batch"], want2.get("ids"))


def test_scan_tail_from_merges_into_base_dicts(store3_pair, monkeypatch):
    """A parallel ``scan_tail_from`` with a base carries the base's
    dictionary objects (the shared-dictionary splice), decodes as the
    1-worker oracle does, and equals the JAX package's tail."""
    j, p = store3_pair
    monkeypatch.setenv("PIO_SCAN_WORKERS", "4")
    snaps = []
    for ev in (p, j):
        ev.build_snapshot(1)
        snaps.append(ev.snapshot_scan(1))
        ev.insert_json_batch(
            [{"event": "buy", "entityType": "user", "entityId": f"u{q % 13}",
              "targetEntityType": "item", "targetEntityId": f"iT{q}", "eventId": f"t{q}",
              "properties": {"color": f"cT{q % 4}"}, "eventTime": "2026-03-01T00:00:00+00:00",
              "creationTime": "2026-03-01T00:00:00+00:00"} for q in range(20)], 1)
    snap = snaps[0]
    base = snap["batch"]
    tail = p.scan_tail_from(1, None, snap["watermark"], base=base, heads=snap["heads"])
    assert tail["events"] == 20
    for d in ("event_dict", "entity_type_dict", "entity_dict", "target_dict"):
        assert getattr(tail["batch"], d) is getattr(base, d), d
    assert tail["batch"].prop_columns["color"].dict is base.prop_columns["color"].dict
    spliced = EventBatch.concat([base, tail["batch"]])
    assert spliced.event_dict is base.event_dict
    jtail = j.scan_tail_from(1, None, snaps[1]["watermark"], base=snaps[1]["batch"],
                             heads=snaps[1]["heads"])
    assert_same_batch(spliced, jax_columnar.EventBatch.concat([snaps[1]["batch"],
                                                               jtail["batch"]]))
    monkeypatch.setenv("PIO_SCAN_WORKERS", "1")
    ser = p.scan_tail_from(1, None, snap["watermark"], base=None, heads=snap["heads"])
    assert canon(tail["batch"], tail["ids"]) == canon(ser["batch"], ser["ids"])
    assert tail["watermark"] == ser["watermark"]
    up_p = p.scan_events_up_to(1, None, tail["watermark"], heads=tail["heads"])
    monkeypatch.setenv("PIO_SCAN_WORKERS", "4")
    up_s = p.scan_events_up_to(1, None, tail["watermark"], heads=tail["heads"])
    assert up_p["events"] == up_s["events"] == len(spliced)
    assert canon(up_p["batch"]) == canon(up_s["batch"])
    assert_same_batch(up_s["batch"], j.scan_events_up_to(
        1, None, jtail["watermark"], heads=jtail["heads"])["batch"])


def test_partition_mid_fanout_promotes_and_dedups(tmp_path, monkeypatch):
    """A primary taken away while its shard's worker scans: the worker
    promotes the replica and re-reads, every acknowledged event once, the
    same as the serial oracle on the promoted topology."""
    monkeypatch.setenv("PIO_FSYNC", "always")
    monkeypatch.setenv("PIO_SCAN_WORKERS", "2")
    ev = sharded.ShardedEvents(tmp_path / "s", shards=2, replicas=2)
    try:
        _ingest(ev, 40)
        fired = {}
        orig = localfs.FSEvents.scan_tail_from

        def boom(self, *a, **kw):
            root = getattr(self, "_node_root", None)
            if (not fired and root is not None and root.name == "a"
                    and root.parent.name == "shard_00"):
                fired["yank"] = True
                shutil.move(str(root), str(root.parent / "a.lost"))
                raise OSError("injected partition mid-fan-out")
            return orig(self, *a, **kw)

        monkeypatch.setattr(localfs.FSEvents, "scan_tail_from", boom)
        res = ev._fanout_snapshot_scan(1)
        assert fired
        got = [r[0] for r in canon(res["batch"], res["ids"])]
        assert sorted(got) == sorted(f"e{k}" for k in range(40)) and len(set(got)) == 40
        assert ev._shards[0].topology()["epoch"] >= 1
        monkeypatch.setattr(localfs.FSEvents, "scan_tail_from", orig)
        monkeypatch.setenv("PIO_SCAN_WORKERS", "1")
        ser = ev._fanout_snapshot_scan(1)
        assert canon(res["batch"], res["ids"]) == canon(ser["batch"], ser["ids"])
    finally:
        ev.close()


def test_find_heap_merge_order_and_limit_pushdown(tmp_path, monkeypatch):
    """``find`` merges the shards in (eventTime, creationTime) order, pushes
    the limit down to each shard, and answers as the JAX store does, ties
    across shards included."""
    monkeypatch.setenv("PIO_FSYNC", "rotate")
    items = [{"event": "buy", "entityType": "user", "entityId": f"u{k}", "eventId": f"e{k}",
              "eventTime": (dt.datetime(2026, 2, 1, tzinfo=dt.timezone.utc)
                            + dt.timedelta(seconds=k // 3)).isoformat(),
              "creationTime": (dt.datetime(2026, 2, 1, tzinfo=dt.timezone.utc)
                               + dt.timedelta(seconds=k % 2)).isoformat()}
             for k in range(60)]
    p = sharded.ShardedEvents(tmp_path / "p", shards=3, replicas=1)
    j = jax_sharded.ShardedEvents(tmp_path / "j", shards=3, replicas=1)
    try:
        for ev in (p, j):
            ev.insert_json_batch(items, 1)
        seen = []
        orig = localfs.FSEvents.find

        def spy(self, app_id, **kw):
            seen.append(kw.get("limit"))
            return orig(self, app_id, **kw)

        monkeypatch.setattr(localfs.FSEvents, "find", spy)
        for kw in ({"limit": 7}, {"limit": 5, "reversed_order": True}, {},
                   {"reversed_order": True}, {"limit": 0}):
            got = [e.event_id for e in p.find(1, **kw)]
            assert got == [e.event_id for e in j.find(1, **kw)], kw
        assert seen[:3] == [7, 7, 7]
    finally:
        _close(p, j)


def test_scan_workers_env_parsing(monkeypatch):
    for value in ("3", "not-a-number", "0", "", "-2", None):
        if value is None:
            monkeypatch.delenv("PIO_SCAN_WORKERS", raising=False)
        else:
            monkeypatch.setenv("PIO_SCAN_WORKERS", value)
        for n in (1, 2, 8, 64):
            assert sharded._scan_workers(n) == jax_sharded._scan_workers(n), (value, n)
    monkeypatch.setenv("PIO_SCAN_WORKERS", "3")
    assert sharded._scan_workers(8) == 3 and sharded._scan_workers(2) == 2


def test_scan_pool_is_persistent_and_host_only(store3_pair, monkeypatch):
    """One pool serves every fan-out at a given width (resized when the knob
    changes), its threads are named ``pio-scan``, and ``close`` shuts it."""
    _, p = store3_pair
    monkeypatch.setenv("PIO_SCAN_WORKERS", "2")
    p._fanout_snapshot_scan(1)
    pool = p._scan_pool
    p._fanout_snapshot_scan(1)
    assert p._scan_pool is pool and p._scan_pool_size == 2
    monkeypatch.setenv("PIO_SCAN_WORKERS", "3")
    p._fanout_snapshot_scan(1)
    assert p._scan_pool is not pool and p._scan_pool_size == 3
    names = {t.name for t in p._scan_pool._threads}
    assert names and all(n.startswith("pio-scan") for n in names)
    p.close()
    assert p._scan_pool is None


# -- BatchMerger and the native dictionary handles --------------------------------------


def _mk_parts(pkg, seed):
    Event = pkg.Event
    rng = np.random.default_rng(seed)

    def mk(lo, hi, n):
        evs = []
        for q in range(n):
            props = ({"rating": float(int(rng.integers(0, 5))), "color": f"c{int(rng.integers(lo, hi))}"}
                     if rng.random() > 0.5 else {})
            tgt = f"i{int(rng.integers(lo, hi))}" if rng.random() > 0.3 else None
            evs.append(Event(event=f"ev{int(rng.integers(0, 3))}", entity_type="user",
                             entity_id=f"u{int(rng.integers(lo, hi))}",
                             target_entity_type="item" if tgt else None, target_entity_id=tgt,
                             properties=props, event_id=f"x{seed}-{lo}-{q}",
                             event_time=dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
                             + dt.timedelta(seconds=q)))
        return evs
    return [mk(0, 9, 17), mk(5, 14, 11), mk(100, 109, 23), mk(3, 7, 0), mk(0, 120, 31)]


@pytest.mark.parametrize("native", ["on", "off"])
@pytest.mark.parametrize("seed", [5, 6])
def test_batch_merger_matches_pairwise_concat_and_jax(native, seed, monkeypatch):
    """One k-way ``BatchMerger`` pass equals pairwise ``concat`` (decoded
    rows) and the JAX ``BatchMerger`` on the same parts (codes and
    dictionaries), natively and through the numpy oracle."""
    from predictionio_tpu.events import event as jax_event
    from predictionio_tpu_torch.events import event as port_event

    monkeypatch.setenv("PIO_NATIVE", native)
    parts = [EventBatch.from_events(evs) for evs in _mk_parts(port_event, seed)]
    jparts = [jax_columnar.EventBatch.from_events(evs) for evs in _mk_parts(jax_event, seed)]
    pairwise = parts[0]
    for part in parts[1:]:
        pairwise = EventBatch.concat([pairwise, part])
    merger, jmerger = BatchMerger(), jax_columnar.BatchMerger()
    for part, jpart in zip(parts, jparts):
        merger.add(part)
        jmerger.add(jpart)
    kway, _ = merger.finish()
    want, _ = jmerger.finish()
    assert canon(kway) == canon(pairwise)
    assert_same_batch(kway, want)
    assert_same_batch(EventBatch.concat(parts), jax_columnar.EventBatch.concat(jparts))


@pytest.mark.parametrize("native", ["on", "off"])
def test_batch_merger_with_base_and_props_matches_jax(store3_pair, native, monkeypatch):
    """``BatchMerger(base=...)`` grows the base's dictionaries in place (its
    property dictionaries too) and merges the id columns, as the JAX one does
    on the same parts: each shard's own snapshot read, so the property
    dictionaries disagree."""
    j, p = store3_pair
    monkeypatch.setenv("PIO_NATIVE", native)
    reads = {}
    for name, ev in (("jax", j), ("port", p)):
        ev.build_snapshot(1)
        reads[name] = [sh.events().snapshot_scan(1) for sh in ev._shards]
    for base_k in (None, 0):
        out = {}
        for name, cls in (("jax", jax_columnar.BatchMerger), ("port", BatchMerger)):
            rs = reads[name]
            base = None if base_k is None else rs[base_k]["batch"].subset(
                np.arange(len(rs[base_k]["batch"])) < 5)
            m = cls(base=base)
            for r in rs:
                m.add(r["batch"], r["ids"])
            batch, ids = m.finish()
            if base is not None:
                assert batch.entity_dict is base.entity_dict
            out[name] = (batch, ids)
        assert_same_batch(out["port"][0], out["jax"][0])
        assert out["port"][1].tolist() == out["jax"][1].tolist()


def _recoded_props(batch, mod):
    """``batch`` with each string property column re-coded into a dictionary
    of its own (reversed, one string added): the four dictionaries stay
    shared with ``batch``, the property dictionaries differ."""
    props = {}
    for key, col in batch.prop_columns.items():
        strings = col.dict.strings()[::-1] + [f"added-{key}"]
        d = mod.IdDict(strings)
        remap = np.array([d.id(x) for x in col.dict.strings()], np.int32)
        codes = remap[col.codes] if len(col.codes) else col.codes
        props[key] = mod.PropColumn(col.rows, col.kind, col.num, col.str_offs, codes, d)
    return mod.EventBatch(batch.event_codes, batch.entity_type_codes, batch.entity_ids,
                          batch.target_ids, batch.times_us, batch.ratings, batch.event_dict,
                          batch.entity_type_dict, batch.entity_dict, batch.target_dict,
                          prop_columns=props)


def test_concat_of_shared_dictionaries_leaves_its_inputs_as_they_were(store3_pair):
    """``EventBatch.concat`` of batches that share their four dictionaries
    but not their property dictionaries re-codes those into new dictionaries
    as the JAX concat does, and changes no input's dictionary."""
    from predictionio_tpu_torch.store import columnar as port_columnar

    j, p = store3_pair
    out = {}
    for name, ev, mod in (("jax", j, jax_columnar), ("port", p, port_columnar)):
        ev.build_snapshot(1)
        b0 = ev._shards[0].events().snapshot_scan(1)["batch"]
        assert any(len(c.codes) for c in b0.prop_columns.values())
        b1 = _recoded_props(b0.subset(np.arange(len(b0)) % 2 == 0), mod)
        before = [(k, c.dict, c.dict.strings()) for b in (b0, b1)
                  for k, c in b.prop_columns.items()]
        dicts = [getattr(b0, d).strings() for d in EventBatch._DICTS]
        out[name] = mod.EventBatch.concat([b0, b1, b0])
        assert [(k, c.dict, c.dict.strings()) for b in (b0, b1)
                for k, c in b.prop_columns.items()] == before
        assert [getattr(b0, d).strings() for d in EventBatch._DICTS] == dicts
        assert out[name].entity_dict is b0.entity_dict
    assert_same_batch(out["port"], out["jax"])
    assert canon(out["port"]) == canon(out["jax"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dict_handle_and_take_native_equal_the_oracle_and_jax(seed):
    """``DictHandle`` unions and ``take_i32`` gathers: the port's native core
    against the numpy oracle and the JAX package's native core."""
    from predictionio_tpu.native import core as jax_ncore

    if ncore.lib() is None:
        pytest.skip("no C++ compiler: the native core did not build")
    rng = np.random.default_rng(seed)
    alphabet = ["a", "b", "é", "☃", "\U0001f600", "\x00", "zz"]
    handles = [ncore.DictHandle()]
    if jax_ncore.lib() is not None:
        handles.append(jax_ncore.DictHandle())
    oracle: dict = {}
    for _ in range(6):
        strs = ["".join(rng.choice(alphabet, int(rng.integers(0, 4))))
                for _ in range(int(rng.integers(0, 40)))]
        strs = list(dict.fromkeys(strs))          # an IdDict holds each once
        enc = [s.encode("utf-8", "surrogatepass") for s in strs]
        blob = b"".join(enc)
        offs = np.zeros(len(enc) + 1, np.int64)
        np.cumsum([len(e) for e in enc], out=offs[1:])
        want = []
        n0 = len(oracle)
        for s in strs:
            want.append(oracle.setdefault(s, len(oracle)))
        for h in handles:
            before = len(h)
            cmap, n_new = h.union(blob, offs)
            assert cmap.tolist() == want and n_new == len(oracle) - n0
            eb, eo = h.export(before)
            new = [eb[eo[q]:eo[q + 1]].decode("utf-8", "surrogatepass")
                   for q in range(len(eo) - 1)]
            assert new == list(oracle)[n0:]
    with pytest.raises(ValueError):
        handles[0].export(len(handles[0]) + 1)
    cmap = rng.integers(0, 1000, 50).astype(np.int32)
    for sentinel in (False, True):
        codes = rng.integers(-1 if sentinel else 0, 50, 300).astype(np.int32)
        out = np.empty(300, np.int32)
        assert ncore.take_i32(cmap, codes, out, sentinel)
        ext = np.append(cmap, np.int32(-1)) if sentinel else cmap
        assert np.array_equal(out, np.take(ext, codes))
        if jax_ncore.lib() is not None:
            jout = np.empty(300, np.int32)
            assert jax_ncore.take_i32(cmap, codes, jout, sentinel)
            assert np.array_equal(out, jout)
    bad = np.array([0, 50], np.int32)
    assert not ncore.take_i32(cmap, bad, np.empty(2, np.int32), False)
    with pytest.raises(IndexError):
        np.take(cmap, bad)
    # buffers the C side cannot write safely go to the oracle instead
    good = np.array([0, 1], np.int32)
    assert not ncore.take_i32(cmap, good, np.empty(4, np.int32)[::2], False)
    assert not ncore.take_i32(cmap, good, np.empty(2, np.int64), False)
    assert not ncore.take_i32(cmap, good, np.empty(3, np.int32), False)
    with pytest.raises(ValueError):
        handles[0].union(b"ab", np.array([0, 1, 5], np.int64))


def test_batch_merger_counts_a_native_failure_and_carries_on(monkeypatch):
    """A native union that raises mid-merge is counted as an ``error``
    fallback and the Python path finishes with the same result."""
    from predictionio_tpu_torch.events import event as port_event

    if ncore.lib() is None:
        pytest.skip("no C++ compiler: the native core did not build")
    monkeypatch.setenv("PIO_NATIVE", "on")
    parts = [EventBatch.from_events(evs) for evs in _mk_parts(port_event, 3)]
    want = BatchMerger()
    monkeypatch.setenv("PIO_NATIVE", "off")
    oracle = BatchMerger()
    for part in parts:
        oracle.add(part)
    monkeypatch.setenv("PIO_NATIVE", "on")
    calls = {"n": 0}
    real = ncore.DictHandle.union

    def flaky(self, blob, offs):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("injected")
        return real(self, blob, offs)

    monkeypatch.setattr(ncore.DictHandle, "union", flaky)
    before = ncore.fallbacks["error"]
    for part in parts:
        want.add(part)
    assert ncore.fallbacks["error"] == before + 1
    assert_same_batch(want.finish()[0], oracle.finish()[0])


# -- the fold over a sharded tail ----------------------------------------------------------


def test_fold_over_a_two_shard_tail_equals_a_retrain_and_the_jax_fold(tmp_path, monkeypatch):
    """The port fold over one two-shard tail is bit-exact against a port
    retrain reading the same store (the staged cache splices the same tail
    after the same base), and agrees with the JAX fold on the same store:
    ids equal but at ties, scores within 1e-4."""
    from _torch_stream_cases import assert_models_equal
    from predictionio_tpu.models.universal_recommender import engine as jax_ur
    from predictionio_tpu.store import event_store as jax_event_store
    from predictionio_tpu.streaming.fold import URFoldState as JaxFoldState
    from predictionio_tpu_torch.models.universal_recommender import engine as port_ur
    from predictionio_tpu_torch.storage import set_storage
    from predictionio_tpu_torch.store import event_store
    from predictionio_tpu_torch.streaming.fold import URFoldState

    cfg = _sharded_cfg(tmp_path / "st")
    store = Storage(StorageConfig(**cfg))
    jstore = JaxStorage(JaxStorageConfig(**cfg))
    specs = [s for s in seeded_corpus(11, n_users=40, n_items=35, n_inter=700)
             if not s[0].startswith("$")]
    app_id = store.apps.insert(App(0, "foldapp"))
    store.l_events.insert_batch(port_events(specs[:500]), app_id)
    ds = port_ur.URDataSourceParams(app_name="foldapp", event_names=["purchase", "view"])
    ap = port_ur.URAlgorithmParams(app_name="foldapp", max_correlators_per_item=6)
    jds = jax_ur.URDataSourceParams(app_name="foldapp", event_names=["purchase", "view"])
    jap = jax_ur.URAlgorithmParams(app_name="foldapp", mesh_dp=1, max_correlators_per_item=6)
    set_storage(store)
    event_store.invalidate_staging_cache()
    jax_event_store.invalidate_staging_cache()
    try:
        ev, jev = store.l_events, jstore.l_events
        base = ev.snapshot_scan(app_id)
        jbase = jev.snapshot_scan(app_id)
        state = URFoldState.bootstrap(ap, ds, base["batch"], device="cpu")
        jstate = JaxFoldState.bootstrap(jap, jds, jbase["batch"])

        def retrain():
            td = port_ur.URDataSource(ds).read_training()
            return port_ur.URAlgorithm(ap, device="cpu").train(td)

        assert_models_equal(state.model, retrain(), "bootstrap vs train")
        # one append that lands on both shards
        tail_specs = specs[500:]
        assert {sharded.shard_of("user", s[2], 2) for s in tail_specs} == {0, 1}
        ev.insert_batch(port_events(tail_specs), app_id)
        tail = ev.scan_tail_from(app_id, None, base["watermark"], base=state.batch,
                                 heads=base["heads"])
        jtail = jev.scan_tail_from(app_id, None, jbase["watermark"], base=jstate.batch,
                                   heads=jbase["heads"])
        assert tail["events"] == len(tail_specs) and set(tail["watermark"]) == set(
            jtail["watermark"])
        state.fold(tail["batch"])
        jstate.fold(jtail["batch"])
        deltas = event_store.staging_counts()["delta"]
        ref = retrain()
        assert event_store.staging_counts()["delta"] - deltas == len(tail_specs)
        assert_models_equal(state.model, ref, "fold vs retrain")
        got, want = state.model, jstate.model
        assert got.item_dict.strings() == want.item_dict.strings()
        for name in want.indicator_idx:
            g_idx, w_idx = got.indicator_idx[name], np.asarray(want.indicator_idx[name])
            g_llr, w_llr = got.indicator_llr[name], np.asarray(want.indicator_llr[name])
            np.testing.assert_allclose(g_llr, w_llr, rtol=1e-4, atol=1e-4)
            differ = g_idx != w_idx
            # ids differ only where the JAX scores tie within the tolerance
            for r, c in zip(*np.nonzero(differ)):
                row = w_llr[r]
                assert np.isclose(row, row[c], rtol=1e-4, atol=1e-4).sum() > 1, (name, r, c)
    finally:
        set_storage(None)
        event_store.invalidate_staging_cache()
        jax_event_store.invalidate_staging_cache()
        store.l_events.close()
        jstore.l_events.close()


# -- the CLI on the three backends -------------------------------------------------------


def test_cli_train_and_follow_on_sharded_sql_and_sharedfs(tmp_path, monkeypatch, capsys):
    """``pio app new`` → ``pio import`` → ``pio train`` → ``deploy(follow=)``
    on the CPU with EVENTDATA on ``sharded`` (2 x 2), METADATA on ``sql`` (a
    SQLite file) and MODELDATA on ``sharedfs``, configured through the
    locator's environment variables; the follower folds an append on the
    sharded store and answers with it."""
    import time

    from predictionio_tpu_torch.cli.main import main as pio
    from predictionio_tpu_torch.storage import get_storage, set_storage
    from predictionio_tpu_torch.storage import sql as port_sql
    from predictionio_tpu_torch.storage import sharedfs as port_sharedfs
    from predictionio_tpu_torch.store import event_store
    from predictionio_tpu_torch.workflow.create_server import deploy

    env = {"PIO_STORAGE_SOURCES_EV_TYPE": "sharded",
           "PIO_STORAGE_SOURCES_EV_PATH": str(tmp_path / "ev"),
           "PIO_STORAGE_SOURCES_EV_SHARDS": "2", "PIO_STORAGE_SOURCES_EV_REPLICAS": "2",
           "PIO_STORAGE_SOURCES_META_TYPE": "sql",
           "PIO_STORAGE_SOURCES_META_PATH": str(tmp_path / "meta.db"),
           "PIO_STORAGE_SOURCES_MOD_TYPE": "sharedfs",
           "PIO_STORAGE_SOURCES_MOD_PATH": str(tmp_path / "models"),
           "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "EV",
           "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "META",
           "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MOD",
           "PIO_TORCH_DEVICE": "cpu"}
    for k in [k for k in os.environ if k.startswith("PIO_STORAGE_")]:
        monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.chdir(tmp_path)
    set_storage(None)
    event_store.invalidate_staging_cache()
    rng = np.random.default_rng(4)
    with open(tmp_path / "events.jsonl", "w") as f:
        for q in range(600):
            f.write(json.dumps({"event": ("purchase", "view")[q % 2], "entityType": "user",
                                "entityId": f"u{int(rng.integers(30))}",
                                "targetEntityType": "item",
                                "targetEntityId": f"i{int(rng.integers(25))}",
                                "eventTime": f"2026-01-01T00:{q // 60:02d}:{q % 60:02d}Z"})
                    + "\n")
    engine_json = tmp_path / "engine.json"
    engine_json.write_text(json.dumps({
        "id": "cli-sharded", "engineFactory": "universal_recommender",
        "datasource": {"params": {"appName": "shop", "eventNames": ["purchase", "view"]}},
        "algorithms": [{"name": "ur", "params": {"appName": "shop",
                                                 "maxCorrelatorsPerItem": 5}}]}))
    server = None
    try:
        assert pio(["app", "new", "shop"]) == 0
        assert pio(["import", "--app-name", "shop", "--input",
                    str(tmp_path / "events.jsonl")]) == 0
        assert pio(["build", "--engine-json", str(engine_json)]) == 0
        assert pio(["train", "--engine-json", str(engine_json)]) == 0
        store = get_storage()
        assert isinstance(store.l_events, sharded.ShardedEvents)
        assert isinstance(store.apps, port_sql.SQLApps)
        assert isinstance(store.models, port_sharedfs.SharedModels)
        app_id = store.apps.get_by_name("shop").id
        assert len(list(store.l_events.find(app_id))) == 600
        inst = store.engine_instances.get_latest_completed("cli-sharded", "1", "default")
        assert inst is not None and store.models.get(inst.id)
        assert list((tmp_path / "models" / "models").iterdir())
        assert (tmp_path / "meta.db").exists()
        server = deploy(str(engine_json), host="127.0.0.1", port=0, device="cpu",
                        follow=0.1)
        follower = server.pio_state.follower
        assert follower is not None and follower.mode == "fold"
        deadline = time.time() + 60
        while time.time() < deadline and follower.generation < 1:
            time.sleep(0.05)
        url = f"http://127.0.0.1:{server.server_address[1]}/queries.json"
        from predictionio_tpu_torch.events.event import Event

        store.l_events.insert_batch([Event("purchase", "user", "probe", "item", "i1")]
                                    + [Event("purchase", "user", f"cob{q}", "item", it)
                                       for q in range(4) for it in ("i1", "brand-new")],
                                    app_id)
        found = False
        while time.time() < deadline and not found:
            req = urllib.request.Request(url, data=json.dumps({"user": "probe",
                                                               "num": 30}).encode())
            with urllib.request.urlopen(req, timeout=10) as r:
                found = any(s["item"] == "brand-new" for s in json.loads(r.read())["itemScores"])
            time.sleep(0.05)
        assert found, "the follower did not fold the append on the sharded store"
        assert follower.status()["lastOutcome"] in ("fold", "idle")
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        store = get_storage()
        store.l_events.close()
        set_storage(None)
        event_store.invalidate_staging_cache()
        capsys.readouterr()


def test_pio_store_metrics_match_jax():
    """The nine ``pio_store_*`` families: the JAX names, kinds and help texts."""
    from predictionio_tpu.obs.metrics import get_registry as jax_registry
    from predictionio_tpu_torch.obs.metrics import get_registry

    names = ["pio_store_shard_events_total", "pio_store_replica_lag_events",
             "pio_store_replicated_bytes_total", "pio_store_replica_heals_total",
             "pio_store_promotions_total", "pio_store_shards",
             "pio_store_scan_shard_duration_seconds", "pio_store_scan_workers",
             "pio_store_scan_merged_events_per_sec"]
    mine, theirs = get_registry(), jax_registry()
    for n in names:
        g, w = mine._metrics[n], theirs._metrics[n]
        assert (g.kind, g.help) == (w.kind, w.help), n
