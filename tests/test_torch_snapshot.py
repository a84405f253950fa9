"""The port's columnar snapshots and staged retrain cache against the JAX
package's, on one store directory.

The localfs cases of ``tests/test_snapshot.py``, each holding the port
against the JAX package on the same store: the PIOCOL01 container (files
written by either package are byte-equal and each reads the other's),
build and scan with properties, the tail spliced after a build,
``find_batches`` with filters, tombstones, recreated segments, compaction,
a SIGKILL mid-build, a torn snapshot, the one-build-at-a-time lock (also
with one JAX and one port builder), the delta retrain, the automatic
build, the name-filtered scan and the shared-dictionary concat.  Each
package reads the other's snapshot and manifest, and the UR's
``read_training`` from a snapshot plus its tail, from a tombstoned log and
as a delta equals the JAX package's.  Everything compares exactly; two
builds' manifests differ only in ``built_at``, ``build_s`` and the random
part of the file name.

The staged cache is process-wide: every test starts and ends with both
packages' caches empty.  No test needs the JAX package's native scanner:
its snapshot read answers the same through its Python header parse.
"""

import datetime as dt
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import predictionio_tpu.storage.localfs as jax_localfs
from predictionio_tpu.models.universal_recommender import engine as jax_ur
from predictionio_tpu.storage import App as JaxApp
from predictionio_tpu.storage import set_storage as jax_set_storage
from predictionio_tpu.storage import snapshot as jax_snap
from predictionio_tpu.storage.locator import Storage as JaxStorage
from predictionio_tpu.storage.locator import StorageConfig as JaxStorageConfig
from predictionio_tpu.store import columnar as jax_columnar
from predictionio_tpu.store import event_store as jax_event_store
import predictionio_tpu_torch.storage.localfs as port_localfs
from predictionio_tpu_torch.models.universal_recommender import engine as ur
from predictionio_tpu_torch.native import core as ncore
from predictionio_tpu_torch.storage import App, Storage, StorageConfig, set_storage
from predictionio_tpu_torch.storage import snapshot as snap
from predictionio_tpu_torch.store import columnar
from predictionio_tpu_torch.store import event_store

from _torch_event_cases import (
    T0,
    assert_same_batch,
    jax_event_server_writes,
    jax_events,
    port_events,
    seeded_corpus,
)

REPO = Path(__file__).resolve().parents[1]
PACKAGES = ("jax", "port")


@pytest.fixture(autouse=True)
def _cold_caches():
    event_store.invalidate_staging_cache()
    jax_event_store.invalidate_staging_cache()
    yield
    event_store.invalidate_staging_cache()
    jax_event_store.invalidate_staging_cache()


@pytest.fixture()
def small_segments(monkeypatch):
    monkeypatch.setattr(jax_localfs, "SEGMENT_MAX_BYTES", 4000)
    monkeypatch.setattr(port_localfs, "SEGMENT_MAX_BYTES", 4000)


def ts(h):
    return T0 + 3600.0 * h


def mixed_specs(n, tag="m"):
    """Interactions and ``$set`` events covering every property kind, as
    ``(event, entity type, id, target type, target id, props, time,
    creation time)`` specs with event ids ``<tag>NNNNNNN`` from position."""
    out = []
    for k in range(n):
        if k % 5 == 4:
            out.append(("$set", "item", f"i{k % 7}", None, None,
                        {"color": "red" if k % 2 else "blue", "sizes": ["s", "m"],
                         "stock": k, "active": bool(k % 2), "meta": {"a": k % 3},
                         "none": None}, ts(k), ts(k)))
        else:
            out.append(("buy" if k % 2 else "view", "user", f"u{k % 11}", "item",
                        f"i{k % 7}", {"rating": float(k % 5)}, ts(k), ts(k)))
    return out


def _events(pkg, specs, tag):
    evs = (jax_events if pkg == "jax" else port_events)(specs)
    for k, e in enumerate(evs):
        e.event_id = f"{tag}{k:07d}"
    return evs


class Both:
    """One store directory with a JAX and a port ``FSEvents`` over it."""

    def __init__(self, root):
        self.root = root
        self.fs = {"jax": jax_localfs.FSEvents(root), "port": port_localfs.FSEvents(root)}

    def insert(self, pkg, specs, tag):
        """Append in batches of 40 (a writer rotates between appends, so
        the 4,000-byte segments make a multi-segment log)."""
        evs = _events(pkg, specs, tag)
        for k in range(0, len(evs), 40):
            self.fs[pkg].insert_batch(evs[k:k + 40], 1)
        return [e.event_id for e in evs]

    def rows(self, **filters):
        """The JAX scan's events as sorted rows (see ``_row``)."""
        return sort_rows(_row(e) for e in self.fs["jax"].scan(1, **filters))


def _row(e):
    return (e.event, e.entity_type, e.entity_id, e.target_entity_id,
            int(e.event_time.timestamp() * 1e6), e.event_id)


def batch_rows(batch, ids=None):
    """The rows of a columnar batch (either package's), sorted."""
    idl = ids.tolist() if ids is not None else [None] * len(batch)
    out = []
    for j in range(len(batch)):
        t = int(batch.target_ids[j])
        out.append((batch.event_dict.str(int(batch.event_codes[j])),
                    batch.entity_type_dict.str(int(batch.entity_type_codes[j])),
                    batch.entity_dict.str(int(batch.entity_ids[j])),
                    batch.target_dict.str(t) if t >= 0 else None,
                    int(batch.times_us[j]), idl[j]))
    return sorted(out, key=lambda r: tuple("" if x is None else x for x in r))


def sort_rows(rows):
    return sorted(rows, key=lambda r: tuple("" if x is None else x for x in r))


def assert_same_scan(got, want):
    """Two ``snapshot_scan`` results equal: batch, ids, counts, watermark."""
    assert (got is None) == (want is None)
    if want is None:
        return
    assert_same_batch(got["batch"], want["batch"])
    assert got["ids"].tolist() == want["ids"].tolist()
    for k in ("snap_events", "tail_events", "watermark", "heads"):
        assert got[k] == want[k], k


def same_manifest(a, b):
    """Two builds' manifests equal but for their times and the random
    part of the file name (``snap-<writer>-<8 hex>.pioc``)."""
    import re

    def keep(m):
        assert re.fullmatch(r"snap-local-[0-9a-f]{8}\.pioc", m["snapshot"])
        return {k: v for k, v in m.items() if k not in ("built_at", "build_s", "snapshot")}

    return keep(a) == keep(b)


@pytest.fixture()
def both(tmp_path, small_segments):
    return Both(tmp_path / "store")


# -- the container ---------------------------------------------------------------


def _builders(specs):
    """The same events through both packages' ``ColumnarBuilder``."""
    lines = [json.loads(e.to_json_line()) for e in _events("port", specs, "c")]
    out = {}
    for pkg, mod in (("jax", jax_snap), ("port", snap)):
        b = mod.ColumnarBuilder()
        for d in lines:
            b.add(d)
        out[pkg] = b.finish()
    return out


SURROGATE_SPECS = mixed_specs(40) + [
    ("view", "user", "u\ud800x", "item", "i\udfff", {"tag": ["a\ud83d", "café ☃"]}, ts(50), ts(50)),
    ("$set", "item", "i3", None, None, {"title": "\U0001f600 \udc00"}, ts(51), ts(51)),
    ("view", "user", "u\0", "item", "i\0\0", {"tag": ["\0"]}, ts(52), ts(52))]


@pytest.mark.parametrize("with_ids", [True, False])
@pytest.mark.parametrize("specs", [mixed_specs(60), SURROGATE_SPECS, []],
                         ids=["mixed", "surrogates", "empty"])
def test_write_batch_files_are_byte_equal_and_read_across(tmp_path, monkeypatch, specs,
                                                          with_ids):
    built = _builders(specs)
    assert_same_batch(built["port"][0], built["jax"][0])
    paths = {}
    for pkg, mod in (("jax", jax_columnar), ("port", columnar)):
        batch, ids = built[pkg]
        paths[pkg] = tmp_path / f"{pkg}.pioc"
        mod.write_batch(paths[pkg], batch, ids if with_ids else None, meta={"w": {"s": 12}})
    assert paths["jax"].read_bytes() == paths["port"].read_bytes()
    for native in ("off", "on"):
        monkeypatch.setenv("PIO_NATIVE", native)
        for writer in PACKAGES:
            got, gids, gmeta = columnar.read_batch(paths[writer])
            want, wids, wmeta = jax_columnar.read_batch(paths[writer])
            assert_same_batch(got, want)
            assert_same_batch(got, built["jax"][0])
            assert gmeta == wmeta == {"w": {"s": 12}}
            assert (gids is None) == (not with_ids)
            if with_ids:
                assert gids.tolist() == wids.tolist() == built["jax"][1].tolist()
            assert not got.event_codes.flags.writeable   # read-only mapped views


@pytest.mark.parametrize("damage", ["half", "third", "garbage", "empty", "header"])
@pytest.mark.parametrize("native", ["off", "on"])
def test_torn_container_is_rejected_by_both(tmp_path, monkeypatch, damage, native):
    batch, ids = _builders(mixed_specs(30))["port"]
    p = tmp_path / "b.pioc"
    columnar.write_batch(p, batch, ids)
    data = p.read_bytes()
    p.write_bytes({"half": data[:len(data) // 2], "third": data[:len(data) // 3],
                   "garbage": b"garbage-not-a-snapshot", "empty": b"",
                   "header": data[:40]}[damage])
    monkeypatch.setenv("PIO_NATIVE", native)
    for mod in (columnar, jax_columnar):
        with pytest.raises(ValueError):
            mod.read_batch(p)


# -- build and scan ---------------------------------------------------------------


@pytest.mark.parametrize("builder", PACKAGES)
def test_build_scan_parity_with_properties(both, builder):
    """Either package builds; both read the snapshot to the same batch, and
    the manifests two builds write agree but for their times."""
    both.insert("jax" if builder == "port" else "port", mixed_specs(300), "a")
    assert len(both.fs["port"].segment_paths(1)) > 1
    stats = both.fs[builder].build_snapshot(1)
    assert stats["events"] == 300
    got, want = both.fs["port"].snapshot_scan(1), both.fs["jax"].snapshot_scan(1)
    assert_same_scan(got, want)
    assert got["tail_events"] == 0 and got["manifest"]["writer"] == "local"
    assert batch_rows(got["batch"], got["ids"]) == sort_rows(both.rows())
    folded = {k: dict(v) for k, v in columnar.fold_properties(got["batch"], "item").items()}
    assert folded == {k: dict(v) for k, v in
                      both.fs["jax"].aggregate_properties(1, "item").items()}
    d = both.fs["port"]._chan_dir(1, None)
    first = snap.load_manifest(d)
    assert first == jax_snap.load_manifest(d)
    both.fs["port" if builder == "jax" else "jax"].build_snapshot(1)
    assert same_manifest(snap.load_manifest(d), first)
    assert snap.snapshot_status(d) | {"builtAt": 0, "buildSeconds": 0, "snapshot": 0} == \
        jax_snap.snapshot_status(d) | {"builtAt": 0, "buildSeconds": 0, "snapshot": 0}


def test_snapshot_of_what_the_jax_event_server_wrote(tmp_path, small_segments):
    """Events posted to the JAX event server, which appends them to its
    localfs store: the port builds the snapshot, and both packages scan it
    to the same batch."""
    from predictionio_tpu.storage.locator import Storage as JaxStorage
    from predictionio_tpu.storage.locator import StorageConfig as JaxStorageConfig

    root = tmp_path / "store"
    jax_store = JaxStorage(JaxStorageConfig(
        sources={"S": {"type": "localfs", "path": str(root)}},
        repositories={r: "S" for r in ("METADATA", "EVENTDATA", "MODELDATA")}))
    app_id = jax_event_server_writes(jax_store, "snapapp", mixed_specs(120))
    both = Both(root)
    assert both.fs["port"].build_snapshot(app_id)["events"] == 120
    got, want = both.fs["port"].snapshot_scan(app_id), both.fs["jax"].snapshot_scan(app_id)
    assert_same_scan(got, want)
    assert got["tail_events"] == 0


@pytest.mark.parametrize("writer", PACKAGES)
def test_tail_is_spliced_after_build(both, writer):
    both.insert(writer, mixed_specs(100), "a")
    both.fs["port"].build_snapshot(1)
    both.insert(writer, [("buy", "user", f"tail{k}", "item", "i0", {}, ts(k), ts(k))
                         for k in range(17)], "t")
    got, want = both.fs["port"].snapshot_scan(1), both.fs["jax"].snapshot_scan(1)
    assert_same_scan(got, want)
    assert got["snap_events"] == 100 and got["tail_events"] == 17
    assert batch_rows(got["batch"], got["ids"]) == sort_rows(both.rows())
    st = snap.snapshot_status(both.fs["port"]._chan_dir(1, None))
    assert (st["events"], st["tailEvents"]) == (100, 17) and 0 < st["coverage"] < 1
    assert got["batch"].entity_dict.id("tail0") is not None


@pytest.mark.parametrize("filters", [{}, {"event_names": ["buy"]}, {"entity_type": "item"},
                                     {"event_names": ["$set", "view"], "entity_type": "user"},
                                     {"start_time": 20, "until_time": 90},
                                     {"target_entity_type": "item"}])
def test_find_batches_with_filters(both, filters):
    both.insert("port", mixed_specs(200), "a")
    both.fs["jax"].build_snapshot(1)
    f = {k: (dt.datetime.fromtimestamp(ts(v), dt.timezone.utc) if k.endswith("_time") else v)
         for k, v in filters.items()}
    got = list(both.fs["port"].find_batches(1, **f))
    want = list(both.fs["jax"].find_batches(1, **f))
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        if "target_entity_type" in f:   # not a column filter: both scan rows
            assert batch_rows(g) == batch_rows(w)
        else:
            assert_same_batch(g, w)
    assert sort_rows(r for b in got for r in batch_rows(b)) == sort_rows(
        r[:5] + (None,) for r in both.rows(**f))


# -- tombstones and rewritten logs ----------------------------------------------


@pytest.mark.parametrize("deleter", PACKAGES)
def test_tombstoned_events_never_resurface(both, deleter):
    ids = both.insert("port", mixed_specs(120), "a")
    both.fs["port"].build_snapshot(1)
    tail = both.insert("jax", [("buy", "user", "late", "item", "i1", {}, ts(3), ts(3))] * 3, "t")
    assert both.fs[deleter].delete(ids[10], 1)
    assert both.fs[deleter].delete(tail[1], 1)
    got, want = both.fs["port"].snapshot_scan(1), both.fs["jax"].snapshot_scan(1)
    assert_same_scan(got, want)
    assert len(got["batch"]) == 121
    assert got["ids"].index_of(ids[10]) == got["ids"].index_of(tail[1]) == -1
    assert batch_rows(got["batch"], got["ids"]) == sort_rows(both.rows())
    both.fs["port"].build_snapshot(1)     # the rebuild folds the tombstones in
    again = both.fs["port"].snapshot_scan(1)
    assert_same_scan(again, both.fs["jax"].snapshot_scan(1))
    assert len(again["batch"]) == 121 and again["tail_events"] == 0
    assert again["manifest"]["tombstones_applied"] == sorted([ids[10], tail[1]])


def test_recreated_segments_invalidate_snapshot_and_watermark(both, tmp_path):
    import shutil

    both.insert("port", mixed_specs(60), "a")
    both.fs["port"].build_snapshot(1)
    res = both.fs["port"].snapshot_scan(1)
    d = both.fs["port"]._chan_dir(1, None)
    shutil.copytree(d / "snapshot", tmp_path / "stale")
    both.fs["port"].remove(1)
    both.fs["port"].init(1)
    # bigger, so the offsets "fit" again; a second later, so the first line
    # (hence the segment's head) differs
    both.insert("port", [sp[:6] + (sp[6] + 1, sp[7] + 1) for sp in mixed_specs(400)], "b")
    shutil.copytree(tmp_path / "stale", d / "snapshot")
    assert both.fs["port"].snapshot_scan(1) is None
    assert both.fs["jax"].snapshot_scan(1) is None
    for pkg in PACKAGES:
        assert both.fs[pkg].scan_tail_from(1, None, res["watermark"], heads=res["heads"]) is None
    assert len(list(both.fs["port"].scan(1))) == 400


@pytest.mark.parametrize("change", ["appended", "tombstoned", "shrunk", "recreated"])
def test_scan_events_up_to_matches_jax(both, change):
    """``scan_events_up_to`` reads exactly the events under a watermark,
    tombstones honoured, as the JAX package's does; a covered segment
    that shrank under its offset, or was recreated under its name, gives
    None in both."""
    ids = both.insert("port", mixed_specs(120), "a")
    both.fs["port"].build_snapshot(1)
    res = both.fs["port"].snapshot_scan(1)
    wm, heads = res["watermark"], res["heads"]
    assert len(wm) > 1
    both.insert("jax", mixed_specs(30, "t"), "t")     # past the watermark
    d = both.fs["port"]._chan_dir(1, None)
    if change == "tombstoned":
        assert both.fs["jax"].delete(ids[7], 1)
    elif change == "shrunk":
        name = sorted(wm)[0]
        os.truncate(d / name, wm[name] // 2)
    elif change == "recreated":
        both.fs["port"].remove(1)
        both.fs["port"].init(1)
        both.insert("port", [sp[:6] + (sp[6] + 1, sp[7] + 1) for sp in mixed_specs(400)], "b")
    got = both.fs["port"].scan_events_up_to(1, None, wm, heads=heads)
    want = both.fs["jax"].scan_events_up_to(1, None, wm, heads=heads)
    if change in ("shrunk", "recreated"):
        assert got is None and want is None
        return
    assert got["events"] == want["events"] == 120 - (change == "tombstoned")
    assert_same_batch(got["batch"], want["batch"])
    assert batch_rows(got["batch"]) == sort_rows(
        r[:5] + (None,) for r in both.rows() if r[5] in set(ids))


@pytest.mark.parametrize("compactor", PACKAGES)
def test_compaction_invalidates_snapshot(both, compactor):
    ids = both.insert("port", mixed_specs(80), "a")
    both.fs["port"].build_snapshot(1)
    both.fs[compactor].delete(ids[0], 1)
    both.fs[compactor].compact(1)
    assert both.fs["port"].snapshot_scan(1) is None
    assert both.fs["jax"].snapshot_scan(1) is None
    both.fs["port"].build_snapshot(1)
    got = both.fs["port"].snapshot_scan(1)
    assert_same_scan(got, both.fs["jax"].snapshot_scan(1))
    assert len(got["batch"]) == 79


# -- crash safety and the build lock -----------------------------------------------


def _spawn_build(pkg, root: Path, delay: str):
    mod = "predictionio_tpu" if pkg == "jax" else "predictionio_tpu_torch"
    script = (
        "import os, sys\n"
        f"os.environ['PIO_SNAPSHOT_TEST_DELAY_S'] = {delay!r}\n"
        "from pathlib import Path\n"
        f"from {mod}.storage.localfs import FSEvents\n"
        f"fs = FSEvents(Path({str(root)!r}))\n"
        "print('START', flush=True)\n"
        "print(fs.build_snapshot(1)['events'], flush=True)\n"
    )
    return subprocess.Popen([sys.executable, "-c", script], cwd=REPO,
                            env={**os.environ, "JAX_PLATFORMS": "cpu"},
                            stdout=subprocess.PIPE, text=True)


def test_sigkill_mid_build_leaves_the_store_readable(both):
    both.insert("port", mixed_specs(60), "a")
    both.fs["port"].build_snapshot(1)
    snap_dir = both.fs["port"]._chan_dir(1, None) / "snapshot"
    before = (snap_dir / "manifest.json").read_text()
    both.insert("port", mixed_specs(400), "b")
    proc = _spawn_build("port", both.root, "0.02")
    assert proc.stdout.readline().strip() == "START"
    time.sleep(1.0)                   # well inside the ~8 s parse
    os.kill(proc.pid, signal.SIGKILL)
    proc.wait()
    assert (snap_dir / "manifest.json").read_text() == before
    got = both.fs["port"].snapshot_scan(1)
    assert_same_scan(got, both.fs["jax"].snapshot_scan(1))
    assert got["snap_events"] == 60 and got["tail_events"] == 400
    both.fs["port"].build_snapshot(1)   # cleans the killed build's temporary file
    assert not list(snap_dir.glob("*.tmp*"))
    again = both.fs["port"].snapshot_scan(1)
    assert again["snap_events"] == 460 and again["tail_events"] == 0


@pytest.mark.parametrize("reader", PACKAGES)
def test_torn_snapshot_is_quarantined_and_rebuilt(both, reader):
    both.insert("port", mixed_specs(90), "a")
    both.fs["port"].build_snapshot(1)
    snap_dir = both.fs["port"]._chan_dir(1, None) / "snapshot"
    f = snap_dir / json.loads((snap_dir / "manifest.json").read_text())["snapshot"]
    f.write_bytes(f.read_bytes()[: f.stat().st_size // 3])
    quarantined = snap.counts["quarantined"]
    assert both.fs[reader].snapshot_scan(1) is None
    assert snap.counts["quarantined"] == quarantined + (reader == "port")
    assert list(snap_dir.glob("*.quarantine"))
    assert not (snap_dir / "manifest.json").exists()
    assert len(list(both.fs["port"].scan(1))) == 90
    both.fs["port"].build_snapshot(1)
    got = both.fs["port"].snapshot_scan(1)
    assert_same_scan(got, both.fs["jax"].snapshot_scan(1))
    assert len(got["batch"]) == 90


def test_concurrent_build_is_exactly_once(both):
    both.insert("port", mixed_specs(500), "a")
    lock_path = both.fs["port"]._chan_dir(1, None) / snap.SNAP_DIR / snap.LOCK
    lock_path.parent.mkdir(parents=True, exist_ok=True)
    script = ("import fcntl, time\n"
              f"f = open({str(lock_path)!r}, 'a')\n"
              "fcntl.flock(f.fileno(), fcntl.LOCK_EX)\n"
              "print('LOCKED', flush=True)\n"
              "time.sleep(120)\n")
    proc = subprocess.Popen([sys.executable, "-c", script], stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "LOCKED"
        with pytest.raises(RuntimeError, match="already in progress"):
            both.fs["port"].build_snapshot(1)
    finally:
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait()
    assert both.fs["port"].build_snapshot(1)["events"] == 500


@pytest.mark.parametrize("first", PACKAGES)
def test_a_jax_and_a_port_builder_build_once(both, first):
    """A build of either package holds the lock the other's build takes:
    the second raises while the first runs, and one snapshot results."""
    both.insert("port", mixed_specs(200), "a")
    d = both.fs["port"]._chan_dir(1, None)
    lock = d / snap.SNAP_DIR / snap.LOCK
    lock.parent.mkdir(parents=True, exist_ok=True)
    lock.touch()
    held = f":{lock.stat().st_ino} "
    proc = _spawn_build(first, both.root, "0.02")
    try:
        assert proc.stdout.readline().strip() == "START"
        deadline = time.time() + 60
        # the child holds the lock once the kernel lists a flock on its inode
        while not any(held in line and "FLOCK" in line for line in open("/proc/locks")):
            assert time.time() < deadline and proc.poll() is None
            time.sleep(0.01)
        second = "port" if first == "jax" else "jax"
        with pytest.raises(RuntimeError, match="already in progress"):
            both.fs[second].build_snapshot(1)
        assert proc.stdout.readline().strip() == "200"
    finally:
        proc.kill()
        proc.wait()
    assert len(list((d / "snapshot").glob("snap-*.pioc"))) == 1
    assert_same_scan(both.fs["port"].snapshot_scan(1), both.fs["jax"].snapshot_scan(1))


# -- the staged cache ----------------------------------------------------------------


def _storages(root):
    cfg = {"sources": {"FS": {"type": "localfs", "path": str(root)}},
           "repositories": {r: "FS" for r in ("METADATA", "EVENTDATA", "MODELDATA")}}
    return JaxStorage(JaxStorageConfig(**cfg)), Storage(StorageConfig(**cfg))


def test_delta_retrain_restages_only_new_events(tmp_path, small_segments, monkeypatch):
    jax_store, store = _storages(tmp_path / "store")
    app_id = store.apps.insert(App(0, "deltaapp"))
    ids = [e.event_id for e in _events("port", mixed_specs(250), "a")]
    store.l_events.insert_batch(_events("port", mixed_specs(250), "a"), app_id)
    store.l_events.build_snapshot(app_id)

    def read():
        got = event_store.PEventStore.batch("deltaapp", storage=store)
        assert_same_batch(got, jax_event_store.PEventStore.batch("deltaapp", storage=jax_store))
        return got

    c0 = event_store.staging_counts()
    assert len(read()) == 250
    c1 = event_store.staging_counts()
    assert c1["snapshot"] - c0["snapshot"] == 250
    store.l_events.insert_batch(_events("port", [("buy", "user", f"d{k}", "item", "i0", {},
                                                   ts(k), ts(k)) for k in range(13)], "d"), app_id)
    assert len(read()) == 263
    c2 = event_store.staging_counts()
    assert (c2["delta"] - c1["delta"], c2["snapshot"] - c1["snapshot"],
            c2["tail"] - c1["tail"]) == (13, 0, 0)
    store.l_events.delete(ids[5], app_id)    # a delete drops the retained batch
    assert len(read()) == 262
    c3 = event_store.staging_counts()
    assert (c3["snapshot"] - c2["snapshot"], c3["tail"] - c2["tail"]) == (249, 13)
    monkeypatch.setenv("PIO_DELTA_STAGING", "off")
    event_store.invalidate_staging_cache()
    store.l_events.insert_batch(_events("port", mixed_specs(4), "e"), app_id)
    assert len(read()) == 266
    c4 = event_store.staging_counts()
    assert c4["delta"] == c3["delta"] and c4["tail"] - c3["tail"] == 17


def test_auto_trigger_builds_in_the_background(tmp_path, small_segments, monkeypatch):
    monkeypatch.setenv("PIO_SNAPSHOT_SEGMENTS", "2")
    fs = port_localfs.FSEvents(tmp_path / "store")
    snap_dir = fs._chan_dir(1, None) / "snapshot"
    for k in range(40):
        fs.insert_batch(_events("port", mixed_specs(10), f"k{k:02d}-"), 1)
        if (snap_dir / "manifest.json").exists():
            break
    deadline = time.time() + 10
    res = None
    while time.time() < deadline:
        res = fs.snapshot_scan(1) if (snap_dir / "manifest.json").exists() else None
        if res is not None:
            break
        time.sleep(0.1)
    assert res is not None, "the automatic build never ran"
    assert res["manifest"]["writer"] == "local"
    assert_same_scan(res, jax_localfs.FSEvents(tmp_path / "store").snapshot_scan(1))
    assert batch_rows(res["batch"], res["ids"]) == sort_rows(
        _row(e) for e in fs.scan(1))


@pytest.mark.parametrize("names", [["buy"], ["view"], ["café"], ["buy", "café"], ["missing"]])
def test_scan_prefilter_parity(both, names):
    """Name-filtered scans return what the JAX package's prefiltered scan
    does, property values that hold the name's bytes included."""
    specs = [("buy", "user", "u1", "item", "i1", {}, ts(1), ts(1)),
             ("view", "user", "u2", None, None, {"note": '"event":"buy"'}, ts(2), ts(2)),
             ("café", "user", "u3", None, None, {}, ts(3), ts(3)),
             ("buyer", "user", "u4", None, None, {}, ts(4), ts(4))]
    both.insert("port", specs, "p")
    got = sorted(e.event_id for e in both.fs["port"].scan(1, event_names=names))
    want = sorted(e.event_id for e in both.fs["jax"].scan(1, event_names=names))
    assert got == want == sorted(e.event_id for e in both.fs["port"].scan(1)
                                 if e.event in names)


@pytest.mark.parametrize("ids, dead", [
    ([f"{k:032x}" for k in range(50)] * 2, [f"{k:032x}" for k in range(0, 60, 3)]),
    ([f"{k:032x}" for k in range(50)], [f"{k:032x}" for k in (7, 3)]),
    ([f"e{k}" for k in range(50)], [f"e{k}" for k in range(0, 60, 4)] + ["e", "", "1"]),
    (["ab", "abc", "b", "ab\ud800", "é"] * 4, ["ab", "b", "ab\ud800", "é", "c", "a",
                                               "bc", "x", "y", "z"]),
    (["a\0b", "a", "b", "", "ab"] * 4, ["a\0b", "b", "", "\0", "a\0"]),
], ids=["fixed-width-duplicates", "few", "mixed-width", "unicode", "nul"])
def test_rows_of_finds_the_rows_jax_index_of_finds(ids, dead):
    """``drop_tombstoned``'s lookup gives the rows the JAX package's
    ``index_of`` loop gives, the first row of each id present: for a few
    ids (an ``index_of`` each) and for ``ROWS_OF_ONE_PASS`` or more (one
    pass over the column, the absent ids padding the set)."""
    want = sorted(r for r in (jax_columnar.EventIdColumn.from_ids(ids).index_of(e)
                              for e in dead) if r >= 0)
    col = columnar.EventIdColumn.from_ids(ids)
    assert sorted(col.rows_of(set(dead[:columnar.ROWS_OF_ONE_PASS - 1]))) == sorted(
        r for r in (col.index_of(e) for e in dead[:columnar.ROWS_OF_ONE_PASS - 1]) if r >= 0)
    pad = {f"absent{k}" for k in range(columnar.ROWS_OF_ONE_PASS)}
    assert sorted(col.rows_of(set(dead) | pad)) == want
    batch = columnar.EventBatch.from_events(_events("port", mixed_specs(len(ids)), "r"))
    kept, kept_ids = snap.drop_tombstoned(batch, col, set(dead))
    assert len(kept) == len(ids) - len(want) == len(kept_ids)
    assert kept_ids.tolist() == [x for j, x in enumerate(ids) if j not in set(want)]


def test_concat_takes_the_shared_dictionary_path():
    evs = _events("port", mixed_specs(50), "c")
    a = columnar.EventBatch.from_events(evs[:30])
    builder = snap.ColumnarBuilder(base=a)
    for e in evs[30:]:
        builder.add(json.loads(e.to_json_line()))
    b, _ids = builder.finish()
    fast = columnar.EventBatch.concat([a, b])
    assert fast.event_dict is a.event_dict and fast.entity_dict is a.entity_dict
    slow = columnar.EventBatch.concat([columnar.EventBatch.from_events(evs[:30]),
                                       columnar.EventBatch.from_events(evs[30:])])
    assert batch_rows(fast) == batch_rows(slow) == sort_rows(_row(e)[:5] + (None,) for e in evs)


# -- the UR's training read -----------------------------------------------------------


def _same_training_data(got, want):
    assert got.user_dict.to_state() == want.user_dict.to_state()
    assert list(got.interactions) == list(want.interactions)
    for name, (wu, wi, wd, wt) in want.interactions.items():
        gu, gi, gd, gt = got.interactions[name]
        for g, w in ((gu, wu), (gi, wi), (gt, wt)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert gd.to_state() == wd.to_state()
    assert got.item_properties == want.item_properties


@pytest.mark.parametrize("seed", [0, 1])
def test_ur_read_training_from_snapshot_tail_delta_and_tombstones(tmp_path, small_segments,
                                                                  seed):
    """The UR's read from the snapshot plus its tail, as a delta in one
    process, and from a tombstoned log equals the JAX package's; each is
    served by the snapshot, never the native scan or the row path."""
    from predictionio_tpu_torch.native import scanner

    jax_store, store = _storages(tmp_path / "store")
    app_id = store.apps.insert(App(0, "nat"))
    specs = seeded_corpus(seed)
    store.l_events.insert_batch(port_events(specs[:300]), app_id)
    store.l_events.build_snapshot(app_id)
    store.l_events.insert_batch(_events("port", specs[300:], "t"), app_id)
    params = dict(app_name="nat", event_names=["purchase", "view"])
    set_storage(store)
    jax_set_storage(jax_store)
    try:
        def check(staged):
            served = scanner.scans_served
            before = event_store.staging_counts()
            got = ur.URDataSource(ur.URDataSourceParams(**params)).read_training()
            after = event_store.staging_counts()
            assert {k: after[k] - before[k] for k in after} == staged
            assert scanner.scans_served == served
            jax_event_store.invalidate_staging_cache()
            want = jax_ur.URDataSource(jax_ur.URDataSourceParams(**params)).read_training()
            _same_training_data(got, want)
            assert got.item_properties

        n_tail = len(specs) - 300
        check({"snapshot": 300, "tail": n_tail, "delta": 0})
        store.l_events.insert_batch(_events("port", mixed_specs(9), "x"), app_id)
        check({"snapshot": 0, "tail": 0, "delta": 9})
        for k in (3, 40, 301):   # two covered by the snapshot, one in its tail
            assert store.l_events.delete(f"ev{k:07d}" if k < 300 else f"t{k - 300:07d}",
                                         app_id)
        check({"snapshot": 298, "tail": n_tail + 9 - 1, "delta": 0})
    finally:
        set_storage(None)
        jax_set_storage(None)


def test_native_header_parse_serves_the_snapshot_read(both, monkeypatch):
    """With a compiler the snapshot read's header parse is native (counted);
    with ``PIO_NATIVE=off`` the Python parse gives the same scan."""
    if ncore.lib() is None:
        pytest.skip("no C++ compiler: the Python header parse answers")
    both.insert("port", mixed_specs(120), "a")
    both.fs["jax"].build_snapshot(1)
    monkeypatch.setenv("PIO_NATIVE", "on")
    calls = ncore.calls["scan"]
    native = both.fs["port"].snapshot_scan(1)
    assert ncore.calls["scan"] == calls + 1
    monkeypatch.setenv("PIO_NATIVE", "off")
    assert_same_scan(both.fs["port"].snapshot_scan(1), native)
    assert ncore.calls["scan"] == calls + 1
