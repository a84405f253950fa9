"""Columnar event-store snapshots: training reads at memory-map speed.

Counterpart of ``predictionio_tpu/storage/snapshot.py``, same files and
same meaning, so a snapshot either package builds is read by the other.
The JSON-lines segments are the system of record; ``pio snapshot`` folds
them into ONE struct-of-arrays PIOCOL01 file (``store.columnar``: int32
code columns, string dictionaries, int64 times, property columns and an
event-id column), so a training read maps the covered columns and parses
only the JSON-lines tail written since the build.

Layout, per (app, channel) directory::

    events/app_<id>/<chan>/snapshot/
        manifest.json            what the snapshot covers (atomic replace)
        snap-<writer>-<id>.pioc  the columnar file (temporary name, fsync, rename)
        .lock                    flock held for a build's whole duration

The manifest records each segment's covered bytes (up to the last complete
line at build time: segments are append-only, so a tail read resumes
there) with a fingerprint of their head, the tombstones applied and an
event-count watermark.  A build is two-phase: a kill at any instant leaves
the old manifest and file or the new pair, never half of one.  A torn file
is quarantined at its first read and rebuilt by the next build.

Settings, the JAX package's: ``PIO_SNAPSHOT=off`` turns the read path and
the automatic build off (``pio snapshot`` still builds);
``PIO_SNAPSHOT_SEGMENTS=N`` starts a build in the background once N
segments exist that the snapshot does not cover (0, the default: never).
Metrics are the JAX package's ``pio_snapshot_*`` families (builds, their
seconds, hits, misses, quarantines, the built events by channel) and
``pio_stage_events_total{mode}`` (events staged by source: ``snapshot``
from the mapped file, ``tail`` parsed from the uncovered tail, ``delta``
parsed past a retained batch's watermark); ``counts`` and ``staged`` read
them as dicts, and ``publish_status_gauges`` mirrors a status onto the
coverage gauges.
"""

from __future__ import annotations

import datetime as _dt
import fcntl
import json
import logging
import os
import threading
import time
import uuid
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from predictionio_tpu_torch.events.event import parse_time
from predictionio_tpu_torch.obs.metrics import LATENCY_BUCKETS, SeriesView, get_registry
from predictionio_tpu_torch.store.columnar import (
    EventBatch,
    EventIdColumn,
    IdDict,
    PropColumn,
    read_batch,
    write_batch,
)

log = logging.getLogger("pio.snapshot")

SNAP_DIR = "snapshot"
MANIFEST = "manifest.json"
LOCK = ".lock"

_REG = get_registry()
_M_BUILD_S = _REG.histogram(
    "pio_snapshot_build_duration_seconds",
    "Wall-clock duration of snapshot builds", buckets=LATENCY_BUCKETS)
_M_BUILDS = _REG.counter(
    "pio_snapshot_builds_total", "Snapshot builds by final status")
_M_EVENTS = _REG.gauge(
    "pio_snapshot_events",
    "Events in the last-built snapshot, by channel")
_M_HITS = _REG.counter(
    "pio_snapshot_scan_hits_total",
    "Training scans served from a snapshot (+ tail)")
_M_MISSES = _REG.counter(
    "pio_snapshot_scan_misses_total",
    "Training scans that fell back to a full JSONL parse")
_M_QUAR = _REG.counter(
    "pio_snapshot_quarantined_total",
    "Torn/corrupt snapshot files set aside for rebuild")
_M_STAGED = _REG.counter(
    "pio_stage_events_total",
    "Events staged into columnar batches by source: snapshot = served "
    "from the mmap'd file, tail = parsed from the uncovered JSONL tail, "
    "delta = parsed past a retained batch's watermark on retrain")

#: snapshot reads served (hits) and missed, files quarantined, builds by outcome
counts = SeriesView({"hits": (_M_HITS, {}), "misses": (_M_MISSES, {}),
                     "quarantined": (_M_QUAR, {}),
                     "builds_ok": (_M_BUILDS, {"status": "ok"}),
                     "builds_failed": (_M_BUILDS, {"status": "failed"})})
#: events staged into columnar batches, by source
staged = SeriesView({m: (_M_STAGED, {"mode": m}) for m in ("snapshot", "tail", "delta")})


def _chan_label(d: Path) -> str:
    return f"{d.parent.name}/{d.name}"


def enabled() -> bool:
    """``PIO_SNAPSHOT=off`` turns the snapshot read path and the automatic
    build off (``pio snapshot`` still builds, to warm a store first)."""
    return os.environ.get("PIO_SNAPSHOT", "").lower() not in ("off", "0", "false")


def auto_threshold() -> int:
    """``PIO_SNAPSHOT_SEGMENTS=N``: the event-log writer starts a build in
    the background once N segments exist that the snapshot does not cover
    (0, the default: never)."""
    try:
        return max(0, int(os.environ.get("PIO_SNAPSHOT_SEGMENTS", "0")))
    except ValueError:
        return 0


def _segment_head(seg: Path, consumed: int) -> Optional[Dict[str, int]]:
    """Fingerprint of a consumed segment prefix: the CRC of its first
    min(64, consumed) bytes.  A segment name can recur with new content (a
    data-delete and re-import restart the numbering at seg-00000), and
    byte offsets into such a file mean nothing; its first line holds a
    unique event id, so 64 bytes tell the generations apart."""
    n = min(64, consumed)
    if n <= 0:
        return None
    try:
        with open(seg, "rb") as f:
            return {"n": n, "crc": zlib.crc32(f.read(n))}
    except OSError:
        return None


def _head_matches(seg: Path, head: Optional[Dict[str, int]]) -> bool:
    if not head:
        return True      # nothing was consumed: nothing to mismatch
    cur = _segment_head(seg, int(head["n"]))
    return cur is not None and cur["crc"] == head["crc"]


def _last_newline_boundary(path: Path, size: int) -> int:
    """The offset just past the last complete line within ``size`` bytes
    (0 if none): a snapshot never covers a torn tail, and a writer's
    healing truncate only removes bytes past it."""
    if size <= 0:
        return 0
    with open(path, "rb") as f:
        pos = size
        while pos > 0:
            step = min(64 * 1024, pos)
            f.seek(pos - step)
            nl = f.read(step).rfind(b"\n")
            if nl >= 0:
                return pos - step + nl + 1
            pos -= step
    return 0


class ColumnarBuilder:
    """Stored event dicts → struct-of-arrays, with an event-id column.

    The columns and property-column kinds of the native scan, codes in
    first-appearance order.  With ``base``, codes are assigned in the base
    batch's dictionaries (which grow in place), so the result concatenates
    with the base on ``EventBatch.concat``'s shared-dictionary path.
    """

    def __init__(self, base: Optional[EventBatch] = None):
        if base is not None:
            self.event_dict = base.event_dict
            self.entity_type_dict = base.entity_type_dict
            self.entity_dict = base.entity_dict
            self.target_dict = base.target_dict
        else:
            self.event_dict = IdDict()
            self.entity_type_dict = IdDict()
            self.entity_dict = IdDict()
            self.target_dict = IdDict()
        self._base_props = (base.prop_columns or {}) if base is not None else {}
        self._ev: List[int] = []
        self._et: List[int] = []
        self._ei: List[int] = []
        self._ti: List[int] = []
        self._ts: List[int] = []
        self._rt: List[float] = []
        self._ids: List[str] = []
        self._props: Dict[str, dict] = {}

    def __len__(self) -> int:
        return len(self._ev)

    def add(self, d: dict) -> None:
        """Append one stored event (a parsed log line)."""
        row = len(self._ev)
        self._ev.append(self.event_dict.add(d["event"]))
        self._et.append(self.entity_type_dict.add(d["entityType"]))
        self._ei.append(self.entity_dict.add(str(d["entityId"])))
        tei = d.get("targetEntityId")
        self._ti.append(self.target_dict.add(str(tei)) if tei is not None else -1)
        self._ts.append(int(parse_time(d.get("eventTime")).timestamp() * 1e6))
        props = d.get("properties") or {}
        r = props.get("rating")
        # a bool counts as a number here, as in EventBatch.from_events
        self._rt.append(float(r) if isinstance(r, (int, float)) else np.nan)
        self._ids.append(d.get("eventId") or "")
        for key, val in props.items():
            self._add_prop(key, row, val)

    def _add_prop(self, key: str, row: int, val) -> None:
        p = self._props.get(key)
        if p is None:
            base_col = self._base_props.get(key)
            p = self._props[key] = {
                "rows": [], "kind": [], "num": [], "strs": [],
                "dict": base_col.dict if base_col is not None else IdDict(),
            }
        # PropColumn's kinds: 0 number, 1 bool, 2 string, 3 list of
        # strings, 4 null, 5 anything else (its JSON)
        if isinstance(val, bool):
            kind, num, strs = 1, float(val), ()
        elif isinstance(val, (int, float)):
            kind, num, strs = 0, float(val), ()
        elif isinstance(val, str):
            kind, num, strs = 2, 0.0, (val,)
        elif val is None:
            kind, num, strs = 4, 0.0, ()
        elif isinstance(val, list) and all(isinstance(x, str) for x in val):
            kind, num, strs = 3, 0.0, tuple(val)
        else:
            kind, num, strs = 5, 0.0, (json.dumps(val),)
        p["rows"].append(row)
        p["kind"].append(kind)
        p["num"].append(num)
        p["strs"].append(strs)

    def finish(self) -> tuple:
        """→ (EventBatch with prop_columns, EventIdColumn)."""
        n = len(self._ev)
        props: Dict[str, PropColumn] = {}
        for key, p in self._props.items():
            offs = np.zeros(len(p["rows"]) + 1, np.int64)
            np.cumsum([len(s) for s in p["strs"]], out=offs[1:])
            flat = [s for strs in p["strs"] for s in strs]
            props[key] = PropColumn(
                rows=np.asarray(p["rows"], np.int64),
                kind=np.asarray(p["kind"], np.int8),
                num=np.asarray(p["num"], np.float64),
                str_offs=offs,
                codes=p["dict"].encode(flat) if flat else np.empty(0, np.int32),
                dict=p["dict"],
            )
        batch = EventBatch(
            np.asarray(self._ev, np.int32), np.asarray(self._et, np.int32),
            np.asarray(self._ei, np.int32), np.asarray(self._ti, np.int32),
            np.asarray(self._ts, np.int64),
            np.asarray(self._rt, np.float32) if n else np.empty(0, np.float32),
            self.event_dict, self.entity_type_dict, self.entity_dict,
            self.target_dict, prop_columns=props,
        )
        return batch, EventIdColumn.from_ids(self._ids)


def _parse_range(seg: Path, start: int, end: int, dead: set,
                 builder: ColumnarBuilder, delay: float = 0.0) -> int:
    """Parse the complete lines of ``seg[start:end)`` into ``builder``,
    skipping tombstoned ids; returns the number of events added."""
    added = 0
    with open(seg, "rb") as f:
        f.seek(start)
        data = f.read(end - start)
    for line in data.split(b"\n"):
        if not line.strip():
            continue
        if delay:
            time.sleep(delay)   # test hook: widens the kill-mid-build window
        d = json.loads(line)
        if d.get("eventId") in dead:
            continue
        builder.add(d)
        added += 1
    return added


def load_manifest(d: Path) -> Optional[dict]:
    p = d / SNAP_DIR / MANIFEST
    try:
        m = json.loads(p.read_text())
    except (OSError, json.JSONDecodeError):
        return None
    if not isinstance(m, dict) or "snapshot" not in m or "covered" not in m:
        return None
    return m


def _fsync_write(path: Path, text: str) -> None:
    """Temporary name, fsync, atomic rename: the manifest's durability."""
    tmp = path.with_suffix(path.suffix + f".tmp{os.getpid()}")
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    tmp.replace(path)


def build_snapshot(d: Path, tombstones: set, writer: str) -> dict:
    """Fold every complete line of every segment into a new snapshot.

    Two-phase: the columns go to ``snap-*.pioc.tmp<pid>`` (no reader
    looks there), fsync, rename, and only then is the manifest replaced
    atomically, so a SIGKILL at any instant leaves a readable store.
    Exactly one build runs at a time across processes and packages: a
    non-blocking flock on ``snapshot/.lock``; losing it raises
    RuntimeError("snapshot build already in progress ...").

    Returns {"events", "segments", "build_s", "snapshot"}.
    """
    snap_dir = d / SNAP_DIR
    snap_dir.mkdir(parents=True, exist_ok=True)
    lockf = open(snap_dir / LOCK, "a")
    try:
        try:
            fcntl.flock(lockf.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            raise RuntimeError("snapshot build already in progress for this channel")
        t0 = time.perf_counter()
        try:
            delay = float(os.environ.get("PIO_SNAPSHOT_TEST_DELAY_S") or 0.0)
        except ValueError:
            delay = 0.0
        for stale in snap_dir.glob("*.tmp*"):
            stale.unlink(missing_ok=True)
        covered: Dict[str, int] = {}
        heads: Dict[str, Dict[str, int]] = {}
        builder = ColumnarBuilder()
        n = 0
        try:
            for seg in sorted(d.glob("seg-*.jsonl")):
                try:
                    size = seg.stat().st_size
                except FileNotFoundError:
                    continue     # racing a data-delete
                end = _last_newline_boundary(seg, size)
                covered[seg.name] = end
                head = _segment_head(seg, end)
                if head is not None:
                    heads[seg.name] = head
                if end > 0:
                    n += _parse_range(seg, 0, end, tombstones, builder, delay)
            batch, ids = builder.finish()
            name = f"snap-{writer}-{uuid.uuid4().hex[:8]}.pioc"
            tmp = snap_dir / (name + f".tmp{os.getpid()}")
            write_batch(tmp, batch, ids, meta={"writer": writer, "events": n})
            tmp.rename(snap_dir / name)
            manifest = {
                "version": 1,
                "snapshot": name,
                "covered": covered,
                "heads": heads,
                "events": n,                     # the event-count watermark
                "tombstones_applied": sorted(tombstones),
                "built_at": _dt.datetime.now(_dt.timezone.utc).isoformat(),
                "build_s": round(time.perf_counter() - t0, 6),
                "writer": writer,
            }
            _fsync_write(snap_dir / MANIFEST, json.dumps(manifest, indent=1, sort_keys=True))
        except Exception:
            _M_BUILDS.inc(1, status="failed")
            raise
        # superseded files go after the manifest flip, so a reader holding
        # the old manifest races at worst into a miss
        for p in snap_dir.glob("snap-*.pioc"):
            if p.name != name:
                p.unlink(missing_ok=True)
        build_s = time.perf_counter() - t0
        _M_BUILD_S.observe(build_s)
        _M_BUILDS.inc(1, status="ok")
        _M_EVENTS.set(n, channel=_chan_label(d))
        log.info("snapshot built: %s/%s %d events / %d segments in %.3fs",
                 d.parent.name, d.name, n, len(covered), build_s)
        return {"events": n, "segments": len(covered), "build_s": build_s, "snapshot": name}
    finally:
        lockf.close()   # closing releases the flock


def _quarantine(snap_dir: Path, name: str) -> None:
    """Set a torn file aside (kept for forensics) and drop the manifest,
    so the next build rebuilds instead of tripping again."""
    try:
        (snap_dir / name).rename(snap_dir / (name + ".quarantine"))
    except OSError:
        pass
    (snap_dir / MANIFEST).unlink(missing_ok=True)
    _M_QUAR.inc()
    log.warning("quarantined torn snapshot %s", snap_dir / name)


def scan_tail(d: Path, watermark: Dict[str, int], tombstones: set,
              base: Optional[EventBatch],
              heads: Optional[Dict[str, dict]] = None) -> Optional[dict]:
    """Parse only the log bytes past ``watermark`` (per-segment covered
    offsets; a segment it does not list is wholly new).

    Returns {"batch", "ids", "events", "watermark", "heads"}, the batch in
    ``base``'s dictionaries when given, or None when the watermark no
    longer describes the log: a segment vanished or shrank (compaction, a
    data-delete), its head changed (a recreated file under the same name),
    or the bytes at an offset do not parse.  None means a full restage."""
    segs = sorted(d.glob("seg-*.jsonl")) if d.exists() else []
    names = {s.name for s in segs}
    if any(name not in names for name in watermark):
        return None
    builder = ColumnarBuilder(base=base)
    new_mark = dict(watermark)
    new_heads: Dict[str, Dict[str, int]] = {}
    n = 0
    for seg in segs:
        start = watermark.get(seg.name, 0)
        try:
            size = seg.stat().st_size
        except FileNotFoundError:
            return None
        if size < start:
            return None          # shrank under the watermark
        if heads is not None and not _head_matches(seg, heads.get(seg.name)):
            return None          # the same name, another file
        if size == start:
            # nothing appended: the verified head still describes the
            # consumed bytes, so skip the boundary scan and the re-read
            new_mark[seg.name] = start
            head = heads.get(seg.name) if heads is not None else _segment_head(seg, start)
            if head is not None:
                new_heads[seg.name] = head
            continue
        end = _last_newline_boundary(seg, size)
        new_mark[seg.name] = max(end, start)
        head = _segment_head(seg, new_mark[seg.name])
        if head is not None:
            new_heads[seg.name] = head
        if end > start:
            try:
                n += _parse_range(seg, start, end, tombstones, builder)
            except (json.JSONDecodeError, UnicodeDecodeError, KeyError, TypeError, ValueError):
                return None      # a stale offset mid-line, or foreign bytes
    batch, ids = builder.finish()
    return {"batch": batch, "ids": ids, "events": n, "watermark": new_mark,
            "heads": new_heads}


def scan_bounded(d: Path, watermark: Dict[str, int], tombstones: set,
                 heads: Optional[Dict[str, dict]] = None) -> Optional[dict]:
    """Parse the log UP TO ``watermark``: exactly the events a persisted
    watermark describes (a restarted follower's read).  Returns {"batch",
    "events"}, or None when the watermark no longer matches the log."""
    builder = ColumnarBuilder()
    n = 0
    for name in sorted(watermark):
        seg = d / name
        end = int(watermark[name])
        try:
            size = seg.stat().st_size
        except OSError:
            return None          # a covered segment vanished
        if size < end:
            return None          # shrank under the watermark
        if heads is not None and not _head_matches(seg, heads.get(name)):
            return None          # a recreated file under the same name
        if end > 0:
            try:
                n += _parse_range(seg, 0, end, tombstones, builder)
            except (json.JSONDecodeError, UnicodeDecodeError, KeyError, TypeError, ValueError):
                return None
    batch, _ids = builder.finish()
    return {"batch": batch, "events": n}


def drop_tombstoned(batch: EventBatch, ids: EventIdColumn, new_dead: set) -> tuple:
    """Drop the rows whose event id was tombstoned after the snapshot was
    built → (batch, ids): the first row of each id, as the JAX package's
    ``ids.index_of`` loop finds it (``EventIdColumn.rows_of``)."""
    if not new_dead:
        return batch, ids
    mask = np.ones(len(batch), bool)
    mask[ids.rows_of(new_dead)] = False
    if not mask.all():
        batch = batch.subset(mask)
        ids = ids.subset(mask)
    return batch, ids


def scan_snapshot(d: Path, tombstones: set) -> Optional[dict]:
    """The snapshot-and-tail read: map the covered columns, parse only the
    uncovered tail, splice them on the shared-dictionary concat path.

    Returns None (a miss: the caller scans the log) when no valid snapshot
    describes the log as it is: no manifest, a covered segment vanished,
    shrank or was recreated, tombstones receded, or the file is torn (then
    also quarantined).  Events tombstoned after the build are dropped by
    the id column, so they never resurface.

    A hit: {"batch", "ids", "snap_events", "tail_events", "watermark",
    "heads", "manifest"}.
    """
    m = load_manifest(d)
    if m is None:
        return None
    snap_dir = d / SNAP_DIR
    covered: Dict[str, int] = m["covered"]
    heads: Dict[str, dict] = m.get("heads", {})
    for name, end in covered.items():
        p = d / name
        try:
            if p.stat().st_size < end:
                return None      # covered bytes no longer exist
        except OSError:
            return None          # segment gone (compaction, data-delete)
        if not _head_matches(p, heads.get(name)):
            return None          # a recreated file under a covered name
    applied = set(m.get("tombstones_applied", ()))
    if applied - tombstones:
        return None              # tombstones receded: the log was rewritten
    try:
        batch, ids, _meta = read_batch(snap_dir / m["snapshot"])
    except FileNotFoundError:
        return None              # raced a concurrent rebuild's clean-up
    except (ValueError, OSError):
        _quarantine(snap_dir, m["snapshot"])
        return None
    if ids is None:
        return None
    batch, ids = drop_tombstoned(batch, ids, tombstones - applied)
    snap_events = len(batch)
    tail = scan_tail(d, covered, tombstones, base=batch, heads=heads)
    if tail is None:
        return None
    if tail["events"]:
        batch = EventBatch.concat([batch, tail["batch"]])
        ids = EventIdColumn.concat([ids, tail["ids"]])
    record_staged(snap_events, "snapshot")
    record_staged(tail["events"], "tail")
    return {"batch": batch, "ids": ids, "snap_events": snap_events,
            "tail_events": tail["events"], "watermark": tail["watermark"],
            "heads": tail["heads"], "manifest": m}


def uncovered_segments(d: Path) -> int:
    """Segments the current snapshot does not list: the automatic build's
    measure of staleness."""
    m = load_manifest(d)
    covered = set(m["covered"]) if m else set()
    if not d.exists():
        return 0
    return sum(1 for s in d.glob("seg-*.jsonl") if s.name not in covered)


# the tail-event count reads every uncovered byte: memoised per channel on
# the (segment name, size, covered offset) signature, so a log that does
# not change is read once
_status_lock = threading.Lock()
_status_cache: Dict[str, dict] = {}


def snapshot_status(d: Path) -> Optional[dict]:
    """Coverage summary, or None when the channel has no snapshot.
    ``tailEvents`` counts the complete lines past the covered offsets
    (tombstones not subtracted: a coverage view, not a scan)."""
    m = load_manifest(d)
    if m is None:
        return None
    covered: Dict[str, int] = m["covered"]
    segs = sorted(d.glob("seg-*.jsonl")) if d.exists() else []
    sizes = []
    for seg in segs:
        try:
            sizes.append((seg, seg.stat().st_size))
        except OSError:
            continue
    sig = (m.get("snapshot"),) + tuple(
        (seg.name, size, covered.get(seg.name, 0)) for seg, size in sizes)
    with _status_lock:
        hit = _status_cache.get(str(d))
        if hit is not None and hit["sig"] == sig:
            tail_events, tail_bytes = hit["tail_events"], hit["tail_bytes"]
            sizes = []           # nothing to recount
        else:
            tail_events = tail_bytes = 0
    for seg, size in sizes:
        start = covered.get(seg.name, 0)
        end = _last_newline_boundary(seg, size)
        if end > start:
            tail_bytes += end - start
            with open(seg, "rb") as f:
                f.seek(start)
                tail_events += f.read(end - start).count(b"\n")
    if sizes or hit is None:
        with _status_lock:
            if len(_status_cache) > 256:
                _status_cache.clear()
            _status_cache[str(d)] = {"sig": sig, "tail_events": tail_events,
                                     "tail_bytes": tail_bytes}
    snap_events = int(m.get("events", 0))
    total = snap_events + tail_events
    return {
        "events": snap_events,
        "tailEvents": tail_events,
        "tailBytes": tail_bytes,
        "coverage": (snap_events / total) if total else 1.0,
        "builtAt": m.get("built_at"),
        "buildSeconds": m.get("build_s"),
        "snapshot": m.get("snapshot"),
        "writer": m.get("writer"),
        "segmentsCovered": len(covered),
    }


def apply_filters(batch: EventBatch,
                  event_names: Optional[Sequence[str]] = None,
                  entity_type: Optional[str] = None,
                  start_time: Optional[_dt.datetime] = None,
                  until_time: Optional[_dt.datetime] = None) -> EventBatch:
    """The scan filters on columns (``storage.base.match_filters``'s
    semantics for these four), shared by every columnar read."""
    mask = np.ones(len(batch), bool)
    if event_names is not None:
        codes = [batch.event_dict.id(n) for n in event_names]
        codes = [c for c in codes if c is not None]
        mask &= np.isin(batch.event_codes, np.asarray(codes, np.int32))
    if entity_type is not None:
        c = batch.entity_type_dict.id(entity_type)
        mask &= batch.entity_type_codes == (c if c is not None else -2)
    if start_time is not None:
        mask &= batch.times_us >= int(start_time.timestamp() * 1e6)
    if until_time is not None:
        mask &= batch.times_us < int(until_time.timestamp() * 1e6)
    return batch.subset(mask) if not mask.all() else batch


def record_hit() -> None:
    _M_HITS.inc()


def record_miss() -> None:
    _M_MISSES.inc()


def record_delta(n: int) -> None:
    record_staged(n, "delta")


def record_staged(n: int, mode: str) -> None:
    if n:
        _M_STAGED.inc(n, mode=mode)


def staged_counts() -> Dict[str, int]:
    """The staged-event counts by source (snapshot, tail, delta): a
    retrain's exactness check reads them before and after."""
    return {mode: int(_M_STAGED.value(mode=mode)) for mode in ("snapshot", "tail", "delta")}


def publish_status_gauges(status: dict, channel: str) -> None:
    """Mirror a ``snapshot_status`` dict onto the ``pio_snapshot_*`` gauges
    (dashboard scrapes)."""
    _M_EVENTS.set(status["events"], channel=channel)
    _REG.gauge(
        "pio_snapshot_tail_events",
        "Events in the uncovered JSONL tail, by channel",
    ).set(status["tailEvents"], channel=channel)
    _REG.gauge(
        "pio_snapshot_coverage_ratio",
        "Events in snapshot / total events, by channel",
    ).set(status["coverage"], channel=channel)
    if status.get("builtAt"):
        try:
            ts = _dt.datetime.fromisoformat(status["builtAt"]).timestamp()
        except ValueError:
            ts = 0.0
        _REG.gauge(
            "pio_snapshot_last_build_timestamp_seconds",
            "Unix time of the last snapshot build, by channel",
        ).set(ts, channel=channel)
    if status.get("buildSeconds") is not None:
        _REG.gauge(
            "pio_snapshot_last_build_seconds",
            "Duration of the last snapshot build, by channel",
        ).set(float(status["buildSeconds"]), channel=channel)
