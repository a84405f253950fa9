"""Local-filesystem storage backend.

Counterpart of ``predictionio_tpu/storage/localfs.py`` (the system of
record of the reference's HBase/Elasticsearch/JDBC backends), with the
same on-disk layout, so a store directory written by either package reads
in the other:

- **Events**: append-only JSON-lines segments per (app, channel), rotated
  at a size threshold (``events/app_<id>/<channel>/seg-NNNNN.jsonl``).
  Segments are immutable once rotated, so a training read is a set of
  sequential file reads, which the native scanner
  (``predictionio_tpu_torch/native``) parses in parallel.  Deletes are
  tombstones in a sidecar (``tombstones*.txt``), so the log stays
  append-only; ``compact`` rewrites it.
- **Metadata** (apps, access keys, channels, engine instances and
  manifests, evaluation instances): one JSON document each under
  ``meta/``, replaced atomically (write a temporary file, then rename).
- **Models**: blobs under ``models/<instance_id>.bin``.
- **Columnar snapshots** (``storage/snapshot.py``): ``build_snapshot``
  (``pio snapshot``) folds the segments into one PIOCOL01 file under
  ``snapshot/``; ``snapshot_scan`` and ``find_batches`` serve a training
  read from it plus the JSON-lines tail written since, tombstones honoured;
  ``scan_tail_from``/``scan_events_up_to``/``tombstone_state`` are the
  delta-tail reads of the staged retrain cache.  With
  ``PIO_SNAPSHOT_SEGMENTS=N`` a segment rotation starts a build in the
  background once N segments are uncovered.

Appends to one (app, channel) are group-committed within a process, as
in the JAX package: concurrent request threads queue their lines and the
first one in writes every queued buffer with one ``write`` (one fsync by
the PIO_FSYNC policy).  Across processes each writer appends only to its
own segments: with a writer tag (``PIO_WRITER_TAG``, which the event
server's prefork workers get) they are ``seg-<tag>-NNNNN.jsonl`` and its
tombstones ``tombstones-<tag>.txt``; without one ``seg-NNNNN.jsonl`` and
``tombstones.txt``, and its snapshots are tagged ``local``.  Readers glob
``seg-*.jsonl`` and ``tombstones*.txt`` and see the union.  The write
path's instruments are the JAX package's ``pio_storage_*`` families.  The
group-commit leader calls ``_commit_point`` and ``_post_commit``, which do
nothing here: the sharded store's nodes override them with the
replication barrier (``storage/sharded.py``).  ``scan`` is the bulk read
in log order that ``find_batches`` takes without a snapshot.
"""

from __future__ import annotations

import datetime as _dt
import fcntl
import json
import logging
import mmap
import os
import re
import shutil
import threading
import time
import uuid
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Sequence

from predictionio_tpu_torch.events.event import Event, canonical_event_json, parse_time
from predictionio_tpu_torch.obs.metrics import LATENCY_BUCKETS, SIZE_BUCKETS, get_registry
from predictionio_tpu_torch.obs.tracing import trace_span
from predictionio_tpu_torch.storage import base
from predictionio_tpu_torch.storage.base import (
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EngineManifest,
    EvaluationInstance,
)

log = logging.getLogger("pio.storage")

# rotate segments at 64 MiB; PIO_SEGMENT_MAX_BYTES overrides (tests rotate
# early to exercise multi-segment layouts cheaply)
SEGMENT_MAX_BYTES = int(os.environ.get("PIO_SEGMENT_MAX_BYTES", 64 << 20))
DEFAULT_CHANNEL = "_default"
# event ids whose bytes are the same in every JSON encoding
_PLAIN_ID = re.compile(r"[A-Za-z0-9_.-]+")

# -- write-path instruments, recorded at group-commit granularity (one
# observation per physical write or fsync, not per event)
_REG = get_registry()
_M_APPEND = _REG.histogram(
    "pio_storage_append_duration_seconds",
    "Segment append latency (write+flush, excluding fsync); count = "
    "physical appends", buckets=LATENCY_BUCKETS)
_M_APPEND_BYTES = _REG.counter(
    "pio_storage_append_bytes_total", "Bytes appended to event segments")
_M_EVENTS = _REG.counter(
    "pio_storage_events_appended_total",
    "Event lines appended to the log (exactly the on-disk line count)")
_M_FSYNC = _REG.histogram(
    "pio_storage_fsync_duration_seconds",
    "fsync latency on event segments; count = fsyncs issued",
    buckets=LATENCY_BUCKETS)
_M_GROUP = _REG.histogram(
    "pio_storage_group_commit_batch_size",
    "Request buffers coalesced per group commit (occupancy = sum/count)",
    buckets=SIZE_BUCKETS)
_M_HEALS = _REG.counter(
    "pio_storage_torn_tail_heals_total",
    "Torn segment tails truncated on writer reopen")
_M_ROTATE = _REG.counter(
    "pio_storage_segment_rotations_total", "New segment files opened")
_M_SEGS = _REG.gauge(
    "pio_storage_live_segments",
    "Segments in the writer's channel directory at last open, by channel")


def _fsync_policy() -> str:
    """Ingest durability policy (PIO_FSYNC):

    - ``rotate`` (default): fsync only when a segment rotates or the writer
      closes: a crash can lose the OS-buffered tail of the active segment,
      like the reference's HBase deferred-WAL-flush mode;
    - ``always``: fsync after every append: no acknowledged event is lost;
    - ``interval:<ms>``: fsync at most every <ms> milliseconds;
    - ``never``: leave it to the OS.
    """
    return os.environ.get("PIO_FSYNC", "rotate").lower()


class _SegmentWriter:
    """Kept-open appender for one (app, channel) log: one ``write`` per
    append under the PIO_FSYNC policy, rotating to a new segment at
    ``SEGMENT_MAX_BYTES``.  Without a ``tag`` it appends only to segments
    of the plain ``seg-NNNNN.jsonl`` naming; with one, only to its own
    ``seg-<tag>-NNNNN.jsonl``, so writer processes never share an active
    file.  Readers glob ``seg-*.jsonl`` and see the union."""

    def __init__(self, d: Path, tag: Optional[str] = None):
        self._dir = d
        self._tag = tag
        self._f = None
        self._path: Optional[Path] = None
        self._last_sync = 0.0
        self.rotations = 0   # new segment files opened (the snapshot auto-trigger)

    def append(self, text: str) -> None:
        if self._f is not None:
            # a data-delete or re-import from any process may have unlinked
            # or replaced the segment: writing on would acknowledge events
            # into an inode no reader sees.  The directory entry's inode
            # against the open handle's catches it (st_nlink does not on
            # every filesystem).
            try:
                if os.stat(self._path).st_ino != os.fstat(self._f.fileno()).st_ino:
                    self._f.close()
                    self._f = None
            except OSError:
                try:
                    self._f.close()
                except OSError:
                    pass
                self._f = None
        if self._f is None or self._f.tell() >= SEGMENT_MAX_BYTES:
            self._open_next()
        t0 = time.perf_counter()
        self._f.write(text)
        self._f.flush()
        _M_APPEND.observe(time.perf_counter() - t0)
        _M_APPEND_BYTES.inc(len(text))
        policy = _fsync_policy()
        if policy == "always":
            self._timed_fsync()
        elif policy.startswith("interval:"):
            try:
                every = float(policy.split(":", 1)[1]) / 1e3
            except ValueError:
                every = 0.1
            now = time.monotonic()
            if now - self._last_sync >= every:
                self._timed_fsync()
                self._last_sync = now

    def _timed_fsync(self) -> None:
        t0 = time.perf_counter()
        os.fsync(self._f.fileno())
        _M_FSYNC.observe(time.perf_counter() - t0)

    @staticmethod
    def _heal_torn_tail(path: Path) -> None:
        """Truncate an unterminated final line before appending again.

        A crash mid-append can leave a partial last line; appending after
        it would fuse two events into one corrupt line.  The torn event was
        never acknowledged (the fsync policy runs after the whole write),
        and only this writer appends to the file, so dropping it is safe."""
        with open(path, "rb+") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            if size == 0:
                return
            f.seek(size - 1)
            if f.read(1) == b"\n":
                return
            pos, keep = size, 0
            while pos > 0:   # scan back in chunks for the last newline
                step = min(64 * 1024, pos)
                f.seek(pos - step)
                nl = f.read(step).rfind(b"\n")
                if nl >= 0:
                    keep = pos - step + nl + 1
                    break
                pos -= step
            f.truncate(keep)
            _M_HEALS.inc()

    def _open_next(self) -> None:
        self.close()
        self._dir.mkdir(parents=True, exist_ok=True)
        if self._tag is None:
            # only the plain numeric naming: never append into a
            # per-writer segment that may share the directory
            segs = sorted(p for p in self._dir.glob("seg-*.jsonl")
                          if p.stem.split("-", 1)[1].isdigit())
        else:
            # the exact tag, not the glob alone: tag 'bulk' must never
            # claim (and heal) the live segments of a tag 'bulk-2'
            def _own(p: Path) -> bool:
                n = p.stem.rsplit("-", 1)[1]
                return n.isdigit() and p.stem == f"seg-{self._tag}-{n}"

            segs = sorted(p for p in self._dir.glob(f"seg-{self._tag}-*.jsonl") if _own(p))
        if segs and segs[-1].stat().st_size < SEGMENT_MAX_BYTES:
            path = segs[-1]
            self._heal_torn_tail(path)
        else:
            n = int(segs[-1].stem.rsplit("-", 1)[1]) + 1 if segs else 0
            path = (self._dir / f"seg-{n:05d}.jsonl" if self._tag is None
                    else self._dir / f"seg-{self._tag}-{n:05d}.jsonl")
            _M_ROTATE.inc()
            self.rotations += 1
        self._path = path
        self._f = open(path, "a")
        # this writer's view of its own series; readers union all writers
        _M_SEGS.set(len(segs) + (1 if path not in segs else 0),
                    channel=f"{self._dir.parent.name}/{self._dir.name}")

    def close(self) -> None:
        if self._f is not None:
            try:
                # skip the sync only for an externally unlinked handle;
                # real flush or fsync failures (ENOSPC, EIO) propagate
                try:
                    unlinked = os.fstat(self._f.fileno()).st_nlink == 0
                except OSError:
                    unlinked = True
                self._f.flush()
                if _fsync_policy() != "never" and not unlinked:
                    self._timed_fsync()
            finally:
                f, self._f = self._f, None
                f.close()


def _atomic_write(path: Path, text: str) -> None:
    tmp = path.with_suffix(path.suffix + f".tmp{os.getpid()}")
    tmp.write_text(text)
    tmp.replace(path)


class _JsonDoc:
    """A JSON document on disk with atomic replace and an in-process lock."""

    def __init__(self, path: Path, default):
        self.path = path
        self.lock = threading.Lock()
        self.default = default
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def read(self):
        if not self.path.exists():
            return json.loads(json.dumps(self.default))
        return json.loads(self.path.read_text())

    def write(self, obj) -> None:
        _atomic_write(self.path, json.dumps(obj, indent=1, sort_keys=True))


def _dt_to_json(t: Optional[_dt.datetime]) -> Optional[str]:
    return t.isoformat() if t else None


def _dt_from_json(s: Optional[str]) -> Optional[_dt.datetime]:
    return _dt.datetime.fromisoformat(s) if s else None


class FSApps(base.Apps):
    def __init__(self, root: Path):
        self._doc = _JsonDoc(root / "meta" / "apps.json", {"next_id": 1, "apps": []})

    def insert(self, app: App) -> Optional[int]:
        with self._doc.lock:
            d = self._doc.read()
            if any(a["name"] == app.name for a in d["apps"]):
                return None
            if app.id <= 0 or any(a["id"] == app.id for a in d["apps"]):
                app.id = d["next_id"]
            d["next_id"] = max(d["next_id"], app.id) + 1
            d["apps"].append({"id": app.id, "name": app.name, "description": app.description})
            self._doc.write(d)
            return app.id

    def _all(self) -> List[App]:
        return [App(a["id"], a["name"], a.get("description", "")) for a in self._doc.read()["apps"]]

    def get(self, app_id: int) -> Optional[App]:
        return next((a for a in self._all() if a.id == app_id), None)

    def get_by_name(self, name: str) -> Optional[App]:
        return next((a for a in self._all() if a.name == name), None)

    def get_all(self) -> List[App]:
        return self._all()

    def update(self, app: App) -> bool:
        with self._doc.lock:
            d = self._doc.read()
            for a in d["apps"]:
                if a["id"] == app.id:
                    a["name"], a["description"] = app.name, app.description
                    self._doc.write(d)
                    return True
            return False

    def delete(self, app_id: int) -> bool:
        with self._doc.lock:
            d = self._doc.read()
            n = len(d["apps"])
            d["apps"] = [a for a in d["apps"] if a["id"] != app_id]
            self._doc.write(d)
            return len(d["apps"]) < n


class FSAccessKeys(base.AccessKeys):
    def __init__(self, root: Path):
        self._doc = _JsonDoc(root / "meta" / "access_keys.json", {"keys": []})

    def insert(self, access_key: AccessKey) -> Optional[str]:
        with self._doc.lock:
            if not access_key.key:
                access_key.key = AccessKey.generate()
            d = self._doc.read()
            d["keys"].append({"key": access_key.key, "appid": access_key.app_id,
                              "events": access_key.events})
            self._doc.write(d)
            return access_key.key

    def _all(self) -> List[AccessKey]:
        return [AccessKey(k["key"], k["appid"], k.get("events", []))
                for k in self._doc.read()["keys"]]

    def get(self, key: str) -> Optional[AccessKey]:
        return next((k for k in self._all() if k.key == key), None)

    def get_by_app_id(self, app_id: int) -> List[AccessKey]:
        return [k for k in self._all() if k.app_id == app_id]

    def delete(self, key: str) -> bool:
        with self._doc.lock:
            d = self._doc.read()
            n = len(d["keys"])
            d["keys"] = [k for k in d["keys"] if k["key"] != key]
            self._doc.write(d)
            return len(d["keys"]) < n


class FSChannels(base.Channels):
    def __init__(self, root: Path):
        self._doc = _JsonDoc(root / "meta" / "channels.json", {"next_id": 1, "channels": []})

    def insert(self, channel: Channel) -> Optional[int]:
        with self._doc.lock:
            d = self._doc.read()
            if any(c["name"] == channel.name and c["appid"] == channel.app_id
                   for c in d["channels"]):
                return None
            channel.id = d["next_id"]
            d["next_id"] += 1
            d["channels"].append({"id": channel.id, "name": channel.name,
                                  "appid": channel.app_id})
            self._doc.write(d)
            return channel.id

    def _all(self) -> List[Channel]:
        return [Channel(c["id"], c["name"], c["appid"]) for c in self._doc.read()["channels"]]

    def get(self, channel_id: int) -> Optional[Channel]:
        return next((c for c in self._all() if c.id == channel_id), None)

    def get_by_app_id(self, app_id: int) -> List[Channel]:
        return [c for c in self._all() if c.app_id == app_id]

    def delete(self, channel_id: int) -> bool:
        with self._doc.lock:
            d = self._doc.read()
            n = len(d["channels"])
            d["channels"] = [c for c in d["channels"] if c["id"] != channel_id]
            self._doc.write(d)
            return len(d["channels"]) < n


def _ei_to_json(i: EngineInstance) -> Dict:
    return {
        "id": i.id, "status": i.status,
        "startTime": _dt_to_json(i.start_time), "endTime": _dt_to_json(i.end_time),
        "engineId": i.engine_id, "engineVersion": i.engine_version,
        "engineVariant": i.engine_variant, "engineFactory": i.engine_factory,
        "env": i.env, "sparkConf": i.spark_conf,
        "dataSourceParams": i.data_source_params, "preparatorParams": i.preparator_params,
        "algorithmsParams": i.algorithms_params, "servingParams": i.serving_params,
    }


def _ei_from_json(d: Dict) -> EngineInstance:
    return EngineInstance(
        id=d["id"], status=d["status"],
        start_time=_dt_from_json(d["startTime"]), end_time=_dt_from_json(d.get("endTime")),
        engine_id=d["engineId"], engine_version=d["engineVersion"],
        engine_variant=d["engineVariant"], engine_factory=d["engineFactory"],
        env=d.get("env", {}), spark_conf=d.get("sparkConf", {}),
        data_source_params=d.get("dataSourceParams", "{}"),
        preparator_params=d.get("preparatorParams", "{}"),
        algorithms_params=d.get("algorithmsParams", "[]"),
        serving_params=d.get("servingParams", "{}"),
    )


class FSEngineInstances(base.EngineInstances):
    def __init__(self, root: Path):
        self._doc = _JsonDoc(root / "meta" / "engine_instances.json", {"instances": []})

    def insert(self, instance: EngineInstance) -> str:
        with self._doc.lock:
            if not instance.id:
                instance.id = uuid.uuid4().hex
            d = self._doc.read()
            d["instances"].append(_ei_to_json(instance))
            self._doc.write(d)
            return instance.id

    def get(self, instance_id: str) -> Optional[EngineInstance]:
        return next((_ei_from_json(i) for i in self._doc.read()["instances"]
                     if i["id"] == instance_id), None)

    def update(self, instance: EngineInstance) -> bool:
        with self._doc.lock:
            d = self._doc.read()
            for k, i in enumerate(d["instances"]):
                if i["id"] == instance.id:
                    d["instances"][k] = _ei_to_json(instance)
                    self._doc.write(d)
                    return True
            return False

    def get_all(self) -> List[EngineInstance]:
        return [_ei_from_json(i) for i in self._doc.read()["instances"]]

    def delete(self, instance_id: str) -> bool:
        with self._doc.lock:
            d = self._doc.read()
            n = len(d["instances"])
            d["instances"] = [i for i in d["instances"] if i["id"] != instance_id]
            self._doc.write(d)
            return len(d["instances"]) < n


class FSEngineManifests(base.EngineManifests):
    def __init__(self, root: Path):
        self._doc = _JsonDoc(root / "meta" / "engine_manifests.json", {"manifests": []})

    @staticmethod
    def _to_json(m: EngineManifest) -> Dict:
        return {"id": m.id, "version": m.version, "name": m.name,
                "description": m.description, "files": m.files,
                "engineFactory": m.engine_factory}

    @staticmethod
    def _from_json(d: Dict) -> EngineManifest:
        return EngineManifest(
            id=d["id"], version=d["version"], name=d["name"],
            description=d.get("description", ""), files=d.get("files", []),
            engine_factory=d.get("engineFactory", ""))

    @staticmethod
    def _other(m: Dict, manifest_id: str, version: str) -> bool:
        return not (m["id"] == manifest_id and m["version"] == version)

    def insert(self, manifest: EngineManifest) -> None:
        with self._doc.lock:
            d = self._doc.read()
            d["manifests"] = [m for m in d["manifests"]
                              if self._other(m, manifest.id, manifest.version)]
            d["manifests"].append(self._to_json(manifest))
            self._doc.write(d)

    def get(self, manifest_id: str, version: str) -> Optional[EngineManifest]:
        return next((self._from_json(m) for m in self._doc.read()["manifests"]
                     if not self._other(m, manifest_id, version)), None)

    def get_all(self) -> List[EngineManifest]:
        return [self._from_json(m) for m in self._doc.read()["manifests"]]

    def delete(self, manifest_id: str, version: str) -> bool:
        with self._doc.lock:
            d = self._doc.read()
            n = len(d["manifests"])
            d["manifests"] = [m for m in d["manifests"]
                              if self._other(m, manifest_id, version)]
            self._doc.write(d)
            return len(d["manifests"]) < n


class FSEvaluationInstances(base.EvaluationInstances):
    def __init__(self, root: Path):
        self._doc = _JsonDoc(root / "meta" / "evaluation_instances.json", {"instances": []})

    @staticmethod
    def _to_json(i: EvaluationInstance) -> Dict:
        return {
            "id": i.id, "status": i.status,
            "startTime": _dt_to_json(i.start_time), "endTime": _dt_to_json(i.end_time),
            "evaluationClass": i.evaluation_class,
            "engineParamsGeneratorClass": i.engine_params_generator_class,
            "env": i.env, "evaluatorResults": i.evaluator_results,
            "evaluatorResultsHTML": i.evaluator_results_html,
            "evaluatorResultsJSON": i.evaluator_results_json,
        }

    @staticmethod
    def _from_json(d: Dict) -> EvaluationInstance:
        return EvaluationInstance(
            id=d["id"], status=d["status"],
            start_time=_dt_from_json(d["startTime"]), end_time=_dt_from_json(d.get("endTime")),
            evaluation_class=d["evaluationClass"],
            engine_params_generator_class=d.get("engineParamsGeneratorClass", ""),
            env=d.get("env", {}),
            evaluator_results=d.get("evaluatorResults", ""),
            evaluator_results_html=d.get("evaluatorResultsHTML", ""),
            evaluator_results_json=d.get("evaluatorResultsJSON", ""),
        )

    def insert(self, instance: EvaluationInstance) -> str:
        with self._doc.lock:
            if not instance.id:
                instance.id = uuid.uuid4().hex
            d = self._doc.read()
            d["instances"].append(self._to_json(instance))
            self._doc.write(d)
            return instance.id

    def get(self, instance_id: str) -> Optional[EvaluationInstance]:
        return next((self._from_json(i) for i in self._doc.read()["instances"]
                     if i["id"] == instance_id), None)

    def update(self, instance: EvaluationInstance) -> bool:
        with self._doc.lock:
            d = self._doc.read()
            for k, i in enumerate(d["instances"]):
                if i["id"] == instance.id:
                    d["instances"][k] = self._to_json(instance)
                    self._doc.write(d)
                    return True
            return False

    def get_completed(self) -> List[EvaluationInstance]:
        return [self._from_json(i) for i in self._doc.read()["instances"]
                if i["status"] == "EVALCOMPLETED"]


class FSModels(base.Models):
    """Reference: data/.../storage/localfs/LocalFSModels.scala."""

    def __init__(self, root: Path):
        self._dir = root / "models"
        self._dir.mkdir(parents=True, exist_ok=True)

    def _path(self, instance_id: str) -> Path:
        if not instance_id.replace("-", "").replace("_", "").isalnum():
            raise ValueError(f"invalid model id {instance_id!r}")
        return self._dir / f"{instance_id}.bin"

    def insert(self, instance_id: str, blob: bytes) -> None:
        tmp = self._path(instance_id).with_suffix(f".tmp{os.getpid()}")
        tmp.write_bytes(blob)
        tmp.replace(self._path(instance_id))

    def get(self, instance_id: str) -> Optional[bytes]:
        p = self._path(instance_id)
        return p.read_bytes() if p.exists() else None

    def delete(self, instance_id: str) -> bool:
        p = self._path(instance_id)
        if p.exists():
            p.unlink()
            return True
        return False


class _EntityIndex:
    """Incremental (entityType, entityId) → line-offset index over one
    channel's segments: the serving history read.

    The reference reads one entity's events from its HBase row keys; here
    the index tails each segment from the last consumed byte on each lookup
    (a stat per segment when nothing changed) and keeps (path, offset,
    length) per event, so a lookup reads only the matching lines.  A torn
    tail line (no newline yet) is not consumed until it is complete."""

    def __init__(self, directory: Path):
        self._dir = directory
        self._consumed: Dict[str, int] = {}          # segment path -> bytes indexed
        self._inodes: Dict[str, int] = {}            # segment path -> st_ino
        self._postings: Dict[tuple, List[tuple]] = {}  # (etype, eid) -> [(path, off, len)]
        self._lock = threading.Lock()

    def _reset(self) -> None:
        self._consumed.clear()
        self._inodes.clear()
        self._postings.clear()

    def _refresh(self) -> None:
        segs = sorted(self._dir.glob("seg-*.jsonl")) if self._dir.exists() else []
        stats = {}
        for seg in segs:
            try:
                stats[str(seg)] = seg.stat()
            except FileNotFoundError:  # racing a delete
                pass
        # a data-delete or re-import from any process replaces or truncates
        # segments, and offsets into the old bytes mean nothing: an inode
        # change, a shrink or a vanished segment rebuilds from scratch
        for path, consumed in self._consumed.items():
            st = stats.get(path)
            if (st is None or st.st_size < consumed
                    or self._inodes.get(path) not in (None, st.st_ino)):
                self._reset()
                break
        for seg in segs:
            path = str(seg)
            st = stats.get(path)
            if st is None:
                continue
            consumed = self._consumed.get(path, 0)
            self._inodes[path] = st.st_ino
            if st.st_size <= consumed:
                continue
            with open(seg, "rb") as f:
                f.seek(consumed)
                chunk = f.read(st.st_size - consumed)
            end = chunk.rfind(b"\n")
            if end < 0:
                continue  # only a torn partial line so far
            offset = consumed
            for line in chunk[: end + 1].split(b"\n"):
                if line.strip():
                    try:
                        d = json.loads(line)
                        key = (d.get("entityType"), d.get("entityId"))
                        self._postings.setdefault(key, []).append((path, offset, len(line)))
                    except json.JSONDecodeError:
                        pass  # a corrupt line is skipped; the offset still advances
                offset += len(line) + 1
            self._consumed[path] = consumed + end + 1

    def warm(self) -> None:
        """Consume every segment byte now (otherwise the first lookup pays
        the whole log's parse)."""
        with self._lock:
            self._refresh()

    def events(self, entity_type: str, entity_id: str, tombstones: set) -> List[Event]:
        for _attempt in range(2):
            with self._lock:
                self._refresh()
                postings = list(self._postings.get((entity_type, entity_id), ()))
            try:
                return self._read_postings(postings, tombstones)
            except (FileNotFoundError, json.JSONDecodeError, ValueError, KeyError):
                # a segment replaced between refresh and read: rebuild once
                with self._lock:
                    self._reset()
        return []

    @staticmethod
    def _read_postings(postings: List[tuple], tombstones: set) -> List[Event]:
        out: List[Event] = []
        by_path: Dict[str, List[tuple]] = {}
        for path, off, ln in postings:
            by_path.setdefault(path, []).append((off, ln))
        for path, spans in by_path.items():
            with open(path, "rb") as f:
                for off, ln in spans:
                    f.seek(off)
                    e = Event.from_json(json.loads(f.read(ln)))
                    if e.event_id not in tombstones:
                        out.append(e)
        return out


def _env_writer_tag() -> Optional[str]:
    """This process's writer tag from PIO_WRITER_TAG (set by the event
    server's prefork spawn), kept to filesystem-safe characters.  '-' is
    kept: tags like ``w1-<parent pid>`` must stay distinct."""
    tag = os.environ.get("PIO_WRITER_TAG", "")
    tag = "".join(c for c in tag if c.isalnum() or c in "_-")
    return tag.strip("-") or None


class _CommitGroup:
    """Pending group-commit appends of one (app, channel) log."""

    __slots__ = ("cond", "pending", "active")

    def __init__(self):
        self.cond = threading.Condition()
        self.pending: List[dict] = []
        self.active = False


class FSEvents(base.LEvents, base.PEvents):
    """Append-only segmented JSON-lines event log.

    Within one process, appends to one (app, channel) are group-committed
    (``_append_lines``); across processes each writer appends only to its
    own segments (``writer_tag``, else PIO_WRITER_TAG, else the plain
    naming), and every read path globs ``seg-*.jsonl``."""

    _COMPACT_INTENT = "compact-intent.json"
    _COMPACT_LOCK = "compact.lock"

    def __init__(self, root: Path, writer_tag: Optional[str] = None):
        self._root = Path(root) / "events"
        # re-entrant: delete and compact re-enter through segment_paths'
        # crashed-compaction recovery
        self._lock = threading.RLock()
        self._indexes: Dict[tuple, _EntityIndex] = {}
        self._writers: Dict[tuple, _SegmentWriter] = {}
        self._groups: Dict[tuple, _CommitGroup] = {}
        self._writer_tag = writer_tag if writer_tag is not None else _env_writer_tag()
        self._rot_seen: Dict[tuple, int] = {}
        self._snap_inflight: set = set()

    def _entity_index(self, app_id: int, channel_id: Optional[int]) -> _EntityIndex:
        key = (app_id, channel_id)
        with self._lock:
            if key not in self._indexes:
                self._indexes[key] = _EntityIndex(self._chan_dir(app_id, channel_id))
            return self._indexes[key]

    def warm_entity_index(self, app_id: int, channel_id: Optional[int] = None) -> None:
        """Build the per-entity serving index now, so the first
        ``find_by_entity`` after a deploy does not parse the whole log."""
        self._entity_index(app_id, channel_id).warm()

    # -- layout --------------------------------------------------------------

    def _chan_dir(self, app_id: int, channel_id: Optional[int]) -> Path:
        chan = DEFAULT_CHANNEL if channel_id is None else f"channel_{channel_id}"
        return self._root / f"app_{app_id}" / chan

    @staticmethod
    def _list_segments(d: Path) -> List[Path]:
        if not d.exists():
            return []
        return sorted(d.glob("seg-*.jsonl"))

    def segment_paths(self, app_id: int, channel_id: Optional[int] = None) -> List[Path]:
        d = self._chan_dir(app_id, channel_id)
        if (d / self._COMPACT_INTENT).exists():
            # finish or roll back a crashed compaction before anyone reads
            with self._lock:
                self._recover_compact(d)
        return self._list_segments(d)

    @staticmethod
    def _tombstones(d: Path) -> set:
        # the union of "tombstones.txt" and the JAX package's per-writer
        # "tombstones-<writer>.txt"
        dead: set = set()
        if d.exists():
            for p in d.glob("tombstones*.txt"):
                dead.update(p.read_text().split())
        return dead

    # -- LEvents -------------------------------------------------------------

    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        self._chan_dir(app_id, channel_id).mkdir(parents=True, exist_ok=True)
        return True

    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        d = self._chan_dir(app_id, channel_id)
        with self._lock:
            self._indexes.pop((app_id, channel_id), None)
            w = self._writers.pop((app_id, channel_id), None)
            if w is not None:
                w.close()
        if d.exists():
            shutil.rmtree(d)
            base.notify_append(None)   # channel data gone: invalidate everything
            return True
        return False

    def insert(self, event: Event, app_id: int, channel_id: Optional[int] = None) -> str:
        return self.insert_batch([event], app_id, channel_id)[0]

    def _new_writer(self, d: Path) -> _SegmentWriter:
        """This store's segment writer: per-writer naming with a tag."""
        return _SegmentWriter(d, self._writer_tag)

    def _tombstone_path(self, d: Path) -> Path:
        """This store's tombstone file: per-writer with a tag (readers
        union every ``tombstones*.txt``)."""
        if self._writer_tag:
            return d / f"tombstones-{self._writer_tag}.txt"
        return d / "tombstones.txt"

    def insert_batch(
        self, events: Sequence[Event], app_id: int, channel_id: Optional[int] = None
    ) -> List[str]:
        self._append_lines("".join(e.to_json_line() + "\n" for e in events),
                           app_id, channel_id)
        base.notify_append([(e.entity_type, e.entity_id) for e in events])
        return [e.event_id for e in events]

    def insert_json_batch(
        self, items: Sequence, app_id: int, channel_id: Optional[int] = None
    ) -> List[dict]:
        """Wire dicts canonicalised without ``Event`` objects
        (``canonical_event_json``: byte-equal lines), every valid item in
        one append.  Events without an eventTime or creationTime share the
        batch's one clock read."""
        results: List[dict] = []
        lines: List[str] = []
        ents: List[tuple] = []
        now_iso = _dt.datetime.now(_dt.timezone.utc).isoformat()
        for item in items:
            try:
                d = canonical_event_json(item, now_iso)
                lines.append(json.dumps(d, separators=(",", ":"), sort_keys=True))
                results.append({"status": 201, "eventId": d["eventId"]})
                ents.append((str(d["entityType"]), str(d["entityId"])))
            except (ValueError, KeyError, TypeError) as e:
                results.append({"status": 400, "message": str(e)})
        if lines:
            self._append_lines("".join(ln + "\n" for ln in lines), app_id, channel_id)
            base.notify_append(ents)
        return results

    def _append_lines(self, lines: str, app_id: int, channel_id: Optional[int]) -> None:
        """Group-commit append: this call's buffer joins the (app,
        channel)'s queue; the first thread into an idle group becomes the
        commit leader and writes EVERY queued buffer with one ``write``
        (one fsync by the policy), while buffers arriving meanwhile queue
        for the next leader.  Leadership is released, never handed on: any
        waiter woken without its buffer written claims the vacancy.  A
        failed write raises in every thread whose lines it held."""
        with trace_span("group_commit_append"):
            self._append_lines_traced(lines, app_id, channel_id)

    def _append_lines_traced(self, lines: str, app_id: int,
                             channel_id: Optional[int]) -> None:
        key = (app_id, channel_id)
        with self._lock:
            g = self._groups.get(key)
            if g is None:
                g = self._groups[key] = _CommitGroup()
        item: dict = {"lines": lines}
        with g.cond:
            g.pending.append(item)
            while "done" not in item and g.active:
                g.cond.wait()
            if "done" not in item:
                # leadership vacancy: commit everything queued, ours too
                g.active = True
                batch = g.pending[:]
                del g.pending[:]
            else:
                batch = None
        if batch is not None:
            err: Optional[BaseException] = None
            commit_info = None
            try:
                with self._lock:
                    w = self._writers.get(key)
                    if w is None:
                        d = self._chan_dir(*key)
                        if (d / self._COMPACT_INTENT).exists():
                            # finish a crashed compaction before picking a
                            # segment: an append to a superseded segment
                            # would acknowledge events that the
                            # roll-forward then unlinks
                            self._recover_compact(d)
                        w = self._writers[key] = self._new_writer(d)
                    payload = "".join(i["lines"] for i in batch)
                    w.append(payload)
                    _M_GROUP.observe(len(batch))
                    _M_EVENTS.inc(payload.count("\n"))
                    commit_info = self._commit_point(key, w)
                    # the snapshot auto-trigger, checked only when this
                    # commit opened a new segment
                    if w.rotations != self._rot_seen.get(key, 0):
                        self._rot_seen[key] = w.rotations
                        self._maybe_auto_snapshot(key)
            except BaseException as e:
                # a failed write (ENOSPC, EIO) NACKs every event in the group
                err = e
            if err is None and commit_info is not None:
                try:
                    # the replication barrier, outside the instance lock (a
                    # slow replica must not block other channels); a failed
                    # barrier NACKs the group as a failed write does
                    self._post_commit(key, commit_info)
                except BaseException as e:
                    err = e
            with g.cond:
                for i in batch:
                    if err is not None:
                        i["err"] = err
                    i["done"] = True
                g.active = False
                g.cond.notify_all()
        err2 = item.get("err")
        if err2 is not None:
            raise err2

    # -- replication hooks (storage.sharded overrides them) -------------------

    def _commit_point(self, key: tuple, writer: _SegmentWriter):
        """Called by the group-commit leader with the instance lock held,
        right after the write: what this commit covered.  A replicated
        backend returns (segment path, end offset); here there is no
        barrier, and None."""
        return None

    def _post_commit(self, key: tuple, info) -> None:
        """Called by the leader after the lock is released when
        ``_commit_point`` returned something: raising NACKs every event of
        the group (the semi-sync replication barrier)."""

    # -- compaction ------------------------------------------------------------

    def _recover_compact(self, d: Path, owned: bool = False) -> None:
        """Finish or roll back a crashed compaction (two-phase intent file).

        A running compactor holds an OS flock on ``compact.lock`` for the
        whole operation, so a recovery that cannot take it does nothing: a
        live compaction is never taken for a crashed one.  With the flock
        held, phase 'prepare' rolls back (partial hidden output deleted,
        the log intact) and phase 'commit' rolls forward (the remaining
        hidden segments published, superseded files unlinked)."""
        intent_path = d / self._COMPACT_INTENT
        if not intent_path.exists():
            return
        lockf = None
        try:
            if not owned:
                lockf = open(d / self._COMPACT_LOCK, "a")
                try:
                    fcntl.flock(lockf.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
                except OSError:
                    return  # a live compactor owns the intent
            if not intent_path.exists():   # recovered while we waited
                return
            try:
                intent = json.loads(intent_path.read_text())
            except (json.JSONDecodeError, OSError):
                intent = {"phase": "prepare", "old": [], "tag": ""}
            tag = intent.get("tag", "")
            if intent.get("phase") == "commit":
                for hidden in d.glob(f".seg-{tag}-*.jsonl.tmp"):
                    try:
                        hidden.rename(d / hidden.name[1:-4])
                    except FileNotFoundError:
                        pass  # a racing recoverer won it
                for name in intent.get("old", []):
                    (d / name).unlink(missing_ok=True)
            else:
                for hidden in d.glob(f".seg-{tag}-*.jsonl.tmp"):
                    hidden.unlink(missing_ok=True)
                for pub in d.glob(f"seg-{tag}-*.jsonl"):
                    pub.unlink(missing_ok=True)
            intent_path.unlink(missing_ok=True)
        finally:
            if lockf is not None:
                lockf.close()  # closing releases the flock

    def compact(self, app_id: int, channel_id: Optional[int] = None,
                before: Optional[_dt.datetime] = None) -> Dict[str, int]:
        """Rewrite the (app, channel) log without its tombstoned events and,
        with ``before``, without events older than that instant (TTL).

        An offline maintenance operation: pause ingest and scans of this
        (app, channel) while it runs.  It is crash-safe: a two-phase intent
        file means a kill at any instant either rolls back (the log intact)
        or forward (the compacted log) on the next access.  Survivors
        stream from the read to hidden output files.  Returns {"kept",
        "expired", "segments"}."""
        if before is not None:
            before = parse_time(before)
        d = self._chan_dir(app_id, channel_id)
        with self._lock:
            w = self._writers.pop((app_id, channel_id), None)
            if w is not None:
                w.close()
            d.mkdir(parents=True, exist_ok=True)
            # own the operation for its whole duration: concurrent
            # recoveries see the flock held and leave the intent alone
            lockf = open(d / self._COMPACT_LOCK, "a")
            try:
                fcntl.flock(lockf.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                lockf.close()
                raise RuntimeError("another compaction is in progress for this channel")
            try:
                out = self._compact_locked(d, (app_id, channel_id), before)
            finally:
                lockf.close()
        base.notify_append(None)   # events trimmed: invalidate everything
        return out

    def _compact_locked(self, d: Path, key: tuple,
                        before: Optional[_dt.datetime]) -> Dict[str, int]:
        """compact()'s body; the caller holds the lock and the flock."""
        self._recover_compact(d, owned=True)
        old_segs = self._list_segments(d)
        old_tombs = sorted(d.glob("tombstones*.txt"))
        tag = uuid.uuid4().hex[:8]
        intent_path = d / self._COMPACT_INTENT
        old_names = [p.name for p in old_segs] + [p.name for p in old_tombs]
        _atomic_write(intent_path, json.dumps(
            {"phase": "prepare", "tag": tag, "old": old_names}))
        # phase 1: survivors into hidden output (a crash here rolls back);
        # the listed segments are read directly, not through segment_paths,
        # whose recovery would act on the intent just written
        kept = expired = n_new = 0
        f = None
        try:
            for e in self._iter_segments(old_segs, self._tombstones(d)):
                if before is not None and e.event_time < before:
                    expired += 1
                    continue
                if f is None or f.tell() >= SEGMENT_MAX_BYTES:
                    if f is not None:
                        f.flush()
                        os.fsync(f.fileno())
                        f.close()
                    f = open(d / f".seg-{tag}-{n_new:05d}.jsonl.tmp", "w")
                    n_new += 1
                f.write(e.to_json_line() + "\n")
                kept += 1
        finally:
            if f is not None:
                f.flush()
                os.fsync(f.fileno())
                f.close()
        # phase 2: commit (an atomic intent flip), then publish and unlink;
        # a crash after the flip rolls forward
        _atomic_write(intent_path, json.dumps(
            {"phase": "commit", "tag": tag, "old": old_names}))
        for hidden in sorted(d.glob(f".seg-{tag}-*.jsonl.tmp")):
            hidden.rename(d / hidden.name[1:-4])
        for p in old_segs + old_tombs:
            p.unlink(missing_ok=True)
        intent_path.unlink(missing_ok=True)
        self._indexes.pop(key, None)
        return {"kept": kept, "expired": expired, "segments": n_new}

    # -- columnar snapshots --------------------------------------------------------

    def build_snapshot(self, app_id: int, channel_id: Optional[int] = None) -> Dict:
        """Fold the (app, channel) log into a columnar snapshot
        (``storage.snapshot``).  Safe beside live appends: segments are
        append-only and only the lines complete at build time are covered."""
        from predictionio_tpu_torch.storage import snapshot as _snap

        self.segment_paths(app_id, channel_id)   # recover a crashed compaction
        d = self._chan_dir(app_id, channel_id)
        d.mkdir(parents=True, exist_ok=True)
        return _snap.build_snapshot(d, self._tombstones(d), self._writer_tag or "local")

    def snapshot_scan(self, app_id: int, channel_id: Optional[int] = None) -> Optional[Dict]:
        """{"batch", "ids", "watermark", ...} from the mapped snapshot and
        a parse of only the uncovered tail, or None (a miss: the caller
        scans the log)."""
        from predictionio_tpu_torch.storage import snapshot as _snap

        if not _snap.enabled():
            return None
        with trace_span("snapshot_scan"):
            self.segment_paths(app_id, channel_id)   # recover a crashed compaction
            d = self._chan_dir(app_id, channel_id)
            res = _snap.scan_snapshot(d, self._tombstones(d))
        if res is None:
            _snap.record_miss()
        else:
            _snap.record_hit()
        return res

    def scan_tail_from(self, app_id: int, channel_id: Optional[int],
                       watermark: Dict[str, int], base=None,
                       heads: Optional[Dict] = None) -> Optional[Dict]:
        """Delta staging: parse only the events past ``watermark`` (a
        previous read's per-segment offsets, ``heads`` its fingerprints);
        None when the watermark no longer matches the log."""
        from predictionio_tpu_torch.storage import snapshot as _snap

        d = self._chan_dir(app_id, channel_id)
        return _snap.scan_tail(d, watermark, self._tombstones(d), base=base, heads=heads)

    def scan_events_up_to(self, app_id: int, channel_id: Optional[int],
                          watermark: Dict[str, int],
                          heads: Optional[Dict] = None) -> Optional[Dict]:
        """The events up to ``watermark`` exactly (a restarted follower's
        read); None when the watermark no longer matches the log."""
        from predictionio_tpu_torch.storage import snapshot as _snap

        d = self._chan_dir(app_id, channel_id)
        return _snap.scan_bounded(d, watermark, self._tombstones(d), heads=heads)

    def snapshot_status(self, app_id: int, channel_id: Optional[int] = None) -> Optional[Dict]:
        from predictionio_tpu_torch.storage import snapshot as _snap

        return _snap.snapshot_status(self._chan_dir(app_id, channel_id))

    def tombstone_state(self, app_id: int, channel_id: Optional[int] = None) -> frozenset:
        """The tombstoned ids (a staging cache is valid while they do not
        change)."""
        return frozenset(self._tombstones(self._chan_dir(app_id, channel_id)))

    def _maybe_auto_snapshot(self, key: tuple) -> None:
        """A background build once PIO_SNAPSHOT_SEGMENTS segments are
        uncovered; called with the lock held, on a segment rotation."""
        from predictionio_tpu_torch.storage import snapshot as _snap

        thr = _snap.auto_threshold()
        if thr <= 0 or not _snap.enabled() or key in self._snap_inflight:
            return
        if _snap.uncovered_segments(self._chan_dir(*key)) < thr:
            return
        self._snap_inflight.add(key)

        def run():
            try:
                self.build_snapshot(*key)
            except RuntimeError:
                pass     # another process's build is in flight
            except Exception:
                log.warning("automatic snapshot build failed for %s", key, exc_info=True)
            finally:
                with self._lock:
                    self._snap_inflight.discard(key)

        threading.Thread(target=run, daemon=True, name="pio-snapshot-build").start()

    def find_batches(self, app_id: int, batch_size: int = 1 << 20,
                     **filters: Any) -> Iterator["EventBatch"]:  # noqa: F821
        """Columnar batches, snapshot first: a valid snapshot and its tail
        are ONE batch (filters applied on columns); a miss, or a filter the
        columns do not hold, reads through the base scan."""
        from predictionio_tpu_torch.storage import snapshot as _snap

        plain = {"channel_id", "start_time", "until_time", "entity_type", "event_names"}
        if set(filters) <= plain:
            res = self.snapshot_scan(app_id, filters.get("channel_id"))
            if res is not None:
                yield _snap.apply_filters(
                    res["batch"], event_names=filters.get("event_names"),
                    entity_type=filters.get("entity_type"),
                    start_time=filters.get("start_time"),
                    until_time=filters.get("until_time"))
                return
        yield from super().find_batches(app_id, batch_size=batch_size, **filters)

    # -- reads -------------------------------------------------------------------

    @staticmethod
    def _iter_segments(segs: Sequence[Path], dead: set,
                       needles: Optional[List[bytes]] = None) -> Iterator[Event]:
        for seg in segs:
            with open(seg, "rb") as f:
                for raw in f:
                    # an unterminated final line is a torn tail from a
                    # writer killed mid-append (never acknowledged): skip
                    # it; the writer truncates it when it opens again
                    if not raw.endswith(b"\n"):
                        break
                    line = raw.strip()
                    if line and (needles is None or any(nd in line for nd in needles)):
                        e = Event.from_json(json.loads(line))
                        if e.event_id not in dead:
                            yield e

    @staticmethod
    def _event_needles(event_names: Optional[Sequence[str]]) -> Optional[List[bytes]]:
        """Raw-line prefilter of a name-filtered scan: a line that holds
        none of these bytes cannot carry a wanted event name, so it is not
        parsed.  ``json.dumps`` gives the escaping both writers emit; the
        spaced form matches pretty-printed external lines.  A needle inside
        a property value only costs a parse: the filter after it decides."""
        if event_names is None:
            return None
        needles: List[bytes] = []
        for n in event_names:
            j = json.dumps(n)
            needles.append(f'"event":{j}'.encode())
            needles.append(f'"event": {j}'.encode())
        return needles

    def _iter_raw(self, app_id: int, channel_id: Optional[int],
                  needles: Optional[List[bytes]] = None) -> Iterator[Event]:
        d = self._chan_dir(app_id, channel_id)
        yield from self._iter_segments(self.segment_paths(app_id, channel_id),
                                       self._tombstones(d), needles=needles)

    def get(self, event_id: str, app_id: int, channel_id: Optional[int] = None) -> Optional[Event]:
        return next((e for e in self._iter_raw(app_id, channel_id) if e.event_id == event_id),
                    None)

    def _is_live(self, event_id: str, app_id: int, channel_id: Optional[int]) -> bool:
        """Whether a complete, untombstoned line holds the event ``event_id``.

        An id of plain ASCII (letters, digits, ``-``, ``_``, ``.``: every
        id the writers mint) has the same bytes in any JSON encoding, so the
        segments are searched for them and only the lines that hold them
        are parsed; any other id is looked for by parsing every line.
        Either way the answer is the one a parse of the whole log gives."""
        dead = self._tombstones(self._chan_dir(app_id, channel_id))
        if event_id in dead:
            return False
        segs = self.segment_paths(app_id, channel_id)
        if not _PLAIN_ID.fullmatch(event_id):
            return any(e.event_id == event_id for e in self._iter_segments(segs, dead))
        needle = event_id.encode()
        for seg in segs:
            with open(seg, "rb") as f:
                if os.fstat(f.fileno()).st_size == 0:
                    continue
                with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as data:
                    end = data.rfind(b"\n") + 1   # a torn last line is not an event
                    pos = data.find(needle, 0, end)
                    while pos >= 0:
                        a, b = data.rfind(b"\n", 0, pos) + 1, data.find(b"\n", pos)
                        line = data[a:b].strip()
                        if line and Event.from_json(json.loads(line)).event_id == event_id:
                            return True
                        pos = data.find(needle, b, end)
        return False

    def delete(self, event_id: str, app_id: int, channel_id: Optional[int] = None) -> bool:
        d = self._chan_dir(app_id, channel_id)
        with self._lock:
            # under the lock: confirm the id is live, then tombstone it
            if not self._is_live(event_id, app_id, channel_id):
                return False
            with open(self._tombstone_path(d), "a") as f:
                f.write(event_id + "\n")
        base.notify_append(None)   # entity unknown here: invalidate everything
        return True

    def find(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        entity_id: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Optional[str] = None,
        target_entity_id: Optional[str] = None,
        limit: Optional[int] = None,
        reversed_order: bool = False,
    ) -> Iterator[Event]:
        if entity_type is not None and entity_id is not None:
            # the serving read (LEventStore.find_by_entity): only this
            # entity's lines, through the incremental index
            candidates = self._entity_index(app_id, channel_id).events(
                entity_type, entity_id, self._tombstones(self._chan_dir(app_id, channel_id)))
        else:
            candidates = self._iter_raw(app_id, channel_id)
        matched = (e for e in candidates if base.match_filters(
            e, start_time, until_time, entity_type, entity_id,
            event_names, target_entity_type, target_entity_id))
        ordered = sorted(matched, key=lambda e: (e.event_time, e.creation_time),
                         reverse=reversed_order)
        if limit is not None and limit >= 0:
            ordered = ordered[:limit]
        yield from ordered

    def scan(
        self,
        app_id: int,
        channel_id: Optional[int] = None,
        start_time: Optional[_dt.datetime] = None,
        until_time: Optional[_dt.datetime] = None,
        entity_type: Optional[str] = None,
        event_names: Optional[Sequence[str]] = None,
        target_entity_type: Optional[str] = None,
    ) -> Iterator[Event]:
        """The bulk training read: the segments streamed in log order,
        unsorted (``find`` sorts by time), lines of other event names
        skipped before their parse (``_event_needles``).  ``find_batches``
        reads through it when no snapshot serves."""
        for e in self._iter_raw(app_id, channel_id,
                                needles=self._event_needles(event_names)):
            if base.match_filters(e, start_time, until_time, entity_type, None,
                                  event_names, target_entity_type, None):
                yield e
