"""Shared-prefix storage backend — the multi-host system-of-record.

Counterpart of ``predictionio_tpu/storage/sharedfs.py``: the same record
files, segment names and snapshots, so a prefix either package wrote reads
the same in the other.

The localfs backend assumes ONE writer process per (app, channel): it
appends to a single active segment and keeps whole-file JSON documents for
metadata, both of which corrupt under concurrent writers on different
hosts.  This backend keeps the same ``base.py`` interfaces (and the same
on-disk event format, so the native scanner and the host-sharded scan
logic run unchanged) but is **object-store-shaped**, targeting a shared
prefix every host can reach (NFS/GCS-fuse/…; reference analogue: the
HBase/Elasticsearch cluster every Spark executor talks to, SURVEY.md §2):

- every write is either a CREATE of a uniquely-named immutable object
  (events, models, instances) or an atomic replace of a record the caller
  logically owns (instance status updates);
- event segments are **per-writer**: ``seg-<host>-<pid>-NNNNN.jsonl`` —
  no cross-writer appends, so any number of event servers / import jobs
  on any number of hosts can ingest concurrently; readers simply list
  ``seg-*.jsonl`` (the glob the localfs scan paths already use);
- tombstones are per-writer too (``tombstones-<writer>.txt``), unioned at
  read time;
- metadata records are one JSON object per file; uniqueness (app/channel
  names) is claimed with O_EXCL creates — the "if-absent PUT" every
  object store offers — instead of read-modify-write of a shared doc.
"""

from __future__ import annotations

import json
import os
import socket
import uuid
import zlib
from pathlib import Path
from typing import Dict, List, Optional

from predictionio_tpu_torch.storage import base, localfs
from predictionio_tpu_torch.storage.base import (
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EngineManifest,
    EvaluationInstance,
)
from predictionio_tpu_torch.storage.localfs import (
    _atomic_write,
    _ei_from_json,
    _ei_to_json,
)


def writer_id() -> str:
    """Stable per-process writer tag for segment/tombstone names."""
    host = "".join(c if c.isalnum() else "_" for c in socket.gethostname())[:24]
    return f"{host}-{os.getpid()}"


def _create_exclusive(path: Path, text: str) -> bool:
    """If-absent PUT: atomically create ``path`` with ``text``; False if it
    already exists (another host claimed it)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    try:
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return False
    with os.fdopen(fd, "w") as f:
        f.write(text)
    return True


def _safe_name(s: str) -> str:
    """Filesystem-safe record name: readable prefix + collision-proof hash."""
    keep = "".join(c if c.isalnum() or c in "-_" else "_" for c in s)[:48]
    return f"{keep}-{zlib.crc32(s.encode()):08x}"


def _claim_id(ids: "_RecordDir", want: int, owner_name: str) -> int:
    """Claim a numeric id via if-absent creates, probing upward past ids
    other owners hold; idempotent for the same owner (crash-retry safe)."""
    claimed = want
    while not ids.put_new(str(claimed), {"name": owner_name}):
        holder = ids.get(str(claimed))
        if holder and holder.get("name") == owner_name:
            break
        claimed += 1
    return claimed


class _RecordDir:
    """A directory of single-JSON-object records (one file per record)."""

    def __init__(self, d: Path):
        self.d = d

    def put(self, name: str, obj: Dict) -> None:
        self.d.mkdir(parents=True, exist_ok=True)
        _atomic_write(self.d / f"{name}.json", json.dumps(obj, sort_keys=True))

    def put_new(self, name: str, obj: Dict) -> bool:
        return _create_exclusive(self.d / f"{name}.json", json.dumps(obj, sort_keys=True))

    def get(self, name: str) -> Optional[Dict]:
        p = self.d / f"{name}.json"
        if not p.exists():
            return None
        try:
            return json.loads(p.read_text())
        except (json.JSONDecodeError, OSError):
            return None

    def all(self) -> List[Dict]:
        if not self.d.exists():
            return []
        out = []
        for p in sorted(self.d.glob("*.json")):
            try:
                out.append(json.loads(p.read_text()))
            except (json.JSONDecodeError, OSError):
                continue  # racing a concurrent replace
        return out

    def delete(self, name: str) -> bool:
        p = self.d / f"{name}.json"
        try:
            p.unlink()
            return True
        except FileNotFoundError:
            return False


class SharedApps(base.Apps):
    def __init__(self, root: Path):
        self._names = _RecordDir(root / "meta" / "apps" / "by_name")
        self._ids = _RecordDir(root / "meta" / "apps" / "by_id")

    def insert(self, app: App) -> Optional[int]:
        name_key = _safe_name(app.name)
        # two-phase but CRASH-SAFE: phase 1 claims the name (id 0 =
        # incomplete) AND records the wanted id, phase 2 claims the id and
        # finalizes.  A retry after a crash mid-insert finds the incomplete
        # record and resumes phase 2 FROM THE RECORDED want, so concurrent
        # repairers (who may not know the original app.id) converge.
        want = app.id if app.id > 0 else (zlib.crc32(app.name.encode()) % (1 << 30)) + 1
        rec = {"id": 0, "want": want, "name": app.name,
               "description": app.description}
        if not self._names.put_new(name_key, rec):
            existing = self._names.get(name_key)
            if existing is None or existing.get("id"):
                return None  # completed insert by someone else: duplicate
            rec = existing  # resume a wedged insert
            want = int(rec.get("want") or want)
        app_id = _claim_id(self._ids, want, app.name)
        rec["id"] = app.id = app_id
        self._names.put(name_key, rec)
        return app_id

    def _from(self, d: Optional[Dict]) -> Optional[App]:
        if d is None or not d.get("id"):
            return None
        return App(d["id"], d["name"], d.get("description", ""))

    def get(self, app_id: int) -> Optional[App]:
        owner = self._ids.get(str(app_id))
        if owner is None:
            return None
        return self.get_by_name(owner["name"])

    def get_by_name(self, name: str) -> Optional[App]:
        return self._from(self._names.get(_safe_name(name)))

    def get_all(self) -> List[App]:
        return [a for a in (self._from(d) for d in self._names.all()) if a]

    def update(self, app: App) -> bool:
        cur = self.get(app.id)
        if cur is None or cur.name != app.name:
            return False  # renames would need a new name claim; not supported
        self._names.put(_safe_name(app.name), {
            "id": app.id, "name": app.name, "description": app.description})
        return True

    def delete(self, app_id: int) -> bool:
        owner = self._ids.get(str(app_id))
        if owner is None:
            return False
        self._names.delete(_safe_name(owner["name"]))
        return self._ids.delete(str(app_id))


class SharedAccessKeys(base.AccessKeys):
    def __init__(self, root: Path):
        self._keys = _RecordDir(root / "meta" / "access_keys")

    def insert(self, access_key: AccessKey) -> Optional[str]:
        if not access_key.key:
            access_key.key = AccessKey.generate()
        ok = self._keys.put_new(_safe_name(access_key.key), {
            "key": access_key.key, "appid": access_key.app_id,
            "events": access_key.events})
        return access_key.key if ok else None

    def _from(self, d: Dict) -> AccessKey:
        return AccessKey(d["key"], d["appid"], d.get("events", []))

    def get(self, key: str) -> Optional[AccessKey]:
        d = self._keys.get(_safe_name(key))
        return self._from(d) if d else None

    def get_by_app_id(self, app_id: int) -> List[AccessKey]:
        return [self._from(d) for d in self._keys.all() if d["appid"] == app_id]

    def delete(self, key: str) -> bool:
        return self._keys.delete(_safe_name(key))


class SharedChannels(base.Channels):
    def __init__(self, root: Path):
        self._root = root

    def _dir(self, app_id: int) -> _RecordDir:
        return _RecordDir(self._root / "meta" / "channels" / f"app_{app_id}")

    def _ids(self, app_id: int) -> _RecordDir:
        return _RecordDir(self._root / "meta" / "channels" / f"app_{app_id}_ids")

    def insert(self, channel: Channel) -> Optional[int]:
        name_key = _safe_name(channel.name)
        rec = {"id": 0, "name": channel.name, "appid": channel.app_id}
        d = self._dir(channel.app_id)
        if not d.put_new(name_key, rec):
            existing = d.get(name_key)
            if existing is None or existing.get("id"):
                return None
            rec = existing  # resume a wedged insert
        want = (zlib.crc32(f"{channel.app_id}/{channel.name}".encode()) % (1 << 30)) + 1
        cid = _claim_id(self._ids(channel.app_id), want, channel.name)
        rec["id"] = channel.id = cid
        d.put(name_key, rec)
        return cid

    def get(self, channel_id: int) -> Optional[Channel]:
        base_dir = self._root / "meta" / "channels"
        if not base_dir.exists():
            return None
        for appdir in base_dir.iterdir():
            if appdir.name.endswith("_ids"):
                continue
            for d in _RecordDir(appdir).all():
                if d.get("id") == channel_id:
                    return Channel(d["id"], d["name"], d["appid"])
        return None

    def get_by_app_id(self, app_id: int) -> List[Channel]:
        return [Channel(d["id"], d["name"], d["appid"])
                for d in self._dir(app_id).all() if d.get("id")]

    def delete(self, channel_id: int) -> bool:
        ch = self.get(channel_id)
        if ch is None:
            return False
        ok = self._dir(ch.app_id).delete(_safe_name(ch.name))
        self._ids(ch.app_id).delete(str(channel_id))  # release the id claim
        return ok


class SharedEngineInstances(base.EngineInstances):
    def __init__(self, root: Path):
        self._recs = _RecordDir(root / "meta" / "engine_instances")

    def insert(self, instance: EngineInstance) -> str:
        if not instance.id:
            instance.id = uuid.uuid4().hex
        self._recs.put(_safe_name(instance.id), _ei_to_json(instance))
        return instance.id

    def get(self, instance_id: str) -> Optional[EngineInstance]:
        d = self._recs.get(_safe_name(instance_id))
        return _ei_from_json(d) if d else None

    def update(self, instance: EngineInstance) -> bool:
        if self._recs.get(_safe_name(instance.id)) is None:
            return False
        self._recs.put(_safe_name(instance.id), _ei_to_json(instance))
        return True

    def get_all(self) -> List[EngineInstance]:
        return [_ei_from_json(d) for d in self._recs.all()]

    def delete(self, instance_id: str) -> bool:
        return self._recs.delete(_safe_name(instance_id))


class SharedEngineManifests(base.EngineManifests):
    def __init__(self, root: Path):
        self._recs = _RecordDir(root / "meta" / "engine_manifests")

    @staticmethod
    def _key(manifest_id: str, version: str) -> str:
        return _safe_name(f"{manifest_id}@@{version}")

    def insert(self, manifest: EngineManifest) -> None:
        self._recs.put(self._key(manifest.id, manifest.version),
                       localfs.FSEngineManifests._to_json(manifest))

    def get(self, manifest_id: str, version: str) -> Optional[EngineManifest]:
        d = self._recs.get(self._key(manifest_id, version))
        return localfs.FSEngineManifests._from_json(d) if d else None

    def get_all(self) -> List[EngineManifest]:
        return [localfs.FSEngineManifests._from_json(d) for d in self._recs.all()]

    def delete(self, manifest_id: str, version: str) -> bool:
        return self._recs.delete(self._key(manifest_id, version))


class SharedEvaluationInstances(base.EvaluationInstances):
    def __init__(self, root: Path):
        self._recs = _RecordDir(root / "meta" / "evaluation_instances")

    def insert(self, instance: EvaluationInstance) -> str:
        if not instance.id:
            instance.id = uuid.uuid4().hex
        self._recs.put(_safe_name(instance.id),
                       localfs.FSEvaluationInstances._to_json(instance))
        return instance.id

    def get(self, instance_id: str) -> Optional[EvaluationInstance]:
        d = self._recs.get(_safe_name(instance_id))
        return localfs.FSEvaluationInstances._from_json(d) if d else None

    def update(self, instance: EvaluationInstance) -> bool:
        if self._recs.get(_safe_name(instance.id)) is None:
            return False
        self._recs.put(_safe_name(instance.id),
                       localfs.FSEvaluationInstances._to_json(instance))
        return True

    def get_all(self) -> List[EvaluationInstance]:
        return [localfs.FSEvaluationInstances._from_json(d) for d in self._recs.all()]

    def get_completed(self) -> List[EvaluationInstance]:
        return [i for i in self.get_all() if i.status == "EVALCOMPLETED"]

    def delete(self, instance_id: str) -> bool:
        return self._recs.delete(_safe_name(instance_id))


class SharedModels(localfs.FSModels):
    """Model blobs are keyed by engine-instance id (uuid → unique object
    names already); the localfs tmp+rename write is the object PUT."""


class SharedFSEvents(localfs.FSEvents):
    """Per-writer segments over the shared prefix.

    Readers (find/scan/native batch/host-sharded scans) are inherited
    unchanged — they glob ``seg-*.jsonl``, and per-writer names sort into a
    stable global order.  The write hooks are the tagged localfs ones:
    segments are ``seg-<writer>-NNNNN.jsonl`` and tombstones
    ``tombstones-<writer>.txt`` (unioned at read time by the inherited
    ``_tombstones``); the tag defaults to ``<host>-<pid>`` instead of
    localfs's untagged single-writer naming.

    Columnar snapshots are shared the same way: ANY host may run
    ``pio snapshot`` (or hit the auto-trigger) and the build lands as
    ``snapshot/snap-<its writer tag>-<id>.pioc`` plus an atomically
    replaced ``manifest.json`` on the shared prefix — every other host's
    ``snapshot_scan`` validates that manifest against the live segment
    set and mmap-loads the same file, so one build serves the whole
    fleet.  Concurrent builders are serialized by the flock where the
    filesystem honors it; where it doesn't, last-writer-wins manifest
    replaces stay self-consistent (the loser's file is garbage-collected
    by the next build)."""

    def __init__(self, root: Path, writer_tag: Optional[str] = None):
        super().__init__(root, writer_tag=writer_tag or writer_id())


class SharedFSSource:
    """Storage source of type ``sharedfs`` (PIO_STORAGE_SOURCES_*_TYPE)."""

    def __init__(self, path: str):
        root = Path(path)
        self.apps = SharedApps(root)
        self.access_keys = SharedAccessKeys(root)
        self.channels = SharedChannels(root)
        self.engine_instances = SharedEngineInstances(root)
        self.engine_manifests = SharedEngineManifests(root)
        self.evaluation_instances = SharedEvaluationInstances(root)
        self.models = SharedModels(root)
        self.events = SharedFSEvents(root)
