"""Storage locator (reference: data/.../storage/Storage.scala).

Counterpart of ``predictionio_tpu/storage/locator.py``.  Repositories are
resolved from ``PIO_STORAGE_REPOSITORIES_{METADATA,EVENTDATA,MODELDATA}_SOURCE``
+ ``PIO_STORAGE_SOURCES_<NAME>_{TYPE,...}`` env vars (set by
conf/pio-env.sh), exactly as in the JAX package; each repository binds to a
source.  With no repository configured, the default is the reference's: one
``localfs`` source under ``PIO_FS_BASEDIR`` (or ``~/.pio_store``).

The source types are the JAX package's: ``memory``, ``localfs``,
``sharedfs`` (a multi-host shared prefix, ``storage/sharedfs.py``),
``sharded`` (events hashed over ``_SHARDS`` shards with ``_REPLICAS`` 1 or
2, metadata and models on the prefix: ``storage/sharded.py``) and ``sql``
(one sqlite3 database, ``_PATH`` or an in-memory one: ``storage/sql.py``).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

from predictionio_tpu_torch.storage import base, localfs, memory, sql

_REPOSITORIES = ("METADATA", "EVENTDATA", "MODELDATA")


@dataclass
class StorageConfig:
    """Parsed PIO_STORAGE_* configuration."""

    sources: Dict[str, Dict[str, str]]        # name -> {type, path, ...}
    repositories: Dict[str, str]              # METADATA/EVENTDATA/MODELDATA -> source name

    @classmethod
    def from_env(cls, env: Optional[Dict[str, str]] = None) -> "StorageConfig":
        env = dict(env if env is not None else os.environ)
        sources: Dict[str, Dict[str, str]] = {}
        repositories: Dict[str, str] = {}
        for k, v in env.items():
            if k.startswith("PIO_STORAGE_SOURCES_"):
                rest = k[len("PIO_STORAGE_SOURCES_"):]
                name, _, attr = rest.partition("_")
                sources.setdefault(name, {})[attr.lower()] = v
            elif k.startswith("PIO_STORAGE_REPOSITORIES_"):
                rest = k[len("PIO_STORAGE_REPOSITORIES_"):]
                repo, _, attr = rest.partition("_")
                if attr == "SOURCE":
                    repositories[repo] = v
        if not repositories:
            # Default single-node config: everything on localfs under ~/.pio_store
            home = env.get("PIO_FS_BASEDIR", str(Path(env.get("HOME", ".")) / ".pio_store"))
            sources = {"LOCALFS": {"type": "localfs", "path": home}}
            repositories = {r: "LOCALFS" for r in _REPOSITORIES}
        for r in _REPOSITORIES:
            if r not in repositories:
                raise ValueError(f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE is not configured")
            if repositories[r] not in sources:
                raise ValueError(
                    f"repository {r} references undefined source {repositories[r]!r}"
                )
        return cls(sources, repositories)

    @classmethod
    def memory(cls) -> "StorageConfig":
        """All three repositories on one ``memory`` source."""
        return cls(sources={"MEM": {"type": "memory"}},
                   repositories={r: "MEM" for r in _REPOSITORIES})


class _MemorySource:
    def __init__(self, spec: Dict[str, str]):
        self.apps = memory.MemApps()
        self.access_keys = memory.MemAccessKeys()
        self.channels = memory.MemChannels()
        self.engine_instances = memory.MemEngineInstances()
        self.engine_manifests = memory.MemEngineManifests()
        self.evaluation_instances = memory.MemEvaluationInstances()
        self.models = memory.MemModels()
        self.events = memory.MemEvents()


class _LocalFSSource:
    def __init__(self, spec: Dict[str, str]):
        root = Path(spec.get("path", ".pio_store"))
        self.apps = localfs.FSApps(root)
        self.access_keys = localfs.FSAccessKeys(root)
        self.channels = localfs.FSChannels(root)
        self.engine_instances = localfs.FSEngineInstances(root)
        self.engine_manifests = localfs.FSEngineManifests(root)
        self.evaluation_instances = localfs.FSEvaluationInstances(root)
        self.models = localfs.FSModels(root)
        self.events = localfs.FSEvents(root)


def _sql_source(spec: Dict[str, str]):
    # the reference's JDBC URL is the path here; without one the database
    # is in memory
    return sql.SQLSource(spec.get("path", ":memory:"))


def _sharedfs_source(spec: Dict[str, str]):
    from predictionio_tpu_torch.storage import sharedfs

    return sharedfs.SharedFSSource(spec.get("path", ".pio_store"))


def _sharded_source(spec: Dict[str, str]):
    # path, shards and replicas (PIO_STORAGE_SOURCES_<NAME>_{PATH,SHARDS,REPLICAS})
    from predictionio_tpu_torch.storage import sharded

    return sharded.ShardedSource(spec)


# each factory takes the source's whole spec and reads its own keys
_SOURCE_TYPES = {
    "memory": _MemorySource,
    "localfs": _LocalFSSource,
    "sql": _sql_source,
    "sharedfs": _sharedfs_source,
    "sharded": _sharded_source,
}


class Storage:
    """Repository accessor bound to a StorageConfig (reference: Storage object)."""

    def __init__(self, config: Optional[StorageConfig] = None):
        self.config = config or StorageConfig.from_env()
        self._clients: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _client(self, repo: str):
        name = self.config.repositories[repo]
        with self._lock:
            if name not in self._clients:
                spec = self.config.sources[name]
                typ = spec.get("type", "localfs")
                if typ not in _SOURCE_TYPES:
                    raise ValueError(
                        f"unknown storage source type {typ!r} (have: {sorted(_SOURCE_TYPES)})")
                self._clients[name] = _SOURCE_TYPES[typ](spec)
            return self._clients[name]

    # Metadata repositories
    @property
    def apps(self) -> base.Apps:
        return self._client("METADATA").apps

    @property
    def access_keys(self) -> base.AccessKeys:
        return self._client("METADATA").access_keys

    @property
    def channels(self) -> base.Channels:
        return self._client("METADATA").channels

    @property
    def engine_instances(self) -> base.EngineInstances:
        return self._client("METADATA").engine_instances

    @property
    def engine_manifests(self) -> base.EngineManifests:
        return self._client("METADATA").engine_manifests

    @property
    def evaluation_instances(self) -> base.EvaluationInstances:
        return self._client("METADATA").evaluation_instances

    # Model repository
    @property
    def models(self) -> base.Models:
        return self._client("MODELDATA").models

    # Event repositories
    @property
    def l_events(self) -> base.LEvents:
        return self._client("EVENTDATA").events

    @property
    def p_events(self) -> base.PEvents:
        return self._client("EVENTDATA").events


_default: Optional[Storage] = None
_default_lock = threading.Lock()


def get_storage(refresh: bool = False) -> Storage:
    """The process-default storage, built from the environment at first
    use (or anew with ``refresh``)."""
    global _default
    with _default_lock:
        changed = _default is None or refresh
        if changed:
            _default = Storage()
        result = _default
    if changed:
        base.notify_append(None)   # new default: cached reads are stale
    return result


def set_storage(storage: Optional[Storage]) -> None:
    """Override the process-default storage (used by tests and servers).

    Cached reads keyed by app and entity names (the serving history cache)
    describe the OLD storage once the default moves: they are flushed
    through the mutation bus."""
    global _default
    with _default_lock:
        _default = storage
    base.notify_append(None)
