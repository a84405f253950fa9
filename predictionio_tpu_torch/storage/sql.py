"""SQL storage backend on sqlite3 — the JDBC-backend parity implementation.

Counterpart of ``predictionio_tpu/storage/sql.py``: the same schema, the
same per-app event tables and the same timestamps (``_ts`` / ``_from_ts``),
so a database file either package wrote reads the same in the other.  It
has no delta-tail protocol (``base.delta_tail_supported`` is False): a
follower on it retrains every tick, as in the JAX package.

The reference ships a complete JDBC alternative backend (SURVEY.md §2:
`data/.../storage/jdbc/JDBC*` via scalikejdbc against PostgreSQL/MySQL):
events, all metadata repositories, and model blobs in one relational store.
This module is the same full surface on the stdlib ``sqlite3`` module — a
real SQL schema with indexed predicate pushdown for event scans (the
reference's JDBCPEvents builds WHERE clauses the same way), not a JSON-doc
dump.  A ``path`` of ``:memory:`` gives an ephemeral store for tests.

Concurrency: one shared connection guarded by a re-entrant lock (sqlite is
in-process; the REST layer above provides request concurrency), WAL mode for
file databases so readers don't block the ingest path.
"""

from __future__ import annotations

import datetime as _dt
import json
import sqlite3
import threading
import uuid
from typing import Iterator, List, Optional, Sequence

from predictionio_tpu_torch.events.event import DataMap, Event
from predictionio_tpu_torch.storage import base
from predictionio_tpu_torch.storage.base import (
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EngineManifest,
    EvaluationInstance,
)

_EPOCH = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)


def _ts(t: _dt.datetime) -> float:
    if t.tzinfo is None:
        t = t.replace(tzinfo=_dt.timezone.utc)
    return (t - _EPOCH).total_seconds()


def _from_ts(s: float) -> _dt.datetime:
    return _EPOCH + _dt.timedelta(seconds=s)


class SQLClient:
    """Shared sqlite3 connection + schema management for one database."""

    def __init__(self, path: str = ":memory:"):
        self.path = path
        self.conn = sqlite3.connect(path, check_same_thread=False)
        self.lock = threading.RLock()
        self._known_tables: set = set()   # positive existence cache (ingest hot path)
        with self.lock:
            if path != ":memory:":
                self.conn.execute("PRAGMA journal_mode=WAL")
            self.conn.execute("PRAGMA foreign_keys=ON")
            self._create_schema()

    def _create_schema(self) -> None:
        c = self.conn
        c.executescript(
            """
            CREATE TABLE IF NOT EXISTS apps (
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                name TEXT UNIQUE NOT NULL,
                description TEXT NOT NULL DEFAULT ''
            );
            CREATE TABLE IF NOT EXISTS access_keys (
                key TEXT PRIMARY KEY,
                app_id INTEGER NOT NULL,
                events TEXT NOT NULL DEFAULT '[]'
            );
            CREATE TABLE IF NOT EXISTS channels (
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                name TEXT NOT NULL,
                app_id INTEGER NOT NULL,
                UNIQUE(app_id, name)
            );
            CREATE TABLE IF NOT EXISTS engine_instances (
                id TEXT PRIMARY KEY,
                status TEXT NOT NULL,
                start_time REAL NOT NULL,
                doc TEXT NOT NULL
            );
            CREATE TABLE IF NOT EXISTS evaluation_instances (
                id TEXT PRIMARY KEY,
                status TEXT NOT NULL,
                doc TEXT NOT NULL
            );
            CREATE TABLE IF NOT EXISTS models (
                id TEXT PRIMARY KEY,
                blob BLOB NOT NULL
            );
            CREATE TABLE IF NOT EXISTS engine_manifests (
                id TEXT NOT NULL,
                version TEXT NOT NULL,
                doc TEXT NOT NULL,
                PRIMARY KEY (id, version)
            );
            """
        )
        c.commit()

    # -- per-(app, channel) event tables (reference: JDBCUtils.eventTableName)

    @staticmethod
    def event_table(app_id: int, channel_id: Optional[int]) -> str:
        return f"events_{app_id}" + (f"_{channel_id}" if channel_id else "")

    def init_event_table(self, app_id: int, channel_id: Optional[int]) -> None:
        t = self.event_table(app_id, channel_id)
        with self.lock:
            self._known_tables.add(t)
            self.conn.executescript(
                f"""
                CREATE TABLE IF NOT EXISTS {t} (
                    id TEXT PRIMARY KEY,
                    event TEXT NOT NULL,
                    entity_type TEXT NOT NULL,
                    entity_id TEXT NOT NULL,
                    target_entity_type TEXT,
                    target_entity_id TEXT,
                    properties TEXT NOT NULL,
                    event_time REAL NOT NULL,
                    tags TEXT NOT NULL DEFAULT '[]',
                    pr_id TEXT,
                    creation_time REAL NOT NULL
                );
                CREATE INDEX IF NOT EXISTS {t}_time ON {t}(event_time);
                CREATE INDEX IF NOT EXISTS {t}_entity ON {t}(entity_type, entity_id);
                CREATE INDEX IF NOT EXISTS {t}_event ON {t}(event);
                """
            )
            self.conn.commit()

    def has_event_table(self, app_id: int, channel_id: Optional[int]) -> bool:
        t = self.event_table(app_id, channel_id)
        with self.lock:
            if t in self._known_tables:
                return True
            row = self.conn.execute(
                "SELECT 1 FROM sqlite_master WHERE type='table' AND name=?", (t,)
            ).fetchone()
            if row is not None:
                self._known_tables.add(t)
            return row is not None


class SQLApps(base.Apps):
    def __init__(self, client: SQLClient):
        self.c = client

    def insert(self, app: App) -> Optional[int]:
        with self.c.lock:
            try:
                if app.id and app.id > 0:
                    self.c.conn.execute(
                        "INSERT INTO apps (id, name, description) VALUES (?,?,?)",
                        (app.id, app.name, app.description),
                    )
                    new_id = app.id
                else:
                    cur = self.c.conn.execute(
                        "INSERT INTO apps (name, description) VALUES (?,?)",
                        (app.name, app.description),
                    )
                    new_id = int(cur.lastrowid)
                self.c.conn.commit()
                return new_id
            except sqlite3.IntegrityError:
                # roll back the implicit BEGIN or the shared connection stays
                # inside an open read transaction pinning a stale WAL snapshot
                self.c.conn.rollback()
                return None

    def get(self, app_id: int) -> Optional[App]:
        with self.c.lock:
            row = self.c.conn.execute(
                "SELECT id, name, description FROM apps WHERE id=?", (app_id,)
            ).fetchone()
        return App(*row) if row else None

    def get_by_name(self, name: str) -> Optional[App]:
        with self.c.lock:
            row = self.c.conn.execute(
                "SELECT id, name, description FROM apps WHERE name=?", (name,)
            ).fetchone()
        return App(*row) if row else None

    def get_all(self) -> List[App]:
        with self.c.lock:
            rows = self.c.conn.execute(
                "SELECT id, name, description FROM apps ORDER BY id"
            ).fetchall()
        return [App(*r) for r in rows]

    def update(self, app: App) -> bool:
        with self.c.lock:
            cur = self.c.conn.execute(
                "UPDATE apps SET name=?, description=? WHERE id=?",
                (app.name, app.description, app.id),
            )
            self.c.conn.commit()
        return cur.rowcount > 0

    def delete(self, app_id: int) -> bool:
        with self.c.lock:
            cur = self.c.conn.execute("DELETE FROM apps WHERE id=?", (app_id,))
            self.c.conn.commit()
        return cur.rowcount > 0


class SQLAccessKeys(base.AccessKeys):
    def __init__(self, client: SQLClient):
        self.c = client

    def insert(self, access_key: AccessKey) -> Optional[str]:
        key = access_key.key or AccessKey.generate()
        with self.c.lock:
            try:
                self.c.conn.execute(
                    "INSERT INTO access_keys (key, app_id, events) VALUES (?,?,?)",
                    (key, access_key.app_id, json.dumps(list(access_key.events))),
                )
                self.c.conn.commit()
                return key
            except sqlite3.IntegrityError:
                # roll back the implicit BEGIN or the shared connection stays
                # inside an open read transaction pinning a stale WAL snapshot
                self.c.conn.rollback()
                return None

    def get(self, key: str) -> Optional[AccessKey]:
        with self.c.lock:
            row = self.c.conn.execute(
                "SELECT key, app_id, events FROM access_keys WHERE key=?", (key,)
            ).fetchone()
        return AccessKey(row[0], row[1], json.loads(row[2])) if row else None

    def get_by_app_id(self, app_id: int) -> List[AccessKey]:
        with self.c.lock:
            rows = self.c.conn.execute(
                "SELECT key, app_id, events FROM access_keys WHERE app_id=?", (app_id,)
            ).fetchall()
        return [AccessKey(r[0], r[1], json.loads(r[2])) for r in rows]

    def delete(self, key: str) -> bool:
        with self.c.lock:
            cur = self.c.conn.execute("DELETE FROM access_keys WHERE key=?", (key,))
            self.c.conn.commit()
        return cur.rowcount > 0


class SQLChannels(base.Channels):
    def __init__(self, client: SQLClient):
        self.c = client

    def insert(self, channel: Channel) -> Optional[int]:
        with self.c.lock:
            try:
                if channel.id and channel.id > 0:
                    self.c.conn.execute(
                        "INSERT INTO channels (id, name, app_id) VALUES (?,?,?)",
                        (channel.id, channel.name, channel.app_id),
                    )
                    new_id = channel.id
                else:
                    cur = self.c.conn.execute(
                        "INSERT INTO channels (name, app_id) VALUES (?,?)",
                        (channel.name, channel.app_id),
                    )
                    new_id = int(cur.lastrowid)
                self.c.conn.commit()
                return new_id
            except sqlite3.IntegrityError:
                # roll back the implicit BEGIN or the shared connection stays
                # inside an open read transaction pinning a stale WAL snapshot
                self.c.conn.rollback()
                return None

    def get(self, channel_id: int) -> Optional[Channel]:
        with self.c.lock:
            row = self.c.conn.execute(
                "SELECT id, name, app_id FROM channels WHERE id=?", (channel_id,)
            ).fetchone()
        return Channel(*row) if row else None

    def get_by_app_id(self, app_id: int) -> List[Channel]:
        with self.c.lock:
            rows = self.c.conn.execute(
                "SELECT id, name, app_id FROM channels WHERE app_id=? ORDER BY id",
                (app_id,),
            ).fetchall()
        return [Channel(*r) for r in rows]

    def delete(self, channel_id: int) -> bool:
        with self.c.lock:
            cur = self.c.conn.execute("DELETE FROM channels WHERE id=?", (channel_id,))
            self.c.conn.commit()
        return cur.rowcount > 0


def _ei_doc(i: EngineInstance) -> str:
    return json.dumps(
        {
            "end_time": _ts(i.end_time) if i.end_time else None,
            "engine_id": i.engine_id,
            "engine_version": i.engine_version,
            "engine_variant": i.engine_variant,
            "engine_factory": i.engine_factory,
            "env": i.env,
            "spark_conf": i.spark_conf,
            "data_source_params": i.data_source_params,
            "preparator_params": i.preparator_params,
            "algorithms_params": i.algorithms_params,
            "serving_params": i.serving_params,
        }
    )


def _ei_from_row(iid: str, status: str, start: float, doc: str) -> EngineInstance:
    d = json.loads(doc)
    return EngineInstance(
        id=iid,
        status=status,
        start_time=_from_ts(start),
        end_time=_from_ts(d["end_time"]) if d.get("end_time") is not None else None,
        engine_id=d["engine_id"],
        engine_version=d["engine_version"],
        engine_variant=d["engine_variant"],
        engine_factory=d["engine_factory"],
        env=d.get("env", {}),
        spark_conf=d.get("spark_conf", {}),
        data_source_params=d.get("data_source_params", "{}"),
        preparator_params=d.get("preparator_params", "{}"),
        algorithms_params=d.get("algorithms_params", "[]"),
        serving_params=d.get("serving_params", "{}"),
    )


class SQLEngineInstances(base.EngineInstances):
    def __init__(self, client: SQLClient):
        self.c = client

    def insert(self, instance: EngineInstance) -> str:
        if not instance.id:
            instance.id = uuid.uuid4().hex
        with self.c.lock:
            self.c.conn.execute(
                "INSERT OR REPLACE INTO engine_instances (id, status, start_time, doc)"
                " VALUES (?,?,?,?)",
                (instance.id, instance.status, _ts(instance.start_time), _ei_doc(instance)),
            )
            self.c.conn.commit()
        return instance.id

    def get(self, instance_id: str) -> Optional[EngineInstance]:
        with self.c.lock:
            row = self.c.conn.execute(
                "SELECT id, status, start_time, doc FROM engine_instances WHERE id=?",
                (instance_id,),
            ).fetchone()
        return _ei_from_row(*row) if row else None

    def update(self, instance: EngineInstance) -> bool:
        with self.c.lock:
            cur = self.c.conn.execute(
                "UPDATE engine_instances SET status=?, start_time=?, doc=? WHERE id=?",
                (instance.status, _ts(instance.start_time), _ei_doc(instance), instance.id),
            )
            self.c.conn.commit()
        return cur.rowcount > 0

    def get_all(self) -> List[EngineInstance]:
        with self.c.lock:
            rows = self.c.conn.execute(
                "SELECT id, status, start_time, doc FROM engine_instances"
                " ORDER BY start_time"
            ).fetchall()
        return [_ei_from_row(*r) for r in rows]

    def delete(self, instance_id: str) -> bool:
        with self.c.lock:
            cur = self.c.conn.execute(
                "DELETE FROM engine_instances WHERE id=?", (instance_id,)
            )
            self.c.conn.commit()
        return cur.rowcount > 0


class SQLEngineManifests(base.EngineManifests):
    def __init__(self, client: SQLClient):
        self.c = client

    def insert(self, manifest: EngineManifest) -> None:
        doc = json.dumps(
            {
                "name": manifest.name,
                "description": manifest.description,
                "files": manifest.files,
                "engine_factory": manifest.engine_factory,
            }
        )
        with self.c.lock:
            self.c.conn.execute(
                "INSERT OR REPLACE INTO engine_manifests (id, version, doc) VALUES (?,?,?)",
                (manifest.id, manifest.version, doc),
            )
            self.c.conn.commit()

    @staticmethod
    def _from_row(mid: str, version: str, doc: str) -> EngineManifest:
        d = json.loads(doc)
        return EngineManifest(
            id=mid, version=version, name=d.get("name", mid),
            description=d.get("description", ""), files=d.get("files", []),
            engine_factory=d.get("engine_factory", ""),
        )

    def get(self, manifest_id: str, version: str) -> Optional[EngineManifest]:
        with self.c.lock:
            row = self.c.conn.execute(
                "SELECT id, version, doc FROM engine_manifests WHERE id=? AND version=?",
                (manifest_id, version),
            ).fetchone()
        return self._from_row(*row) if row else None

    def get_all(self) -> List[EngineManifest]:
        with self.c.lock:
            rows = self.c.conn.execute(
                "SELECT id, version, doc FROM engine_manifests"
            ).fetchall()
        return [self._from_row(*r) for r in rows]

    def delete(self, manifest_id: str, version: str) -> bool:
        with self.c.lock:
            cur = self.c.conn.execute(
                "DELETE FROM engine_manifests WHERE id=? AND version=?",
                (manifest_id, version),
            )
            self.c.conn.commit()
        return cur.rowcount > 0


def _evi_doc(i: EvaluationInstance) -> str:
    return json.dumps(
        {
            "start_time": _ts(i.start_time),
            "end_time": _ts(i.end_time) if i.end_time else None,
            "evaluation_class": i.evaluation_class,
            "engine_params_generator_class": i.engine_params_generator_class,
            "env": i.env,
            "evaluator_results": i.evaluator_results,
            "evaluator_results_html": i.evaluator_results_html,
            "evaluator_results_json": i.evaluator_results_json,
        }
    )


class SQLEvaluationInstances(base.EvaluationInstances):
    def __init__(self, client: SQLClient):
        self.c = client

    def insert(self, instance: EvaluationInstance) -> str:
        if not instance.id:
            instance.id = uuid.uuid4().hex
        with self.c.lock:
            self.c.conn.execute(
                "INSERT OR REPLACE INTO evaluation_instances (id, status, doc)"
                " VALUES (?,?,?)",
                (instance.id, instance.status, _evi_doc(instance)),
            )
            self.c.conn.commit()
        return instance.id

    def _from_row(self, iid: str, status: str, doc: str) -> EvaluationInstance:
        d = json.loads(doc)
        return EvaluationInstance(
            id=iid,
            status=status,
            start_time=_from_ts(d["start_time"]),
            end_time=_from_ts(d["end_time"]) if d.get("end_time") is not None else None,
            evaluation_class=d["evaluation_class"],
            engine_params_generator_class=d.get("engine_params_generator_class", ""),
            env=d.get("env", {}),
            evaluator_results=d.get("evaluator_results", ""),
            evaluator_results_html=d.get("evaluator_results_html", ""),
            evaluator_results_json=d.get("evaluator_results_json", ""),
        )

    def get(self, instance_id: str) -> Optional[EvaluationInstance]:
        with self.c.lock:
            row = self.c.conn.execute(
                "SELECT id, status, doc FROM evaluation_instances WHERE id=?",
                (instance_id,),
            ).fetchone()
        return self._from_row(*row) if row else None

    def update(self, instance: EvaluationInstance) -> bool:
        with self.c.lock:
            cur = self.c.conn.execute(
                "UPDATE evaluation_instances SET status=?, doc=? WHERE id=?",
                (instance.status, _evi_doc(instance), instance.id),
            )
            self.c.conn.commit()
        return cur.rowcount > 0

    def get_completed(self) -> List[EvaluationInstance]:
        with self.c.lock:
            rows = self.c.conn.execute(
                "SELECT id, status, doc FROM evaluation_instances WHERE status='EVALCOMPLETED'"
            ).fetchall()
        return [self._from_row(*r) for r in rows]


class SQLModels(base.Models):
    def __init__(self, client: SQLClient):
        self.c = client

    def insert(self, instance_id: str, blob: bytes) -> None:
        with self.c.lock:
            self.c.conn.execute(
                "INSERT OR REPLACE INTO models (id, blob) VALUES (?,?)",
                (instance_id, sqlite3.Binary(blob)),
            )
            self.c.conn.commit()

    def get(self, instance_id: str) -> Optional[bytes]:
        with self.c.lock:
            row = self.c.conn.execute(
                "SELECT blob FROM models WHERE id=?", (instance_id,)
            ).fetchone()
        return bytes(row[0]) if row else None

    def delete(self, instance_id: str) -> bool:
        with self.c.lock:
            cur = self.c.conn.execute("DELETE FROM models WHERE id=?", (instance_id,))
            self.c.conn.commit()
        return cur.rowcount > 0


_EVENT_COLS = (
    "id, event, entity_type, entity_id, target_entity_type, target_entity_id,"
    " properties, event_time, tags, pr_id, creation_time"
)


def _event_from_row(r: tuple) -> Event:
    return Event(
        event=r[1],
        entity_type=r[2],
        entity_id=r[3],
        target_entity_type=r[4],
        target_entity_id=r[5],
        properties=DataMap(json.loads(r[6])),
        event_time=_from_ts(r[7]),
        tags=tuple(json.loads(r[8])),
        pr_id=r[9],
        event_id=r[0],
        creation_time=_from_ts(r[10]),
    )


class SQLEvents(base.LEvents, base.PEvents):
    """Event store with SQL predicate pushdown (reference: JDBCLEvents +
    JDBCPEvents; the WHERE construction mirrors JDBCPEvents.find)."""

    def __init__(self, client: SQLClient):
        self.c = client

    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        self.c.init_event_table(app_id, channel_id)
        return True

    def compact(self, app_id: int, channel_id: Optional[int] = None,
                before=None) -> dict:
        """Deletes are in-place in SQL, so compaction is the TTL trim plus
        a VACUUM to reclaim pages (interface parity with segment backends)."""
        from predictionio_tpu_torch.events.event import parse_time

        if not self.c.has_event_table(app_id, channel_id):
            return {"kept": 0, "expired": 0, "segments": 0}
        t = self.c.event_table(app_id, channel_id)
        with self.c.lock:
            expired = 0
            if before is not None:
                before = parse_time(before)
                cur = self.c.conn.execute(
                    f"DELETE FROM {t} WHERE event_time < ?", (_ts(before),))
                expired = cur.rowcount
            kept = self.c.conn.execute(f"SELECT COUNT(*) FROM {t}").fetchone()[0]
            self.c.conn.commit()
            # VACUUM under the shared-connection lock: a concurrent writer's
            # open transaction would otherwise make it raise
            self.c.conn.execute("VACUUM")
        return {"kept": kept, "expired": expired, "segments": 0}

    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        if not self.c.has_event_table(app_id, channel_id):
            return False
        t = self.c.event_table(app_id, channel_id)
        with self.c.lock:
            self.c.conn.execute(f"DROP TABLE IF EXISTS {t}")
            self.c.conn.commit()
            self.c._known_tables.discard(t)
        return True

    def insert(self, event: Event, app_id: int, channel_id: Optional[int] = None) -> str:
        if not self.c.has_event_table(app_id, channel_id):
            self.c.init_event_table(app_id, channel_id)
        t = self.c.event_table(app_id, channel_id)
        with self.c.lock:
            self.c.conn.execute(
                f"INSERT OR REPLACE INTO {t} ({_EVENT_COLS}) VALUES (?,?,?,?,?,?,?,?,?,?,?)",
                (
                    event.event_id, event.event, event.entity_type, event.entity_id,
                    event.target_entity_type, event.target_entity_id,
                    json.dumps(dict(event.properties)), _ts(event.event_time),
                    json.dumps(list(event.tags)), event.pr_id, _ts(event.creation_time),
                ),
            )
            self.c.conn.commit()
        return event.event_id

    def insert_batch(
        self, events: Sequence[Event], app_id: int, channel_id: Optional[int] = None
    ) -> List[str]:
        if not self.c.has_event_table(app_id, channel_id):
            self.c.init_event_table(app_id, channel_id)
        t = self.c.event_table(app_id, channel_id)
        rows = [
            (
                e.event_id, e.event, e.entity_type, e.entity_id,
                e.target_entity_type, e.target_entity_id,
                json.dumps(dict(e.properties)), _ts(e.event_time),
                json.dumps(list(e.tags)), e.pr_id, _ts(e.creation_time),
            )
            for e in events
        ]
        with self.c.lock:
            self.c.conn.executemany(
                f"INSERT OR REPLACE INTO {t} ({_EVENT_COLS}) VALUES (?,?,?,?,?,?,?,?,?,?,?)",
                rows,
            )
            self.c.conn.commit()
        return [e.event_id for e in events]

    def get(self, event_id: str, app_id: int, channel_id: Optional[int] = None) -> Optional[Event]:
        if not self.c.has_event_table(app_id, channel_id):
            return None
        t = self.c.event_table(app_id, channel_id)
        with self.c.lock:
            row = self.c.conn.execute(
                f"SELECT {_EVENT_COLS} FROM {t} WHERE id=?", (event_id,)
            ).fetchone()
        return _event_from_row(row) if row else None

    def delete(self, event_id: str, app_id: int, channel_id: Optional[int] = None) -> bool:
        if not self.c.has_event_table(app_id, channel_id):
            return False
        t = self.c.event_table(app_id, channel_id)
        with self.c.lock:
            cur = self.c.conn.execute(f"DELETE FROM {t} WHERE id=?", (event_id,))
            self.c.conn.commit()
        return cur.rowcount > 0

    def _where(
        self,
        start_time=None, until_time=None, entity_type=None, entity_id=None,
        event_names=None, target_entity_type=None, target_entity_id=None,
    ):
        clauses, params = [], []
        if start_time is not None:
            clauses.append("event_time >= ?")
            params.append(_ts(start_time))
        if until_time is not None:
            clauses.append("event_time < ?")
            params.append(_ts(until_time))
        if entity_type is not None:
            clauses.append("entity_type = ?")
            params.append(entity_type)
        if entity_id is not None:
            clauses.append("entity_id = ?")
            params.append(entity_id)
        if event_names is not None:
            names = list(event_names)
            clauses.append(f"event IN ({','.join('?' * len(names))})" if names else "0")
            params.extend(names)
        if target_entity_type is not None:
            clauses.append("target_entity_type = ?")
            params.append(target_entity_type)
        if target_entity_id is not None:
            clauses.append("target_entity_id = ?")
            params.append(target_entity_id)
        return (" WHERE " + " AND ".join(clauses) if clauses else ""), params

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
        if not self.c.has_event_table(app_id, channel_id):
            return iter(())
        t = self.c.event_table(app_id, channel_id)
        where, params = self._where(
            start_time, until_time, entity_type, entity_id,
            event_names, target_entity_type, target_entity_id,
        )
        order = " ORDER BY event_time" + (" DESC" if reversed_order else "")
        lim = f" LIMIT {int(limit)}" if limit is not None and limit >= 0 else ""
        sql = f"SELECT {_EVENT_COLS} FROM {t}{where}{order}{lim}"
        with self.c.lock:
            rows = self.c.conn.execute(sql, params).fetchall()
        return (_event_from_row(r) for r in rows)

    def scan(self, app_id: int, channel_id: Optional[int] = None, **filters) -> Iterator[Event]:
        """Unordered streaming scan for training reads — no ORDER BY, rows
        fetched incrementally from a dedicated cursor."""
        if not self.c.has_event_table(app_id, channel_id):
            return iter(())
        t = self.c.event_table(app_id, channel_id)
        where, params = self._where(**filters)
        sql = f"SELECT {_EVENT_COLS} FROM {t}{where}"

        def gen():
            with self.c.lock:
                cur = self.c.conn.execute(sql, params)
            while True:
                with self.c.lock:
                    rows = cur.fetchmany(8192)
                if not rows:
                    return
                for r in rows:
                    yield _event_from_row(r)

        return gen()


class SQLSource:
    """Storage-locator source: one sqlite database providing every repository."""

    def __init__(self, path: str = ":memory:"):
        client = SQLClient(path)
        self.client = client
        self.apps = SQLApps(client)
        self.access_keys = SQLAccessKeys(client)
        self.channels = SQLChannels(client)
        self.engine_instances = SQLEngineInstances(client)
        self.engine_manifests = SQLEngineManifests(client)
        self.evaluation_instances = SQLEvaluationInstances(client)
        self.models = SQLModels(client)
        self.events = SQLEvents(client)
