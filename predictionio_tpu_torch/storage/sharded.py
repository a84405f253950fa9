"""Sharded, replicated event store: scale-out past one node.

Counterpart of ``predictionio_tpu/storage/sharded.py``, with the same
on-disk layout, routing, replication protocol and reads, so a store that
either package wrote reads the same in the other.  The reference scales out
on pluggable storage (HBase / Elasticsearch: entity-keyed regions,
replicated event data); this backend gives that shape on top of the
localfs segment files:

- **Sharding**: entities are hashed (CRC32 of entityType + entityId) over N
  shards; each shard is a full ``FSEvents`` store with its own tagged
  group-commit segments, tombstones and columnar snapshot.  The serving
  read (``find`` by entity) touches one shard; bulk scans fan out over a
  thread pool (``PIO_SCAN_WORKERS``) and merge (``BatchMerger``).
- **Replication**: with ``replicas=2`` each shard has two node directories
  (``a``/``b``).  Writes go to the primary; a follower thread tails the
  primary's segments byte for byte into the replica and acknowledges only
  complete, durable lines (``repl/acked.json``, fsynced).  The group-commit
  leader waits for that acknowledgement (semi-sync, localfs's
  ``_post_commit`` hook), so an acknowledged event is on both nodes, and a
  SIGKILLed primary or a removed directory cannot lose one.
- **Failover**: when a primary turns unusable (an I/O error, a missing
  directory), the shard promotes: ``topology.json`` flips the primary and
  bumps the epoch (fsynced), writers on the old epoch are fenced at their
  next commit, and the unacknowledged tail of the old node is healed away
  when it rejoins as the replica (truncated back to the acknowledged
  offsets seeded at promotion).  Ingest and scans retry once on the new
  primary.

Layout::

    <root>/meta, models/           shared metadata (localfs, unsharded)
    <root>/shard_00/topology.json  {"primary": "a"|"b", "epoch": N}
    <root>/shard_00/repl.lock      flock: which process runs the follower
    <root>/shard_00/a/events/...   a full FSEvents tree per node
    <root>/shard_00/b/events/...
    <root>/shard_00/b/repl/acked.json  replicated-offset watermark (+ head
                                       fingerprints), on the REPLICA

Configured through the locator: ``PIO_STORAGE_SOURCES_<NAME>_TYPE=sharded``
with ``_SHARDS=N`` and ``_REPLICAS=1|2``.  Knobs: ``PIO_STORE_ACK_REPLICAS``
(0 = asynchronous replication: acknowledgements do not wait),
``PIO_STORE_ACK_TIMEOUT_S``, ``PIO_STORE_REPL_POLL_S``, ``PIO_SCAN_WORKERS``.

Delta protocol: ``snapshot_scan`` / ``scan_tail_from`` /
``scan_events_up_to`` namespace the per-segment watermarks as
``"<shard>|<segment>"``, so the staged retrain cache and the follow-trainer
run unchanged on a sharded store; a watermark without the namespace (a
localfs one) reads as a full restage.

Every thread here (the scan pool, the followers) works on the host: it
parses and encodes numpy columns, and nothing in this module touches a
device.
"""

from __future__ import annotations

import datetime as _dt
import heapq
import json
import logging
import os
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from itertools import islice
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Sequence

from predictionio_tpu_torch.events.event import Event
from predictionio_tpu_torch.obs.metrics import get_registry
from predictionio_tpu_torch.storage import base, localfs
from predictionio_tpu_torch.storage.snapshot import (
    _fsync_write,
    _last_newline_boundary,
)
from predictionio_tpu_torch.store.columnar import BatchMerger, EventBatch

log = logging.getLogger("pio.sharded")

TOPOLOGY = "topology.json"
REPL_LOCK = "repl.lock"
ACKED = "acked.json"
NODES = ("a", "b")

_REG = get_registry()
_M_SHARD_EVENTS = _REG.counter(
    "pio_store_shard_events_total",
    "Events acknowledged into the sharded event store, by shard")
_M_REPL_LAG = _REG.gauge(
    "pio_store_replica_lag_events",
    "Complete event lines on a shard primary not yet acknowledged by its "
    "replica, by shard (0 = fully caught up)")
_M_REPL_BYTES = _REG.counter(
    "pio_store_replicated_bytes_total",
    "Bytes copied from shard primaries to their replicas, by shard")
_M_REPL_HEALS = _REG.counter(
    "pio_store_replica_heals_total",
    "Replica tails truncated back to the acknowledged offset (torn or "
    "un-acked bytes healed away), by shard")
_M_PROMOTIONS = _REG.counter(
    "pio_store_promotions_total",
    "Shard failovers — replica promoted to primary, by shard and reason")
_M_SHARDS = _REG.gauge(
    "pio_store_shards", "Configured shard count of the sharded event store")
_M_SCAN_SHARD_S = _REG.gauge(
    "pio_store_scan_shard_duration_seconds",
    "Per-shard scan+parse wall seconds of the last cross-shard merged "
    "scan, by shard — the scan pipeline's straggler view")
_M_SCAN_WORKERS = _REG.gauge(
    "pio_store_scan_workers",
    "Thread-pool width used by the last cross-shard merged scan "
    "(1 = the serial legacy path, the parallel pipeline's parity oracle)")
_M_SCAN_RATE = _REG.gauge(
    "pio_store_scan_merged_events_per_sec",
    "Merged events/second over the last cross-shard merged cold scan "
    "(per-shard fan-out + k-way merge, wall clock)")


def shard_of(entity_type: str, entity_id: str, n: int) -> int:
    """Stable entity → shard routing (CRC32, process-independent — the
    reference's HBase rowkey-prefix partitioning analogue)."""
    if n <= 1:
        return 0
    key = f"{entity_type}\x00{entity_id}".encode("utf-8", "surrogatepass")
    return zlib.crc32(key) % n


def _ack_replicas() -> int:
    """PIO_STORE_ACK_REPLICAS: replicas that must acknowledge a group
    commit before its events are acked to clients (semi-sync).  0 = async
    replication — acks return on the primary write alone, trading the
    zero-acked-loss guarantee for latency."""
    try:
        return int(os.environ.get("PIO_STORE_ACK_REPLICAS", "1"))
    except ValueError:
        return 1


def _ack_timeout() -> float:
    try:
        return float(os.environ.get("PIO_STORE_ACK_TIMEOUT_S", "10"))
    except ValueError:
        return 10.0


def _poll_s() -> float:
    try:
        return float(os.environ.get("PIO_STORE_REPL_POLL_S", "0.05"))
    except ValueError:
        return 0.05


def _scan_workers(n_shards: int) -> int:
    """PIO_SCAN_WORKERS: thread-pool width for cross-shard merged scans
    (``snapshot_scan`` / ``scan_tail_from`` / ``scan_events_up_to`` and
    everything riding them — ``find_batches``, delta staging, the
    ``--follow`` bootstrap).  Default ≈ cores, capped at the shard
    count; ``1`` forces the serial legacy path (the parity oracle)."""
    try:
        w = int(os.environ.get("PIO_SCAN_WORKERS", "0") or "0")
    except ValueError:
        w = 0
    if w <= 0:
        w = os.cpu_count() or 1
    return max(1, min(w, n_shards))


class _Fenced(OSError):
    """A writer discovered at commit time that its node lost the primary
    role (epoch moved on) — the group is NACKed and NOT retried with a
    promotion (the topology already changed under us)."""


class _AckTimeout(OSError):
    """The semi-sync barrier expired: the REPLICA failed to acknowledge,
    not the primary.  The group NACKs but must never trigger a failover —
    promoting would install the node that is provably behind (and, when
    the replica's disk is the broken part, ping-pong the primary onto it
    at one ack-timeout per write)."""


class _NodeEvents(localfs.FSEvents):
    """One shard node's event store: a plain FSEvents whose group-commit
    leader runs the shard's replication barrier before acking."""

    def __init__(self, root: Path, writer_tag: Optional[str],
                 node: str, shard: "_Shard"):
        super().__init__(root, writer_tag=writer_tag)
        self._node_name = node
        self._node_root = Path(root)
        self._shard = shard

    def _commit_point(self, key: tuple, writer):
        # fstat, not tell(): segments are opened in text mode and the
        # write was flushed inside append(), so st_size is the exact
        # committed byte offset
        return (writer._path, os.fstat(writer._f.fileno()).st_size)

    def _post_commit(self, key: tuple, info) -> None:
        self._shard.after_commit(self._node_name, info[0], info[1])


class _ShardFollower:
    """Replication worker for one shard: tails the primary node's segment
    and tombstone files byte-for-byte into the replica node.

    Exactly one process replicates a shard at a time (flock on
    ``repl.lock``); ownership floats — every process's follower thread
    keeps trying the lock, so a SIGKILLed owner's role is picked up by any
    survivor.  Only complete lines are copied, and an offset is
    acknowledged (fsynced into ``repl/acked.json`` on the replica, with a
    head fingerprint against recreated files) only after the bytes are
    durably on the replica — the offset the semi-sync commit barrier
    waits on."""

    def __init__(self, shard: "_Shard"):
        self.shard = shard
        self.cond = threading.Condition()
        self._stop = False
        self._lockf = None
        self._owned = False
        self._acked: Dict[str, dict] = {}
        self._acked_node: Optional[str] = None
        self._dirty = False   # in-memory acked state not yet persisted
        # state as of the last durable _save: what the commit barrier
        # waits on (the docstring contract — an ack means the offset is
        # fsynced in repl/acked.json, not merely advanced in memory)
        self._saved: Dict[str, dict] = {}
        self._lag_cache: Optional[tuple] = None   # (monotonic, value)
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"pio-repl-shard{shard.index}")
        self._thread.start()

    # -- lifecycle -----------------------------------------------------------

    def kick(self) -> None:
        with self.cond:
            self.cond.notify_all()

    def stop(self) -> None:
        self._stop = True
        self.kick()
        self._thread.join(timeout=5)
        if self._lockf is not None:
            try:
                self._lockf.close()   # releases the flock
            except OSError:
                pass
            self._lockf = None
            self._owned = False

    def _try_own(self) -> bool:
        if self._owned:
            return True
        import fcntl

        lockf = None
        try:
            self.shard.root.mkdir(parents=True, exist_ok=True)
            lockf = open(self.shard.root / REPL_LOCK, "a")
            fcntl.flock(lockf.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            if lockf is not None:
                lockf.close()
            return False
        self._lockf = lockf
        self._owned = True
        return True

    def _run(self) -> None:
        while not self._stop:
            with self.cond:
                self.cond.wait(_poll_s())
            if self._stop:
                break
            try:
                if self._try_own():
                    self.sync()
            except Exception:
                log.warning("replica sync failed for shard %d",
                            self.shard.index, exc_info=True)

    # -- acked-offset state (lives on the replica node) ----------------------

    def _state_path(self, replica: str) -> Path:
        return self.shard.node_root(replica) / "repl" / ACKED

    @staticmethod
    def read_state(path: Path) -> Dict[str, dict]:
        try:
            doc = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError):
            return {}
        out: Dict[str, dict] = {}
        if isinstance(doc, dict):
            for rel, ent in doc.items():
                if isinstance(ent, dict) and "off" in ent:
                    out[str(rel)] = {"off": int(ent["off"]),
                                     "head": ent.get("head")}
        return out

    def _load(self, replica: str) -> None:
        if self._acked_node == replica:
            return
        self._acked = self.read_state(self._state_path(replica))
        self._acked_node = replica
        self._dirty = False   # any unsaved state belonged to the other node
        self._saved = dict(self._acked)

    def _save(self, replica: str) -> None:
        p = self._state_path(replica)
        p.parent.mkdir(parents=True, exist_ok=True)
        _fsync_write(p, json.dumps(self._acked, indent=1, sort_keys=True))
        self._saved = dict(self._acked)

    # -- the copy loop -------------------------------------------------------

    @staticmethod
    def _repl_files(node_root: Path) -> Iterator[Path]:
        evroot = node_root / "events"
        if not evroot.exists():
            return
        for chan in sorted(evroot.glob("app_*/*")):
            if not chan.is_dir():
                continue
            yield from sorted(chan.glob("seg-*.jsonl"))
            yield from sorted(chan.glob("tombstones*.txt"))

    @staticmethod
    def _fd_boundary(f, size: int) -> int:
        """_last_newline_boundary over an already-open handle (the held fd
        stays valid through a concurrent rename/unlink of the path)."""
        pos = size
        while pos > 0:
            step = min(64 * 1024, pos)
            f.seek(pos - step)
            chunk = f.read(step)
            nl = chunk.rfind(b"\n")
            if nl >= 0:
                return pos - step + nl + 1
            pos -= step
        return 0

    @staticmethod
    def _fd_head(f, consumed: int) -> Optional[Dict[str, int]]:
        """_segment_head over an already-open handle."""
        import zlib

        n = min(64, consumed)
        if n <= 0:
            return None
        f.seek(0)
        return {"n": n, "crc": zlib.crc32(f.read(n))}

    def _sync_one(self, f, rel: str, rroot: Path, shard_label: str) -> int:
        """Replicate one open primary file.  Every read goes through the
        held fd ``f``, so a mid-pass partition (the path renamed or
        unlinked underneath us) can neither masquerade as a recreated
        file nor feed us a different generation's bytes — the handle
        pins one file identity for the whole decision.  Returns
        (events copied, caught-up) — caught-up False means acked is
        still behind this file's boundary; mutations mark
        ``self._dirty``."""
        import zlib

        size = os.fstat(f.fileno()).st_size
        end = self._fd_boundary(f, size)
        ent = self._acked.get(rel) or {"off": 0, "head": None}
        acked = int(ent["off"])
        head = ent.get("head")
        if acked and head:
            f.seek(0)
            cur = f.read(int(head["n"]))
            if len(cur) < int(head["n"]) or zlib.crc32(cur) != head["crc"]:
                # the primary file was genuinely recreated under the same
                # name (data-delete + re-import): offsets into it are
                # meaningless — restart this file's replication
                acked = 0
                ent = {"off": 0, "head": None}
                self._dirty = True
        dst = rroot / rel
        try:
            rsize = dst.stat().st_size
        except OSError:
            rsize = 0
        if rsize > acked:
            # un-acked replica bytes (torn copy, or the healed tail of a
            # demoted primary): truncate back to what was acknowledged
            with open(dst, "rb+") as df:
                df.truncate(acked)
            _M_REPL_HEALS.inc(1, shard=shard_label)
            self._dirty = True
        elif rsize < acked:
            # replica lost acknowledged bytes (external tear): fall back
            # to its own last complete line and re-copy
            bnd = _last_newline_boundary(dst, rsize) if rsize else 0
            if bnd < rsize:
                with open(dst, "rb+") as df:
                    df.truncate(bnd)
                _M_REPL_HEALS.inc(1, shard=shard_label)
            acked = bnd
            ent = {"off": bnd, "head": self._fd_head(f, bnd)}
            self._dirty = True
        copied = 0
        if end > acked:
            f.seek(acked)
            data = f.read(end - acked)
            nl = data.rfind(b"\n")
            if nl >= 0:
                data = data[: nl + 1]
                dst.parent.mkdir(parents=True, exist_ok=True)
                with open(dst, "rb+" if dst.exists() else "wb") as df:
                    df.seek(acked)
                    df.write(data)
                    df.flush()
                    if localfs._fsync_policy() == "always":
                        os.fsync(df.fileno())
                copied = data.count(b"\n")
                acked += len(data)
                ent = {"off": acked, "head": self._fd_head(f, acked)}
                _M_REPL_BYTES.inc(len(data), shard=shard_label)
                self._dirty = True
        if ent["off"]:
            self._acked[rel] = ent
        else:
            self._acked.pop(rel, None)
        return copied, acked >= end

    def sync(self) -> int:
        """One primary → replica pass.  Returns events copied."""
        shard = self.shard
        topo = shard.topology()
        primary = topo["primary"]
        replica = "b" if primary == "a" else "a"
        proot = shard.node_root(primary)
        rroot = shard.node_root(replica)
        label = str(shard.index)
        if not proot.exists():
            # primary gone: nothing to tail.  Promotion (not this loop)
            # decides what happens next; never mirror-delete on this path.
            return 0
        self._load(replica)
        copied_events = 0
        caught_up = True
        seen: set = set()
        for src in self._repl_files(proot):
            rel = str(src.relative_to(proot))
            try:
                f = open(src, "rb")
            except OSError:
                # vanished mid-pass (partition / promotion in flight):
                # skip — never touch the replica on evidence we can no
                # longer read.  NOT marked seen, so no mirror-delete.
                caught_up = False
                continue
            seen.add(rel)
            try:
                with f:
                    copied, ok = self._sync_one(f, rel, rroot, label)
                    copied_events += copied
                    caught_up &= ok
            except OSError:
                # one file failing (ENOSPC, dst perms, mid-write yank)
                # must not starve the rest of the pass — or the _save
                caught_up = False
                log.warning("replica sync of %s failed for shard %d",
                            rel, shard.index, exc_info=True)
        # mirror deletions of files we replicated, but ONLY when the
        # channel directory itself is still live on the primary
        # (compaction / tombstone rewrite) — a yanked primary must never
        # cascade deletes into the replica it is about to fail over to
        for rel in [r for r in self._acked if r not in seen]:
            src = proot / rel
            if not src.exists() and src.parent.exists():
                (rroot / rel).unlink(missing_ok=True)
                del self._acked[rel]
                self._dirty = True
        if self._dirty:
            # _dirty survives an aborted earlier pass: the in-memory state
            # may be AHEAD of acked.json (bytes copied, save missed) and a
            # no-op pass must still persist it, or lag_events read from
            # disk reports phantom lag forever
            self._save(replica)
            self._dirty = False
        with self.cond:
            self.cond.notify_all()
        # a clean pass that left every file at its boundary IS lag 0 —
        # don't pay a second full file walk every idle 50 ms poll
        lag = (0 if caught_up
               else self._pending_events(proot, self._acked))
        _M_REPL_LAG.set(lag, shard=label)
        self._lag_cache = (time.monotonic(), lag)
        return copied_events

    def _pending_events(self, proot: Path, state: Dict[str, dict]) -> int:
        lag = 0
        for src in self._repl_files(proot):
            rel = str(src.relative_to(proot))
            try:
                f = open(src, "rb")
            except OSError:
                continue     # vanished mid-walk
            with f:
                try:
                    size = os.fstat(f.fileno()).st_size
                    end = self._fd_boundary(f, size)
                    acked = int((state.get(rel) or {"off": 0})["off"])
                    if end > acked:
                        f.seek(acked)
                        lag += f.read(end - acked).count(b"\n")
                except OSError:
                    continue
        return lag

    def lag_events(self) -> int:
        """Complete primary lines not yet acknowledged by the replica —
        readable from any process (non-owners read the acked file).
        Never mutates ``self._acked``: the owner's sync thread may be
        mid-pass in it concurrently.  Walking every segment per call is
        O(segments) I/O, so results are cached briefly — /stats.json
        scrapes and tight drill polls reuse the sync loop's own figure
        instead of re-opening every file."""
        cached = self._lag_cache
        if cached is not None and time.monotonic() - cached[0] < 0.2:
            return cached[1]
        shard = self.shard
        topo = shard.topology()
        primary = topo["primary"]
        replica = "b" if primary == "a" else "a"
        proot = shard.node_root(primary)
        if not proot.exists():
            return 0
        if self._owned and self._acked_node == replica:
            state = self._acked
        else:
            state = self.read_state(self._state_path(replica))
        lag = self._pending_events(proot, state)
        self._lag_cache = (time.monotonic(), lag)
        return lag

    def wait_acked(self, rel: str, offset: int, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        while True:
            if self._owned:
                # _saved, not _acked: an ack promises the offset is
                # durable in repl/acked.json, and the in-memory dict
                # runs ahead of the end-of-pass save
                acked = self._saved if self._acked_node else {}
            else:
                topo = self.shard.topology()
                replica = "b" if topo["primary"] == "a" else "a"
                acked = self.read_state(self._state_path(replica))
            if int((acked.get(rel) or {"off": 0})["off"]) >= offset:
                return
            if time.monotonic() > deadline:
                raise _AckTimeout(
                    f"shard {self.shard.index}: replica did not acknowledge "
                    f"{rel}@{offset} within {timeout}s — events NACKed "
                    "(semi-sync barrier; set PIO_STORE_ACK_REPLICAS=0 for "
                    "async replication)")
            with self.cond:
                self.cond.wait(0.02)


class _Shard:
    """One hash partition: node directories, topology, follower."""

    def __init__(self, root: Path, index: int, replicas: int,
                 writer_tag: Optional[str]):
        self.root = Path(root)
        self.index = index
        self.replicas = replicas
        self._writer_tag = writer_tag
        self._lock = threading.RLock()
        self._nodes: Dict[str, _NodeEvents] = {}
        self._topo_cache: Optional[tuple] = None
        self.follower = _ShardFollower(self) if replicas >= 2 else None

    def close(self) -> None:
        if self.follower is not None:
            self.follower.stop()

    def node_root(self, name: str) -> Path:
        return self.root / name

    # -- topology ------------------------------------------------------------

    def topology(self, force: bool = False) -> dict:
        p = self.root / TOPOLOGY
        try:
            st = p.stat()
        except OSError:
            st = None
        with self._lock:
            if st is None:
                doc = {"primary": "a", "epoch": 0}
                self.root.mkdir(parents=True, exist_ok=True)
                try:
                    fd = os.open(p, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                    with os.fdopen(fd, "w") as f:
                        f.write(json.dumps(doc, indent=1, sort_keys=True))
                except (FileExistsError, OSError):
                    pass     # another process created it; next stat reads it
                self._topo_cache = None
                return doc
            if (not force and self._topo_cache is not None
                    and self._topo_cache[0] == st.st_mtime_ns):
                return self._topo_cache[1]
            try:
                doc = json.loads(p.read_text())
            except (OSError, json.JSONDecodeError):
                doc = {"primary": "a", "epoch": 0}
            if doc.get("primary") not in NODES:
                doc["primary"] = "a"
            doc["epoch"] = int(doc.get("epoch", 0))
            self._topo_cache = (st.st_mtime_ns, doc)
            return doc

    def active_name(self) -> str:
        return self.topology()["primary"]

    def events(self, name: Optional[str] = None) -> _NodeEvents:
        name = name or self.active_name()
        with self._lock:
            ev = self._nodes.get(name)
            if ev is None:
                ev = self._nodes[name] = _NodeEvents(
                    self.node_root(name), self._writer_tag, name, self)
            return ev

    def promote(self, reason: str,
                expect_epoch: Optional[int] = None) -> dict:
        """Flip primary ↔ replica (epoch bump, fsynced).  Seeds the new
        replica's acked state from the new primary's, so the demoted
        node's un-acked tail is healed away when it rejoins.

        ``expect_epoch`` fences the flip: when the force-read topology
        has already moved past the epoch the caller observed failing,
        another waiter promoted first and this call returns the current
        topology WITHOUT flipping — otherwise N threads unblocked by one
        NACKed group would ping-pong the primary (and the last flip can
        land it back on the node that just failed)."""
        if self.replicas < 2:
            raise OSError(
                f"shard {self.index}: cannot promote without a replica "
                "(replicas=1)")
        with self._lock:
            topo = self.topology(force=True)
            if expect_epoch is not None and topo["epoch"] != expect_epoch:
                return topo
            old = topo["primary"]
            new = "b" if old == "a" else "a"
            if not self.node_root(new).exists():
                raise OSError(
                    f"shard {self.index}: replica node {new!r} has no data "
                    "to promote")
            doc = {
                "primary": new,
                "epoch": topo["epoch"] + 1,
                "promotedAt": _dt.datetime.now(
                    _dt.timezone.utc).isoformat(),
                "reason": reason,
            }
            _fsync_write(self.root / TOPOLOGY,
                         json.dumps(doc, indent=1, sort_keys=True))
            self._topo_cache = None
            # seed <old>/repl/acked.json from <new>/repl/acked.json: every
            # byte past those offsets on the demoted node was never
            # acknowledged — the follower truncates it away on re-attach
            src = self.node_root(new) / "repl" / ACKED
            if self.node_root(old).exists():
                try:
                    dst = self.node_root(old) / "repl" / ACKED
                    dst.parent.mkdir(parents=True, exist_ok=True)
                    _fsync_write(
                        dst, src.read_text() if src.exists() else "{}")
                except OSError:
                    pass     # node is unreachable; heal happens on rejoin
            if self.follower is not None:
                with self.follower.cond:
                    self.follower._acked_node = None   # direction flipped
                self.follower.kick()
        _M_PROMOTIONS.inc(1, shard=str(self.index), reason=reason)
        log.warning("shard %d: promoted node %s (epoch %d, reason=%s)",
                    self.index, new, doc["epoch"], reason)
        return doc

    # -- commit barrier ------------------------------------------------------

    def after_commit(self, node: str, path: Path, offset: int) -> None:
        topo = self.topology()
        if topo["primary"] != node:
            raise _Fenced(
                f"shard {self.index}: writer on node {node!r} fenced — no "
                f"longer primary (epoch {topo['epoch']})")
        if self.replicas < 2 or self.follower is None:
            return
        self.follower.kick()
        if _ack_replicas() <= 0:
            return
        rel = str(Path(path).relative_to(self.node_root(node)))
        self.follower.wait_acked(rel, offset, _ack_timeout())

    def wait_replicated(self, node_events: _NodeEvents, path: Path,
                        offset: int) -> None:
        """Synchronous replication of an out-of-band append (tombstones)."""
        if self.replicas < 2 or self.follower is None or _ack_replicas() <= 0:
            return
        self.follower.kick()
        rel = str(Path(path).relative_to(node_events._node_root))
        self.follower.wait_acked(rel, offset, _ack_timeout())

    def lag_events(self) -> int:
        if self.follower is None:
            return 0
        try:
            return self.follower.lag_events()
        except OSError:
            return 0


class ShardedEvents(base.LEvents, base.PEvents):
    """Entity-hashed events across N shards, each optionally replicated.

    Read fan-out rules: entity-targeted ``find`` touches exactly one
    shard; everything else fans out and merges.  Every shard operation
    retries ONCE onto the promoted replica when the primary turns
    unusable mid-call (mid-scan partitions included — re-scanned events
    already yielded are deduped by event id)."""

    def __init__(self, root: Path, shards: int = 1, replicas: int = 1,
                 writer_tag: Optional[str] = None):
        self._root = Path(root)
        self.n_shards = max(1, int(shards))
        self.replicas = max(1, min(2, int(replicas)))
        tag = (writer_tag if writer_tag is not None
               else localfs._env_writer_tag())
        self._shards = [
            _Shard(self._root / f"shard_{k:02d}", k, self.replicas, tag)
            for k in range(self.n_shards)
        ]
        self._pool_lock = threading.Lock()
        self._scan_pool: Optional[ThreadPoolExecutor] = None
        self._scan_pool_size = 0
        _M_SHARDS.set(self.n_shards)

    def close(self) -> None:
        with self._pool_lock:
            if self._scan_pool is not None:
                self._scan_pool.shutdown(wait=False, cancel_futures=True)
                self._scan_pool = None
        for sh in self._shards:
            sh.close()

    def _pool(self, workers: int) -> ThreadPoolExecutor:
        """Persistent scan pool (resized when PIO_SCAN_WORKERS changes):
        the follow-trainer's delta scan runs every tick, so per-scan
        thread spawn/join would tax exactly the path this pipeline
        accelerates."""
        with self._pool_lock:
            if self._scan_pool is None or self._scan_pool_size != workers:
                if self._scan_pool is not None:
                    self._scan_pool.shutdown(wait=False)
                self._scan_pool = ThreadPoolExecutor(
                    max_workers=workers, thread_name_prefix="pio-scan")
                self._scan_pool_size = workers
            return self._scan_pool

    # -- routing / failover --------------------------------------------------

    def shard_for(self, entity_type: str, entity_id: str) -> _Shard:
        return self._shards[
            shard_of(str(entity_type), str(entity_id), self.n_shards)]

    def _failover(self, shard: _Shard) -> bool:
        """Try to promote ``shard``'s replica after an I/O failure on the
        primary.  False = nothing to promote (caller re-raises)."""
        if self.replicas < 2:
            return False
        topo = shard.topology(force=True)
        reason = ("primary-missing"
                  if not shard.node_root(topo["primary"]).exists()
                  else "io-error")
        try:
            # epoch-fenced: if another waiter from the same failed group
            # (or another process) already flipped, this no-ops and the
            # caller's retry lands on the promoted primary
            shard.promote(reason, expect_epoch=topo["epoch"])
            return True
        except OSError:
            return False

    def _ensure_active(self, shard: _Shard) -> None:
        """Health probe before touching a shard: a yanked primary node
        directory doesn't raise — the store just looks EMPTY — so a
        missing-primary-with-live-replica promotes eagerly instead of
        silently serving nothing."""
        if self.replicas < 2:
            return
        topo = shard.topology()
        other = "b" if topo["primary"] == "a" else "a"
        if (not shard.node_root(topo["primary"]).exists()
                and shard.node_root(other).exists()):
            try:
                shard.promote("primary-missing",
                              expect_epoch=topo["epoch"])
            except OSError:
                pass

    def _on_shard(self, shard: _Shard, fn):
        self._ensure_active(shard)
        try:
            return fn(shard.events())
        except _Fenced:
            # topology already flipped under this writer: retry on the
            # NEW primary, never promote back
            return fn(shard.events())
        except _AckTimeout:
            # the REPLICA failed, not the primary: NACK without failover
            # (promoting would install the node that is provably behind)
            raise
        except OSError:
            if not self._failover(shard):
                raise
            return fn(shard.events())

    # -- LEvents -------------------------------------------------------------

    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        for shard in self._shards:
            self._on_shard(shard, lambda ev: ev.init(app_id, channel_id))
        return True

    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        removed = False
        for shard in self._shards:
            names = NODES[: self.replicas]
            for name in names:
                try:
                    removed |= shard.events(name).remove(app_id, channel_id)
                except OSError:
                    pass
            if shard.follower is not None:
                shard.follower.kick()
        # the merged cross-shard snapshot under the virtual channel dir
        # describes data that no longer exists (validation would reject
        # it anyway — this just reclaims the disk)
        import shutil

        d = self._chan_dir(app_id, channel_id)
        if d.exists():
            shutil.rmtree(d, ignore_errors=True)
        return removed

    def insert(self, event: Event, app_id: int,
               channel_id: Optional[int] = None) -> str:
        return self.insert_batch([event], app_id, channel_id)[0]

    def insert_batch(self, events: Sequence[Event], app_id: int,
                     channel_id: Optional[int] = None) -> List[str]:
        groups: Dict[int, List[int]] = {}
        for i, e in enumerate(events):
            k = shard_of(e.entity_type, e.entity_id, self.n_shards)
            groups.setdefault(k, []).append(i)
        ids: List[Optional[str]] = [None] * len(events)
        for k, idxs in groups.items():
            sub = [events[i] for i in idxs]
            res = self._on_shard(
                self._shards[k],
                lambda ev, sub=sub: ev.insert_batch(sub, app_id, channel_id))
            _M_SHARD_EVENTS.inc(len(res), shard=str(k))
            for i, eid in zip(idxs, res):
                ids[i] = eid
        return ids  # type: ignore[return-value]

    def insert_json_batch(self, items: Sequence, app_id: int,
                          channel_id: Optional[int] = None) -> List[dict]:
        groups: Dict[int, List[int]] = {}
        for i, item in enumerate(items):
            et = eid = None
            if isinstance(item, dict):
                et, eid = item.get("entityType"), item.get("entityId")
            groups.setdefault(
                shard_of(str(et), str(eid), self.n_shards), []).append(i)
        results: List[Optional[dict]] = [None] * len(items)
        for k, idxs in groups.items():
            sub = [items[i] for i in idxs]
            res = self._on_shard(
                self._shards[k],
                lambda ev, sub=sub: ev.insert_json_batch(
                    sub, app_id, channel_id))
            _M_SHARD_EVENTS.inc(
                sum(1 for r in res if r.get("status") == 201), shard=str(k))
            for i, r in zip(idxs, res):
                results[i] = r
        return results  # type: ignore[return-value]

    def get(self, event_id: str, app_id: int,
            channel_id: Optional[int] = None) -> Optional[Event]:
        for shard in self._shards:
            e = self._on_shard(
                shard, lambda ev: ev.get(event_id, app_id, channel_id))
            if e is not None:
                return e
        return None

    def delete(self, event_id: str, app_id: int,
               channel_id: Optional[int] = None) -> bool:
        for shard in self._shards:
            ok = self._on_shard(
                shard, lambda ev: ev.delete(event_id, app_id, channel_id))
            if ok:
                # tombstones bypass the group-commit barrier; replicate
                # synchronously so a failover can't resurrect the event
                ev = shard.events()
                tp = ev._tombstone_path(ev._chan_dir(app_id, channel_id))
                try:
                    size = tp.stat().st_size
                except OSError:
                    size = 0
                shard.wait_replicated(ev, tp, size)
                return True
        return False

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
        kw = dict(
            channel_id=channel_id, start_time=start_time,
            until_time=until_time, entity_type=entity_type,
            entity_id=entity_id, event_names=event_names,
            target_entity_type=target_entity_type,
            target_entity_id=target_entity_id, limit=limit,
            reversed_order=reversed_order)
        if entity_type is not None and entity_id is not None:
            # serving hot path: the entity lives on exactly one shard
            shard = self.shard_for(entity_type, entity_id)
            yield from self._on_shard(
                shard, lambda ev: list(ev.find(app_id, **kw)))
            return
        # k-way merge instead of materialize-all + global re-sort: each
        # shard's find already yields time order AND honors the limit
        # (its top-`limit` is a superset of its share of the global
        # top-`limit`), so the merged stream holds at most
        # shards × limit events and stops at `limit` — a small-limit
        # query no longer pays an O(total events) sort
        parts = [self._on_shard(shard,
                                lambda ev: list(ev.find(app_id, **kw)))
                 for shard in self._shards]
        merged = heapq.merge(
            *parts, key=lambda e: (e.event_time, e.creation_time),
            reverse=reversed_order)
        if limit is not None and limit >= 0:
            merged = islice(merged, limit)
        yield from merged

    def warm_entity_index(self, app_id: int,
                          channel_id: Optional[int] = None) -> None:
        """Pre-build every shard's per-entity serving index (each shard
        is a full localfs store — see FSEvents.warm_entity_index)."""
        for shard in self._shards:
            self._on_shard(
                shard,
                lambda ev: ev.warm_entity_index(app_id, channel_id))

    # -- PEvents -------------------------------------------------------------

    def scan(self, app_id: int, channel_id: Optional[int] = None,
             **filters: Any) -> Iterator[Event]:
        """Streaming fan-out scan.  A shard whose primary dies mid-scan is
        promoted and re-scanned with already-yielded events deduped by
        id, so one scan still sees every surviving event exactly once.
        Unreplicated stores have no failover retry to dedupe against, so
        they stream without the O(events) id set."""
        track = self.replicas >= 2
        for shard in self._shards:
            yielded: set = set()
            retried = False
            while True:
                try:
                    self._ensure_active(shard)
                    for e in shard.events().scan(
                            app_id, channel_id=channel_id, **filters):
                        if track:
                            if e.event_id in yielded:
                                continue
                            yielded.add(e.event_id)
                        yield e
                    break
                except OSError as err:
                    if (isinstance(err, _Fenced) or retried
                            or not self._failover(shard)):
                        raise
                    retried = True

    def segment_paths(self, app_id: int,
                      channel_id: Optional[int] = None) -> List[Path]:
        out: List[Path] = []
        for shard in self._shards:
            out.extend(self._on_shard(
                shard, lambda ev: ev.segment_paths(app_id, channel_id)))
        return out

    def compact(self, app_id: int, channel_id: Optional[int] = None,
                before: Optional[_dt.datetime] = None) -> Dict[str, int]:
        totals = {"kept": 0, "expired": 0, "segments": 0}
        for shard in self._shards:
            res = self._on_shard(
                shard, lambda ev: ev.compact(app_id, channel_id, before))
            for k2 in totals:
                totals[k2] += res.get(k2, 0)
            if shard.follower is not None:
                shard.follower.kick()
        return totals

    def tombstone_state(self, app_id: int,
                        channel_id: Optional[int] = None) -> frozenset:
        dead: set = set()
        for shard in self._shards:
            dead |= set(self._on_shard(
                shard, lambda ev: ev.tombstone_state(app_id, channel_id)))
        return frozenset(dead)

    def _chan_dir(self, app_id: int, channel_id: Optional[int]) -> Path:
        """Store-level channel identity: the staging-cache key, and home
        of the MERGED cross-shard snapshot (``<dir>/snapshot/``).  The
        event log itself lives per shard under
        shard_*/<node>/events/...; this dir holds only the derived
        merged columnar file + manifest (rebuildable at any time via
        ``build_snapshot``)."""
        chan = (localfs.DEFAULT_CHANNEL if channel_id is None
                else f"channel_{channel_id}")
        return self._root / "events" / f"app_{app_id}" / chan

    # -- snapshot / delta protocol (shard-namespaced watermarks) -------------

    def build_snapshot(self, app_id: int,
                      channel_id: Optional[int] = None) -> Dict:
        agg = {"events": 0, "segments": 0, "build_s": 0.0,
               "snapshot": f"{self.n_shards} shard(s)"}
        for shard in self._shards:
            res = self._on_shard(
                shard, lambda ev: ev.build_snapshot(app_id, channel_id))
            agg["events"] += res.get("events", 0)
            agg["segments"] += res.get("segments", 0)
            agg["build_s"] = max(agg["build_s"], res.get("build_s", 0.0))
        agg["merged"] = self._build_merged_snapshot(app_id, channel_id)
        return agg

    # -- merged cross-shard snapshot -----------------------------------------
    #
    # The per-shard snapshots make each SHARD's read mmap-cheap, but a
    # merged cold scan still paid N× the fixed read/validate cost plus a
    # full k-way re-code per scan.  Folding the k-way merge result into
    # ONE columnar file at the store root (under the virtual channel dir
    # — the same two-phase manifest protocol as storage.snapshot) makes
    # the cross-shard cold scan literally a single-shard read again:
    # mmap the merged file, validate each shard's covered byte ranges +
    # head fingerprints, parse only per-shard tails.  Any validation
    # failure (compaction, recreated segments, receded tombstones, shard
    # count change, torn file) falls back to the live parallel fan-out
    # merge, which is always correct.

    def _build_merged_snapshot(self, app_id: int,
                               channel_id: Optional[int]) -> bool:
        from predictionio_tpu_torch.storage import snapshot as _snap
        from predictionio_tpu_torch.store.columnar import write_batch

        if not _snap.enabled() or self.n_shards < 2:
            return False
        # tombstones read BEFORE the scan: a delete landing mid-build is
        # then absent from ``tombstones_applied`` and the next scan's
        # new-dead mask drops it — the reverse order could record a
        # tombstone as applied that the batch never masked
        tombs = self.tombstone_state(app_id, channel_id)
        res = self._fanout_snapshot_scan(app_id, channel_id)
        if res is None or res.get("ids") is None:
            return False
        d = self._chan_dir(app_id, channel_id)
        snap_dir = d / _snap.SNAP_DIR
        snap_dir.mkdir(parents=True, exist_ok=True)
        import fcntl
        import uuid

        lockf = open(snap_dir / _snap.LOCK, "a")
        try:
            try:
                fcntl.flock(lockf.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                return False     # another process's merged build in flight
            for stale in snap_dir.glob("*.tmp*"):
                stale.unlink(missing_ok=True)
            name = f"snap-merged-{uuid.uuid4().hex[:8]}.pioc"
            tmp = snap_dir / (name + f".tmp{os.getpid()}")
            write_batch(tmp, res["batch"], res["ids"],
                        meta={"merged": True, "events": res["events"]})
            tmp.rename(snap_dir / name)
            manifest = {
                "version": 1,
                "merged": True,
                "shards": self.n_shards,
                "snapshot": name,
                "covered": res["watermark"],
                "heads": res["heads"],
                "events": res["events"],
                "tombstones_applied": sorted(tombs),
                "built_at": _dt.datetime.now(
                    _dt.timezone.utc).isoformat(),
            }
            _fsync_write(snap_dir / _snap.MANIFEST, json.dumps(
                manifest, indent=1, sort_keys=True))
            for p in snap_dir.glob("snap-*.pioc"):
                if p.name != name:
                    p.unlink(missing_ok=True)
            return True
        finally:
            lockf.close()

    def _merged_snapshot_scan(self, app_id: int,
                              channel_id: Optional[int]) -> Optional[Dict]:
        """Serve the merged cross-shard snapshot if it still describes
        the live store: one mmap read + per-shard covered-range/head
        validation + tail-only parses.  None = no or stale merged snapshot
        (caller falls back to the live fan-out merge)."""
        from predictionio_tpu_torch.storage import snapshot as _snap
        from predictionio_tpu_torch.store.columnar import read_batch

        if not _snap.enabled():
            return None
        d = self._chan_dir(app_id, channel_id)
        m = _snap.load_manifest(d)
        if m is None or not m.get("merged") \
                or m.get("shards") != self.n_shards:
            return None
        split = self._split_marks(m["covered"], m.get("heads", {}))
        if split is None:
            return None
        per_wm, per_heads = split
        tombs = self.tombstone_state(app_id, channel_id)
        applied = set(m.get("tombstones_applied", ()))
        if applied - tombs:
            return None          # tombstones receded: log was rewritten
        snap_dir = d / _snap.SNAP_DIR
        try:
            batch, ids, _meta = read_batch(snap_dir / m["snapshot"])
        except FileNotFoundError:
            return None
        except (ValueError, OSError):
            _snap._quarantine(snap_dir, m["snapshot"])
            return None
        if ids is None:
            return None
        batch, ids = _snap.drop_tombstoned(batch, ids, tombs - applied)
        snap_events = len(batch)
        # per-shard tails past the merged watermark: serial, encoding
        # straight into the merged batch's dictionaries (tails are the
        # hot-append suffix — usually empty or tiny)
        tails: List[Dict] = []
        wm: Dict[str, int] = {}
        heads: Dict[str, dict] = {}
        tail_events = 0
        for k, shard in enumerate(self._shards):
            res = self._on_shard(
                shard,
                lambda ev, k=k: ev.scan_tail_from(
                    app_id, channel_id, per_wm[k], base=batch,
                    heads=per_heads[k]))
            if res is None:
                return None      # a shard's log moved under the manifest
            tail_events += res["events"]
            if res["events"]:
                tails.append(res)
            for name, off in res["watermark"].items():
                wm[f"{k}|{name}"] = off
            for name, h in (res.get("heads") or {}).items():
                heads[f"{k}|{name}"] = h
        if tails:
            batch = EventBatch.concat(
                [batch] + [t["batch"] for t in tails])
            if all(t.get("ids") is not None for t in tails):
                from predictionio_tpu_torch.store.columnar import EventIdColumn
                ids = EventIdColumn.concat(
                    [ids] + [t["ids"] for t in tails])
            else:
                ids = None
        _snap.record_staged(snap_events, "snapshot")
        _snap.record_staged(tail_events, "tail")
        return {"batch": batch, "ids": ids, "events": len(batch),
                "snap_events": snap_events, "tail_events": tail_events,
                "watermark": wm, "heads": heads}

    def _scan_fanout(self, fn) -> Iterator[tuple]:
        """Run ``fn(k, shard)`` for every shard on a bounded thread pool
        (``PIO_SCAN_WORKERS`` wide) and yield ``(k, result)`` IN SHARD
        ORDER as each result becomes consumable — the consumer (the
        k-way merge) stages completed shards while later shards are
        still parsing.  Failover runs inside the worker (``fn`` wraps
        ``_on_shard``), so a shard partitioned mid-fan-out promotes and
        re-reads on its own thread without disturbing its siblings; a
        shard whose failover fails raises, exactly like the serial
        loop.  At ``workers <= 1`` the shards run inline — the
        bit-exactness oracle the parity tests compare against.
        Per-shard wall time lands on
        ``pio_store_scan_shard_duration_seconds{shard}``."""
        workers = _scan_workers(self.n_shards)
        _M_SCAN_WORKERS.set(workers)

        def timed(k, shard):
            t0 = time.perf_counter()
            res = fn(k, shard)
            return res, time.perf_counter() - t0

        if workers <= 1:
            for k, shard in enumerate(self._shards):
                res, dt = timed(k, shard)
                _M_SCAN_SHARD_S.set(dt, shard=str(k))
                yield k, res
            return
        pool = self._pool(workers)
        futs = [pool.submit(timed, k, shard)
                for k, shard in enumerate(self._shards)]
        try:
            for k, fut in enumerate(futs):
                res, dt = fut.result()
                _M_SCAN_SHARD_S.set(dt, shard=str(k))
                yield k, res
        finally:
            # a consumer that bails early (miss → None, or an exception)
            # must not leave stray shard reads running into a store that
            # may be closing
            for f in futs:
                f.cancel()

    def snapshot_scan(self, app_id: int,
                      channel_id: Optional[int] = None) -> Optional[Dict]:
        """Merged snapshot-or-parse read across shards.  Unlike localfs,
        this never returns None for a healthy store: shards without a
        built columnar snapshot fall back to a full parse of their own
        log — the result always carries a shard-namespaced watermark, so
        delta staging and the follow-trainer work on a sharded store with
        or without per-shard snapshot builds.

        Read strategy, fastest first: (1) the merged cross-shard
        snapshot — one mmap read at single-shard cost, validated per
        shard, tails parsed per shard; (2) the parallel fan-out
        pipeline — per-shard reads on the ``PIO_SCAN_WORKERS`` thread
        pool merged through ONE k-way :class:`BatchMerger` pass (each
        column re-coded at most once) instead of the old serial loop
        with pairwise ``EventBatch.concat`` accumulation (O(shards²)
        copying).  On the fan-out path, row order (shard 0 first, then
        shard 1, ...), merged dictionaries, property columns and
        tombstone filtering are bit-exact vs the ``PIO_SCAN_WORKERS=1``
        serial path."""
        t0 = time.perf_counter()
        res = self._merged_snapshot_scan(app_id, channel_id)
        if res is not None:
            wall = time.perf_counter() - t0
            if wall > 0:
                _M_SCAN_RATE.set(res["events"] / wall)
            return res
        return self._fanout_snapshot_scan(app_id, channel_id)

    def _fanout_snapshot_scan(self, app_id: int,
                              channel_id: Optional[int] = None
                              ) -> Optional[Dict]:
        """The live parallel fan-out + k-way merge (strategy 2)."""
        t0 = time.perf_counter()

        def read(k, shard):
            def go(ev):
                res = ev.snapshot_scan(app_id, channel_id)
                if res is None:
                    res = ev.scan_tail_from(app_id, channel_id, {},
                                            base=None, heads=None)
                return res
            return self._on_shard(shard, go)

        # single-shard stores pass the sole part through untouched — the
        # k-way merge would only re-code what is already one batch
        merger = BatchMerger() if self.n_shards > 1 else None
        sole: Optional[Dict] = None
        wm: Dict[str, int] = {}
        heads: Dict[str, dict] = {}
        snap_events = tail_events = parts = 0
        for k, res in self._scan_fanout(read):
            if res is None:
                return None
            for name, off in res["watermark"].items():
                wm[f"{k}|{name}"] = off
            for name, h in (res.get("heads") or {}).items():
                heads[f"{k}|{name}"] = h
            snap_events += res.get("snap_events", 0)
            tail_events += res.get("tail_events", res.get("events", 0))
            if merger is None:
                sole = res
            else:
                merger.add(res["batch"], res.get("ids"))
            parts += 1
        if not parts:
            return None
        if merger is None:
            batch, ids = sole["batch"], sole.get("ids")
        else:
            batch, ids = merger.finish()
        wall = time.perf_counter() - t0
        if wall > 0:
            _M_SCAN_RATE.set(len(batch) / wall)
        return {"batch": batch, "ids": ids, "events": len(batch),
                "snap_events": snap_events, "tail_events": tail_events,
                "watermark": wm, "heads": heads}

    def _split_marks(self, watermark: Dict[str, int],
                     heads: Optional[Dict]) -> Optional[tuple]:
        per_wm: List[Dict[str, int]] = [dict() for _ in self._shards]
        per_heads: List[Dict[str, dict]] = [dict() for _ in self._shards]
        for key, off in (watermark or {}).items():
            k, sep, name = key.partition("|")
            if not sep or not k.isdigit() or int(k) >= self.n_shards:
                return None     # foreign/stale watermark: full restage
            per_wm[int(k)][name] = off
        for key, h in (heads or {}).items():
            k, sep, name = key.partition("|")
            if not sep or not k.isdigit() or int(k) >= self.n_shards:
                return None
            per_heads[int(k)][name] = h
        return per_wm, per_heads

    def scan_tail_from(self, app_id: int, channel_id: Optional[int],
                       watermark: Dict[str, int], base=None,
                       heads: Optional[Dict] = None) -> Optional[Dict]:
        split = self._split_marks(watermark, heads)
        if split is None:
            return None
        per_wm, per_heads = split

        single = self.n_shards == 1

        def read(k, shard):
            # base=None per shard (multi-shard): a worker-thread builder
            # must never encode into the (shared, mutable) base
            # dictionaries; the k-way merge below re-codes each
            # completed part INTO the base dicts serially, in shard
            # order — same final dict state, same codes, no cross-thread
            # mutation.  A single-shard store is inherently serial, so
            # its one builder encodes straight into the base as before.
            return self._on_shard(
                shard,
                lambda ev, k=k: ev.scan_tail_from(
                    app_id, channel_id, per_wm[k],
                    base=base if single else None,
                    heads=per_heads[k] if heads is not None else None))

        merger = BatchMerger(base=base) if not single else None
        sole: Optional[Dict] = None
        new_wm: Dict[str, int] = {}
        new_heads: Dict[str, dict] = {}
        total = parts = 0
        for k, res in self._scan_fanout(read):
            if res is None:
                return None
            total += res["events"]
            for name, off in res["watermark"].items():
                new_wm[f"{k}|{name}"] = off
            for name, h in (res.get("heads") or {}).items():
                new_heads[f"{k}|{name}"] = h
            if merger is None:
                sole = res
            else:
                merger.add(res["batch"], res.get("ids"))
            parts += 1
        if not parts:
            return None
        if merger is None:
            batch, ids = sole["batch"], sole.get("ids")
        else:
            # with base given the merged tail carries the base's
            # dictionary OBJECTS, so the caller's concat([base, tail])
            # takes the shared-dict fast path — the delta-staging
            # contract
            batch, ids = merger.finish()
        return {"batch": batch, "ids": ids, "events": total,
                "watermark": new_wm, "heads": new_heads}

    def scan_events_up_to(self, app_id: int, channel_id: Optional[int],
                          watermark: Dict[str, int],
                          heads: Optional[Dict] = None) -> Optional[Dict]:
        split = self._split_marks(watermark, heads)
        if split is None:
            return None
        per_wm, per_heads = split

        def read(k, shard):
            return self._on_shard(
                shard,
                lambda ev, k=k: ev.scan_events_up_to(
                    app_id, channel_id, per_wm[k],
                    heads=per_heads[k] if heads is not None else None))

        merger = BatchMerger() if self.n_shards > 1 else None
        sole: Optional[Dict] = None
        total = parts = 0
        for _k, res in self._scan_fanout(read):
            if res is None:
                return None
            total += res["events"]
            if merger is None:
                sole = res
            else:
                merger.add(res["batch"])
            parts += 1
        if not parts:
            return None
        batch = sole["batch"] if merger is None else merger.finish()[0]
        return {"batch": batch, "events": total}

    def snapshot_status(self, app_id: int,
                        channel_id: Optional[int] = None) -> Optional[Dict]:
        per = []
        for shard in self._shards:
            try:
                st = self._on_shard(
                    shard, lambda ev: ev.snapshot_status(app_id, channel_id))
            except OSError:
                st = None
            if st is not None:
                per.append(st)
        if not per:
            return None
        events = sum(s.get("events", 0) for s in per)
        tail = sum(s.get("tailEvents", 0) for s in per)
        total = events + tail
        return {
            "events": events,
            "tailEvents": tail,
            "tailBytes": sum(s.get("tailBytes", 0) for s in per),
            "coverage": (events / total) if total else 1.0,
            "builtAt": max((s.get("builtAt") or "" for s in per),
                           default="") or None,
            "snapshot": f"{len(per)}/{self.n_shards} shard(s)",
            "segmentsCovered": sum(s.get("segmentsCovered", 0) for s in per),
            "shards": self.n_shards,
        }

    def find_batches(
        self,
        app_id: int,
        batch_size: int = 1 << 20,
        **filters: Any,
    ) -> Iterator["EventBatch"]:
        from predictionio_tpu_torch.storage import snapshot as _snap

        plain = {"channel_id", "start_time", "until_time", "entity_type",
                 "event_names"}
        if set(filters) <= plain:
            res = self.snapshot_scan(app_id, filters.get("channel_id"))
            if res is not None:
                yield _snap.apply_filters(
                    res["batch"],
                    event_names=filters.get("event_names"),
                    entity_type=filters.get("entity_type"),
                    start_time=filters.get("start_time"),
                    until_time=filters.get("until_time"))
                return
        yield from super().find_batches(app_id, batch_size=batch_size,
                                        **filters)

    # -- observability -------------------------------------------------------

    def topology_status(self) -> Dict:
        """Shard/replica topology for /stats.json and the failover drill."""
        per = []
        for k, shard in enumerate(self._shards):
            topo = shard.topology()
            lag = shard.lag_events()
            _M_REPL_LAG.set(lag, shard=str(k))
            per.append({
                "shard": k,
                "primary": topo["primary"],
                "epoch": topo["epoch"],
                "replicaLagEvents": lag,
                "promotedAt": topo.get("promotedAt"),
                "reason": topo.get("reason"),
            })
        return {"shards": self.n_shards, "replicas": self.replicas,
                "perShard": per}


class ShardedSource:
    """Storage source of type ``sharded`` (PIO_STORAGE_SOURCES_*_TYPE):
    metadata and model blobs stay on the shared prefix (localfs, one
    copy); event data is sharded (``_SHARDS``) and optionally replicated
    (``_REPLICAS=2``)."""

    def __init__(self, spec: Dict[str, str]):
        root = Path(spec.get("path", ".pio_store"))
        shards = int(spec.get("shards", "1") or "1")
        replicas = int(spec.get("replicas", "1") or "1")
        self.apps = localfs.FSApps(root)
        self.access_keys = localfs.FSAccessKeys(root)
        self.channels = localfs.FSChannels(root)
        self.engine_instances = localfs.FSEngineInstances(root)
        self.engine_manifests = localfs.FSEngineManifests(root)
        self.evaluation_instances = localfs.FSEvaluationInstances(root)
        self.models = localfs.FSModels(root)
        self.events = ShardedEvents(root, shards=shards, replicas=replicas)
