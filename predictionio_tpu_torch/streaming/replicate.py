"""Model-plane replication: the plane's files streamed over TCP (PRP1).

Counterpart of ``predictionio_tpu/streaming/replicate.py``; the wire is the
JAX package's, so either package's publisher feeds the other's subscriber.

- :class:`PlaneReplicator` (the publisher, ``deploy --plane-publish``)
  watches its plane directory (inotify, stat-poll fallback) and streams
  every new generation file to each connected subscriber, then a ``flip``
  frame with the manifest.
- :class:`PlaneSubscriber` (``deploy --plane-from``, ``pio
  plane-subscribe``) lands each file two-phase (tmp, sha256 check, fsync,
  rename) in its own node-local plane directory and flips ``CURRENT.json``
  under the plane's publish lock; from there the plane's ``PlaneWatcher``
  serves it as if a local publisher had written it.

Failures reuse what the plane proves locally: a cold or lagging subscriber
(the publisher's GC moved past its generation) is re-planned from the
nearest keyframe and the chain replayed forward; a torn transfer (sha256
mismatch) is quarantined on the subscriber, never flipped, and the chain
re-requested; a killed subscriber resumes from its last flipped manifest
(the ``have`` of its first sync frame); a stuck one costs the publisher
one blocked send (the socket buffer and one chunk), then the send timeout
drops it.

Wire (``PRP1``): every frame is ``b"PRP1" + u32 header_len + u64
payload_len + header JSON + payload``.  Frames: ``sync`` (subscriber →
publisher: ``have`` and ``reason``; also the ack of each flip; its payload
a JSON document with the node name and its HTTP port), ``file`` (one
container and its sha256), ``flip`` (the manifest), ``ping`` (the
publisher's generation while idle).  Every manifest a subscriber lands
carries ``replicatedFrom`` (``plane.REPLICA_KEY``); a subscriber refuses a
directory whose manifest lacks it.

Lineage (``obs/lineage.py``): the manifest's ``lineageId`` rides each
``file`` frame (``lid``), so a subscriber stages ``repl.recv``,
``repl.verify`` and ``repl.land`` under the publisher's record, and every
sync frame's payload carries the subscriber's recent records, which the
publisher ingests (stitching them into one cross-node record).  The
publisher stages ``repl.plan``.  ``PlaneReplicator.peers()`` (every
subscriber ever seen, with its HTTP port) feeds the cluster federation
(``obs/cluster.py``) and ``cluster_view()`` the stitching's expected set.
Each of these threads records into the lineage id it is handed.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import socket
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from predictionio_tpu_torch.obs import lineage as _obs_lineage
from predictionio_tpu_torch.obs import metrics as _obs_metrics
from predictionio_tpu_torch.streaming.plane import (
    REPLICA_KEY,
    ModelPlane,
    _DirNotify,
    _gen_of,
    _PlaneCorrupt,
    plane_notify_enabled,
    plane_poll_s,
)

log = logging.getLogger("pio.planerepl")

_REG = _obs_metrics.get_registry()
_M_RBYTES = _REG.counter(
    "pio_plane_repl_bytes_total",
    "Replicated plane bytes by direction (out: sent to subscribers, in: "
    "landed from a publisher) and container kind (full|delta)")
_M_RLAG = _REG.gauge(
    "pio_plane_repl_lag_generations",
    "Generations the named peer is behind the publisher (a publisher: one "
    "series a subscriber; a subscriber: its own); removed on disconnect")
_M_RSUBS = _REG.gauge(
    "pio_plane_repl_subscribers",
    "Connected replication subscribers of this publisher")
_M_RESYNC = _REG.counter(
    "pio_plane_repl_resyncs_total",
    "Keyframe-chain re-syncs by reason: cold (a new subscriber), lag (behind "
    "the publisher's GC), torn (a sha256 mismatch on arrival)")

_MAGIC = b"PRP1"
_HDR = struct.Struct("<4sIQ")      # magic, header length, payload length
_MAX_HEADER = 16 << 20


def _env_float(name: str, default: float, floor: float) -> float:
    try:
        return max(float(os.environ.get(name, str(default))), floor)
    except ValueError:
        return default


def repl_ping_s() -> float:
    """``PIO_PLANE_REPL_PING_S`` (default 5): the publisher's keepalive
    while idle, also how often an idle subscriber's lag refreshes."""
    return _env_float("PIO_PLANE_REPL_PING_S", 5.0, 0.2)


def repl_timeout_s() -> float:
    """``PIO_PLANE_REPL_TIMEOUT_S`` (default 30): socket send and ack
    timeout; a subscriber that stops reading this long is dropped."""
    return _env_float("PIO_PLANE_REPL_TIMEOUT_S", 30.0, 1.0)


def repl_backoff_s() -> float:
    """``PIO_PLANE_REPL_BACKOFF_S`` (default 1): a subscriber's first
    reconnect delay, doubling to 30 s."""
    return _env_float("PIO_PLANE_REPL_BACKOFF_S", 1.0, 0.05)


def repl_chunk_bytes() -> int:
    """``PIO_PLANE_REPL_CHUNK`` (default 1 MiB): the transfer chunk, and the
    publisher's memory a subscriber."""
    try:
        return max(int(os.environ.get("PIO_PLANE_REPL_CHUNK", str(1 << 20))), 4096)
    except ValueError:
        return 1 << 20


def parse_endpoint(spec: str, default_host: str = "0.0.0.0") -> Tuple[str, int]:
    """``HOST:PORT`` | ``:PORT`` | ``PORT`` → (host, port)."""
    s = str(spec).strip()
    if ":" in s:
        host, _, port = s.rpartition(":")
        host = host or default_host
    else:
        host, port = default_host, s
    try:
        return host, int(port)
    except ValueError:
        raise ValueError(f"bad replication endpoint {spec!r} (want HOST:PORT or PORT)")


def _send_frame(sock: socket.socket, header: Dict[str, Any], payload_len: int = 0) -> None:
    hj = json.dumps(header, separators=(",", ":")).encode()
    sock.sendall(_HDR.pack(_MAGIC, len(hj), payload_len) + hj)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    parts = []
    while n:
        b = sock.recv(min(n, 1 << 20))
        if not b:
            raise ConnectionError("peer closed mid-frame")
        parts.append(b)
        n -= len(b)
    return b"".join(parts)


def _recv_frame(sock: socket.socket) -> Tuple[Dict[str, Any], int]:
    """(header, payload length); the caller drains the payload (a file
    streams to disk)."""
    magic, hlen, plen = _HDR.unpack(_recv_exact(sock, _HDR.size))
    if magic != _MAGIC:
        raise ConnectionError(f"bad frame magic {magic!r}")
    if hlen > _MAX_HEADER:
        raise ConnectionError(f"oversized frame header ({hlen} bytes)")
    header = json.loads(_recv_exact(sock, hlen))
    if not isinstance(header, dict) or "type" not in header:
        raise ConnectionError("malformed frame header")
    return header, plen


def _safe_plane_name(name: str) -> str:
    """A file name off the wire, validated: a subscriber writes only
    ``gen-N.arena|.delta`` basenames inside its own plane dir."""
    base = os.path.basename(str(name))
    if (base != name or _gen_of(base) is None
            or not (base.endswith(".arena") or base.endswith(".delta"))):
        raise ConnectionError(f"refusing wire file name {name!r}")
    return base


def _manifest_lid(manifest: Optional[Dict[str, Any]]) -> Optional[str]:
    """The publisher's lineage id riding the manifest; None on manifests
    without one (stitching then stays off for them)."""
    lid = (manifest or {}).get("lineageId")
    return str(lid) if lid else None


class _Session:
    """One publisher → subscriber connection, owned by its thread."""

    def __init__(self, sock: socket.socket, addr, node: str, have: int):
        self.sock = sock
        self.addr = addr
        self.node = node
        self.have = int(have)
        self.http_port = 0           # the subscriber's serving port, if any
        self.sent_bytes = 0
        self.resyncs = 0
        self.connected_at = time.time()


class PlaneReplicator:
    """The publisher side: serve the local plane dir to K subscribers.

    Daemon threads: an acceptor on ``bind``, a plane-dir watcher that wakes
    every session when the manifest moves, one thread a session.  Sessions
    are pull-paced: after each ``flip`` the publisher waits for the
    subscriber's next ``sync`` (the ack), so a slow subscriber throttles its
    own connection only."""

    def __init__(self, plane: ModelPlane, bind: str = "0.0.0.0:0"):
        self.plane = plane
        self.host, self.port = parse_endpoint(bind)
        self._sessions: Dict[int, _Session] = {}
        # every subscriber node ever seen in this process: the cluster's
        # expected set for lineage stitching and the federation's scrape
        # list; a disconnect marks a peer, never removes it
        self._peers: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._cur_gen = 0
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._notify: Optional[_DirNotify] = None
        self._listener: Optional[socket.socket] = None
        self._session_seq = 0

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._listener is not None:
            return
        os.makedirs(self.plane.dir, exist_ok=True)
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((self.host, self.port))
        srv.listen(64)
        self.port = srv.getsockname()[1]
        self._listener = srv
        cur = self.plane.current()
        self._cur_gen = int(cur["generation"]) if cur else 0
        for target, name in ((self._accept_loop, "pio-plane-repl-accept"),
                             (self._watch_loop, "pio-plane-repl-watch")):
            t = threading.Thread(target=target, daemon=True, name=name)
            t.start()
            self._threads.append(t)
        log.info("plane replication: publishing %s on %s:%d", self.plane.dir, self.host,
                 self.port)

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        if self._notify is not None:
            self._notify.poke()
        with self._cond:
            self._cond.notify_all()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
            self._listener = None
        with self._lock:
            sessions = list(self._sessions.values())
        for s in sessions:
            try:
                s.sock.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=timeout)
        self._threads = []
        if self._notify is not None:
            self._notify.close()
            self._notify = None

    def poke(self) -> None:
        """The manifest may have flipped (the in-process follower's publish
        listener): no waiting out the directory watch."""
        self._refresh_gen()

    def status(self) -> Dict[str, Any]:
        with self._lock:
            subs = [{"node": s.node, "ackedGeneration": s.have,
                     "lagGenerations": max(self._cur_gen - s.have, 0),
                     "sentBytes": s.sent_bytes, "resyncs": s.resyncs}
                    for s in self._sessions.values()]
        return {"role": "publisher", "bind": f"{self.host}:{self.port}",
                "generation": self._cur_gen,
                "subscribers": sorted(subs, key=lambda d: d["node"])}

    # -- cluster membership ----------------------------------------------------

    def peers(self) -> Dict[str, Dict[str, Any]]:
        """Every subscriber node this publisher has ever seen: node →
        {addr, httpPort, connected, lastSeen}.  The federation scrapes
        this list; lineage stitching uses it as the expected set."""
        with self._lock:
            return {n: dict(p) for n, p in self._peers.items()}

    def cluster_view(self) -> Dict[str, Any]:
        """{"expected", "live"} node-name sets for
        :func:`~predictionio_tpu_torch.obs.lineage.set_cluster_provider`."""
        with self._lock:
            return {"expected": sorted(self._peers),
                    "live": sorted(n for n, p in self._peers.items()
                                   if p.get("connected"))}

    def _note_peer(self, sess: _Session, connected: bool = True) -> None:
        with self._lock:
            p = self._peers.setdefault(sess.node, {"httpPort": 0})
            p["addr"] = sess.addr[0]
            p["lastSeen"] = time.time()
            p["connected"] = connected
            if sess.http_port:
                p["httpPort"] = sess.http_port

    def _ingest_sync(self, sess: _Session, raw: bytes) -> None:
        """The push half of lineage stitching: a subscriber's sync frames
        (the first and each flip's ack) carry its recent lineage fragments
        and its HTTP port as the payload.  An empty payload is fine; a
        malformed one never kills the session."""
        if not raw:
            return
        try:
            doc = json.loads(raw)
            if not isinstance(doc, dict):
                return
            port = int(doc.get("httpPort") or 0)
            if port:
                sess.http_port = port
            recs = doc.get("records")
            if recs:
                rec = _obs_lineage.get_lineage()
                if rec.enabled:
                    rec.ingest(recs, node=sess.node)
        except Exception:
            log.debug("plane replication: bad sync payload from %s",
                      sess.node, exc_info=True)

    # -- watch ---------------------------------------------------------------

    def _refresh_gen(self) -> None:
        cur = self.plane.current()
        gen = int(cur["generation"]) if cur else 0
        with self._cond:
            if gen != self._cur_gen:
                self._cur_gen = gen
                self._cond.notify_all()

    def _watch_loop(self) -> None:
        if plane_notify_enabled():
            try:
                self._notify = _DirNotify(self.plane.dir)
            except OSError:
                self._notify = None
        poll = plane_poll_s()
        while not self._stop.is_set():
            if self._notify is not None:
                self._notify.wait(poll)
            else:
                self._stop.wait(poll)
            if self._stop.is_set():
                return
            try:
                self._refresh_gen()
            except Exception:
                log.exception("plane replication: watch failed")

    # -- sessions ------------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, addr = self._listener.accept()
            except (OSError, AttributeError):
                return          # stop() closed the listener
            threading.Thread(target=self._serve, args=(sock, addr), daemon=True,
                             name="pio-plane-repl-session").start()

    def _serve(self, sock: socket.socket, addr) -> None:
        sid = None
        node = f"{addr[0]}:{addr[1]}"
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.settimeout(repl_timeout_s())
            header, plen = _recv_frame(sock)
            if header.get("type") != "sync":
                raise ConnectionError(f"expected sync, got {header.get('type')!r}")
            raw = _recv_exact(sock, plen) if plen else b""
            node = str(header.get("node") or node)
            sess = _Session(sock, addr, node, int(header.get("have") or 0))
            self._ingest_sync(sess, raw)
            self._note_peer(sess)
            with self._lock:
                self._session_seq += 1
                sid = self._session_seq
                self._sessions[sid] = sess
                _M_RSUBS.set(len(self._sessions))
            log.info("plane replication: subscriber %s connected (have=%d, reason=%s)",
                     node, sess.have, header.get("reason"))
            self._session_loop(sess, str(header.get("reason") or "cold"))
        except (ConnectionError, socket.timeout, OSError) as e:
            if not self._stop.is_set():
                log.info("plane replication: subscriber %s dropped (%s)", node, e)
        except Exception:
            log.exception("plane replication: session %s failed", node)
        finally:
            try:
                sock.close()
            except OSError:
                pass
            if sid is not None:
                with self._lock:
                    self._sessions.pop(sid, None)
                    _M_RSUBS.set(len(self._sessions))
                    if node in self._peers:
                        self._peers[node]["connected"] = False
                        self._peers[node]["lastSeen"] = time.time()
                _M_RLAG.remove(node=node)   # no stale series for a dead peer

    def _session_loop(self, sess: _Session, reason: str) -> None:
        ping_s = repl_ping_s()
        while not self._stop.is_set():
            with self._cond:
                deadline = time.time() + ping_s
                while self._cur_gen <= sess.have and not self._stop.is_set():
                    left = deadline - time.time()
                    if left <= 0:
                        break
                    self._cond.wait(left)
                gen = self._cur_gen
            if self._stop.is_set():
                return
            _M_RLAG.set(max(gen - sess.have, 0), node=sess.node)
            if gen <= sess.have:
                _send_frame(sess.sock, {"type": "ping", "gen": gen})
                continue
            cur = self.plane.current()
            if cur is None or int(cur["generation"]) <= sess.have:
                continue
            reason = self._ship(sess, cur, reason)

    def _plan(self, have: int, cur: Dict[str, Any], reason: str
              ) -> Tuple[List[str], Optional[str]]:
        """(files to ship in order, the re-sync reason or None for an
        incremental catch-up)."""
        gen = int(cur["generation"])
        resync = "torn" if reason == "torn" else ("cold" if have <= 0 else None)
        files: List[str] = []
        if resync is None:
            for g in range(have + 1, gen + 1):
                for nm in (f"gen-{g:010d}.delta", f"gen-{g:010d}.arena"):
                    if os.path.exists(os.path.join(self.plane.dir, nm)):
                        files.append(nm)
                        break
                else:
                    resync = "lag"   # GC moved past the subscriber
                    break
        if resync is not None:
            files = self.plane.chain_files(str(cur["file"]))
        return files, resync

    def _ship(self, sess: _Session, cur: Dict[str, Any], reason: str) -> str:
        """One catch-up batch (files, then the flip), then block on the
        subscriber's ack; returns the next batch's reason (the ack's)."""
        gen = int(cur["generation"])
        lid = _manifest_lid(cur)
        t_plan = time.time()
        p0 = time.perf_counter()
        try:
            files, resync = self._plan(sess.have, cur, reason)
        except _PlaneCorrupt as e:
            # the local chain is broken (a quarantined file): the next
            # keyframe heals it; keep the session
            log.warning("plane replication: cannot plan a catch-up for %s (%s); waiting "
                        "for a healing keyframe", sess.node, e)
            _send_frame(sess.sock, {"type": "ping", "gen": gen})
            time.sleep(min(repl_ping_s(), 1.0))
            return "lag"
        if resync is not None:
            sess.resyncs += 1
            _M_RESYNC.inc(reason=resync)
            log.info("plane replication: re-syncing %s from a keyframe (%s, %d files)",
                     sess.node, resync, len(files))
        if lid:
            lin = _obs_lineage.get_lineage()
            if lin.enabled:
                lin.stage(lid, "repl.plan", start=t_plan,
                          duration_s=time.perf_counter() - p0,
                          generation=gen, peer=sess.node, files=len(files),
                          resync=resync or "incremental")
        for nm in files:
            if not self._send_file(sess, nm, lid):
                return "lag"   # vanished mid-plan (GC): re-plan next turn
        _send_frame(sess.sock, {"type": "flip", "manifest": cur, "resync": resync})
        header, plen = _recv_frame(sess.sock)   # the ack
        if header.get("type") != "sync":
            raise ConnectionError(f"expected ack sync, got {header.get('type')!r}")
        self._ingest_sync(sess, _recv_exact(sess.sock, plen) if plen else b"")
        self._note_peer(sess)
        sess.have = int(header.get("have") or 0)
        _M_RLAG.set(max(self._cur_gen - sess.have, 0), node=sess.node)
        return str(header.get("reason") or "ack")

    def _send_file(self, sess: _Session, name: str, lid: Optional[str] = None) -> bool:
        """Hash, then stream, one file from one open fd (GC may unlink the
        path mid-send; the fd keeps the bytes).  False when already gone.
        ``lid`` rides the frame header, so the subscriber opens its
        ``repl.recv`` stage under the publisher's lineage id before the
        flip arrives."""
        chunk = repl_chunk_bytes()
        try:
            f = open(os.path.join(self.plane.dir, name), "rb")
        except FileNotFoundError:
            return False
        with f:
            h = hashlib.sha256()
            size = 0
            while True:
                b = f.read(chunk)
                if not b:
                    break
                h.update(b)
                size += len(b)
            kind = "delta" if name.endswith(".delta") else "full"
            hdr = {"type": "file", "name": name, "gen": _gen_of(name),
                   "bytes": size, "sha256": h.hexdigest(), "kind": kind}
            if lid:
                hdr["lid"] = lid
            _send_frame(sess.sock, hdr, payload_len=size)
            f.seek(0)
            left = size
            while left:
                b = f.read(min(chunk, left))
                if not b:
                    raise ConnectionError(f"{name}: shrank mid-send ({left} bytes short)")
                sess.sock.sendall(b)
                left -= len(b)
        sess.sent_bytes += size
        _M_RBYTES.inc(size, dir="out", kind=kind)
        return True


class PlaneSubscriber:
    """The subscriber side: mirror a publisher's plane into a local plane
    dir.  It connects with exponential backoff, announces its last flipped
    generation (that state IS the local manifest, so a killed subscriber
    resumes), lands files two-phase and flips the manifest under the
    plane's publish lock with ``REPLICA_KEY`` stamped."""

    def __init__(self, plane_dir: str, source: str, node: Optional[str] = None):
        self.plane = ModelPlane(plane_dir)
        self.source = source
        self.host, self.port = parse_endpoint(source, default_host="127.0.0.1")
        self.node = (node or _obs_lineage.cluster_node()
                     or f"{socket.gethostname()}-{os.getpid()}")
        # this node's serving port, announced in every sync frame; 0 = none
        self.http_port = 0
        self.generation = 0          # last flipped locally
        self.source_generation = 0   # the publisher's, from pings and flips
        self.resyncs = 0
        self.connected = False
        self.last_flip_at = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._sock: Optional[socket.socket] = None
        self._flip_cond = threading.Condition()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self.generation = self._initial_have()   # raises on a foreign dir
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="pio-plane-subscribe")
        self._thread.start()

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        sock = self._sock
        if sock is not None:
            for close in (lambda: sock.shutdown(socket.SHUT_RDWR), sock.close):
                try:
                    close()
                except OSError:
                    pass
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    def status(self) -> Dict[str, Any]:
        src_gen = max(self.source_generation, self.generation)
        return {"role": "subscriber", "source": self.source, "node": self.node,
                "connected": self.connected, "generation": self.generation,
                "sourceGeneration": src_gen,
                "lagGenerations": max(src_gen - self.generation, 0),
                "resyncs": self.resyncs, "lastFlipAt": self.last_flip_at}

    def wait_generation(self, gen: int, timeout: float) -> bool:
        """Block until generation ``gen`` has flipped locally."""
        deadline = time.time() + timeout
        with self._flip_cond:
            while self.generation < gen:
                left = deadline - time.time()
                if left <= 0:
                    return False
                self._flip_cond.wait(left)
        return True

    # -- resume and split-brain ----------------------------------------------

    def _initial_have(self) -> int:
        """The local manifest's generation when replication landed it and
        its chain survives; 0 (a full re-sync) otherwise.  A manifest
        without the marker belongs to a local publisher: refuse."""
        cur = self.plane.current()
        if cur is None:
            return 0
        if REPLICA_KEY not in cur:
            raise RuntimeError(
                f"plane dir {self.plane.dir} has a locally-published manifest (no "
                "replication marker): subscribing would split-brain with the local "
                "publisher.  Point PIO_MODEL_PLANE_DIR (or --plane-dir) at a directory "
                "this subscriber owns.")
        try:
            self.plane.chain_files(str(cur["file"]))
        except _PlaneCorrupt:
            return 0
        return int(cur["generation"])

    # -- receive loop --------------------------------------------------------

    def _loop(self) -> None:
        backoff = repl_backoff_s()
        reason = "cold" if self.generation == 0 else "resume"
        while not self._stop.is_set():
            try:
                reason = self._run_once(reason)
                backoff = repl_backoff_s()
            except (ConnectionError, socket.timeout, OSError) as e:
                if self._stop.is_set():
                    return
                log.warning("plane replication: link to %s lost (%s); reconnecting in "
                            "%.1f s", self.source, e, backoff)
                self._stop.wait(backoff)
                backoff = min(backoff * 2, 30.0)
            except Exception:
                if self._stop.is_set():
                    return
                log.exception("plane replication: subscriber failed; reconnecting in "
                              "%.1f s", backoff)
                self._stop.wait(backoff)
                backoff = min(backoff * 2, 30.0)
            finally:
                self.connected = False
                _M_RLAG.remove(node=self.node)

    def _run_once(self, reason: str) -> str:
        ping_s = repl_ping_s()
        sock = socket.create_connection((self.host, self.port), timeout=repl_timeout_s())
        self._sock = sock
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # a read must outlive the publisher's ping period
            sock.settimeout(max(repl_timeout_s(), ping_s * 3))
            self._send_sync(sock, reason)
            self.connected = True
            log.info("plane replication: subscribed to %s (have=%d, %s)", self.source,
                     self.generation, reason)
            torn: Optional[str] = None
            while not self._stop.is_set():
                header, plen = _recv_frame(sock)
                typ = header.get("type")
                if typ == "ping":
                    self.source_generation = int(header.get("gen") or 0)
                    self._note_lag()
                elif typ == "file":
                    name, ok = self._land_file(sock, header, plen)
                    if not ok and torn is None:
                        torn = name
                elif typ == "flip":
                    manifest = header.get("manifest") or {}
                    self.source_generation = int(manifest.get("generation") or 0)
                    if torn is None and self._flip(manifest):
                        reason = "ack"
                    else:
                        # a torn or incomplete batch: never flip over it,
                        # re-request the chain
                        self.resyncs += 1
                        _M_RESYNC.inc(reason="torn")
                        reason = "torn"
                    torn = None
                    self._note_lag()
                    self._send_sync(sock, reason)
                elif typ == "error":
                    raise ConnectionError(f"publisher error: {header.get('msg')}")
                else:
                    raise ConnectionError(f"unexpected frame {typ!r}")
            return reason
        finally:
            self._sock = None
            try:
                sock.close()
            except OSError:
                pass

    def _note_lag(self) -> None:
        _M_RLAG.set(max(self.source_generation - self.generation, 0), node=self.node)

    def _send_sync(self, sock: socket.socket, reason: str) -> None:
        """A sync frame (the first, and each flip's ack); its payload names
        this node and its HTTP port and carries this node's recent lineage
        records (the push half of stitching)."""
        payload = b""
        try:
            doc: Dict[str, Any] = {"node": self.node, "httpPort": int(self.http_port)}
            rec = _obs_lineage.get_lineage()
            if rec.enabled:
                doc["records"] = rec.export()
            payload = json.dumps(doc, separators=(",", ":")).encode()
        except Exception:
            payload = b""
        _send_frame(sock, {"type": "sync", "have": self.generation, "node": self.node,
                           "reason": reason}, payload_len=len(payload))
        if payload:
            sock.sendall(payload)

    def _repl_stage(self, lid: Any, name: str, **kw: Any) -> None:
        """One replication stage under the publisher's lineage id.
        ``node=`` is passed explicitly (not left to the environment's
        stamp): one process may run several subscribers."""
        if not lid:
            return
        try:
            rec = _obs_lineage.get_lineage()
            if rec.enabled:
                rec.stage(str(lid), name, node=self.node, **kw)
        except Exception:
            log.debug("plane replication: lineage stage %s failed", name, exc_info=True)

    def _land_file(self, sock: socket.socket, header: Dict[str, Any],
                   plen: int) -> Tuple[str, bool]:
        """Stream one container to ``.<name>.tmp-<pid>`` while hashing; rename
        it into place when the hash matches, else keep it as
        ``<name>.quarantine`` and report the tear.  → (name, landed)."""
        name = _safe_plane_name(header.get("name"))
        want_sha = str(header.get("sha256") or "")
        kind = "delta" if name.endswith(".delta") else "full"
        os.makedirs(self.plane.dir, exist_ok=True)
        tmp = os.path.join(self.plane.dir, f".{name}.tmp-{os.getpid()}")
        t_recv = time.time()
        r0 = time.perf_counter()
        h = hashlib.sha256()
        left = plen
        chunk = repl_chunk_bytes()
        with open(tmp, "wb") as f:
            while left:
                b = sock.recv(min(left, chunk))
                if not b:
                    raise ConnectionError(f"{name}: peer closed mid-blob")
                h.update(b)
                f.write(b)
                left -= len(b)
            f.flush()
            os.fsync(f.fileno())
        _M_RBYTES.inc(plen, dir="in", kind=kind)
        torn_flag = 0 if h.hexdigest() == want_sha else 1
        self._repl_stage(header.get("lid"), "repl.recv", start=t_recv,
                         duration_s=time.perf_counter() - r0,
                         generation=_gen_of(name), kind=kind, bytes=plen, torn=torn_flag)
        if h.hexdigest() != want_sha:
            try:
                os.replace(tmp, os.path.join(self.plane.dir, name + ".quarantine"))
            except OSError:
                pass
            log.warning("plane replication: %s torn in transit (sha256 %s != %s); "
                        "quarantined, re-requesting", name, h.hexdigest()[:12], want_sha[:12])
            return name, False
        os.replace(tmp, os.path.join(self.plane.dir, name))
        return name, True

    def _flip(self, manifest: Dict[str, Any]) -> bool:
        """Flip the local manifest to the replicated generation under the
        plane's publish lock, then GC as a publisher would.  False when the
        chain is incomplete locally (the caller re-syncs)."""
        if not isinstance(manifest, dict) or "generation" not in manifest \
                or "file" not in manifest:
            raise ConnectionError("flip without a usable manifest")
        gen = int(manifest["generation"])
        lid = _manifest_lid(manifest)
        t_ver = time.time()
        v0 = time.perf_counter()
        try:
            self.plane.chain_files(str(manifest["file"]))
        except _PlaneCorrupt as e:
            log.warning("plane replication: not flipping to generation %d, the chain is "
                        "incomplete locally (%s)", gen, e)
            return False
        self._repl_stage(lid, "repl.verify", start=t_ver,
                         duration_s=time.perf_counter() - v0, generation=gen)
        doc = dict(manifest)
        doc[REPLICA_KEY] = self.source
        doc["publisherPid"] = os.getpid()
        doc["replicatedAt"] = time.time()
        t_land = time.time()
        l0 = time.perf_counter()
        with self.plane._publish_lock():
            local = self.plane.current()
            if (local is not None and REPLICA_KEY not in local
                    and int(local.get("generation") or 0) >= gen):
                raise RuntimeError(f"plane dir {self.plane.dir} was taken over by a local "
                                   "publisher mid-stream; refusing to fight it")
            self.plane._write_manifest(doc)
            kf = doc.get("keyframeGeneration")
            self.plane._gc_keyframes[gen] = int(kf) if kf else gen
            self.plane._gc(gen)
        self.generation = gen
        self.last_flip_at = time.time()
        # repl.land is a subscriber's publish-equivalent marker: lineage
        # supersession closes pre-resync records against it
        self._repl_stage(lid, "repl.land", start=t_land,
                         duration_s=time.perf_counter() - l0, generation=gen, flush=True)
        if lid:
            try:
                rec = _obs_lineage.get_lineage()
                if rec.enabled:
                    rec.note_generation(str(lid), gen)
            except Exception:
                pass
        with self._flip_cond:
            self._flip_cond.notify_all()
        log.info("plane replication: generation %d live locally (%s)", gen,
                 manifest.get("file"))
        return True
