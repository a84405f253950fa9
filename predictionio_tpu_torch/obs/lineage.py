"""Generation lineage: cross-process freshness tracing (counterpart of
``predictionio_tpu/obs/lineage.py``, whose record files and documents it
reads and writes).

The flight recorder (``obs.tracing``) traces one REQUEST inside one process; the
streaming pipeline now spans a follower loop, a dedicated publisher
process, and K prefork serving workers.  This module traces one MODEL
GENERATION across all of them: every fold tick mints a lineage id
(``ln-<hex>``), carried through the publish job, the delta-arena
manifest header (``plane.py`` writes it into ``meta["info"]``;
``PlaneWatcher`` reads it back after compose), and closed by each
worker at install plus at the first query served against that
generation — yielding an exact per-generation waterfall::

    append_observed -> fold.apply -> fold.rellr -> fold.emit ->
    publish -> plane.write -> watcher_wake -> compose ->
    install (per worker, + cache_invalidation child) ->
    first_serve (per worker)

Each process appends *stages* to a bounded record ring persisted to
``<lineage dir>/<worker tag>.json`` (the same sibling-merge pattern as
``/metrics`` and ``/traces.json``), so ANY worker can answer
``/lineage.json`` (index) and ``/lineage/<gen>.json`` (full waterfall)
for the whole group: the merge unions every process's stages by lineage
id.  A record whose origin process died mid-publish (SIGKILL) is left
``open`` on disk; the merge closes it as ``abandoned`` as soon as a
newer generation reaches publish — no cooperation from the dead process
needed, nothing leaks.

Lineage dir precedence (:func:`lineage_dir`): ``PIO_LINEAGE_DIR``, else
``<PIO_METRICS_DIR>/lineage`` (prefork groups), else ``<storage
localfs/sharedfs METADATA path>/lineage``, else in-memory only.  Kill
switch: ``PIO_LINEAGE=off``.  This propagation contract is what the
multi-node fabric (ROADMAP item 1) will reuse verbatim: a replicated
manifest carries the same ``lineageId`` to other kernels.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import uuid
from collections import deque
from pathlib import Path
from typing import Dict, List, Optional

from predictionio_tpu_torch.obs import metrics as _metrics

_REG = _metrics.get_registry()
_M_RECORDS = _REG.counter(
    "pio_lineage_records_total",
    "Lineage records begun by this process (one per fold tick that "
    "reached the fold stage)")
_M_STAGES = _REG.counter(
    "pio_lineage_stages_total",
    "Lineage stages recorded by this process, by stage name")

# stage order used to sanity-sort ties and by renderers; merge order is
# by wall-clock start, this is only the canonical pipeline sequence.
# The repl.* stages are the replication channel's hops on a subscriber
# node (plan is publisher-side, per peer): the cross-node stretch of the
# same waterfall.
STAGE_ORDER = (
    "append_observed", "fold.apply", "fold.rellr", "fold.emit",
    "publish", "plane.write", "repl.plan", "repl.recv", "repl.verify",
    "repl.land", "watcher_wake", "compose", "install",
    "cache_invalidation", "first_serve",
)
# a record is complete once the publish side AND at least one worker's
# install + first-serve are visible in the merged view.  repl.land
# counts as publish-equivalent: on a subscriber node the replicated
# flip IS the publish (the publisher's own stages may not be visible
# locally), which also lets supersession close a reconnecting
# subscriber's pre-resync orphans (see merge_records).
_PUBLISH_STAGES = frozenset({"publish", "plane.write", "repl.land"})


def cluster_node() -> Optional[str]:
    """This process's cluster node name (PIO_CLUSTER_NODE; deploy sets
    it whenever replication is wired).  None = single-node deployment —
    stages carry no node field and nothing changes."""
    return os.environ.get("PIO_CLUSTER_NODE") or None


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def lineage_dir(storage=None) -> Optional[Path]:
    """Where this process persists lineage records for siblings (see
    module docstring for the precedence); None = in-memory ring only."""
    env = os.environ.get("PIO_LINEAGE_DIR")
    if env:
        return Path(env)
    md = os.environ.get("PIO_METRICS_DIR")
    if md:
        return Path(md) / "lineage"
    if storage is not None:
        try:
            src = storage.config.sources[storage.config.repositories["METADATA"]]
            if src.get("type") in ("localfs", "sharedfs") and src.get("path"):
                return Path(src["path"]) / "lineage"
        except (KeyError, AttributeError):
            pass
    return None


class LineageRecorder:
    """Per-process bounded record ring + the cross-process merge.

    Thread-safe; every mutator tolerates an unknown lineage id by
    creating a *partial* record (a serving worker contributes install/
    first-serve stages for a generation whose record was begun in the
    publisher process — the merge reunites them by id)."""

    # stage writes within this window coalesce into one ring write;
    # begin/close/flush-flagged stages persist immediately so a SIGKILL
    # can lose at most a window of *intermediate* stages, never the
    # record itself
    PERSIST_THROTTLE_S = 0.5

    def __init__(self, ring: Optional[int] = None,
                 directory: Optional[os.PathLike] = None,
                 tag: Optional[str] = None,
                 enabled: Optional[bool] = None):
        if enabled is None:
            enabled = os.environ.get("PIO_LINEAGE", "").lower() not in (
                "off", "0", "false")
        self.enabled = enabled
        size = ring if ring is not None else max(
            _env_int("PIO_LINEAGE_RING", 64), 1)
        self._ring: deque = deque(maxlen=size)
        self._lock = threading.Lock()
        self._io_lock = threading.Lock()
        self.dir: Optional[Path] = Path(directory) if directory else None
        self._tag = tag
        self._dirty = False
        self._last_persist = 0.0
        self._flush_timer: Optional[threading.Timer] = None

    @property
    def tag(self) -> str:
        return self._tag or _metrics.worker_tag()

    def configure(self, directory: Optional[os.PathLike],
                  tag: Optional[str] = None) -> None:
        with self._lock:
            self.dir = Path(directory) if directory else None
            if tag is not None:
                self._tag = tag

    # -- record lifecycle ----------------------------------------------------

    def new_id(self) -> str:
        return f"ln-{uuid.uuid4().hex[:12]}"

    def _find(self, lid: str) -> Optional[dict]:
        for doc in reversed(self._ring):
            if doc.get("lid") == lid:
                return doc
        return None

    def _ensure(self, lid: str, origin: bool) -> dict:
        doc = self._find(lid)
        if doc is None:
            doc = {"lid": lid, "start": time.time(), "generation": None,
                   "outcome": "open", "stages": []}
            if origin:
                doc["origin"] = self.tag
            self._ring.append(doc)
        elif origin and "origin" not in doc:
            doc["origin"] = self.tag
        return doc

    def begin(self, lid: str, start: Optional[float] = None) -> None:
        """Open a lineage record in THIS process (the fold tick's
        origin).  Persisted immediately: a publisher SIGKILLed
        mid-publish leaves the open record on disk for the merge to
        close as ``abandoned``."""
        if not self.enabled:
            return
        with self._lock:
            doc = self._ensure(lid, origin=True)
            if start is not None:
                doc["start"] = float(start)
            self._dirty = True
        _M_RECORDS.inc()
        self._persist()

    def stage(self, lid: str, name: str, start: Optional[float] = None,
              duration_s: float = 0.0, parent: Optional[str] = None,
              flush: bool = False, node: Optional[str] = None,
              **attrs) -> None:
        """Append one stage to ``lid``'s record (creating a partial
        record when this process never saw ``begin`` — the cross-process
        case).  ``attrs`` values must be JSON-able scalars.  ``node``
        overrides the stage's cluster-node stamp (replication daemons
        hosting several logical nodes in one process); by default the
        stamp comes from PIO_CLUSTER_NODE at the source, so stitched
        records attribute every stage without ingest-time guessing."""
        if not self.enabled:
            return
        s: Dict = {"stage": name, "start": float(start if start is not None
                                                 else time.time()),
                   "duration_s": round(float(duration_s), 6),
                   "worker": self.tag}
        nd = node or cluster_node()
        if nd:
            s["node"] = nd
        if parent:
            s["parent"] = parent
        if attrs:
            s["attrs"] = attrs
        with self._lock:
            doc = self._ensure(lid, origin=False)
            doc["stages"].append(s)
            if doc["start"] > s["start"]:
                doc["start"] = s["start"]
            self._dirty = True
        _M_STAGES.inc(1, stage=name)
        if flush:
            self._persist()
        else:
            self._request_persist()

    def note_generation(self, lid: str, generation: int) -> None:
        if not self.enabled:
            return
        with self._lock:
            doc = self._ensure(lid, origin=False)
            doc["generation"] = int(generation)
            self._dirty = True
        self._request_persist()

    def close(self, lid: str, outcome: str = "published") -> None:
        """Origin-side close after a successful publish; the merged
        outcome (`complete`/`abandoned`) is computed at read time from
        every process's stages."""
        if not self.enabled:
            return
        with self._lock:
            doc = self._ensure(lid, origin=True)
            doc["outcome"] = outcome
            self._dirty = True
        self._persist()

    def ingest(self, records, node: Optional[str] = None) -> int:
        """Merge record fragments received from ANOTHER node (the
        replication ack payload, or a federation pull of a subscriber's
        ``/lineage/<gen>.json``) into this process's ring — the
        publisher-side half of cross-node lineage stitching.  Only the
        raw fields (lid, start, generation, stages) are taken; derived
        fields (outcome, workers, durationMs) are recomputed at merge
        time.  Stages dedupe on the merge key, so re-ingesting the same
        fragment (push + pull overlap, shared-dir topologies) is a
        no-op.  Node attribution is SOURCE-stamped only — a stage
        without a ``node`` field stays unattributed rather than being
        guessed from the sender (``node`` here is informational): in a
        shared-lineage-dir topology a subscriber's fragment can carry
        the publisher's own stages back, and stamping those with the
        sender's name would mark its lane complete for work it never
        did.  Returns the number of stages actually added."""
        if not self.enabled:
            return 0
        added = 0
        with self._lock:
            for rdoc in records or ():
                lid = rdoc.get("lid")
                if not isinstance(lid, str) or not lid.startswith("ln-"):
                    continue
                doc = self._ensure(lid, origin=False)
                seen = {(s.get("stage"), s.get("worker"),
                         round(float(s.get("start") or 0), 6))
                        for s in doc["stages"]}
                for s in rdoc.get("stages", ()):
                    if not isinstance(s, dict) or not s.get("stage"):
                        continue
                    key = (s.get("stage"), s.get("worker"),
                           round(float(s.get("start") or 0), 6))
                    if key in seen:
                        continue
                    seen.add(key)
                    cp = {"stage": str(s["stage"]),
                          "start": float(s.get("start") or 0),
                          "duration_s": round(
                              float(s.get("duration_s") or 0), 6),
                          "worker": str(s.get("worker") or "")}
                    if s.get("node"):
                        cp["node"] = str(s["node"])
                    if s.get("parent"):
                        cp["parent"] = str(s["parent"])
                    if isinstance(s.get("attrs"), dict):
                        cp["attrs"] = dict(s["attrs"])
                    doc["stages"].append(cp)
                    if doc["start"] > cp["start"] > 0:
                        doc["start"] = cp["start"]
                    added += 1
                if rdoc.get("generation") is not None \
                        and doc.get("generation") is None:
                    try:
                        doc["generation"] = int(rdoc["generation"])
                    except (TypeError, ValueError):
                        pass
            if added:
                self._dirty = True
        if added:
            self._request_persist()
        return added

    def export(self, limit: int = 8) -> List[dict]:
        """The newest merged records as raw push fragments (the ack
        payload a subscriber ships back to its publisher): only the raw
        fields ingest() accepts, bounded to the last ``limit`` records
        so an ack stays a few KB."""
        out = []
        for d in self.merged()[:max(limit, 1)]:
            out.append({"lid": d.get("lid"), "start": d.get("start"),
                        "generation": d.get("generation"),
                        "stages": d.get("stages", [])})
        return out

    # -- persistence + cross-process merge -----------------------------------

    def _request_persist(self) -> None:
        if self.dir is None:
            return
        delay = self.PERSIST_THROTTLE_S - (
            time.monotonic() - self._last_persist)
        if delay <= 0:
            self._persist()
            return
        with self._lock:
            if self._flush_timer is not None:
                return
            t = self._flush_timer = threading.Timer(delay, self._timer_flush)
            t.daemon = True
        t.start()

    def _timer_flush(self) -> None:
        with self._lock:
            self._flush_timer = None
        self.flush()

    def _persist(self) -> None:
        if self.dir is None:
            return
        with self._io_lock:
            with self._lock:
                payload = {"worker": self.tag, "flushedAt": time.time(),
                           "records": [dict(d, stages=list(d["stages"]))
                                       for d in self._ring]}
                self._dirty = False
            self._last_persist = time.monotonic()
            path = self.dir / f"{self.tag}.json"
            tmp = path.with_name(path.name + f".tmp{os.getpid()}")
            try:
                os.makedirs(self.dir, exist_ok=True)
                with open(tmp, "w") as f:
                    json.dump(payload, f)
                os.replace(tmp, path)
            except OSError:
                with self._lock:
                    self._dirty = True
                with contextlib.suppress(OSError):
                    os.unlink(tmp)

    def flush(self) -> None:
        if self._dirty:
            self._persist()

    def _sibling_docs(self) -> List[dict]:
        if self.dir is None:
            return []
        self.flush()
        try:
            names = [n for n in os.listdir(self.dir) if n.endswith(".json")]
        except OSError:
            return []
        docs: List[dict] = []
        now = time.time()
        stale_after = _metrics.sibling_stale_s()
        for name in names:
            path = self.dir / name
            try:
                mtime = os.stat(path).st_mtime
            except OSError:
                continue
            if now - mtime > stale_after:
                # a dead group member's leftovers; never our own file
                # (our live ring re-creates it on the next flush)
                if name != f"{self.tag}.json":
                    try:
                        os.unlink(path)
                        _metrics.STALE_SIBLINGS.inc(1, kind="lineage")
                    except OSError:
                        pass
                continue
            try:
                with open(path) as f:
                    payload = json.load(f)
                docs.extend(payload.get("records", ()))
            except (OSError, json.JSONDecodeError):
                continue   # sibling mid-write; next read heals
        return docs

    def merged(self) -> List[dict]:
        """Cross-process merged records, newest first: stages unioned by
        lineage id across every sibling's persisted ring + our live one,
        with the merged outcome computed (see :func:`merge_records`)."""
        with self._lock:
            own = [dict(d, stages=list(d["stages"])) for d in self._ring]
        return merge_records(self._sibling_docs() + own)

    def index(self, limit: int = 100) -> dict:
        """The /lineage.json body: merged per-generation summaries,
        newest first (cluster-annotated when a provider is armed)."""
        entries = []
        for d in self.merged()[:limit]:
            annotate_cluster(d)
            entry = {
                "lid": d.get("lid"),
                "generation": d.get("generation"),
                "start": d.get("start"),
                "outcome": d.get("outcome"),
                "origin": d.get("origin"),
                "workers": d.get("workers"),
                "stageCount": len(d.get("stages", ())),
                "durationMs": d.get("durationMs"),
            }
            cl = d.get("cluster")
            if cl:
                entry["cluster"] = {"expected": len(cl["expected"]),
                                    "done": len(cl["done"]),
                                    "missing": cl["missing"]}
            entries.append(entry)
        return {"worker": self.tag, "records": entries}

    def get(self, lid: str) -> Optional[dict]:
        for d in self.merged():
            if d.get("lid") == lid:
                return annotate_cluster(d)
        return None

    def get_generation(self, generation: int) -> Optional[dict]:
        """The merged record of one plane/server generation; when a
        generation id was reused across deployments, the record with the
        most stages (then newest) wins."""
        best = None
        for d in self.merged():
            if d.get("generation") != generation:
                continue
            if best is None or (len(d.get("stages", ())),
                                d.get("start", 0)) > (
                                    len(best.get("stages", ())),
                                    best.get("start", 0)):
                best = d
        return annotate_cluster(best)


def merge_records(docs: List[dict]) -> List[dict]:
    """Union per-process record fragments by lineage id.

    Stages dedupe on (stage, worker, start) — a stage persisted by both
    the origin's ring and a re-read of its own file appears once.  The
    merged outcome:

    - ``complete``  — a publish-side stage plus at least one worker's
      install AND first_serve are visible;
    - ``published`` — the origin closed it but no worker has served
      against it yet;
    - ``abandoned`` — still open, and a NEWER record reached publish:
      the origin died (or gave up) mid-flight — the supersession is the
      close, so dead publishers leak nothing;
    - ``open``      — still in flight (the newest record while a fold
      or publish is running).

    On a subscriber node ``repl.land`` is the publish-equivalent marker
    (the replicated flip IS the local publish), so supersession closes
    a reconnecting subscriber's pre-resync orphans — a record whose
    transfer was cut short (repl.recv with no land) goes ``abandoned``
    as soon as a newer generation lands, exactly like the SIGKILLed
    publisher case.
    """
    by_lid: Dict[str, dict] = {}
    for doc in docs:
        lid = doc.get("lid")
        if not lid:
            continue
        tgt = by_lid.get(lid)
        if tgt is None:
            tgt = by_lid[lid] = {
                "lid": lid, "start": doc.get("start", 0),
                "generation": None, "outcome": "open",
                "origin": None, "_seen": set(), "stages": []}
        if doc.get("start") and doc["start"] < tgt["start"]:
            tgt["start"] = doc["start"]
        if doc.get("origin") and not tgt["origin"]:
            tgt["origin"] = doc["origin"]
        if doc.get("generation") is not None:
            g = int(doc["generation"])
            if tgt["generation"] is None or g > tgt["generation"]:
                tgt["generation"] = g
        if doc.get("outcome") not in (None, "open"):
            tgt["outcome"] = doc["outcome"]
        for s in doc.get("stages", ()):
            key = (s.get("stage"), s.get("worker"),
                   round(float(s.get("start") or 0), 6))
            if key in tgt["_seen"]:
                continue
            tgt["_seen"].add(key)
            tgt["stages"].append(s)
    records = []
    for rec in by_lid.values():
        rec.pop("_seen")
        rec["stages"].sort(key=lambda s: (s.get("start", 0),
                                          _stage_rank(s.get("stage"))))
        names = {s.get("stage") for s in rec["stages"]}
        workers = sorted({s.get("worker") for s in rec["stages"]
                          if s.get("worker")})
        rec["workers"] = workers
        published = bool(names & _PUBLISH_STAGES) \
            or rec["outcome"] == "published"
        if published and "install" in names and "first_serve" in names:
            rec["outcome"] = "complete"
        elif published:
            rec["outcome"] = "published"
        rec["_published"] = published
        if rec["stages"]:
            end = max(s.get("start", 0) + s.get("duration_s", 0)
                      for s in rec["stages"])
            rec["durationMs"] = round(max(end - rec["start"], 0) * 1e3, 3)
        else:
            rec["durationMs"] = 0.0
        records.append(rec)
    # supersession closes orphans: an open record older than any record
    # that reached publish was abandoned by a dead/stuck origin
    latest_published = max(
        (r["start"] for r in records if r["_published"]), default=None)
    for rec in records:
        if not rec["_published"] and rec["outcome"] == "open" \
                and latest_published is not None \
                and rec["start"] < latest_published:
            rec["outcome"] = "abandoned"
        rec.pop("_published")
    records.sort(key=lambda r: r.get("start", 0), reverse=True)
    return records


def _stage_rank(name: Optional[str]) -> int:
    try:
        return STAGE_ORDER.index(name)
    except ValueError:
        return len(STAGE_ORDER)


# -- cluster stitching --------------------------------------------------------

def apply_cluster_outcome(doc: dict, expected,
                          live=None) -> dict:
    """Annotate one merged record with the cluster view: a per-node
    lane summary under ``doc["cluster"]`` and the stitched outcome —
    ``cluster_complete`` only when EVERY expected subscriber node's
    install + first_serve stages are visible; a record that completed
    on some nodes but still lags on another is demoted back to
    ``published`` (the cluster, not the node, is the unit of
    observation).  ``live`` (when given) distinguishes a lagging node
    that is still connected (lane ``open``) from one that died mid-
    transfer (lane ``abandoned``).  Mutates and returns ``doc``."""
    expected = sorted({str(n) for n in (expected or ()) if n})
    live_set = None if live is None else {str(n) for n in live}
    lanes: Dict[str, dict] = {
        n: {"names": set(), "stages": 0} for n in expected}
    serve_end = None
    for s in doc.get("stages", ()):
        if s.get("stage") == "first_serve":
            end = float(s.get("start") or 0) + float(
                s.get("duration_s") or 0)
            if serve_end is None or end > serve_end:
                serve_end = end
        lane = lanes.get(s.get("node"))
        if lane is not None:
            lane["names"].add(s.get("stage"))
            lane["stages"] += 1
    done, missing, nodes_doc = [], [], {}
    for n in expected:
        names = lanes[n]["names"]
        ok = "install" in names and "first_serve" in names
        (done if ok else missing).append(n)
        if ok:
            status = "complete"
        elif live_set is not None and n not in live_set:
            status = "abandoned"
        elif lanes[n]["stages"] == 0:
            status = "missing"
        else:
            status = "open"
        nodes_doc[n] = {"status": status, "stages": lanes[n]["stages"]}
    cluster = {"expected": expected, "done": done, "missing": missing,
               "nodes": nodes_doc}
    if expected:
        if not missing and doc.get("outcome") == "complete":
            doc["outcome"] = "cluster_complete"
            if serve_end is not None:
                cluster["propagationMs"] = round(max(
                    serve_end - float(doc.get("start") or 0), 0) * 1e3, 3)
        elif missing and doc.get("outcome") == "complete":
            doc["outcome"] = "published"
    doc["cluster"] = cluster
    return doc


# publisher-side hook: deploy --plane-publish registers a callable
# returning {"expected": [subscriber nodes ever seen], "live":
# [currently connected]} so every lineage read answers with the
# stitched cluster outcome; None = single-node semantics unchanged
_cluster_provider = None


def set_cluster_provider(fn) -> None:
    global _cluster_provider
    _cluster_provider = fn


def annotate_cluster(doc: Optional[dict]) -> Optional[dict]:
    """Apply the registered cluster view to one merged record; no-op
    when no provider is registered (single-node) or the view is
    empty."""
    if doc is None or _cluster_provider is None:
        return doc
    try:
        view = _cluster_provider()
    except Exception:
        return doc
    if view and view.get("expected"):
        apply_cluster_outcome(doc, view["expected"], view.get("live"))
    return doc


# -- process singleton --------------------------------------------------------

_lineage: Optional[LineageRecorder] = None
_lineage_lock = threading.Lock()


def get_lineage() -> LineageRecorder:
    global _lineage
    with _lineage_lock:
        if _lineage is None:
            _lineage = LineageRecorder()
        return _lineage


def set_lineage(recorder: Optional[LineageRecorder]) -> None:
    """Swap the process recorder (tests; None resets to lazy default)."""
    global _lineage
    with _lineage_lock:
        _lineage = recorder


def arm(storage=None, directory: Optional[os.PathLike] = None,
        tag: Optional[str] = None) -> LineageRecorder:
    """Point the process recorder at this deployment's lineage dir so
    records become visible to sibling workers and the dashboard;
    servers call this at startup (same contract as ``tracing.arm``)."""
    rec = get_lineage()
    rec.configure(
        directory if directory is not None else lineage_dir(storage), tag)
    return rec


def render_lineage_text(doc: dict, width: int = 44) -> str:
    """ASCII waterfall of one merged lineage record (``pio lineage``
    output): one row per stage, bars proportional to offset/duration
    within the generation's end-to-end span."""
    total_ms = max(float(doc.get("durationMs") or 0.0), 1e-6)
    t0 = float(doc.get("start") or 0.0)
    lines = [
        "generation %s lineage %s: %s in %.1f ms (origin %s, workers %s)"
        % (doc.get("generation", "?"), doc.get("lid", "?"),
           doc.get("outcome", "?"), total_ms, doc.get("origin", "?"),
           ",".join(doc.get("workers") or []) or "?")]
    for s in doc.get("stages", ()):
        off_ms = max((float(s.get("start", t0)) - t0) * 1e3, 0.0)
        dur_ms = float(s.get("duration_s", 0.0)) * 1e3
        i0 = min(int(off_ms / total_ms * width), width - 1)
        i1 = min(max(int((off_ms + dur_ms) / total_ms * width), i0 + 1),
                 width)
        bar = " " * i0 + "#" * (i1 - i0) + " " * (width - i1)
        name = ("  " if s.get("parent") else "") + str(s.get("stage", "?"))
        attrs = s.get("attrs") or {}
        attr_txt = (" " + " ".join(f"{k}={v}"
                                   for k, v in sorted(attrs.items()))
                    if attrs else "")
        lines.append("  %-20s %-14s %9.3f ms |%s|%s"
                     % (name[:20], str(s.get("worker", ""))[:14],
                        dur_ms, bar, attr_txt))
    if not doc.get("stages"):
        lines.append("  (no stages recorded)")
    return "\n".join(lines) + "\n"


def render_lineage_cluster_text(doc: dict, width: int = 44) -> str:
    """ASCII waterfall of one stitched record with a per-node lane
    (``pio lineage --cluster``): publisher lane first, then one lane
    per expected subscriber node, all bars on the shared time axis so
    a lagging node reads as a right-shifted lane."""
    cluster = doc.get("cluster") or {}
    nodes_doc = cluster.get("nodes") or {}
    total_ms = max(float(doc.get("durationMs") or 0.0), 1e-6)
    t0 = float(doc.get("start") or 0.0)
    head = ("generation %s lineage %s: %s in %.1f ms "
            "(cluster %d/%d nodes%s)"
            % (doc.get("generation", "?"), doc.get("lid", "?"),
               doc.get("outcome", "?"), total_ms,
               len(cluster.get("done") or ()),
               len(cluster.get("expected") or ()),
               ", propagation %.1f ms" % cluster["propagationMs"]
               if cluster.get("propagationMs") is not None else ""))
    lanes: Dict[Optional[str], List[dict]] = {None: []}
    for n in nodes_doc:
        lanes[n] = []
    for s in doc.get("stages", ()):
        lanes.setdefault(s.get("node") if s.get("node") in nodes_doc
                         else None, []).append(s)
    lines = [head]

    def emit(title: str, stages: List[dict]) -> None:
        lines.append(title)
        for s in stages:
            off_ms = max((float(s.get("start", t0)) - t0) * 1e3, 0.0)
            dur_ms = float(s.get("duration_s", 0.0)) * 1e3
            i0 = min(int(off_ms / total_ms * width), width - 1)
            i1 = min(max(int((off_ms + dur_ms) / total_ms * width),
                         i0 + 1), width)
            bar = " " * i0 + "#" * (i1 - i0) + " " * (width - i1)
            name = (("  " if s.get("parent") else "")
                    + str(s.get("stage", "?")))
            lines.append("  %-20s %-14s %9.3f ms |%s|"
                         % (name[:20], str(s.get("worker", ""))[:14],
                            dur_ms, bar))
        if not stages:
            lines.append("  (no stages recorded)")

    emit("-- publisher (origin %s)" % doc.get("origin", "?"), lanes[None])
    for n in sorted(nodes_doc):
        nd = nodes_doc[n]
        emit("-- node %s [%s, %d stages]"
             % (n, nd.get("status", "?"), nd.get("stages", 0)), lanes[n])
    return "\n".join(lines) + "\n"


# -- shared HTTP endpoints ----------------------------------------------------

def handle_lineage_request(handler, path: str) -> bool:
    """Serve /lineage.json and /lineage/<gen|lid>.json on any
    JsonHandler server; returns True when the path was one of ours.
    Unauthenticated like /metrics — lineage carries timing structure,
    not event payloads."""
    if path == "/lineage.json":
        rec = get_lineage()
        if not rec.enabled:
            handler.send_error_json(503, "lineage disabled (PIO_LINEAGE=off)")
            return True
        handler.send_json(rec.index())
        return True
    if path.startswith("/lineage/") and path.endswith(".json"):
        rec = get_lineage()
        if not rec.enabled:
            handler.send_error_json(503, "lineage disabled (PIO_LINEAGE=off)")
            return True
        token = path[len("/lineage/"):-len(".json")]
        if token.startswith("ln-"):
            doc = rec.get(token)
        else:
            try:
                doc = rec.get_generation(int(token))
            except ValueError:
                handler.send_error_json(
                    400, f"lineage key {token!r} is neither a generation "
                    "number nor an ln- id")
                return True
        if doc is None:
            handler.send_error_json(
                404, f"no lineage record for {token!r}")
        else:
            handler.send_json(doc)
        return True
    return False
