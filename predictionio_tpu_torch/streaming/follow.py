"""Resident follow-trainer: tail the event store, fold, hot-swap.

Counterpart of ``predictionio_tpu/streaming/follow.py``.  The
:class:`FollowTrainer` is the daemon behind ``pio train --follow`` and the
embedded updater behind ``pio deploy --follow SECS``.  Each tick it

1. tails the event store from its watermark (``scan_tail_from``: only the
   events past the watermark are parsed);
2. folds the delta into the live model (:mod:`streaming.fold`, on the
   trainer's device) or, when folding is unsupported for the engine or
   shape, retrains through the normal (delta-staged) path;
3. publishes the new generation: a COMPLETED EngineInstance and its model
   blob when ``persist`` (every ``--auto-reload`` deployment converges
   within its poll interval), and/or the in-process hot-swap callback
   ``on_publish`` (the query server swaps its predictor under its lock);
4. persists its watermark (``follow/<engine>-<variant>.json`` under a
   localfs METADATA source), so a restarted daemon re-reads exactly the
   covered prefix (``scan_events_up_to``), or restores its fold-state
   checkpoint, and folds only the unapplied suffix.

A tombstone change or a log-shape mismatch forces a full restage;
``PIO_FOLLOW_MAX_LAG_EVENTS`` bounds the delta folded incrementally.
``PIO_FOLLOW=off`` idles the loop.  On a backend without the delta-tail
protocol the trainer retrains every tick and says so (``mode`` is
``retrain`` in ``status()`` and ``pio_follow_state_mode``).  Knobs, with
the reference's defaults: ``PIO_FOLLOW_INTERVAL_S`` (2),
``PIO_FOLLOW_MAX_LAG_EVENTS`` (1M), ``PIO_FOLLOW_CHECKPOINT_S`` (60),
``PIO_FOLLOW_PIPELINE`` (on).

``add_publish_listener(fn)`` calls ``fn()`` after every publish: the plane
replicator's ``poke``, so a generation the in-process follower published
reaches the wire without waiting out a directory watch.

Not here: the reference's lineage stages and per-fold traces, which wait
for ROADMAP.md, queue A, 'Observability and the rest of the front end'
(the publish info carries no ``lineageId``).
"""

from __future__ import annotations

import datetime as _dt
import json
import logging
import os
import queue
import threading
import time
import uuid
import zlib
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np

from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.obs import metrics as _obs_metrics
from predictionio_tpu_torch.obs.metrics import LATENCY_BUCKETS
from predictionio_tpu_torch.storage.locator import Storage, get_storage
from predictionio_tpu_torch.streaming.fold import (
    FoldUnsupported,
    URFoldState,
    fold_state_impl,
)

log = logging.getLogger("pio.follow")

_REG = _obs_metrics.get_registry()
_M_FOLDS = _REG.counter(
    "pio_follow_folds_total",
    "Follow-trainer ticks by outcome: fold (incremental), retrain "
    "(full train through the delta-staged path), restage (tombstone/"
    "log-shape change or max-lag breach forced a full rebuild), idle "
    "(no new events), disabled (PIO_FOLLOW=off), error")
_M_FOLD_S = _REG.histogram(
    "pio_follow_fold_duration_seconds",
    "Wall time of one follow tick that published a generation, by "
    "mode: tail scan + fold/retrain + publish when synchronous; with "
    "the pipelined publisher, tail scan + fold only (emit/warm/publish "
    "run off-loop — see pio_follow_fold_phase_duration_seconds)",
    buckets=LATENCY_BUCKETS)
_M_LAG = _REG.gauge(
    "pio_follow_lag_events",
    "Unapplied events behind the live log at the last tick "
    "(0 after a successful fold — the freshness backlog)")
_M_PUBLISH_TS = _REG.gauge(
    "pio_follow_last_publish_timestamp_seconds",
    "Unix time of the last published model generation")
_M_GEN = _REG.gauge(
    "pio_model_generation",
    "Monotonic generation counter of the live model: bumped by every "
    "hot-swap (follow fold, auto-reload, manual /reload) — serving "
    "caches key on the model object this counts")
_M_STATE_BYTES = _REG.gauge(
    "pio_follow_state_bytes",
    "Resident fold-state bytes (sorted-COO counts + accumulated batch "
    "+ pair sets + popularity inputs + indicator tables) — what "
    "PIO_FOLLOW_STATE_BYTES bounds; 0 in retrain mode.  With the "
    "sparse state this grows with the EVENT count, not catalog**2")
_M_STATE_MODE = _REG.gauge(
    "pio_follow_state_mode",
    "Fold-state representation in use: 1 on the active mode label "
    "(sparse | dense | retrain), 0 on the others")
_M_PHASE_S = _REG.histogram(
    "pio_follow_fold_phase_duration_seconds",
    "Wall time of one fold tick's phases: apply (delta application + "
    "marginals), rellr (LLR + top-k recompute incl. the pruned "
    "certificate), emit (URModel construction + incremental serving-"
    "state carry), warm (embedded serving-bundle build + warm + swap), "
    "publish (durable instance/model persistence + watermark).  With "
    "the pipelined publisher, emit/warm/publish overlap the NEXT "
    "tick's apply/rellr",
    buckets=LATENCY_BUCKETS)


def follow_pipeline_enabled() -> bool:
    """``PIO_FOLLOW_PIPELINE=off`` keeps fold, emit, warm and publish on
    the loop thread.  On (the default), ``run_forever`` hands emit and
    publish to a publisher thread, so the next delta folds while the
    previous generation warms; a direct ``tick()`` stays synchronous."""
    return os.environ.get("PIO_FOLLOW_PIPELINE", "").lower() not in ("off", "0", "false")


def follow_interval_s() -> float:
    """``PIO_FOLLOW_INTERVAL_S``: seconds between ticks (default 2)."""
    try:
        return max(float(os.environ.get("PIO_FOLLOW_INTERVAL_S", "2.0")), 0.05)
    except ValueError:
        return 2.0


def follow_max_lag_events() -> int:
    """``PIO_FOLLOW_MAX_LAG_EVENTS``: a larger delta restages instead of
    folding (default 1M: a backlog that big means the follower was down)."""
    try:
        return max(int(os.environ.get("PIO_FOLLOW_MAX_LAG_EVENTS", "1000000")), 1)
    except ValueError:
        return 1_000_000


def follow_enabled() -> bool:
    """``PIO_FOLLOW=off`` idles a running follower without tearing it down."""
    return os.environ.get("PIO_FOLLOW", "").lower() not in ("off", "0", "false")


def follow_checkpoint_interval_s() -> float:
    """``PIO_FOLLOW_CHECKPOINT_S``: the least seconds between fold-state
    checkpoints (default 60; <= 0 disables them)."""
    try:
        return float(os.environ.get("PIO_FOLLOW_CHECKPOINT_S", "60"))
    except ValueError:
        return 60.0


def follow_state_path(storage: Storage, engine_id: str, variant: str) -> Optional[Path]:
    """Where the follower persists its watermark: ``follow/`` under a
    localfs METADATA source's path; None (in memory only) elsewhere."""
    try:
        src = storage.config.sources[storage.config.repositories["METADATA"]]
    except (KeyError, AttributeError):
        return None
    if src.get("type") not in ("localfs", "sharedfs") or not src.get("path"):
        return None
    safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in f"{engine_id}-{variant}")
    return Path(src["path"]) / "follow" / f"{safe}.json"


class FollowTrainer:
    """Resident trainer: tail → fold → hot-swap, forever, on ``device``
    (default ``"cuda"``: the fold's re-selection runs K2 and K3 there).

    ``on_publish(models, info)`` is the embedded hot-swap hook (the query
    server passes its ``swap_models``); ``persist=True`` records a
    COMPLETED EngineInstance and model blob per generation."""

    def __init__(self, engine, engine_params, engine_id: str,
                 engine_version: str = "1", engine_variant: str = "default",
                 engine_factory: str = "",
                 storage: Optional[Storage] = None,
                 interval: Optional[float] = None,
                 on_publish: Optional[Callable] = None,
                 persist: bool = True,
                 max_lag: Optional[int] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.engine = engine
        self.engine_params = engine_params
        self.engine_id = engine_id
        self.engine_version = engine_version
        self.engine_variant = engine_variant
        self.engine_factory = engine_factory or engine_id
        self.storage = storage or get_storage()
        self.interval = float(interval) if interval else follow_interval_s()
        self.on_publish = on_publish
        self.persist = persist
        self.max_lag = max_lag
        self.generation = 0
        self.instance_id: Optional[str] = None
        self.last_outcome = "init"
        self.last_fold_events = 0
        self.last_publish_at: Optional[float] = None
        self.bootstrap_events = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._backoff = 0.0
        # fold-mode state (None in retrain mode and before the bootstrap)
        self._fold: Optional[URFoldState] = None
        self._wm: Dict[str, int] = {}
        self._heads: Dict[str, dict] = {}
        self._tombstones = frozenset()
        self._retrain_count = -1
        # a generation whose fold succeeded but whose publish raised:
        # (models, mode, duration_s), retried first thing next tick (the
        # watermark has advanced, so a 0-event tick would otherwise idle
        # on a stale live model)
        self._pending: Optional[tuple] = None
        self._last_ckpt_at = 0.0
        self._ckpt_cost_s = 0.0
        self._state_bytes = 0
        self._state_mode = "retrain"
        # the pipelined publisher (run_forever only): one worker thread
        # emits and publishes generations in order, at most one queued
        # (backpressure on the fold loop)
        self._pub_queue: Optional[queue.Queue] = None
        self._pub_thread: Optional[threading.Thread] = None
        self._pub_lock = threading.Lock()
        self._pub_done = threading.Condition(self._pub_lock)
        self._pub_inflight = 0
        self._pub_failed = False
        # events covered by the last PUBLISHED generation (the drain
        # signal: with the pipeline the fold state runs ahead of serving)
        self._published_events: Optional[int] = None
        self._publish_listeners: list = []
        self._resolve_mode()
        self._state_path = (follow_state_path(self.storage, engine_id, engine_variant)
                            if persist else None)

    # -- mode / storage plumbing ---------------------------------------------

    def _resolve_mode(self) -> None:
        """Fold mode needs one URAlgorithm, the identity preparator, a UR
        data source and an event backend with the delta-tail protocol;
        anything else retrains per tick (still exact, still delta-staged)."""
        from predictionio_tpu_torch.models.universal_recommender.engine import (
            URAlgorithm,
            URDataSourceParams,
            URPreparator,
        )
        from predictionio_tpu_torch.storage.base import (
            StoreCapabilityError,
            delta_tail_supported,
        )

        self.mode = "retrain"
        self._algo = None
        _ds, prep, algos, _serving = self.engine.make_components(
            self.engine_params, device=self.device)
        ds_params = self.engine_params.data_source_params
        self.app_name = getattr(ds_params, "app_name", None)
        if self.app_name is None:
            raise FoldUnsupported("follow-trainer needs a data source with an app_name")
        backend = self.storage.l_events
        if delta_tail_supported(backend):
            self._backend = backend
        else:
            # loudly, once: every tick of this trainer is a full retrain
            self._backend = None
            log.warning(
                "event backend %s.%s does not support the delta-tail "
                "protocol (scan_tail_from/scan_events_up_to/"
                "tombstone_state): --follow degrades to full "
                "retrain-per-tick (%s)",
                type(backend).__module__, type(backend).__name__,
                StoreCapabilityError.__name__)
        if (len(algos) == 1 and type(algos[0]) is URAlgorithm
                and type(prep) is URPreparator
                and isinstance(ds_params, URDataSourceParams)
                and self._backend is not None):
            self.mode = "fold"
            self._algo = algos[0]
            self._ds_params = ds_params

    def _app_channel(self):
        app = self.storage.apps.get_by_name(self.app_name)
        if app is None:
            raise ValueError(f"app {self.app_name!r} does not exist")
        return app.id, None

    # -- watermark persistence ------------------------------------------------

    def _persist_state(self, wm: Optional[Dict] = None, heads: Optional[Dict] = None,
                       fold_events: Optional[int] = None) -> None:
        """Persist the watermark.  The pipelined publisher passes the
        positions of the generation it just published (the loop's
        ``self._wm`` may already describe a newer fold)."""
        if self._state_path is None:
            return
        from predictionio_tpu_torch.storage.snapshot import _fsync_write

        self._state_path.parent.mkdir(parents=True, exist_ok=True)
        _fsync_write(self._state_path, json.dumps({
            "version": 1,
            "watermark": self._wm if wm is None else wm,
            "heads": self._heads if heads is None else heads,
            "generation": self.generation,
            "instanceId": self.instance_id,
            "bootstrapEvents": self.bootstrap_events,
            "lastFoldEvents": self.last_fold_events if fold_events is None else fold_events,
            "updatedAt": _dt.datetime.now(_dt.timezone.utc).isoformat(),
        }, indent=1, sort_keys=True))

    def _load_state(self) -> Optional[dict]:
        if self._state_path is None:
            return None
        try:
            doc = json.loads(self._state_path.read_text())
        except (OSError, json.JSONDecodeError):
            return None
        if not isinstance(doc, dict) or "watermark" not in doc:
            return None
        return doc

    # -- pipelined publisher --------------------------------------------------
    #
    # run_forever (only) hands each folded generation to ONE worker thread
    # that emits and publishes it while the loop folds the next delta.
    # Jobs publish in fold order (one FIFO worker, at most one queued job);
    # each carries the watermark captured at its fold; the emit reads the
    # fold state through an _EmitSnapshot (copy-on-write arrays), so the
    # next _apply never mutates what it reads; a restage, a retrain
    # fallback and stop flush the queue first.

    def _start_publisher(self) -> None:
        if self._pub_queue is not None:
            return
        self._pub_queue = queue.Queue(maxsize=1)
        t = threading.Thread(target=self._publisher_loop, daemon=True,
                             name="pio-follow-publish")
        self._pub_thread = t
        t.start()

    def _publisher_loop(self) -> None:
        while True:
            try:
                job = self._pub_queue.get(timeout=0.25)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            if job is None:
                return
            try:
                # an abandoned generation breaks the emit chain (the next
                # snapshot's hints describe only its own fold): skip every
                # job until the loop restages and clears the flag
                if not self._pub_failed:
                    self._process_publish_job(job)
            finally:
                with self._pub_lock:
                    self._pub_inflight -= 1
                    self._pub_done.notify_all()

    def _process_publish_job(self, job: dict) -> None:
        attempts = 0
        while not self._stop.is_set():
            try:
                models = job.get("models")
                if models is None:
                    t0 = time.perf_counter()
                    # the job pins its state: a loop-thread restage nulling
                    # self._fold must not strand an in-flight emit
                    models = [job["state"].emit_snapshot(job["snap"])]
                    _M_PHASE_S.observe(time.perf_counter() - t0, phase="emit")
                    job["models"] = models   # a publish retry skips the emit
                self._publish(models, job["mode"], job["duration_s"], wm=job.get("wm"),
                              heads=job.get("heads"), fold_events=job.get("events"))
                self._published_events = job.get("covered")
                return
            except Exception:
                attempts += 1
                log.exception("pipelined publish failed (attempt %d/3)", attempts)
                if attempts >= 3:
                    # a deterministic failure: the loop drops the fold
                    # state and restages, as after a synchronous failure
                    self._pub_failed = True
                    return
                self._stop.wait(min(self.interval * attempts, 10.0))

    def _enqueue_publish(self, job: dict) -> None:
        with self._pub_lock:
            self._pub_inflight += 1
        while True:
            try:
                self._pub_queue.put(job, timeout=0.25)
                return
            except queue.Full:
                if self._stop.is_set():
                    with self._pub_lock:
                        self._pub_inflight -= 1
                        self._pub_done.notify_all()
                    return

    def _flush_publishes(self, timeout: float = 600.0) -> bool:
        """Block until every enqueued generation has published (before any
        out-of-band rebuild, so publications stay ordered)."""
        if self._pub_queue is None:
            return True
        deadline = time.monotonic() + timeout
        with self._pub_lock:
            while self._pub_inflight > 0:
                rest = deadline - time.monotonic()
                if rest <= 0:
                    return False
                self._pub_done.wait(min(rest, 1.0))
        return True

    # -- fold-state checkpoint ------------------------------------------------
    #
    # Two files beside follow.json: <name>.ckpt.batch (the accumulated
    # batch, store.columnar.write_batch) and <name>.ckpt.npz (the numeric
    # state and a JSON meta), written batch first with a shared ckptId, so
    # the npz is the commit point: a crash between the renames leaves an
    # id mismatch and the loader falls back to the covered-prefix reparse.
    # The files are the JAX package's layout.

    def _ckpt_paths(self):
        if self._state_path is None:
            return None, None
        stem = self._state_path.with_suffix("")
        return (stem.parent / (stem.name + ".ckpt.npz"),
                stem.parent / (stem.name + ".ckpt.batch"))

    def _params_fingerprint(self) -> int:
        from predictionio_tpu_torch.controller.engine import serialize_engine_params

        blob = json.dumps(serialize_engine_params(self.engine_params), sort_keys=True,
                          default=str)
        return int(zlib.crc32(blob.encode()))

    def _maybe_checkpoint(self) -> None:
        interval = follow_checkpoint_interval_s()
        if (interval <= 0 or self.mode != "fold" or self._fold is None
                or self._state_path is None):
            return
        # the write is synchronous in the tick path, so its duty cycle is
        # bounded: never more than ~10% of the wall time
        effective = max(interval, 10.0 * self._ckpt_cost_s)
        if self._last_ckpt_at and time.monotonic() - self._last_ckpt_at < effective:
            return
        try:
            t0 = time.perf_counter()
            self._write_checkpoint()
            self._ckpt_cost_s = time.perf_counter() - t0
            self._last_ckpt_at = time.monotonic()
        except Exception:
            # a failed checkpoint never fails the publish that triggered it
            log.exception("fold-state checkpoint failed; restart will reparse "
                          "the covered prefix")

    def _write_checkpoint(self) -> None:
        from predictionio_tpu_torch.store.columnar import write_batch

        npz_path, batch_path = self._ckpt_paths()
        state = self._fold
        arrays, meta = state.checkpoint_arrays()
        ckpt_id = uuid.uuid4().hex
        meta.update({
            "ckptId": ckpt_id,
            "paramsFingerprint": self._params_fingerprint(),
            "watermark": dict(self._wm),
            "heads": dict(self._heads),
            "tombstones": sorted(self._tombstones),
            "followGeneration": self.generation,
            "instanceId": self.instance_id,
        })
        npz_path.parent.mkdir(parents=True, exist_ok=True)
        bt = batch_path.with_name(batch_path.name + ".tmp")
        write_batch(bt, state.batch, meta={"ckptId": ckpt_id})
        os.replace(bt, batch_path)
        nt = npz_path.with_name(npz_path.name + ".tmp")
        arrays = dict(arrays)
        arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), np.uint8).copy()
        with open(nt, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(nt, npz_path)
        log.info("fold-state checkpoint: %d events, %d B state", len(state.batch),
                 state.state_bytes())

    def _load_checkpoint(self):
        """(state, watermark, heads, tombstones, meta), or None: every
        validation failure logs its reason and falls back."""
        from predictionio_tpu_torch.store.columnar import read_batch

        npz_path, batch_path = self._ckpt_paths()
        if npz_path is None or not npz_path.exists() or not batch_path.exists():
            return None
        try:
            with np.load(npz_path) as npz:
                arrays = {k: npz[k] for k in npz.files}
            meta = json.loads(bytes(arrays.pop("meta_json")))
            if meta.get("paramsFingerprint") != self._params_fingerprint():
                log.info("fold-state checkpoint: engine params changed; ignoring it")
                return None
            conf = os.environ.get("PIO_FOLLOW_STATE", "").lower()
            if conf in ("sparse", "dense") and fold_state_impl() != meta.get("impl"):
                # an EXPLICIT representation wins over the persisted one
                log.info("fold-state checkpoint: PIO_FOLLOW_STATE=%s overrides the "
                         "checkpoint's %s representation; ignoring it", conf,
                         meta.get("impl"))
                return None
            # tombstones before the expensive restore: a delete while down
            # invalidates it all
            app_id, chan = self._app_channel()
            if self._backend.tombstone_state(app_id, chan) != frozenset(
                    meta.get("tombstones") or []):
                log.info("follow restart: tombstones changed while down; checkpoint "
                         "unusable, falling back to the watermark reparse")
                return None
            batch, _ids, bmeta = read_batch(batch_path, mmap=False)
            if bmeta.get("ckptId") != meta.get("ckptId"):
                log.info("fold-state checkpoint: batch/state id mismatch (torn); "
                         "ignoring it")
                return None
            state = URFoldState.restore_checkpoint(
                self._algo.params, self._ds_params, batch, arrays, meta,
                device=self.device)
        except Exception as e:
            # any corruption (a torn zip, a bad dtype, config drift) falls
            # back to the non-checkpoint restart, never crashes it
            log.warning("fold-state checkpoint unusable (%s); restart falls back to "
                        "the covered-prefix reparse", e)
            return None
        wm = {str(k): int(v) for k, v in (meta.get("watermark") or {}).items()}
        heads = dict(meta.get("heads") or {})
        tombs = frozenset(meta.get("tombstones") or [])
        return state, wm, heads, tombs, meta

    # -- bootstrap ------------------------------------------------------------

    def bootstrap(self) -> bool:
        """Make a model live: resume from a fold-state checkpoint, else
        from a persisted watermark (re-read the covered prefix, fold the
        suffix), else a full restage.  True once a model exists."""
        if self.mode != "fold":
            return self._retrain_tick(force=True) in ("retrain", "idle")
        prior = self._load_state()
        if self._bootstrap_from_checkpoint(prior):
            return True
        if prior is not None and self._bootstrap_from_watermark(prior):
            return True
        return self._restage(publish=True)

    def _bootstrap_from_checkpoint(self, prior: Optional[dict]) -> bool:
        """Resume from the persisted fold state, re-publish it to an
        embedded host, and fold only the events past its watermark."""
        loaded = self._load_checkpoint()
        if loaded is None:
            return False
        state, wm, heads, tombs, meta = loaded
        self._fold = state
        self._wm, self._heads = wm, heads
        self._tombstones = tombs
        self.generation = int((prior or {}).get("generation",
                                                meta.get("followGeneration", 0)))
        self.instance_id = (prior or {}).get("instanceId", meta.get("instanceId"))
        self.bootstrap_events = len(state.batch)
        log.info("follow restart: restored fold state from checkpoint (%d covered "
                 "events, %d B, generation %d); folding only the unapplied suffix",
                 len(state.batch), state.state_bytes(), self.generation)
        if self.on_publish is not None:
            self.on_publish([state.model], self._publish_info("restart"))
        self._published_events = len(state.batch)
        self._update_state_metrics()
        self.tick()
        return True

    def _bootstrap_from_watermark(self, prior: dict) -> bool:
        app_id, chan = self._app_channel()
        wm = {str(k): int(v) for k, v in prior["watermark"].items()}
        heads = prior.get("heads") or {}
        # tombstones before the scan: one landing mid-scan compares unequal
        # next tick and restages
        tombs = self._backend.tombstone_state(app_id, chan)
        res = self._backend.scan_events_up_to(app_id, chan, wm, heads=heads)
        if res is None:
            log.info("follow restart: the persisted watermark no longer matches the "
                     "log; full restage")
            return False
        try:
            self._fold = URFoldState.bootstrap(self._algo.params, self._ds_params,
                                               res["batch"], device=self.device)
        except (FoldUnsupported, ValueError) as e:
            log.warning("follow restart: bootstrap from the covered prefix failed "
                        "(%s); full restage", e)
            return False
        self._wm, self._heads = wm, heads
        self._tombstones = tombs
        self.generation = int(prior.get("generation", 0))
        self.instance_id = prior.get("instanceId")
        self.bootstrap_events = int(res["events"])
        log.info("follow restart: rebuilt state from %d covered events (generation "
                 "%d); folding the unapplied suffix", res["events"], self.generation)
        self._update_state_metrics()
        if self.on_publish is not None:
            self.on_publish([self._fold.model], self._publish_info("restart"))
        self._published_events = len(self._fold.batch)
        self.tick()
        return True

    def _restage(self, publish: bool) -> bool:
        """Full rebuild: read the whole log (snapshot first) and bootstrap."""
        if not self._flush_publishes():
            # a wedged publish could later install its older generation
            # over the restaged one: bail, the next tick retries
            log.warning("restage deferred: a pipelined publish has not drained")
            return False
        app_id, chan = self._app_channel()
        tombs = self._backend.tombstone_state(app_id, chan)
        res = self._backend.snapshot_scan(app_id, chan)
        if res is None:
            res = self._backend.scan_tail_from(app_id, chan, {}, base=None, heads=None)
        if res is None:
            return False
        try:
            t0 = time.perf_counter()
            self._fold = URFoldState.bootstrap(self._algo.params, self._ds_params,
                                               res["batch"], device=self.device)
        except ValueError as e:
            # no primary events yet, or a config error that recurs: log
            # every retry so the operator sees why nothing publishes
            log.warning("follow restage could not bootstrap (%s); retrying next tick", e)
            self._fold = None
            return False
        except FoldUnsupported as e:
            log.warning("fold unsupported (%s); falling back to retrain mode", e)
            self._fold = None
            self.mode = "retrain"
            return self._retrain_tick(force=True) == "retrain"
        self._wm = dict(res["watermark"])
        self._heads = dict(res.get("heads") or {})
        self._tombstones = tombs
        self.bootstrap_events = len(self._fold.batch)
        self.last_fold_events = len(self._fold.batch)
        self._last_ckpt_at = 0.0   # a fresh state deserves a prompt checkpoint
        if publish:
            self._publish_guarded([self._fold.model], "restage", time.perf_counter() - t0)
            self._published_events = len(self._fold.batch)
        return True

    # -- the tick -------------------------------------------------------------

    def tick(self) -> str:
        """One follow cycle; returns its outcome (also counted in
        pio_follow_folds_total)."""
        if not follow_enabled():
            self.last_outcome = "disabled"
            _M_FOLDS.inc(1, outcome="disabled")
            return "disabled"
        try:
            outcome = self._tick_inner()
        except Exception:
            log.exception("follow tick failed")
            self.last_outcome = "error"
            _M_FOLDS.inc(1, outcome="error")
            self._update_state_metrics()
            raise
        self.last_outcome = outcome
        _M_FOLDS.inc(1, outcome=outcome)
        self._update_state_metrics()
        return outcome

    def _update_state_metrics(self) -> None:
        """Refresh the fold-state gauges and their status() mirror."""
        if self.mode == "fold" and self._fold is not None:
            self._state_bytes = self._fold.state_bytes()
            self._state_mode = self._fold.state_mode
        else:
            self._state_bytes = 0
            self._state_mode = "retrain"
        _M_STATE_BYTES.set(self._state_bytes)
        for m in ("sparse", "dense", "retrain"):
            _M_STATE_MODE.set(1 if m == self._state_mode else 0, mode=m)

    def _tick_inner(self) -> str:
        if self._pending is not None:
            models, pmode, dur = self._pending
            self._publish(models, pmode, dur)
            self._pending = None
            if self.mode == "fold" and self._fold is not None:
                self._published_events = len(self._fold.batch)
            return pmode
        if self._pub_failed:
            # the publisher gave up on a generation: drop the state and
            # restage.  Flush first, so queued stale jobs drain as skips.
            self._flush_publishes()
            self._pub_failed = False
            log.warning("pipelined publish abandoned a generation; dropping fold "
                        "state and restaging")
            self._fold = None
        if self.mode != "fold":
            return self._retrain_tick()
        if self._fold is None:
            return "restage" if self._restage(publish=True) else "idle"
        if self._pub_queue is not None:
            # the loop thread's quiescent point (only it mutates the fold
            # state), where a checkpoint cannot race the next _apply
            self._maybe_checkpoint()
        app_id, chan = self._app_channel()
        t0 = time.perf_counter()
        tombs = self._backend.tombstone_state(app_id, chan)
        if tombs != self._tombstones:
            # folded events may be dead and the state cannot subtract
            log.info("follow: tombstone set changed; full restage")
            self._fold = None
            return "restage" if self._restage(publish=True) else "idle"
        tail = self._backend.scan_tail_from(app_id, chan, self._wm, base=self._fold.batch,
                                            heads=self._heads)
        if tail is None:
            log.info("follow: watermark no longer matches the log; full restage")
            self._fold = None
            return "restage" if self._restage(publish=True) else "idle"
        _M_LAG.set(tail["events"])
        if tail["events"] == 0:
            self._wm, self._heads = tail["watermark"], tail["heads"]
            return "idle"
        max_lag = self.max_lag or follow_max_lag_events()
        if tail["events"] > max_lag:
            log.info("follow: %d unapplied events exceed PIO_FOLLOW_MAX_LAG_EVENTS=%d; "
                     "full restage", tail["events"], max_lag)
            self._fold = None
            return "restage" if self._restage(publish=True) else "idle"
        pipelined = self._pub_queue is not None
        try:
            if pipelined:
                snap = self._fold.fold_apply(tail["batch"])
            else:
                model = self._fold.fold(tail["batch"])
        except FoldUnsupported as e:
            log.warning("fold unsupported mid-stream (%s); restaging in retrain mode", e)
            self._fold = None
            self.mode = "retrain"
            return self._retrain_tick(force=True)
        except Exception:
            # a partial apply cannot be trusted, and retrying the suffix on
            # it would double-fold: drop it, the next cycle restages
            self._fold = None
            raise
        for phase, dur in (self._fold.last_phase_s or {}).items():
            _M_PHASE_S.observe(dur, phase=phase)
        covered = len(self._fold.batch)
        self._wm, self._heads = tail["watermark"], tail["heads"]
        self.last_fold_events = int(tail["events"])
        if pipelined:
            self._enqueue_publish({
                "snap": snap, "state": self._fold, "mode": "fold",
                # tail scan + fold only: queue wait and publish retries
                # are not fold cost
                "duration_s": time.perf_counter() - t0,
                "covered": covered, "wm": dict(self._wm), "heads": dict(self._heads),
                "events": int(tail["events"]),
            })
        else:
            _M_PHASE_S.observe(self._fold.last_emit_s, phase="emit")
            self._publish_guarded([model], "fold", time.perf_counter() - t0)
            self._published_events = covered
        _M_LAG.set(0)
        return "fold"

    def _retrain_tick(self, force: bool = False) -> str:
        """The retrain path: a full ``Engine.train`` per tick (delta-staged
        by the staging cache), published as a fold is; the events it staged
        count by source in pio_train_staged_events_total, as a train's."""
        from predictionio_tpu_torch.store.event_store import staging_counts
        from predictionio_tpu_torch.workflow.core_workflow import _staging_delta, count_staged

        if not self._flush_publishes():
            log.warning("retrain deferred: a pipelined publish has not drained")
            return "idle"
        t0 = time.perf_counter()
        changed, commit = self._probe_store()
        if not force and not changed:
            commit()
            return "idle"
        before = staging_counts()
        models = self.engine.train(self.engine_params, device=self.device)
        staged = _staging_delta(before)
        count_staged(staged)
        log.info("follow: retrain tick staged %s", staged)
        # the probe's positions commit only now: a failed train leaves the
        # watermark behind, so the next tick retries the same suffix
        commit()
        self._publish_guarded(models, "retrain", time.perf_counter() - t0)
        return "retrain"

    def _probe_store(self):
        """The new-events probe of retrain mode: a watermark tail scan on a
        delta-tail backend, an event count elsewhere.  → ``(changed,
        commit)``; ``commit()`` applies the observed positions."""
        app_id, chan = self._app_channel()
        if self._backend is not None:
            tombs = self._backend.tombstone_state(app_id, chan)
            tomb_changed = tombs != self._tombstones
            tail = self._backend.scan_tail_from(app_id, chan, self._wm, base=None,
                                                heads=self._heads or None)
            if tail is None:
                def commit():
                    self._tombstones = tombs
                    self._wm, self._heads = {}, {}
                return True, commit
            _M_LAG.set(tail["events"])

            # positions commit even on a tombstone-only trigger: the
            # retrain reads the whole log
            def commit():
                self._tombstones = tombs
                self._wm, self._heads = tail["watermark"], tail["heads"]
            return tomb_changed or tail["events"] > 0, commit
        n = sum(1 for _ in self.storage.p_events.find(app_id))

        def commit():
            self._retrain_count = n
        return n != self._retrain_count, commit

    # -- publication ----------------------------------------------------------

    def _publish_info(self, mode: str) -> dict:
        return {
            "mode": mode,
            "generation": self.generation,
            "engineInstanceId": self.instance_id,
            "foldEvents": self.last_fold_events,
            "publishedAt": self.last_publish_at,
            "stateBytes": self._state_bytes,
            "stateMode": self._state_mode,
        }

    def _publish_guarded(self, models, mode: str, duration_s: float) -> None:
        """Publish, keeping the generation in ``_pending`` so a transient
        publish failure is retried first thing next tick."""
        self._pending = (models, mode, duration_s)
        self._publish(models, mode, duration_s)
        self._pending = None

    def _publish(self, models, mode: str, duration_s: float,
                 wm: Optional[Dict] = None, heads: Optional[Dict] = None,
                 fold_events: Optional[int] = None) -> None:
        """Publish one generation: the durable instance record (``persist``)
        and the in-process hot-swap (``on_publish``), then the watermark,
        which advances only after the generation it describes is out (a
        crash between the two re-folds, never skips)."""
        from predictionio_tpu_torch.controller.engine import serialize_engine_params
        from predictionio_tpu_torch.storage.base import EngineInstance
        from predictionio_tpu_torch.workflow import persistence

        self.generation += 1
        t_pub0 = time.perf_counter()
        t_warm = 0.0
        try:
            if self.persist:
                now = _dt.datetime.now(_dt.timezone.utc)
                params_json = serialize_engine_params(self.engine_params)
                instance = EngineInstance(
                    id="", status="TRAINING", start_time=now, end_time=None,
                    engine_id=self.engine_id, engine_version=self.engine_version,
                    engine_variant=self.engine_variant,
                    engine_factory=self.engine_factory,
                    data_source_params=params_json["data_source_params"],
                    preparator_params=params_json["preparator_params"],
                    algorithms_params=params_json["algorithms_params"],
                    serving_params=params_json["serving_params"])
                iid = self.storage.engine_instances.insert(instance)
                try:
                    persistence.save_models(self.storage, iid, models)
                    instance.status = "COMPLETED"
                    instance.end_time = _dt.datetime.now(_dt.timezone.utc)
                    self.storage.engine_instances.update(instance)
                except BaseException:
                    # the retry inserts a fresh row; this one must not
                    # linger TRAINING forever
                    try:
                        instance.status = "ABORTED"
                        instance.end_time = _dt.datetime.now(_dt.timezone.utc)
                        self.storage.engine_instances.update(instance)
                    except Exception:
                        log.exception("follow: could not mark instance %s ABORTED", iid)
                    raise
                self.instance_id = iid
            if self.on_publish is not None:
                tw = time.perf_counter()
                self.on_publish(models, self._publish_info(mode))
                t_warm = time.perf_counter() - tw
        except BaseException:
            # the retry re-runs _publish whole: generations advance by one
            # a published swap
            self.generation -= 1
            raise
        self.last_publish_at = time.time()
        for fn in list(self._publish_listeners):
            try:
                fn()
            except Exception:
                log.exception("follow: publish listener failed")
        if self.on_publish is None:
            # an embedded host's install sets pio_model_generation from the
            # server's generation (which counts reloads too)
            _M_GEN.set(self.generation)
        _M_PUBLISH_TS.set(self.last_publish_at)
        _M_FOLD_S.observe(duration_s, mode=mode)
        _M_PHASE_S.observe(t_warm, phase="warm")
        _M_PHASE_S.observe(max(time.perf_counter() - t_pub0 - t_warm, 0.0), phase="publish")
        self._persist_state(wm=wm, heads=heads, fold_events=fold_events)
        if self._pub_queue is None:
            # synchronous mode only: from the publisher thread a checkpoint
            # would race the loop's next _apply
            self._maybe_checkpoint()
        log.info("follow: published generation %d (%s, %d events, %.3fs)",
                 self.generation, mode, self.last_fold_events, duration_s)

    # -- loop / lifecycle -----------------------------------------------------

    def run_forever(self) -> None:
        """The blocking daemon loop, with exponential error backoff; with
        the pipeline on (default), each generation's emit, warm and publish
        run on the publisher thread."""
        while not self._stop.is_set():
            try:
                if self.mode == "fold" and self._fold is None and self.generation == 0:
                    self.bootstrap()   # publishes, and ticks when it lands
                    if follow_pipeline_enabled():
                        self._start_publisher()
                else:
                    if self._pub_queue is None and follow_pipeline_enabled():
                        self._start_publisher()
                    self.tick()
                self._backoff = 0.0
            except Exception:
                log.exception("follow cycle failed; backing off")
                self._backoff = min(max(self.interval, self._backoff * 2 or self.interval),
                                    60.0)
            self._stop.wait(self.interval + self._backoff)

    def add_publish_listener(self, fn: Callable[[], None]) -> None:
        """Call ``fn()`` (no arguments; its exceptions are logged) after
        every successful publish."""
        self._publish_listeners.append(fn)

    def start(self) -> threading.Thread:
        """Run the loop on a daemon thread (the embedded mode)."""
        t = threading.Thread(target=self.run_forever, daemon=True, name="pio-follow")
        self._thread = t
        t.start()
        return t

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        if self._pub_thread is not None:
            try:
                self._pub_queue.put_nowait(None)
            except queue.Full:
                pass   # the publisher's 0.25 s poll sees _stop
            self._pub_thread.join(timeout=timeout)

    def status(self) -> dict:
        """The freshness document's ``follower`` payload."""
        # one read: a concurrent tick may demote (self._fold = None)
        fold = self._fold
        covered = None
        if fold is not None:
            # with the pipeline, what the last PUBLISHED generation covers
            covered = (self._published_events
                       if self._pub_queue is not None and self._published_events is not None
                       else len(fold.batch))
        return {
            "mode": self.mode,
            "generation": self.generation,
            "lastOutcome": self.last_outcome,
            "lastFoldEvents": self.last_fold_events,
            "stateBytes": self._state_bytes,
            "stateMode": self._state_mode,
            # the events the live (published) model covers: the
            # deterministic drain signal; None in retrain mode
            "coveredEvents": covered,
            "lastPublishAt": (_dt.datetime.fromtimestamp(
                self.last_publish_at, _dt.timezone.utc).isoformat()
                if self.last_publish_at else None),
            "engineInstanceId": self.instance_id,
            "enabled": follow_enabled(),
            "intervalSeconds": self.interval,
        }
