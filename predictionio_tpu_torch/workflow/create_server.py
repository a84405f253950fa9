"""Query server — ``pio deploy``.

Counterpart of the serving half of
``predictionio_tpu/workflow/create_server.py`` (reference:
core/.../workflow/CreateServer.scala):

  POST /queries.json   query → predict → serve → JSON prediction
  GET  /               engine-instance info (HTML for a browser)
  GET  /reload         hot-swap to the newest COMPLETED instance
  GET  /stop           shut down (``pio undeploy``)
  GET  /metrics        Prometheus text (cross-worker aggregate)
  GET  /stats.json     per-(route, status) request windows

The server is the event-loop front end of ``api/http_util.py``.  With
``PIO_SERVE_BATCH`` on (``auto``, the default, turns it on when the
deployed models live on a CUDA device) the queries in flight at the same
time meet in ``_MicroBatcher`` and leave as one ``serve_batch_predict``
pass, so the card scores them in one launch.  ``--feedback`` writes every
answered query back as a ``predict`` event; ``--auto-reload SECS`` polls
the model store and installs a newer instance without dropping the port;
``--follow SECS`` hosts an embedded follow-trainer
(``streaming/follow.py``) that tails the event store every SECS, folds
the delta into the live model on the deploy's device and hot-swaps it
through ``QueryServerState.swap_models`` (the freshness document's
``follower`` key reports it); ``--workers N`` preforks N−1 more
processes on the same port (CPU only).

Each install re-arms the response cache (``serve/response_cache.py``)
on the new models inside the install's lock, before the new predictor
goes live: a swap keeps the entries its provenance proves unchanged (a
fold's ``_plane_prov``) and drops the rest (a reload or a retrain
flushes).  A UR model then answers repeated queries from the cache, on
``predict`` and on ``serve_batch_predict`` alike.

The model plane (``streaming/plane.py``): with a plane directory the
state's ``PlaneWatcher`` installs each generation published there, mapped
read-only and composed (on the card the install stages the device tables);
a ``/reload`` or the auto-reload poller publishes the new instance into the
plane once, the embedded follower publishes each fold there
(``plane_publish``) and serves the composed generation, and the freshness
document reports ``planeGeneration``, ``planePublish`` and the replication
role and lag.  ``deploy(plane_publish=)`` streams the plane to replication
subscribers (``streaming/replicate.py``), ``deploy(plane_from=)`` serves a
node-local plane fed by one.  A prefork group (``workers > 1``, CPU only)
shares one plane: no worker folds, a dedicated ``--plane-publisher``
process hosts the one follower.

Observability, as in the JAX package: ``GET /traces.json`` and
``/traces/<rid>.json`` (the flight recorder, ``obs/tracing.py``),
``/lineage.json`` and ``/lineage/<gen|ln-id>.json`` (``obs/lineage.py``:
each install stages ``install`` and ``cache_invalidation``, the next
answer ``first_serve``), ``/metrics/history.json`` (``obs/tsdb.py``),
``/cluster/{metrics,history}.json`` (a replication publisher's
federation, ``obs/cluster.py``) and ``/healthz`` (``obs/slo.py``).
"""

from __future__ import annotations

import datetime as _dt
import gc
import json
import logging
import os
import sys
import threading
import time
import uuid
from typing import Any, Callable, Dict, Optional, Sequence

from predictionio_tpu_torch.api import prefork
from predictionio_tpu_torch.api.http_util import JsonHandler, start_server
from predictionio_tpu_torch.obs import cluster as obs_cluster
from predictionio_tpu_torch.obs import lineage as obs_lineage
from predictionio_tpu_torch.obs import metrics as obs_metrics
from predictionio_tpu_torch.obs import slo as obs_slo
from predictionio_tpu_torch.obs import tracing as obs_tracing
from predictionio_tpu_torch.obs import tsdb as obs_tsdb
from predictionio_tpu_torch.obs.exposition import StatsCollector, metrics_payload
from predictionio_tpu_torch.obs.metrics import SIZE_BUCKETS
from predictionio_tpu_torch.serve import response_cache as _response_cache
from predictionio_tpu_torch.storage.locator import Storage, get_storage
from predictionio_tpu_torch.workflow import core_workflow
from predictionio_tpu_torch.workflow.create_workflow import (
    engine_from_variant,
    load_engine_variant,
    resolve_engine_id,
)

log = logging.getLogger("pio.queryserver")

_M_SERVE_BATCH = obs_metrics.get_registry().histogram(
    "pio_serve_batch_size",
    "Queries coalesced per micro-batch device dispatch",
    buckets=SIZE_BUCKETS)
_M_SERIAL_RERUNS = obs_metrics.get_registry().counter(
    "pio_serve_batch_serial_reruns_total",
    "Micro-batches whose batched pass raised and that were re-run one "
    "query at a time to isolate the failing query")
_M_GENERATION = obs_metrics.get_registry().gauge(
    "pio_model_generation",
    "Monotonic generation counter of the live model: bumped by every "
    "hot-swap (follow fold, auto-reload, manual /reload) — serving "
    "caches key on the model object this counts")


def _to_jsonable(obj: Any) -> Any:
    if hasattr(obj, "to_json"):
        return obj.to_json()
    if isinstance(obj, (dict, list, str, int, float, bool)) or obj is None:
        return obj
    if hasattr(obj, "__dict__"):
        return obj.__dict__
    return str(obj)


# How long a queued query waits for its result before giving up; only a
# dead leader should trip it.  Module-level so tests can shrink it.
_WAIT_TIMEOUT_S = 600.0


class _MicroBatcher:
    """Group-commit micro-batching of concurrent queries, across
    requests, handler threads and connections.

    The first thread into an idle batcher becomes the leader and at once
    runs whatever is queued (usually just itself); queries arriving while
    a batch runs coalesce into the next batch, which the same leader runs
    before it releases leadership.  No timer and no added latency for a
    lone query: the batch size follows the load, as a storage group
    commit does.  On the card a batch of B queries is one K1 launch and
    one readback instead of B.

    A handler thread blocks here until its query is served, so at most
    ``PIO_HTTP_POOL`` queries of one server can be queued at once: the
    handler pool caps the batch.

    ``PIO_SERVE_BATCH_WINDOW_MS`` (default 0) makes the leader dwell that
    long before its first batch, trading a bounded p50 cost for larger
    batches; 0 keeps the pure group commit.
    """

    def __init__(self, run_batch: Callable, run_one: Callable,
                 max_batch: Optional[int] = None,
                 window_s: Optional[float] = None):
        from predictionio_tpu_torch.controller.engine import DEFAULT_SERVE_BATCH

        if max_batch is None:
            max_batch = DEFAULT_SERVE_BATCH
        if window_s is None:
            try:
                window_s = float(os.environ.get("PIO_SERVE_BATCH_WINDOW_MS", "0")) / 1e3
            except ValueError:
                window_s = 0.0
        self._run = run_batch
        self._run_one = run_one
        self._max = max_batch
        self._window = max(0.0, window_s)
        self._lock = threading.Lock()
        self._queue: list = []
        self._leader_active = False

    def predict(self, query: Any) -> Any:
        item = {"q": query, "ev": threading.Event()}
        with self._lock:
            self._queue.append(item)
            lead = not self._leader_active
            if lead:
                self._leader_active = True
        while True:
            if lead:
                self._lead_until_served(item)
                lead = False  # leading guarantees our item was served
            if "r" in item or "e" in item:
                break
            # re-arm, then re-check BOTH wake sources under ONE lock hold.
            # Result writers assign r/e before set(), so a set() racing
            # our clear() is caught by the r/e re-check.  Leadership
            # nudges set() WITHOUT writing a result (a clear() could
            # swallow one), so the vacancy itself is probed too: with no
            # leader active we claim the lead.  The r/e check shares the
            # claim's lock hold: results are written before leadership is
            # released, so a served waiter can never become a leader that
            # withholds its own finished result.
            item["ev"].clear()
            with self._lock:
                if "r" in item or "e" in item:
                    break
                lead = not self._leader_active
                if lead:
                    self._leader_active = True
            if lead:
                continue
            if not item["ev"].wait(timeout=_WAIT_TIMEOUT_S):
                with self._lock:
                    if item in self._queue:
                        self._queue.remove(item)
                    served = "r" in item or "e" in item
                    # about to inherit leadership: pass the wake on so the
                    # remaining waiters are not stranded
                    nxt = (self._queue[0]
                           if not served and not self._leader_active
                           and self._queue else None)
                if nxt is not None:
                    nxt["ev"].set()
                if not served:
                    raise TimeoutError(
                        "micro-batch not served within %.0f s (leader died?)"
                        % _WAIT_TIMEOUT_S)
                continue
            # woken: the loop re-checks the result and the vacancy
        if "e" in item:
            raise item["e"]
        return item["r"]

    def _lead_until_served(self, own: dict) -> None:
        """Run batches until ``own`` is served, then RELEASE leadership
        and nudge the head waiter to re-claim it under the lock.
        Leadership rotates (draining the queue to empty would starve the
        leader's own client under sustained load) and is never handed to
        a given thread: the nudged waiter may have timed out and left,
        and ``_leader_active`` would then stay True forever."""
        if self._window:
            time.sleep(self._window)
        while True:
            with self._lock:
                batch = self._queue[: self._max]
                del self._queue[: self._max]
                if not batch:
                    self._leader_active = False
                    return
            _M_SERVE_BATCH.observe(len(batch))
            try:
                try:
                    results = self._run([i["q"] for i in batch])
                    # strict: a predictor returning the wrong count falls
                    # into the serial re-run, never leaves an item unserved
                    for i, r in zip(batch, results, strict=True):
                        i["r"] = r
                except Exception:
                    # one poisoned query must not fail its batchmates:
                    # re-run the batch serially so only the offender errors
                    _M_SERIAL_RERUNS.inc()
                    for i in batch:
                        try:
                            i["r"] = self._run_one(i["q"])
                        except Exception as e:
                            i["e"] = e
            except BaseException as exc:
                # SystemExit/KeyboardInterrupt escape the clauses above;
                # leadership and the batch's waiters must not leak with them
                err = RuntimeError(f"batch leader aborted: {exc!r}")
                for i in batch:
                    if "r" not in i and "e" not in i:
                        i["e"] = err
                with self._lock:
                    self._leader_active = False
                    nxt = self._queue[0] if self._queue else None
                if nxt is not None:
                    nxt["ev"].set()
                for i in batch:
                    i["ev"].set()
                raise
            served_self = own in batch
            if served_self:
                with self._lock:
                    self._leader_active = False
                    nxt = self._queue[0] if self._queue else None
                if nxt is not None:
                    nxt["ev"].set()  # wake to re-claim the released lead
            for i in batch:
                i["ev"].set()
            if served_self:
                return


def _batch_wanted(models: Sequence[Any]) -> bool:
    """``PIO_SERVE_BATCH``: on | off | auto (default).  Auto turns the
    micro-batcher on when the deployed models live on a CUDA device (a
    batch is one launch and one readback for B queries); on the CPU the
    batcher's coordination costs more than it saves.  ``off`` never looks
    at the models' device."""
    conf = os.environ.get("PIO_SERVE_BATCH", "auto").lower()
    if conf in ("1", "on", "true"):
        return True
    if conf != "auto":
        return False
    return any(getattr(getattr(m, "device", None), "type", None) == "cuda" for m in models)


class QueryServerState:
    """The deployed engine, its models and predictor; hot reload
    (reference: MasterActor hot-swapping engine instances).

    Models are loaded onto ``device`` (``reload`` and the auto-reload
    poller load onto the deploy's own device, never a default).  Given
    ``models``, the state serves them as they are and ``reload`` reads
    the model store."""

    def __init__(
        self,
        engine,
        engine_params,
        query_class,
        engine_id: str,
        engine_version: str = "1",
        engine_variant: str = "default",
        storage: Optional[Storage] = None,
        feedback: bool = False,
        feedback_app_name: str = "",
        plugins=None,
        auto_reload: float = 0.0,
        plane_dir: Optional[str] = None,
        device="cuda",
        models: Optional[Sequence[Any]] = None,
    ):
        from predictionio_tpu_torch.api.plugins import PluginRegistry

        self.plugins = PluginRegistry()
        self.engine = engine
        self.engine_params = engine_params
        self.query_class = query_class
        self.engine_id = engine_id
        self.engine_version = engine_version
        self.engine_variant = engine_variant
        self.storage = storage or get_storage()
        self.device = device
        self.feedback = feedback
        self.feedback_app_name = feedback_app_name
        self._lock = threading.Lock()
        self.instance = None
        self.models: list = []
        self.predictor: Optional[Callable] = None
        self.batcher: Optional[_MicroBatcher] = None
        self.query_count = 0
        self.started = _dt.datetime.now(_dt.timezone.utc)
        # every hot-swap installs NEW model objects and bumps this; the
        # serving caches live on the model objects, so the swap is their
        # invalidation
        self.generation = 0
        self.swapped_at: Optional[_dt.datetime] = None
        self.follower = None          # embedded FollowTrainer, if any
        self.follow_info: Optional[Dict] = None
        self._build_seq = 0           # install-order tickets (see _install)
        self._installed_seq = 0
        # (lineage id, generation) of the newest install whose
        # first_serve stage this worker still owes — grabbed by the
        # first predict() that runs on the new generation
        self._lineage_pending: Optional[tuple] = None
        # the model plane this state reads (streaming/plane.py), and the
        # replication endpoint this process hosts (a PlaneReplicator or a
        # PlaneSubscriber): freshness() reports both
        self.plane = None
        self.plane_watcher = None
        self.plane_generation = 0
        self.replication = None
        self._tune_gil_switch()
        if models is not None:
            self._install(list(models))
        else:
            self.reload()
        if plane_dir:
            from predictionio_tpu_torch.streaming.plane import ModelPlane, PlaneWatcher

            self.plane = ModelPlane(plane_dir, device=device)
            self.plane_watcher = PlaneWatcher(self.plane, self._install_plane)
            self.plane_watcher.start()
        # plugins start once the state is whole (a live predictor)
        for p in plugins or []:
            self.plugins.register(p)
            p.start(self)
        # auto hot-swap (reference: MasterActor watching for retrained
        # instances): poll the engine instances and install a newer
        # COMPLETED one without dropping the port
        self._auto_stop = threading.Event()
        self._auto_thread: Optional[threading.Thread] = None
        if auto_reload > 0:
            self._auto_thread = threading.Thread(
                target=self._auto_reload_loop, args=(float(auto_reload),),
                daemon=True, name="pio-auto-reload")
            self._auto_thread.start()

    @staticmethod
    def _tune_gil_switch() -> None:
        """Shorten the interpreter's GIL switch interval (default 5 ms) in
        a query server: a Python-heavy background thread (the auto-reload
        install) holding the GIL a whole interval stalls colliding
        queries.  PIO_GIL_SWITCH_S overrides; <= 0 keeps the default."""
        try:
            s = float(os.environ.get("PIO_GIL_SWITCH_S", "0.001"))
            if s > 0:
                sys.setswitchinterval(s)
        except (ValueError, OSError):
            pass

    # -- the model plane ------------------------------------------------------

    def _install_plane(self, models, info: Optional[Dict] = None) -> bool:
        """The PlaneWatcher's install hook: a composed generation goes
        through the one build-ticket install path."""
        info = dict(info or {})
        installed = self._install(models, follow_info=info)
        gen = int(info.get("planeGeneration") or 0)
        if gen:
            self.plane_generation = gen
        return installed

    def plane_reload(self):
        """``/reload`` with a plane: load the newest instance once, publish
        it as a plane generation and install it here (every sibling's
        watcher converges on it).  → (plane generation, instance id)."""
        instance, models = core_workflow.load_latest_models(
            self.engine_id, self.engine_version, self.engine_variant,
            storage=self.storage, device=self.device)
        gen = self.plane.publish(models, {"mode": "reload", "engineInstanceId": instance.id})
        self.plane_watcher.check_now()
        # the composed install carries no instance: record it, so freshness
        # names it and the poller does not publish it again
        self.instance = instance
        return gen, instance.id

    def plane_publish_initial(self) -> None:
        """Seed an empty plane with the loaded instance (the deploy of a
        plane's owner); a plane that has a generation is left as it is."""
        if self.plane is None or self.plane.current() is not None:
            return
        self.plane_reload()

    def plane_publish(self, models, info: Optional[Dict] = None) -> None:
        """The embedded follower's publish hook with a plane: write the
        generation, then install the composed one here (this process serves
        what every reader of the plane serves).  A bundle the plane cannot
        carry installs in-process."""
        from predictionio_tpu_torch.streaming.plane import PlaneUnsupported

        try:
            self.plane.publish(models, info)
        except PlaneUnsupported as e:
            log.warning("model plane cannot carry this bundle (%s); installing in-process", e)
            self.swap_models(models, info)
            return
        self.plane_watcher.check_now()

    def disable_plane(self) -> None:
        """Serve private models (a bundle the plane cannot carry)."""
        if self.plane_watcher is not None:
            self.plane_watcher.stop()
        self.plane = None
        self.plane_watcher = None

    def _auto_reload_loop(self, interval: float) -> None:
        while not self._auto_stop.wait(interval):
            try:
                latest = self.storage.engine_instances.get_latest_completed(
                    self.engine_id, self.engine_version, self.engine_variant)
            except Exception:
                log.exception("auto-reload: instance lookup failed")
                continue
            current = self.instance
            if latest is not None and (current is None or latest.id != current.id):
                if self.plane is not None:
                    # one publish converges the whole group
                    try:
                        gen, iid = self.plane_reload()
                        log.info("auto-reload: published instance %s as plane generation %d",
                                 iid, gen)
                    except Exception:
                        log.exception("auto-reload: plane publish failed; keeping the "
                                      "current generation")
                    continue
                try:
                    if self.reload() is not None:
                        log.info("auto-reload: hot-swapped to instance %s", latest.id)
                    else:
                        log.info("auto-reload: instance %s dropped as stale (a newer "
                                 "generation installed first)", latest.id)
                except Exception:
                    # the newer instance's models may still be mid-write:
                    # keep serving the current model, retry next tick
                    log.exception("auto-reload: reload failed; keeping current instance")

    def stop_auto_reload(self) -> None:
        """Stop every background updater, the auto-reload poller and the
        embedded follower (wired into server shutdown)."""
        self._auto_stop.set()
        if self.follower is not None:
            self.follower.stop(timeout=2.0)
        if self.replication is not None:
            try:
                self.replication.stop(timeout=1.0)
            except Exception:
                log.exception("plane replication stop failed")
            self.replication = None
            # publisher-side cluster observability dies with replication
            obs_lineage.set_cluster_provider(None)
            obs_cluster.set_federation(None)
        if self.plane_watcher is not None:
            self.plane_watcher.stop()
        t = self._auto_thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)

    def reload(self) -> Optional[str]:
        """Load and install the latest persisted instance onto the
        deploy's device.  Its id, or None when the bundle was dropped as
        stale (a build that started later installed first)."""
        instance, models = core_workflow.load_latest_models(
            self.engine_id, self.engine_version, self.engine_variant,
            storage=self.storage, device=self.device)
        if self._install(models, instance=instance):
            return instance.id
        return None

    def swap_models(self, models, info: Optional[Dict] = None) -> None:
        """The embedded follower's hot-swap: install already-built models
        without a round trip through the model store.  The swap is atomic
        under the serving lock; in-flight queries finish on the old
        generation, whose tensors are released once they drop it."""
        self._install(models, follow_info=info)

    def _install(self, models, instance=None, follow_info: Optional[Dict] = None) -> bool:
        """The one model-installation path (deploy, reload, auto-reload,
        follower swap): build and warm the serving bundle OUTSIDE the lock
        (on the card that stages the new tensors while the old model still
        serves, so for a moment the peak holds both), then swap the
        predictor, batcher and generation in one lock hold.  Builds are
        ordered by a ticket taken at build START: a bundle whose build
        began before a later build installed is dropped, so a slow stale
        build (the auto-reload poller's, the follower's) never replaces a
        newer generation.  False when dropped as stale."""
        w_inst, t_inst = time.time(), time.perf_counter()
        with self._lock:
            self._build_seq += 1
            ticket = self._build_seq
        enable = _batch_wanted(models)
        predictor, bp = self.engine.serving_bundle(self.engine_params, models)
        _response_cache.warm()
        batcher = (_MicroBatcher(bp, predictor, max_batch=getattr(bp, "max_batch", None))
                   if enable and bp is not None else None)
        with self._lock:
            if ticket <= self._installed_seq:
                return False   # a build that started later already installed
            self._installed_seq = ticket
            # the response cache re-arms on the new generation BEFORE the
            # predictor goes live, dropping the entries its swap provenance
            # cannot prove unchanged; it must never break an install
            w_cache, t_cache = time.time(), time.perf_counter()
            cache_attrs = None
            try:
                cache = _response_cache.get_cache()
                cache.on_swap(models)
                cache_attrs = {
                    "start": w_cache,
                    "duration_s": time.perf_counter() - t_cache,
                    # workers without provenance flush everything — that
                    # IS the interesting outcome on a lineage waterfall
                    "outcome": ("full_flush"
                                if cache.last_swap_reason == "no_provenance"
                                else cache.last_swap_reason or "noop"),
                    "dropped": int(cache.last_swap_invalidated),
                    "entries": len(cache),
                }
            except Exception:
                log.exception("response-cache swap sweep failed; disarming the cache")
                try:
                    _response_cache.get_cache().disarm()
                except Exception:
                    pass
            self.predictor = predictor
            self.batcher = batcher
            self.models = list(models)
            if instance is not None:
                self.instance = instance
            self.generation += 1
            self.swapped_at = _dt.datetime.now(_dt.timezone.utc)
            if follow_info is not None:
                self.follow_info = dict(follow_info)
            lid = (follow_info or {}).get("lineageId")
            gen = int((follow_info or {}).get("planeGeneration")
                      or self.generation)
            if lid:
                # first_serve is owed by whichever predict() runs next on
                # this generation; newer installs overwrite the debt (the
                # superseded generation never served from this worker)
                self._lineage_pending = (lid, gen)
        _M_GENERATION.set(self.generation)
        if lid:
            lin = obs_lineage.get_lineage()
            if lin.enabled:
                lin.note_generation(lid, gen)
                if cache_attrs is not None:
                    lin.stage(lid, "cache_invalidation",
                              parent="install", **cache_attrs)
                lin.stage(lid, "install", start=w_inst,
                          duration_s=time.perf_counter() - t_inst,
                          generation=gen, flush=True)
        return True

    def freshness(self) -> Dict:
        """How current the live model is and who keeps it so
        (``/stats.json``'s and ``GET /``'s ``freshness``): with a
        follower, its ``status()`` under ``follower`` and the fold state's
        footprint mirrored at the top."""
        doc: Dict[str, Any] = {
            "generation": self.generation,
            "swappedAt": self.swapped_at.isoformat() if self.swapped_at else None,
            "engineInstanceId": self.instance.id if self.instance else None,
        }
        if self.plane is not None:
            # equal across the group: every process serves one plane copy
            doc["planeGeneration"] = self.plane_generation
            if self.plane.last_publish_stats:
                # this process published: the write profile of its last
                # generation (logical bytes against bytes written)
                doc["planePublish"] = dict(self.plane.last_publish_stats)
        if self.replication is not None:
            doc["replication"] = self.replication.status()
        if self.follower is not None:
            doc["follower"] = self.follower.status()
        elif self.follow_info is not None:
            doc["follower"] = dict(self.follow_info)
        fr = doc.get("follower")
        if isinstance(fr, dict):
            doc["stateBytes"] = fr.get("stateBytes")
            doc["stateMode"] = fr.get("stateMode")
        return doc

    def parse_query(self, body: Dict) -> Any:
        if self.query_class is not None and hasattr(self.query_class, "from_json"):
            return self.query_class.from_json(body)
        return body

    def predict(self, body: Dict) -> Any:
        query = self.parse_query(body)
        w_q, t_q = time.time(), time.perf_counter()
        with self._lock:
            predictor = self.predictor
            batcher = self.batcher
            pending, self._lineage_pending = self._lineage_pending, None
        prediction = batcher.predict(query) if batcher else predictor(query)
        if pending is not None:
            # the freshness waterfall's last hop: this worker ANSWERED a
            # query from the new generation (not merely installed it)
            lin = obs_lineage.get_lineage()
            if lin.enabled:
                lin.stage(pending[0], "first_serve", start=w_q,
                          duration_s=time.perf_counter() - t_q,
                          generation=pending[1], flush=True)
        prediction = self.plugins.apply(query, prediction)
        with self._lock:
            self.query_count += 1
        if self.feedback and self.feedback_app_name:
            self._log_feedback(body, prediction)
        return prediction

    def _log_feedback(self, query_body: Dict, prediction: Any) -> None:
        """Write the served prediction back as a ``predict`` event (its
        prId links follow-up reward events to it, as in the reference)."""
        from predictionio_tpu_torch.events.event import DataMap, Event

        app = self.storage.apps.get_by_name(self.feedback_app_name)
        if app is None:
            return
        self.storage.l_events.insert(
            Event(
                event="predict",
                entity_type="pio_pr",
                entity_id=uuid.uuid4().hex,
                properties=DataMap(
                    {"query": query_body, "prediction": _to_jsonable(prediction)}),
                pr_id=uuid.uuid4().hex,
            ),
            app.id,
        )

    def info(self) -> Dict:
        return {
            "status": "alive",
            # which prefork worker answered: the readiness probe of
            # `deploy --workers N` polls fresh connections for N pids
            "pid": os.getpid(),
            "workerTag": obs_metrics.worker_tag(),
            "engineId": self.engine_id,
            "engineVersion": self.engine_version,
            "variant": self.engine_variant,
            "engineInstanceId": self.instance.id if self.instance else None,
            "trainedAt": self.instance.start_time.isoformat() if self.instance else None,
            "queryCount": self.query_count,
            "startedAt": self.started.isoformat(),
            "modelGeneration": self.generation,
            # None without a plane, else this process's installed generation
            "planeGeneration": self.plane_generation if self.plane is not None else None,
            "freshness": self.freshness(),
            "engine": type(self.engine).__name__,
            "algorithms": [name for name, _ in self.engine_params.algorithm_params_list],
            "devices": sorted({str(m.device) for m in self.models if hasattr(m, "device")}),
            "microBatching": self.batcher is not None,
        }


def _render_info_html(state: QueryServerState) -> str:
    """Deploy web UI (reference: CreateServer's engine-instance page)."""
    import html as _html

    info = state.info()
    rows = "".join(
        f"<tr><th>{_html.escape(str(k))}</th><td>{_html.escape(str(v))}</td></tr>"
        for k, v in info.items()
    )
    plugins = ", ".join(p.name for p in state.plugins.all()) or "(none)"
    return f"""<!DOCTYPE html>
<html><head><title>PredictionIO engine server</title>
<style>body{{font-family:sans-serif;margin:2em}}table{{border-collapse:collapse}}
th,td{{border:1px solid #ccc;padding:4px 10px;text-align:left}}</style></head>
<body><h1>Engine server: {_html.escape(state.engine_id)}</h1>
<table>{rows}</table>
<p>plugins: {_html.escape(plugins)}</p>
<p>POST /queries.json &middot; GET /reload &middot; GET /stop &middot;
GET /metrics &middot; GET /stats.json</p>
</body></html>"""


def make_handler(state: QueryServerState):
    class QueryHandler(JsonHandler):
        # per-(route, status) windows for /stats.json; None under
        # PIO_METRICS=off (then /stats.json answers 503)
        stats_collector = (StatsCollector()
                           if obs_metrics.get_registry().enabled else None)

        def do_GET(self):
            path, _query = self.route
            if path == "/":
                if "text/html" in self.headers.get("Accept", ""):
                    self.send_html(_render_info_html(state))
                else:
                    self.send_json(state.info())
            elif path == "/metrics":
                self._send_raw(200, metrics_payload(),
                               ctype="text/plain; version=0.0.4; charset=utf-8")
            elif obs_tracing.handle_trace_request(self, path):
                pass   # /traces.json + /traces/{rid}.json (flight recorder)
            elif obs_lineage.handle_lineage_request(self, path):
                pass   # /lineage.json + /lineage/{gen|ln-id}.json
            elif obs_tsdb.handle_history_request(self, path):
                pass   # /metrics/history.json (local time-series ring)
            elif obs_cluster.handle_cluster_request(self, path):
                pass   # /cluster/{metrics,history}.json (publisher only)
            elif obs_slo.handle_healthz_request(self, path):
                pass   # /healthz (SLO burn-rate verdicts, always 200)
            elif path == "/stats.json":
                if self.stats_collector is None:
                    self.send_error_json(503, "stats disabled (PIO_METRICS=off)")
                    return
                doc = self.stats_collector.to_json()
                doc["engineId"] = state.engine_id
                doc["queryCount"] = state.query_count
                doc["startedAt"] = state.started.isoformat()
                doc["freshness"] = state.freshness()
                self.send_json(doc)
            elif path == "/reload":
                from predictionio_tpu_torch.streaming.plane import PlaneUnsupported

                try:
                    if state.plane is not None:
                        try:
                            # one reload on any worker publishes a generation
                            # the whole group converges on
                            gen, iid = state.plane_reload()
                            self.send_json({"reloaded": True, "generation": gen,
                                            "engineInstanceId": iid})
                            return
                        except PlaneUnsupported:
                            pass   # a non-UR bundle: the private reload
                    iid = state.reload()
                    live = state.instance.id if state.instance else None
                    self.send_json({"reloaded": iid is not None,
                                    "engineInstanceId": iid or live})
                except Exception as e:
                    self.send_error_json(500, f"reload failed: {e}")
            elif path == "/stop":
                self.send_json({"stopping": True})

                def _stop(server):
                    state.stop_auto_reload()
                    server.shutdown()
                    # close the listening socket too: after shutdown() alone
                    # connections would be accepted and never served
                    server.server_close()

                threading.Thread(target=_stop, args=(self.server,), daemon=True).start()
            else:
                self.send_error_json(404, "not found")

        def do_POST(self):
            path, _query = self.route
            if path != "/queries.json":
                self.send_error_json(404, "not found")
                return
            try:
                body = self.read_json()
            except json.JSONDecodeError as e:
                self.send_error_json(400, f"invalid JSON: {e}")
                return
            if not isinstance(body, dict):
                self.send_error_json(400, "query must be a JSON object")
                return
            try:
                prediction = state.predict(body)
            except (KeyError, ValueError, TypeError) as e:
                self.send_error_json(400, f"bad query: {e}")
                return
            except Exception as e:  # engine failure: report, keep serving
                log.exception("prediction failed")
                self.send_error_json(500, f"prediction failed: {e}")
                return
            self.send_json(_to_jsonable(prediction))

    return QueryHandler


def _serve(state: QueryServerState, host: str, port: int, background: bool,
           reuse_port: bool = False):
    httpd = start_server(make_handler(state), host, port, background=background,
                         reuse_port=reuse_port)
    httpd.pio_state = httpd.state = state   # handles for tests and tools
    httpd.pio_workers = []
    return httpd


def deploy_models(engine, engine_params, models: Sequence[Any],
                  host: str = "127.0.0.1", port: int = 0,
                  query_class: Optional[type] = None):
    """Serve ``models`` (already on their device) on ``host:port`` (0 =
    any free port) through the event-loop front end, from a daemon thread
    (``server.thread``); returns the server: ``server.server_address``
    has the bound port, ``server.state`` (also ``server.pio_state``) the
    ``QueryServerState``.  Stop it with ``server.shutdown();
    server.server_close()``, or ``GET /stop``."""
    state = QueryServerState(engine, engine_params, query_class, type(engine).__name__,
                             models=models)
    httpd = _serve(state, host, port, background=True)
    prefork.wire_shutdown(httpd, [], before=state.stop_auto_reload)
    return httpd


def deploy(
    engine_json: str = "engine.json",
    variant: str = "default",
    engine_id: Optional[str] = None,
    engine_version: str = "1",
    host: str = "0.0.0.0",
    port: int = 8000,
    feedback: bool = False,
    storage: Optional[Storage] = None,
    device="cuda",
    background: bool = True,
    plugins=None,
    auto_reload: float = 0.0,
    workers: int = 1,
    reuse_port: bool = False,
    follow: float = 0.0,
    plane_publish: Optional[str] = None,
    plane_from: Optional[str] = None,
):
    """Serve the latest COMPLETED instance of ``engine_json``'s engine
    (``variant`` is the engine variant it was trained under) from the
    model store, its models on ``device`` (raises when CUDA is asked for
    and absent).  Returns the server, serving from a daemon thread
    (``background``, the default; the JAX package's default blocks), else
    serves in the foreground until stopped and returns 0.

    ``feedback`` writes each answer back as a ``predict`` event of the data
    source's app; ``auto_reload`` (seconds) polls for a newer instance and
    hot-swaps it in; ``plugins`` are ``api.plugins`` engine-server plugins.

    ``workers > 1`` preforks N−1 more processes on the same port
    (SO_REUSEPORT; the kernel balances accepts), which resolve storage
    from ``PIO_STORAGE_*`` (a ``storage`` object cannot cross the process
    boundary) and serve on ``device`` too.  It raises on a CUDA device, as
    the JAX package raises on an accelerator.  The group shares one model
    plane (``PIO_MODEL_PLANE=auto``): one ``/reload`` converges every
    worker, and with ``follow`` a dedicated ``--plane-publisher`` process
    folds once for the group; ``PIO_MODEL_PLANE=off`` gives each worker
    its own model (and follower), and then a ``/reload`` reaches one.

    ``follow`` (seconds) hosts an embedded ``FollowTrainer`` on ``device``
    that tails the event store at that interval, folds each delta into the
    live model and swaps it in (through the plane when there is one); an
    engine it cannot follow (no data source ``app_name``) deploys without
    one, with a warning.

    ``plane_publish="[HOST:]PORT"`` also streams this node's plane to
    replication subscribers; ``plane_from="HOST:PORT"`` makes the node a
    subscriber (no local fold: it conflicts with ``follow``), its plane
    fed by that publisher.  Both need a node-local plane directory
    (``PIO_MODEL_PLANE_DIR``, or a localfs METADATA store)."""
    from predictionio_tpu_torch.streaming import plane as plane_mod

    # cheap refusals first: after the state exists they would leak its
    # threads
    if plane_from and follow > 0:
        raise ValueError("deploy --plane-from serves replicated generations instead of "
                         "folding locally: drop --follow (the publisher's node folds)")
    if plane_from and plane_publish:
        raise ValueError("deploy cannot subscribe to a plane and publish one at once "
                         "(relaying is not supported)")
    if (plane_from or plane_publish) and not os.environ.get("PIO_CLUSTER_NODE"):
        # multi-node deployment: every lineage stage this node records is
        # SOURCE-stamped with a node name (obs.lineage reads the env
        # lazily) so cross-node stitching attributes per-node lanes; set
        # BEFORE the serving state exists so the install/first_serve
        # stages carry it, and prefork children inherit it.  Operators
        # set it explicitly for stable names across restarts.
        import socket as _socket

        role = "sub" if plane_from else "pub"
        os.environ["PIO_CLUSTER_NODE"] = f"{_socket.gethostname()}-{role}-{os.getpid()}"
    if workers > 1:
        import torch

        if torch.device(str(device)).type == "cuda":
            raise ValueError(
                "deploy --workers requires the CPU: the port serves a CUDA "
                "device from one process (scale card serving with the "
                "micro-batcher, not prefork workers)")
        if storage is not None:
            raise ValueError(
                "deploy --workers resolves storage from PIO_STORAGE_* env in "
                "each worker; a programmatic storage object cannot cross the "
                "process boundary")
    if workers == 1:
        prefork.maybe_watch_parent(log)   # prefork child: die when orphaned
        obs_metrics.start_worker_flusher()
        obs_metrics.mark_worker_up()
    doc = load_engine_variant(engine_json, variant)
    factory, engine, engine_params = engine_from_variant(doc)
    eid = resolve_engine_id(engine_id, doc, factory)
    feedback_app = (getattr(engine_params.data_source_params, "app_name", "") or ""
                    if feedback else "")
    metrics_dir: Optional[str] = None
    if workers > 1:
        import tempfile

        metrics_dir = tempfile.mkdtemp(prefix="pio-metrics-")
        obs_metrics.start_worker_flusher(metrics_dir, f"w0-{os.getpid()}")
    plane_dir: Optional[str] = None
    if plane_mod.plane_wanted(workers) or plane_from or plane_publish:
        plane_dir = plane_mod.resolve_plane_dir(storage or get_storage(), eid, variant)
        if plane_dir is None:
            if plane_from or plane_publish:
                raise ValueError(
                    "plane replication needs a model-plane directory: set "
                    "PIO_MODEL_PLANE_DIR to a node-local path (or use a localfs "
                    "METADATA store)")
            log.warning("model plane wanted but no plane directory resolves (set "
                        "PIO_MODEL_PLANE_DIR or use a localfs METADATA store); the "
                        "workers serve private models")
    state = QueryServerState(
        engine, engine_params, getattr(factory, "query_class", None), eid,
        engine_version, variant, storage=storage, feedback=feedback,
        feedback_app_name=feedback_app, plugins=plugins, auto_reload=auto_reload,
        device=device, plane_dir=plane_dir)
    log.info("deploying engine instance %s of %s", state.instance.id, eid)
    if state.plane is not None and plane_from is None and not prefork.is_prefork_child():
        # the plane's owner seeds it (a subscriber's belongs to its
        # publisher); a bundle the plane cannot carry, or a plane that
        # cannot be written, degrades the deploy to private models
        try:
            state.plane_publish_initial()
        except plane_mod.PlaneUnsupported as e:
            log.warning("model plane disabled for this engine (%s); serving private "
                        "models", e)
            state.disable_plane()
            plane_dir = None
        except Exception:
            log.exception("model plane seed publish failed; serving private models")
            state.disable_plane()
            plane_dir = None
    if follow > 0 and not (plane_dir is not None and workers > 1):
        # a prefork plane group folds in its publisher process (below)
        _start_follower(state, engine, engine_params, eid, engine_version, variant,
                        follow, device)
    if plane_publish is not None and state.plane is not None:
        from predictionio_tpu_torch.streaming.replicate import PlaneReplicator

        repl = PlaneReplicator(state.plane, bind=plane_publish)
        repl.start()
        state.replication = repl
        if state.follower is not None:
            state.follower.add_publish_listener(repl.poke)
    elif plane_from is not None and state.plane is not None:
        from predictionio_tpu_torch.streaming.replicate import PlaneSubscriber

        # started once the port is bound: its sync frames name that port
        state.replication = PlaneSubscriber(state.plane.dir, plane_from)
    _warm_entity_index(engine_params)
    # flight recorder: prefork children resolve the group's traces dir from
    # PIO_METRICS_DIR; a single worker persists next to the storage's spans
    # dir so the dashboard can merge them.  Lineage records persist next to
    # the traces; the history sampler gives every serving process its
    # /metrics/history.json ring and SLO gauges
    obs_tracing.arm(storage=state.storage)
    obs_lineage.arm(storage=state.storage)
    if obs_metrics.get_registry().enabled:
        obs_tsdb.start_sampler()
    httpd = _serve(state, host, port, background, reuse_port=workers > 1 or reuse_port)
    bound_port = httpd.server_address[1]
    if plane_from is not None and state.replication is not None:
        state.replication.http_port = bound_port
        try:
            state.replication.start()
        except Exception:
            state.replication = None   # never started: nothing to stop
            state.stop_auto_reload()
            if background:
                httpd.shutdown()
            httpd.server_close()
            raise
    elif plane_publish is not None and state.replication is not None:
        # cluster observability (publisher only): lineage reads answer with
        # the stitched cross-node outcome, the federation thread scrapes
        # every subscriber's metrics and lineage, and the cluster SLO rows
        # ride /healthz like any local SLO
        repl = state.replication
        obs_lineage.set_cluster_provider(repl.cluster_view)
        if obs_metrics.get_registry().enabled:
            fed = obs_cluster.ClusterFederation(repl.peers)
            fed.start()
            obs_cluster.set_federation(fed)
            obs_slo.arm_cluster_slos()
    children: list = []
    if workers > 1:
        obs_tracing.arm(directory=os.path.join(metrics_dir, "traces"),
                        tag=f"w0-{os.getpid()}")
        obs_lineage.arm(directory=os.path.join(metrics_dir, "lineage"),
                        tag=f"w0-{os.getpid()}")
        # with a plane the children only read it: no follower, no poller
        # (the parent's publishes converge them)
        children = prefork.spawn_workers(
            workers - 1,
            lambda w: (
                [sys.executable, "-m", "predictionio_tpu_torch.cli.main",
                 "deploy", "--engine-json", str(engine_json),
                 "--variant", variant, "--engine-version", engine_version,
                 "--ip", host, "--port", str(bound_port), "--reuse-port"]
                + (["--engine-id", engine_id] if engine_id else [])
                + (["--feedback"] if feedback else [])
                + (["--auto-reload", str(auto_reload)]
                   if auto_reload and plane_dir is None else [])
                + (["--follow", str(follow)] if follow and plane_dir is None else [])),
            build_env=lambda w: {
                "PIO_METRICS_TAG": f"w{w + 1}-{os.getpid()}",
                "PIO_METRICS_DIR": metrics_dir,
                "PIO_TORCH_DEVICE": str(device),
                **prefork.plane_child_env(plane_dir)},
            log=log,
        )
        if plane_dir is not None and follow > 0:
            # the group's one fold: a process that folds and publishes into
            # the plane and serves no queries
            children += prefork.spawn_workers(
                1,
                lambda w: (
                    [sys.executable, "-m", "predictionio_tpu_torch.cli.main",
                     "deploy", "--engine-json", str(engine_json),
                     "--variant", variant, "--engine-version", engine_version,
                     "--follow", str(follow), "--plane-publisher"]
                    + (["--engine-id", engine_id] if engine_id else [])),
                build_env=lambda w: {
                    "PIO_METRICS_TAG": f"pub-{os.getpid()}",
                    "PIO_METRICS_DIR": metrics_dir,
                    "PIO_TORCH_DEVICE": str(device),
                    "PIO_MODEL_PLANE_DIR": plane_dir},
                log=log,
            )
    log.info("Query server for %s listening on %s:%d", eid, host, bound_port)
    httpd.pio_workers = children
    prefork.wire_shutdown(httpd, children, before=state.stop_auto_reload)
    if metrics_dir is not None:
        prefork.wire_metrics_cleanup(httpd, metrics_dir)
    if background:
        return httpd
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    return 0


def _start_follower(state: QueryServerState, engine, engine_params, eid: str,
                    engine_version: str, variant: str, interval: float, device) -> None:
    """The embedded follow-trainer of ``deploy(follow=)``: it bootstraps
    from the log on its own thread and publishes each generation, into the
    plane when the state has one (then serving the composed generation),
    else straight into the server."""
    from predictionio_tpu_torch.streaming.fold import FoldUnsupported
    from predictionio_tpu_torch.streaming.follow import FollowTrainer

    try:
        state.follower = FollowTrainer(
            engine, engine_params, eid, engine_version, variant,
            storage=state.storage, interval=interval,
            on_publish=state.plane_publish if state.plane is not None else state.swap_models,
            persist=False, device=device)
    except FoldUnsupported as e:
        # nothing to tail (no app_name): serve without a follower rather
        # than raise with the auto-reload poller and plugins started
        log.warning("--follow unsupported for this engine (%s); deploying without "
                    "a follower", e)
        return
    state.follower.start()


def run_plane_publisher(engine_json: str, variant: str = "default",
                        engine_id: Optional[str] = None, engine_version: str = "1",
                        follow: float = 2.0, device="cuda") -> int:
    """The prefork plane group's fold process (``deploy --plane-publisher``,
    spawned by ``deploy --workers N --follow``): the group's one
    follow-trainer, publishing every generation into
    ``PIO_MODEL_PLANE_DIR`` and serving no queries.  Dies with its parent."""
    from predictionio_tpu_torch.streaming.fold import FoldUnsupported
    from predictionio_tpu_torch.streaming.follow import FollowTrainer
    from predictionio_tpu_torch.streaming.plane import ModelPlane

    plane_dir = os.environ.get("PIO_MODEL_PLANE_DIR")
    if not plane_dir:
        print("Error: --plane-publisher requires PIO_MODEL_PLANE_DIR", file=sys.stderr)
        return 1
    prefork.maybe_watch_parent(log)
    obs_metrics.start_worker_flusher()
    obs_metrics.mark_worker_up()
    # the publisher OPENS every lineage record (fold + publish stages);
    # PIO_METRICS_DIR is in its spawn env, so arm() lands the records in
    # the group dir the serving workers merge from
    obs_lineage.arm()
    doc = load_engine_variant(engine_json, variant)
    factory, engine, engine_params = engine_from_variant(doc)
    eid = resolve_engine_id(engine_id, doc, factory)
    plane = ModelPlane(plane_dir, device=device)
    try:
        trainer = FollowTrainer(engine, engine_params, eid, engine_version, variant,
                                interval=follow, on_publish=plane.publish, persist=False,
                                device=device)
    except FoldUnsupported as e:
        print(f"Error: the plane publisher cannot follow this engine: {e}", file=sys.stderr)
        return 1
    log.info("model-plane publisher for %s: folding every %.2f s into %s", eid,
             trainer.interval, plane_dir)
    try:
        trainer.run_forever()
    except KeyboardInterrupt:
        pass
    return 0


def _warm_entity_index(engine_params) -> None:
    """Build the serving history read's per-entity index (a localfs
    store's; other backends lack the hook) before the server listens, so
    the first query does not parse the whole log.  The JAX package builds
    it off-thread once the server listens, and its first queries wait for
    it."""
    app_name = getattr(getattr(engine_params, "data_source_params", None), "app_name", None)
    storage = get_storage()   # the history read's store, as in LEventStore
    warm = getattr(storage.l_events, "warm_entity_index", None)
    app = storage.apps.get_by_name(app_name) if app_name and warm else None
    if app is not None:
        warm(app.id)


def run_server_from_args(args) -> int:
    """``pio deploy``: serve in the foreground until ``GET /stop`` (``pio
    undeploy``) or SIGINT, on ``args.device`` (the CLI's
    ``PIO_TORCH_DEVICE``)."""
    from predictionio_tpu_torch.workflow.create_workflow import resolve_variant_path

    # the serving process's heap as imported (the interpreter's, torch's and
    # numpy's modules, which live as long as it does) goes to the permanent
    # generation: a full collection of the cyclic GC, which lands on
    # whichever query allocates past its threshold, then walks only what was
    # made since (the engine, its models, the server), and a model swapped
    # out later is still collected
    gc.collect()
    gc.freeze()
    if getattr(args, "plane_publisher", False):
        try:
            return run_plane_publisher(
                engine_json=resolve_variant_path(args), variant=args.variant,
                engine_id=args.engine_id, engine_version=args.engine_version,
                follow=args.follow or 2.0, device=args.device)
        except Exception as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1
    try:
        server = deploy(
            engine_json=resolve_variant_path(args),
            variant=args.variant,
            engine_id=args.engine_id,
            engine_version=args.engine_version,
            host=args.ip,
            port=args.port,
            device=args.device,
            feedback=args.feedback,
            auto_reload=args.auto_reload,
            workers=args.workers,
            reuse_port=getattr(args, "reuse_port", False),
            follow=args.follow,
            plane_publish=args.plane_publish,
            plane_from=args.plane_from,
        )
    except Exception as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    host, port = server.server_address[:2]
    print(f"Engine instance {server.state.instance.id} deployed at "
          f"http://{host}:{port} (stop with pio undeploy --port {port})", flush=True)
    try:
        while server.thread.is_alive():
            server.thread.join(0.5)   # a timed join lets SIGINT through
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        server.server_close()
    return 0
