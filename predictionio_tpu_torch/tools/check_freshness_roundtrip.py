#!/usr/bin/env python
"""End-to-end streaming-freshness roundtrip check.

Builds a localfs store, trains a small UR model, deploys it behind the
event-loop front end with an EMBEDDED follow-trainer (the
``pio deploy --follow`` path), then over several rounds:

1. appends events through the storage layer: co-buyers purchase a seed
   item the probe user already owns PLUS a BRAND-NEW item — invisible
   to any stale model, since the recommendable catalog comes from the
   model (serving history comes from the live store, so an own-purchase
   probe would reflect even without a fold — the new-item probe cannot);
2. waits for the follower to fold them (polls the HTTP /stats.json
   ``freshness`` key — generation, covered events — the SDK contract)
   and records the append→reflected wall latency;
3. asserts exact parity: the deployed model's responses for a fixed
   probe corpus are identical — same items, same float scores, same
   order — to a from-scratch ``engine.train`` over the same events.

Draining is DETERMINISTIC: the script tracks how many events it
inserted and waits until ``freshness.follower.coveredEvents`` reaches
that count with an idle outcome — a bare "idle" can be a tick that ran
before an append became visible (a race this script used to lose under
CPU contention).

Any 5xx anywhere, a fold that never lands, or a single float of
divergence fails the script.  Exit 0 = clean; 2 = the device asked for
is absent.  Run standalone (``python -m
predictionio_tpu_torch.tools.check_freshness_roundtrip [--device
cuda|cpu]``, or the file's path) or via the tier-1 suite
(tests/test_torch_drill_freshness.py wraps it).  The port's copy of
``scripts/check_freshness_roundtrip.py``: the same modes, checks and
messages, the model trained, folded (fold re-selection runs K2 and K3 on
the card) and served on ``--device`` (default ``cuda``), every retrain
it is held to on the same device, and this process's K1/K2/K3 launch
counts printed before the verdict.

Modes:

- default: 12-user / 8-item shape, 3 rounds.
- ``--storage sharded [--shards N]``: the same roundtrip over the
  sharded, replicated event store — the proof that delta staging and
  ``pio deploy --follow`` work unchanged when events are
  hash-partitioned.
- ``--large``: the large-catalog smoke: a
  4000-item catalog under a deliberately small
  PIO_FOLLOW_STATE_BYTES=32MiB budget.  The legacy dense fold state
  (4000² × 4 B = 64 MiB per event type) would demote to
  retrain-per-tick; the sorted-COO sparse state must stay in fold mode
  (asserted via ``freshness.follower.stateMode == "sparse"`` and
  ``mode == "fold"``), reflect an append, and keep exact parity.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

# runnable from any cwd without an installed package
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from predictionio_tpu_torch.tools import _drill  # noqa: E402

ROUNDS = 3
WAIT_S = 20.0

# the large smoke pins the budget low enough that the DENSE state could
# not hold this catalog (I² × 4 B = 64 MiB > 32 MiB) while the sparse
# state (O(nnz)) fits with room to spare.  The budget is the fold state's
# own (PIO_FOLLOW_STATE_BYTES), the same on the card as on the CPU.
LARGE_ITEMS = 4000
LARGE_BUDGET = 32 << 20


def buy(u: str, i: str):
    from predictionio_tpu_torch.events.event import Event

    return Event(event="purchase", entity_type="user", entity_id=u,
                 target_entity_type="item", target_entity_id=i)


def seed_events(large: bool = False):
    if large:
        # one purchase per item puts all LARGE_ITEMS in the catalog;
        # u0..u99 each own a 40-item slice, so cross-joins stay tiny
        evs = [buy(f"u{k % 100}", f"i{k}") for k in range(LARGE_ITEMS)]
        # a correlated cluster for the probe rounds
        evs += [buy(f"u{u}", f"i{it}") for u in range(12)
                for it in range(8) if (u * it + u) % 3]
        return evs
    return [buy(f"u{u}", f"i{it}")
            for u in range(12) for it in range(8) if (u * it + u) % 3]


def build_store(path: str, storage_type: str = "localfs", shards: int = 2,
                large: bool = False):
    from predictionio_tpu_torch.storage.base import App
    from predictionio_tpu_torch.storage.locator import (
        Storage, StorageConfig, set_storage,
    )

    src = {"type": storage_type, "path": path}
    if storage_type == "sharded":
        src["shards"] = str(shards)
    storage = Storage(StorageConfig(
        sources={"FS": src},
        repositories={r: "FS" for r in ("METADATA", "EVENTDATA",
                                        "MODELDATA")}))
    set_storage(storage)
    app_id = storage.apps.insert(App(0, "freshapp"))
    events = seed_events(large)
    for s in range(0, len(events), 5000):
        storage.l_events.insert_batch(events[s:s + 5000], app_id)
    return storage, app_id, len(events)


def canon(doc: dict):
    return [(r["item"], float(r["score"])) for r in doc["itemScores"]]


def parse_args(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--large", action="store_true",
                    help="the 4000-item catalog under a 32 MiB fold-state budget")
    ap.add_argument("--storage", default="localfs", choices=("localfs", "sharded"))
    ap.add_argument("--shards", type=int, default=2)
    return _drill.parse_args(argv, __doc__.splitlines()[0], ap)


def main(argv=None) -> int:
    import http.client

    args, device = parse_args(argv)
    large, storage_type, shards = args.large, args.storage, args.shards
    rounds = 2 if large else ROUNDS
    os.environ.setdefault("PIO_UR_SERVE_SCORER", "host")
    if storage_type == "sharded" and shards > 1:
        # the parallel-path assertion at the end reads the workers gauge;
        # pin the pool width (capped at the shard count anyway) so a
        # single-core CI host doesn't legitimately default to 1 and fail
        os.environ.setdefault("PIO_SCAN_WORKERS", "2")
    if large:
        os.environ["PIO_FOLLOW_STATE_BYTES"] = str(LARGE_BUDGET)

    from predictionio_tpu_torch.controller.engine import EngineParams
    from predictionio_tpu_torch.models.universal_recommender import (
        UniversalRecommenderEngine, URQuery,
    )
    from predictionio_tpu_torch.models.universal_recommender.engine import (
        URAlgorithm, URAlgorithmParams, URDataSourceParams,
    )
    from predictionio_tpu_torch.api.http_util import start_server
    from predictionio_tpu_torch.store.event_store import invalidate_staging_cache
    from predictionio_tpu_torch.streaming.follow import FollowTrainer
    from predictionio_tpu_torch.workflow import core_workflow
    from predictionio_tpu_torch.workflow.create_server import (
        QueryServerState, make_handler,
    )

    tmp = tempfile.mkdtemp(prefix="pio-fresh-")
    problems = []
    ok_line = ""
    httpd = None
    follower = None
    try:
        storage, app_id, n_events = build_store(tmp, storage_type, shards, large)
        engine = UniversalRecommenderEngine.apply()
        ap = URAlgorithmParams(app_name="freshapp", mesh_dp=1,
                               max_correlators_per_item=8)
        ep = EngineParams(
            data_source_params=URDataSourceParams(
                app_name="freshapp", event_names=["purchase"]),
            algorithm_params_list=[("ur", ap)])
        core_workflow.run_train(engine, ep, engine_id="fresh-engine",
                                storage=storage, device=device)
        state = QueryServerState(
            engine, ep, UniversalRecommenderEngine.query_class,
            "fresh-engine", "1", "default", storage=storage, device=device)
        follower = state.follower = FollowTrainer(
            engine, ep, "fresh-engine", storage=storage, interval=0.1,
            on_publish=state.swap_models, persist=False, device=device)
        if follower.mode != "fold":
            problems.append(f"follower resolved mode={follower.mode}, "
                            "expected fold on a localfs UR deployment")
        follower.start()
        httpd = start_server(make_handler(state), "127.0.0.1", 0,
                             background=True)
        port = httpd.server_address[1]
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)

        def http_json(method, path, body=None):
            conn.request(method, path,
                         json.dumps(body).encode() if body else None,
                         {"Content-Type": "application/json"})
            r = conn.getresponse()
            payload = r.read()
            if r.status >= 500:
                problems.append(f"{method} {path}: HTTP {r.status} "
                                f"{payload[:200]!r}")
            return r.status, json.loads(payload)

        def follower_stats():
            _, stats = http_json("GET", "/stats.json")
            return stats.get("freshness", {}).get("follower", {})

        def drain(timeout: float = WAIT_S) -> bool:
            """Wait until the follower's resident state covers EVERY
            event this script inserted AND the last tick found nothing
            new — deterministic, unlike a bare lastOutcome poll."""
            end = time.time() + timeout
            while time.time() < end:
                fr = follower_stats()
                covered = fr.get("coveredEvents")
                caught_up = covered is None or covered >= n_events
                if caught_up and fr.get("lastOutcome") in ("idle",
                                                           "disabled"):
                    return True
                time.sleep(0.02)
            return False

        latencies = []
        algo = URAlgorithm(ap, device=device)
        if not drain():
            problems.append("follower never drained after bootstrap "
                            f"(outcome={follower.last_outcome})")
        if large:
            fr = follower_stats()
            if fr.get("mode") != "fold":
                problems.append(
                    f"large-catalog: follower demoted to {fr.get('mode')} "
                    f"under PIO_FOLLOW_STATE_BYTES={LARGE_BUDGET} — the "
                    "sparse state must hold fold mode here")
            if fr.get("stateMode") != "sparse":
                problems.append(
                    f"large-catalog: stateMode={fr.get('stateMode')}, "
                    "expected sparse")
            sb = fr.get("stateBytes") or 0
            dense_equiv = LARGE_ITEMS * LARGE_ITEMS * 4
            if not 0 < sb <= LARGE_BUDGET:
                problems.append(
                    f"large-catalog: stateBytes={sb} outside "
                    f"(0, {LARGE_BUDGET}]")
            if dense_equiv <= LARGE_BUDGET:
                problems.append("large-catalog smoke misconfigured: the "
                                "dense state would also fit the budget")
        for rnd in range(rounds):
            seed_item = "i1"
            new_item = f"fresh_item_{rnd}"
            probe_user = f"probe{rnd}"
            # the probe user's history holds seed_item BEFORE the round,
            # so reflection == the brand-new co-occurring item appearing
            # in their response — impossible on any stale model, whose
            # catalog cannot contain new_item
            storage.l_events.insert_batch([buy(probe_user, seed_item)],
                                          app_id)
            n_events += 1
            drain()
            t0 = time.time()
            cobuyers = [f"cob{rnd}_{j}" for j in range(6)]
            storage.l_events.insert_batch(
                [buy(u, seed_item) for u in cobuyers]
                + [buy(u, new_item) for u in cobuyers], app_id)
            n_events += 12
            reflected = None
            while time.time() - t0 < WAIT_S:
                st, doc = http_json("POST", "/queries.json",
                                    {"user": probe_user, "num": 30})
                if st == 200 and any(r["item"] == new_item
                                     for r in doc["itemScores"]):
                    reflected = time.time() - t0
                    break
                time.sleep(0.02)
            if reflected is None:
                problems.append(
                    f"round {rnd}: append not reflected within {WAIT_S}s "
                    f"(follower outcome={follower.last_outcome})")
                break
            latencies.append(reflected)
            # the new-item proof covers the append's visibility; drain so
            # the parity model covers the whole batch before comparing
            # vs a from-scratch retrain over the same events
            if not drain():
                problems.append(f"round {rnd}: drain after append timed "
                                "out")
            invalidate_staging_cache()
            ref = engine.train(ep, device=device)[0]
            probes = ([{"user": f"u{u}", "num": 6} for u in range(0, 12, 3)]
                      + [{"user": probe_user, "num": 5},
                         {"user": "nobody", "num": 4},
                         {"item": "i2", "num": 5}])
            for body in probes:
                st, doc = http_json("POST", "/queries.json", body)
                if st != 200:
                    problems.append(f"round {rnd}: probe {body} HTTP {st}")
                    continue
                want = [(s.item, float(s.score)) for s in algo.predict(
                    ref, URQuery.from_json(body)).item_scores]
                got = canon(doc)
                if got != want:
                    problems.append(
                        f"round {rnd}: probe {body} diverges from "
                        f"from-scratch retrain:\n  got:  {got}\n"
                        f"  want: {want}")
        if large and not problems:
            # pruned re-LLR + incremental emit engagement: a
            # brand-new user buying an EXISTING item bumps N — Dunning
            # G² couples every cell to N, so this is exactly the full
            # re-LLR the selection-stability certificate prunes — then
            # the counters must show certified rows and carried/patched
            # serving-state emits, with parity still exact below
            from predictionio_tpu_torch.obs.metrics import get_registry

            reg = get_registry()
            cert0 = reg.counter("pio_follow_rellr_rows_total",
                                "x").value(outcome="certified")
            storage.l_events.insert_batch(
                [buy("nbump_user", "i1")], app_id)
            n_events += 1
            if not drain():
                problems.append("large-catalog: N-bump round never "
                                "drained")
            cert = reg.counter("pio_follow_rellr_rows_total",
                               "x").value(outcome="certified")
            if not cert > cert0:
                problems.append(
                    "large-catalog: the pruned re-LLR certified no rows "
                    f"on an N-bump fold (certified {cert0} -> {cert}) — "
                    "certification is not engaging")
            emit_inc = 0.0
            for comp in ("inverted", "pop_order", "popularity",
                         "user_seen", "seen_by_event", "props"):
                for path in ("carried", "patched"):
                    emit_inc += reg.counter(
                        "pio_follow_emit_total",
                        "x").value(component=comp, path=path)
            if not emit_inc > 0:
                problems.append(
                    "large-catalog: no incremental serving-state emit "
                    "engaged (pio_follow_emit_total carried/patched all "
                    "zero)")
            invalidate_staging_cache()
            ref = engine.train(ep, device=device)
            for body in [{"user": "u1", "num": 6},
                         {"user": "nbump_user", "num": 5}]:
                st, doc = http_json("POST", "/queries.json", body)
                want = [(s.item, float(s.score)) for s in algo.predict(
                    ref[0], URQuery.from_json(body)).item_scores]
                if st != 200 or canon(doc) != want:
                    problems.append(
                        f"large-catalog: post-N-bump probe {body} "
                        "diverges from the from-scratch retrain")
        conn.close()
        if storage_type == "sharded" and shards > 1:
            # the roundtrip must have exercised the PARALLEL cross-shard
            # scan pipeline, not a silent serial fallback: every merged
            # scan records its pool width on the workers gauge
            from predictionio_tpu_torch.storage.sharded import _M_SCAN_WORKERS

            w = _M_SCAN_WORKERS.value()
            if w <= 1:
                problems.append(
                    f"sharded roundtrip ran with scan workers={w:g} — the "
                    "parallel cross-shard scan pipeline was not exercised "
                    "(PIO_SCAN_WORKERS forced to 1, or a 1-core fallback)")
        if not problems:
            lat = ", ".join(f"{v * 1e3:.0f}ms" for v in latencies)
            extra = ""
            if large:
                extra = (f", {LARGE_ITEMS}-item catalog held fold mode "
                         f"sparse under a {LARGE_BUDGET >> 20} MiB budget")
            ok_line = (f"ok: {rounds} append→fold→reflected rounds "
                       f"(latencies {lat}), responses exactly equal a "
                       f"from-scratch retrain each round, zero 5xx{extra}")
    finally:
        if follower is not None:
            follower.stop()
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        shutil.rmtree(tmp, ignore_errors=True)
        from predictionio_tpu_torch.storage.locator import set_storage

        set_storage(None)
    _drill.print_launches(device)
    for p in problems:
        print(f"FAIL {p}", file=sys.stderr)
    if not problems:
        print(ok_line)
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
