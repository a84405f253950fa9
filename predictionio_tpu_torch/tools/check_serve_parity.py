#!/usr/bin/env python
"""Verify host-tail ≡ device-tail serving parity on a trained UR model.

Trains a small Universal Recommender model on deterministic synthetic
commerce data (two clusters, category properties, availability dates),
then replays a fixed query corpus — user, cold user, item-similarity,
itemSet, hard field filter, field boost, blacklist, dateRange,
currentDate avail/expire, an all-masked query, and a no-match empty
result — through BOTH serve tails (``PIO_UR_SERVE_TAIL=host`` vs
``device``) and through ``serve_batch_predict`` vs serial ``predict``
under each tail, diffing results EXACTLY: same items, same float scores,
same order.

A candidate-pruned phase then replays the corpus through the sparse
host tail (``PIO_UR_SERVE_CANDIDATES=on`` — posting-union candidates,
sliced rule masks, popularity-order backfill merge) serial AND batched,
diffing exact floats against the dense reference.

Then the same corpus goes over HTTP against the event-loop front end —
a live deployed query server — in BOTH wire modes: serial keep-alive
(one request/response at a time) and HTTP/1.1 pipelined (the SDK's
QueryPipeline, every query in flight at once), each replayed under the
candidate-pruned AND the dense tail, diffing the JSON responses exactly
against the in-process reference.  Any divergence — tail math,
candidate pruning, micro-batching, request-loop parsing, response
ordering under pipelining — fails the script.

The host tail's contract is that it is a bit-exact twin of the device
tail (the same elementwise f32 mask and boost math, and host_topk_desc
keeps the device top-k's tie order: the larger score first, the lower
index among equals), so any diff here is a real divergence, not float
noise.

Exit 0 = every query identical across all paths; 1 = any diff
(printed); 2 = the device asked for is absent.  Run standalone
(``python -m predictionio_tpu_torch.tools.check_serve_parity
[--device cuda|cpu]``, or the file's path) or via the tier-1 suite
(tests/test_torch_drill_serve_parity.py wraps it).  The port's copy of
``scripts/check_serve_parity.py``: the same phases, checks and messages,
every model trained, folded and served on ``--device`` (default ``cuda``;
on the card the device tail's mask, boosts and top-k run there and must
still equal the host tail's floats), and this process's K1/K2/K3 launch
counts printed before the verdict.  On the card the cache phase also
holds every generation the follower swapped out to be collected once it
is replaced (its card tensors released), printing the card's allocated
bytes before and after the swaps.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

# runnable from any cwd without an installed package
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from predictionio_tpu_torch.tools import _drill  # noqa: E402


def build_app():
    import numpy as np

    from predictionio_tpu_torch.events.event import DataMap, Event
    from predictionio_tpu_torch.storage.base import App
    from predictionio_tpu_torch.storage.locator import (
        Storage, StorageConfig, set_storage,
    )

    storage = Storage(StorageConfig(
        sources={"MEM": {"type": "memory"}},
        repositories={r: "MEM" for r in ("METADATA", "EVENTDATA",
                                         "MODELDATA")},
    ))
    set_storage(storage)
    app_id = storage.apps.insert(App(0, "parityapp"))
    rng = np.random.default_rng(42)
    e_items = [f"e{i}" for i in range(8)]
    b_items = [f"b{i}" for i in range(8)]
    events = []
    for u in range(40):
        mine = e_items if u < 20 else b_items
        for it in mine:
            if rng.random() < 0.7:
                events.append(Event(
                    event="purchase", entity_type="user", entity_id=f"u{u}",
                    target_entity_type="item", target_entity_id=it))
            if rng.random() < 0.9:
                events.append(Event(
                    event="view", entity_type="user", entity_id=f"u{u}",
                    target_entity_type="item", target_entity_id=it))
    for k, it in enumerate(e_items):
        events.append(Event(
            event="$set", entity_type="item", entity_id=it,
            properties=DataMap({
                "category": "electronics",
                "availableDate": "2026-01-01T00:00:00",
                "expireDate": f"2026-0{(k % 6) + 1}-15T00:00:00"})))
    for it in b_items:
        events.append(Event(
            event="$set", entity_type="item", entity_id=it,
            properties=DataMap({"category": "books",
                                "availableDate": "2026-02-01T00:00:00"})))
    storage.l_events.insert_batch(events, app_id)
    return storage


def corpus_bodies():
    """The corpus as wire-format JSON bodies — shared verbatim by the
    in-process phase (parsed via query_cls.from_json, exactly what the
    query server does) and the HTTP phases."""
    return [
        {"user": "u2", "num": 6},
        {"user": "u25", "num": 6},
        {"user": "nobody-cold", "num": 5},
        {"item": "e1", "num": 5},
        {"itemSet": ["e0", "e2"], "num": 6},
        {"user": "u3", "num": 6,
         "fields": [{"name": "category", "values": ["books"],
                     "bias": -1}]},
        {"user": "u3", "num": 6,
         "fields": [{"name": "category", "values": ["electronics"],
                     "bias": 4.0}]},
        {"user": "u4", "num": 6, "blacklistItems": ["e0", "e1", "e2"]},
        {"user": "u5", "num": 6,
         "dateRange": {"name": "expireDate",
                       "after": "2026-02-01T00:00:00"}},
        {"user": "u6", "num": 8, "currentDate": "2026-03-01T00:00:00"},
        # all-masked: no item carries this category value → empty result
        {"user": "u7", "num": 6,
         "fields": [{"name": "category", "values": ["no-such-cat"],
                     "bias": -1}]},
        # empty-history user + hard filter (pure backfill under a mask)
        {"user": "ghost", "num": 4,
         "fields": [{"name": "category", "values": ["books"],
                     "bias": -1}]},
    ]


def corpus(query_cls, field_cls):
    return [query_cls.from_json(b) for b in corpus_bodies()]


def canon(result):
    return [(s.item, float(s.score)) for s in result.item_scores]


def canon_http(resp: dict):
    return [(r["item"], float(r["score"])) for r in resp["itemScores"]]


def http_phase(engine, ep, query_cls, storage, reference, problems,
               device) -> None:
    """Deploy the trained model behind the event-loop front end and
    replay the corpus in serial-keep-alive and pipelined wire modes;
    responses must match the in-process reference EXACTLY (JSON
    round-trips floats losslessly, so this is float-equality, not
    tolerance)."""
    import http.client
    import json as _json

    from predictionio_tpu_torch.api.http_util import start_server
    from predictionio_tpu_torch.sdk import EngineClient
    from predictionio_tpu_torch.workflow import core_workflow
    from predictionio_tpu_torch.workflow.create_server import (
        QueryServerState, make_handler,
    )

    core_workflow.run_train(engine, ep, engine_id="parity-engine",
                            storage=storage, device=device)
    state = QueryServerState(engine, ep, query_cls, "parity-engine", "1",
                             "default", storage=storage, device=device)
    httpd = start_server(make_handler(state), "127.0.0.1", 0,
                         background=True)
    port = httpd.server_address[1]
    bodies = corpus_bodies()
    try:
        # the deployed server is in-process, so the per-query env switch
        # flips ITS tail too: each wire mode replays under the dense AND
        # the candidate-pruned tail
        for cand in ("off", "on"):
            os.environ["PIO_UR_SERVE_CANDIDATES"] = cand
            # serial keep-alive: one request/response at a time per socket
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            serial = []
            for body in bodies:
                conn.request("POST", "/queries.json",
                             _json.dumps(body).encode(),
                             {"Content-Type": "application/json"})
                r = conn.getresponse()
                payload = r.read()
                if r.status != 200:
                    problems.append(
                        f"http/serial/cand_{cand} HTTP {r.status}: "
                        f"{payload[:200]!r}")
                    return
                serial.append(canon_http(_json.loads(payload)))
            conn.close()
            # pipelined: every query in flight at once on one socket; the
            # event loop must answer strictly in order
            with EngineClient(f"http://127.0.0.1:{port}").pipeline(
                    depth=len(bodies)) as p:
                handles = [p.send_query(body) for body in bodies]
            pipelined = [canon_http(h.result()) for h in handles]
            for name, results in ((f"http/serial/cand_{cand}", serial),
                                  (f"http/pipelined/cand_{cand}",
                                   pipelined)):
                for qi, (got, want) in enumerate(zip(results, reference)):
                    if got != want:
                        problems.append(
                            f"query #{qi} differs on {name} vs "
                            f"in-process:\n  got:  {got}\n  want: {want}")
    finally:
        httpd.shutdown()
        httpd.server_close()


def hotswap_phase(engine, ep, query_cls, storage, problems,
                  device) -> None:
    """Replay the rules corpus through a LIVE deploy while an embedded
    follow-trainer swaps model generations mid-stream: every response
    must be a valid 200 (zero 5xx — a query must never observe a
    half-swapped model), and once the stream of appends has been folded
    the deployed responses must match a from-scratch retrain over the
    same events EXACTLY."""
    import http.client
    import json as _json
    import threading
    import time as _time

    from predictionio_tpu_torch.api.http_util import start_server
    from predictionio_tpu_torch.events.event import Event
    from predictionio_tpu_torch.store.event_store import invalidate_staging_cache
    from predictionio_tpu_torch.streaming.follow import FollowTrainer
    from predictionio_tpu_torch.workflow.create_server import (
        QueryServerState, make_handler,
    )

    app = storage.apps.get_by_name("parityapp")
    state = QueryServerState(engine, ep, query_cls, "parity-engine", "1",
                             "default", storage=storage, device=device)
    follower = state.follower = FollowTrainer(
        engine, ep, "parity-engine", storage=storage, interval=0.05,
        on_publish=state.swap_models, persist=False, device=device)
    follower.start()
    httpd = start_server(make_handler(state), "127.0.0.1", 0,
                         background=True)
    port = httpd.server_address[1]
    bodies = corpus_bodies()
    gen_start = state.generation
    errors_5xx = []
    replay_errors = []
    replay_count = [0]
    stop = threading.Event()

    def replay_loop():
        # a transport error mid-swap (reset, half-response) is exactly
        # the failure this phase exists to catch — it must FAIL the
        # phase, not silently kill the replay thread and leave the
        # zero-5xx assertion vacuously true
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            while not stop.is_set():
                for body in bodies:
                    conn.request("POST", "/queries.json",
                                 _json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
                    r = conn.getresponse()
                    payload = r.read()
                    replay_count[0] += 1
                    if r.status >= 500:
                        errors_5xx.append((r.status, payload[:200]))
            conn.close()
        except Exception as e:
            replay_errors.append(f"{type(e).__name__}: {e}")

    t = threading.Thread(target=replay_loop, daemon=True)
    try:
        t.start()
        # appends forcing folds/swaps while the replay loop is live:
        # fresh users co-purchasing with the electronics cluster
        for k in range(6):
            storage.l_events.insert_batch(
                [Event(event="purchase", entity_type="user",
                       entity_id=f"swapper{k}", target_entity_type="item",
                       target_entity_id=f"e{j}") for j in (0, 1, 2)],
                app.id)
            _time.sleep(0.15)
        deadline = _time.time() + 20
        while _time.time() < deadline and (
                state.generation <= gen_start
                or follower.last_outcome not in ("fold", "idle")):
            _time.sleep(0.05)
        # drain: one more tick's worth so the LAST append is folded
        while _time.time() < deadline and follower.last_outcome != "idle":
            _time.sleep(0.05)
    finally:
        stop.set()
        t.join(timeout=10)
        follower.stop()
    swaps = state.generation - gen_start
    if swaps < 1:
        problems.append("hotswap: follower never swapped a generation "
                        f"(outcome={follower.last_outcome})")
    if errors_5xx:
        problems.append(
            f"hotswap: {len(errors_5xx)} 5xx responses during swaps "
            f"(first: {errors_5xx[0]})")
    if replay_errors:
        problems.append(
            f"hotswap: replay connection died mid-stream after "
            f"{replay_count[0]} responses: {replay_errors[0]}")
    # post-swap exactness: live responses == from-scratch retrain now
    invalidate_staging_cache()
    from predictionio_tpu_torch.models.universal_recommender.engine import (
        URAlgorithm,
    )

    ref = engine.train(ep, device=device)[0]
    algo = URAlgorithm(ep.algorithm_params_list[0][1], device=device)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    for qi, body in enumerate(bodies + [{"user": "swapper0", "num": 6}]):
        conn.request("POST", "/queries.json", _json.dumps(body).encode(),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        payload = r.read()
        if r.status != 200:
            problems.append(f"hotswap: post-swap query #{qi} HTTP "
                            f"{r.status}: {payload[:200]!r}")
            continue
        got = canon_http(_json.loads(payload))
        want = canon(algo.predict(ref, query_cls.from_json(body)))
        if got != want:
            problems.append(
                f"hotswap: query #{qi} differs from the post-swap "
                f"from-scratch model:\n  got:  {got}\n  want: {want}")
    conn.close()
    httpd.shutdown()
    httpd.server_close()
    if not problems:
        print(f"hotswap phase: {swaps} mid-stream generation swaps, "
              "zero 5xx, post-swap responses exactly match a "
              "from-scratch retrain")


def plane_phase(engine, ep, query_cls, storage, problems,
                device) -> None:
    """Shared-memory model plane: a publisher server (embedded follower
    emitting every generation into the arena) and a pure-consumer
    sibling share one plane dir — the prefork topology minus process
    isolation (tests/test_model_plane.py covers the real-process
    drill).  The corpus replays over HTTP against the CONSUMER while
    generations hot-swap mid-stream (zero 5xx), then: one /reload on
    the consumer must converge the publisher's server too, and
    post-drain responses from the mapped model must EXACTLY match a
    from-scratch retrain — the ``PIO_MODEL_PLANE=off`` in-process
    oracle the earlier phases established.

    Runs with DELTA ARENAS ON (the default) and a short keyframe
    interval, and asserts the fold stream actually published delta
    generations — the consumer's post-drain parity therefore proves
    delta-composed mapped models bit-exact against the oracle, not just
    full arenas."""
    import http.client
    import json as _json
    import shutil
    import tempfile
    import threading
    import time as _time

    from predictionio_tpu_torch.api.http_util import start_server
    from predictionio_tpu_torch.events.event import Event
    from predictionio_tpu_torch.store.event_store import invalidate_staging_cache
    from predictionio_tpu_torch.streaming.follow import FollowTrainer
    from predictionio_tpu_torch.workflow.create_server import (
        QueryServerState, make_handler,
    )

    plane_tmp = tempfile.mkdtemp(prefix="pio_parity_plane")
    os.environ["PIO_MODEL_PLANE_POLL_S"] = "0.05"
    # delta arenas ON with a short keyframe interval: the fold stream
    # below must cross a keyframe boundary AND publish deltas, so the
    # replay exercises full→delta→keyframe→delta compose transitions
    os.environ.pop("PIO_MODEL_PLANE_DELTA", None)
    os.environ["PIO_MODEL_PLANE_FULL_EVERY"] = "4"
    app = storage.apps.get_by_name("parityapp")
    pub = QueryServerState(engine, ep, query_cls, "parity-engine", "1",
                           "default", storage=storage,
                           plane_dir=plane_tmp, device=device)
    sub = QueryServerState(engine, ep, query_cls, "parity-engine", "1",
                           "default", storage=storage,
                           plane_dir=plane_tmp, device=device)
    follower = None
    httpd = start_server(make_handler(sub), "127.0.0.1", 0,
                         background=True)
    port = httpd.server_address[1]
    bodies = corpus_bodies()
    errors_5xx: list = []
    replay_errors: list = []
    stop = threading.Event()

    def replay_loop():
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port,
                                              timeout=30)
            while not stop.is_set():
                for body in bodies:
                    conn.request("POST", "/queries.json",
                                 _json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
                    r = conn.getresponse()
                    payload = r.read()
                    if r.status >= 500:
                        errors_5xx.append((r.status, payload[:200]))
            conn.close()
        except Exception as e:
            replay_errors.append(f"{type(e).__name__}: {e}")

    t = threading.Thread(target=replay_loop, daemon=True)
    try:
        pub.plane_publish_initial()
        # one /reload on the consumer converges the sibling BEFORE any
        # folding (a reload publishes the PERSISTED instance — running
        # it after fresh folds would legitimately supersede them with
        # the older trained model, exactly as the build-ticket path
        # does in-process)
        import urllib.request

        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/reload", timeout=20) as r:
            rel = _json.loads(r.read())
        gen = int(rel.get("generation") or 0)
        deadline = _time.time() + 10
        while _time.time() < deadline and pub.plane_generation < gen:
            _time.sleep(0.05)
        if not rel.get("reloaded") or gen < 2 \
                or pub.plane_generation < gen:
            problems.append(
                f"plane: one /reload did not converge the sibling "
                f"(reload={rel}, sibling gen={pub.plane_generation})")
        follower = pub.follower = FollowTrainer(
            engine, ep, "parity-engine", storage=storage, interval=0.05,
            on_publish=pub.plane_publish, persist=False, device=device)
        follower.start()
        t.start()
        for k in range(5):
            storage.l_events.insert_batch(
                [Event(event="purchase", entity_type="user",
                       entity_id=f"planeswapper{k}",
                       target_entity_type="item",
                       target_entity_id=f"e{j}") for j in (0, 1, 2)],
                app.id)
            _time.sleep(0.12)
        deadline = _time.time() + 20
        while _time.time() < deadline and not (
                follower.last_outcome == "idle"
                and sub.plane_generation == pub.plane_generation
                and sub.plane_generation > 0):
            _time.sleep(0.05)
    finally:
        stop.set()
        t.join(timeout=10)
        if follower is not None:
            follower.stop()
    if sub.plane_generation < 2:
        problems.append(
            "plane: consumer never converged past the initial "
            f"generation (gen={sub.plane_generation}, "
            f"publisher gen={pub.plane_generation})")
    n_delta = len(list(Path(plane_tmp).glob("gen-*.delta")))
    if n_delta == 0:
        problems.append(
            "plane: no delta generation was published — the phase "
            "validated only full arenas (PIO_MODEL_PLANE_DELTA "
            "regression?)")
    if errors_5xx:
        problems.append(
            f"plane: {len(errors_5xx)} 5xx during mapped-generation "
            f"swaps (first: {errors_5xx[0]})")
    if replay_errors:
        problems.append(
            f"plane: replay connection died: {replay_errors[0]}")
    # post-drain exactness: the mapped model == a from-scratch retrain
    invalidate_staging_cache()
    from predictionio_tpu_torch.models.universal_recommender.engine import (
        URAlgorithm,
    )

    ref = engine.train(ep, device=device)[0]
    algo = URAlgorithm(ep.algorithm_params_list[0][1], device=device)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    for qi, body in enumerate(bodies + [{"user": "planeswapper0",
                                         "num": 6}]):
        conn.request("POST", "/queries.json", _json.dumps(body).encode(),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        payload = r.read()
        if r.status != 200:
            problems.append(f"plane: post-drain query #{qi} HTTP "
                            f"{r.status}: {payload[:200]!r}")
            continue
        got = canon_http(_json.loads(payload))
        want = canon(algo.predict(ref, query_cls.from_json(body)))
        if got != want:
            problems.append(
                f"plane: query #{qi} from the mapped model differs from "
                f"the in-process oracle:\n  got:  {got}\n  want: {want}")
    conn.close()
    httpd.shutdown()
    httpd.server_close()
    pub.stop_auto_reload()
    sub.stop_auto_reload()
    shutil.rmtree(plane_tmp, ignore_errors=True)
    if not problems:
        print(f"plane phase: {sub.plane_generation} mapped generations, "
              "zero 5xx mid-swap, one /reload converged both servers, "
              "post-drain responses exactly match the in-process oracle")


def native_phase(engine, ep, query_cls, storage, problems,
                 device) -> None:
    """Native data-plane cores: the corpus replays over HTTP
    against a live deploy running ``PIO_NATIVE=on`` — native HTTP
    parse/assemble plus the native serve fast lane — while an embedded
    follower swaps generations mid-stream.  Zero 5xx; after the drain
    every response must EXACTLY match the ``PIO_NATIVE=off`` Python
    oracle on a from-scratch retrain.  Skips (loudly, success) when no
    C++ toolchain built the cores — the off path IS the behavior then."""
    import http.client
    import json as _json
    import threading
    import time as _time

    from predictionio_tpu_torch.api.http_util import start_server
    from predictionio_tpu_torch.events.event import Event
    from predictionio_tpu_torch.native import core as ncore
    from predictionio_tpu_torch.store.event_store import invalidate_staging_cache
    from predictionio_tpu_torch.streaming.follow import FollowTrainer
    from predictionio_tpu_torch.workflow.create_server import (
        QueryServerState, make_handler,
    )

    if ncore.lib() is None:
        print("native phase: skipped (no C++ toolchain; PIO_NATIVE=off "
              "Python path is the behavior)")
        return
    saved = os.environ.get("PIO_NATIVE")
    os.environ["PIO_NATIVE"] = "on"
    app = storage.apps.get_by_name("parityapp")
    state = QueryServerState(engine, ep, query_cls, "parity-engine", "1",
                             "default", storage=storage, device=device)
    follower = state.follower = FollowTrainer(
        engine, ep, "parity-engine", storage=storage, interval=0.05,
        on_publish=state.swap_models, persist=False, device=device)
    follower.start()
    httpd = start_server(make_handler(state), "127.0.0.1", 0,
                         background=True)
    port = httpd.server_address[1]
    bodies = corpus_bodies()
    gen_start = state.generation
    calls0 = ncore._M_CALLS.value(core="http")
    errors_5xx: list = []
    replay_errors: list = []
    stop = threading.Event()

    def replay_loop():
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port,
                                              timeout=30)
            while not stop.is_set():
                for body in bodies:
                    conn.request("POST", "/queries.json",
                                 _json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
                    r = conn.getresponse()
                    payload = r.read()
                    if r.status >= 500:
                        errors_5xx.append((r.status, payload[:200]))
            conn.close()
        except Exception as e:
            replay_errors.append(f"{type(e).__name__}: {e}")

    t = threading.Thread(target=replay_loop, daemon=True)
    try:
        t.start()
        for k in range(4):
            storage.l_events.insert_batch(
                [Event(event="purchase", entity_type="user",
                       entity_id=f"natswapper{k}",
                       target_entity_type="item",
                       target_entity_id=f"e{j}") for j in (0, 1, 2)],
                app.id)
            _time.sleep(0.15)
        deadline = _time.time() + 20
        while _time.time() < deadline and (
                state.generation <= gen_start
                or follower.last_outcome != "idle"):
            _time.sleep(0.05)
    finally:
        stop.set()
        t.join(timeout=10)
        follower.stop()
    swaps = state.generation - gen_start
    if swaps < 1:
        problems.append("native: follower never swapped a generation "
                        f"(outcome={follower.last_outcome})")
    if errors_5xx:
        problems.append(
            f"native: {len(errors_5xx)} 5xx responses with PIO_NATIVE=on "
            f"during swaps (first: {errors_5xx[0]})")
    if replay_errors:
        problems.append(
            f"native: replay connection died: {replay_errors[0]}")
    if ncore._M_CALLS.value(core="http") <= calls0:
        problems.append("native: pio_native_calls_total{core=http} never "
                        "moved — the native lane was dark, the phase "
                        "proved nothing")
    # post-drain exactness: oracle answers computed with the native lane
    # OFF (the Python path), then replayed over HTTP with it ON — the
    # deployed server is in-process, so the env flip governs each side
    invalidate_staging_cache()
    from predictionio_tpu_torch.models.universal_recommender.engine import (
        URAlgorithm,
    )

    all_bodies = bodies + [{"user": "natswapper0", "num": 6}]
    os.environ["PIO_NATIVE"] = "off"
    try:
        ref = engine.train(ep, device=device)[0]
        algo = URAlgorithm(ep.algorithm_params_list[0][1], device=device)
        oracle = [canon(algo.predict(ref, query_cls.from_json(b)))
                  for b in all_bodies]
    finally:
        os.environ["PIO_NATIVE"] = "on"
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    for qi, body in enumerate(all_bodies):
        conn.request("POST", "/queries.json", _json.dumps(body).encode(),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        payload = r.read()
        if r.status != 200:
            problems.append(f"native: post-drain query #{qi} HTTP "
                            f"{r.status}: {payload[:200]!r}")
            continue
        got = canon_http(_json.loads(payload))
        if got != oracle[qi]:
            problems.append(
                f"native: query #{qi} with PIO_NATIVE=on differs from "
                f"the Python oracle:\n  got:  {got}\n"
                f"  want: {oracle[qi]}")
    conn.close()
    httpd.shutdown()
    httpd.server_close()
    if saved is None:
        os.environ.pop("PIO_NATIVE", None)
    else:
        os.environ["PIO_NATIVE"] = saved
    if not problems:
        print(f"native phase: {swaps} mid-stream generation swaps with "
              "PIO_NATIVE=on, zero 5xx, post-drain responses exactly "
              "match the PIO_NATIVE=off oracle")


def _card_allocated(device) -> int:
    """Bytes the caching allocator holds for live tensors on a CUDA
    ``device`` after a collection (0 on the CPU)."""
    if device.type != "cuda":
        return 0
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize(device)
    return torch.cuda.memory_allocated(device)


def cache_phase(engine, ep, query_cls, storage, problems,
                device) -> None:
    """Provenance-invalidated response cache over the live front end:
    the corpus replays against a deployed server with the cache ON while
    an embedded follower swaps generations mid-stream (zero 5xx — a hit
    must never observe a half-swapped model either), then every
    post-drain answer — cached hits included — must be bit-identical to
    the ``PIO_SERVE_CACHE=off`` oracle on the same generation, with the
    online audit (every 3rd hit) recording zero mismatches and the cache
    proven live (hit_count > 0, not vacuously dark)."""
    import http.client
    import json as _json
    import threading
    import time as _time
    import weakref

    from predictionio_tpu_torch.api.http_util import start_server
    from predictionio_tpu_torch.events.event import Event
    from predictionio_tpu_torch.serve import response_cache as rc
    from predictionio_tpu_torch.streaming.follow import FollowTrainer
    from predictionio_tpu_torch.workflow.create_server import (
        QueryServerState, make_handler,
    )

    saved = {k: os.environ.get(k)
             for k in ("PIO_SERVE_CACHE", "PIO_SERVE_CACHE_AUDIT_N",
                       "PIO_FOLLOW_DENSE_RELLR_BYTES")}
    os.environ.pop("PIO_SERVE_CACHE", None)          # cache ON
    os.environ["PIO_SERVE_CACHE_AUDIT_N"] = "3"      # audit every 3rd hit
    # force the pruned sparse re-LLR at toy scale so folds carry serve
    # provenance exactly as the at-scale regime does
    os.environ["PIO_FOLLOW_DENSE_RELLR_BYTES"] = "1"
    cache = rc.get_cache()
    cache.clear()
    cache.hit_count = cache.miss_count = 0
    audit0 = rc._M_AUDIT.value()
    app = storage.apps.get_by_name("parityapp")
    state = QueryServerState(engine, ep, query_cls, "parity-engine", "1",
                             "default", storage=storage, device=device)
    # every generation the state serves, held weakly: on the card each one
    # the follower swaps out must be collected (its tensors released)
    generations = [weakref.ref(state.models[0])]

    def swap(models, info=None):
        generations.append(weakref.ref(models[0]))
        state.swap_models(models, info)

    follower = state.follower = FollowTrainer(
        engine, ep, "parity-engine", storage=storage, interval=0.05,
        on_publish=swap, persist=False, device=device)
    mem_before = _card_allocated(device)
    follower.start()
    httpd = start_server(make_handler(state), "127.0.0.1", 0,
                         background=True)
    port = httpd.server_address[1]
    bodies = corpus_bodies()
    gen_start = state.generation
    errors_5xx: list = []
    replay_errors: list = []
    stop = threading.Event()

    def replay_loop():
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port,
                                              timeout=30)
            while not stop.is_set():
                for body in bodies:
                    conn.request("POST", "/queries.json",
                                 _json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
                    r = conn.getresponse()
                    payload = r.read()
                    if r.status >= 500:
                        errors_5xx.append((r.status, payload[:200]))
            conn.close()
        except Exception as e:
            replay_errors.append(f"{type(e).__name__}: {e}")

    t = threading.Thread(target=replay_loop, daemon=True)
    try:
        t.start()
        for k in range(4):
            storage.l_events.insert_batch(
                [Event(event="purchase", entity_type="user",
                       entity_id=f"cacheswapper{k}",
                       target_entity_type="item",
                       target_entity_id=f"e{j}") for j in (0, 1, 2)],
                app.id)
            _time.sleep(0.15)
        deadline = _time.time() + 20
        while _time.time() < deadline and (
                state.generation <= gen_start
                or follower.last_outcome != "idle"):
            _time.sleep(0.05)
    finally:
        stop.set()
        t.join(timeout=10)
        follower.stop()
    swaps = state.generation - gen_start
    if swaps < 1:
        problems.append("cache: follower never swapped a generation "
                        f"(outcome={follower.last_outcome})")
    if errors_5xx:
        problems.append(
            f"cache: {len(errors_5xx)} 5xx responses with the cache on "
            f"during swaps (first: {errors_5xx[0]})")
    if replay_errors:
        problems.append(
            f"cache: replay connection died: {replay_errors[0]}")
    # post-drain: fill + hit for every body, each bit-identical to the
    # PIO_SERVE_CACHE=off oracle on the SAME generation (the deployed
    # server is in-process, so the env flip governs its lookups too)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)

    def post(body):
        conn.request("POST", "/queries.json", _json.dumps(body).encode(),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        payload = r.read()
        if r.status != 200:
            return None, f"HTTP {r.status}: {payload[:200]!r}"
        return canon_http(_json.loads(payload)), None

    for qi, body in enumerate(bodies + [{"user": "cacheswapper0",
                                         "num": 6}]):
        first, err = post(body)
        second = None
        if err is None:
            second, err = post(body)           # warm: a cache hit
        if err is None:
            os.environ["PIO_SERVE_CACHE"] = "off"
            try:
                oracle, err = post(body)
            finally:
                os.environ.pop("PIO_SERVE_CACHE", None)
        if err is not None:
            problems.append(f"cache: post-drain query #{qi} {err}")
            continue
        if first != oracle or second != oracle:
            problems.append(
                f"cache: query #{qi} differs from the cache-off oracle:"
                f"\n  fill: {first}\n  hit:  {second}\n  want: {oracle}")
    conn.close()
    httpd.shutdown()
    httpd.server_close()
    if device.type == "cuda":
        # the follower's own fold state goes with it; what is left is the
        # state's one live generation
        state.follower = follower = None
        mem_after = _card_allocated(device)
        live = state.models[0]
        kept = [r() for r in generations[:-1]]
        kept = [m for m in kept if m is not None and m is not live]
        if kept:
            problems.append(
                f"cache: {len(kept)} swapped-out generation(s) still alive "
                "after the swaps — their card memory was not released")
        print(f"cache phase: {len(generations)} generations served on "
              f"{device}, card memory allocated {mem_before} B before the "
              f"follower started, {mem_after} B after the drain")
        del live, kept
    if cache.hit_count == 0:
        problems.append("cache: hit_count stayed 0 — the phase never "
                        "served a cached answer (cache dark?)")
    audit_failures = rc._M_AUDIT.value() - audit0
    if audit_failures:
        problems.append(f"cache: {audit_failures} online audit "
                        "mismatches — a cached answer diverged from the "
                        "recomputed tail")
    cache.clear()
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    if not problems:
        print(f"cache phase: {swaps} mid-stream swaps with the cache on, "
              f"zero 5xx, {cache.hit_count} hits, fill+hit responses "
              "exactly match the cache-off oracle, zero audit mismatches")


def main(argv=None) -> int:
    _args, device = _drill.parse_args(argv, __doc__.splitlines()[0])
    # pin the scorer so both tails consume the IDENTICAL signal array and
    # any diff is attributable to the tail under test
    os.environ["PIO_UR_SERVE_SCORER"] = "host"
    # the tail/wire phases replay repeated corpora through armed servers:
    # keep them measuring the TAILS, not the response cache (which gets
    # its own phase below)
    os.environ["PIO_SERVE_CACHE"] = "off"
    build_app()
    from predictionio_tpu_torch.controller.engine import EngineParams
    from predictionio_tpu_torch.models.universal_recommender import (
        UniversalRecommenderEngine, URQuery,
    )
    from predictionio_tpu_torch.models.universal_recommender.engine import (
        FieldRule, URAlgorithm, URAlgorithmParams, URDataSourceParams,
    )

    engine = UniversalRecommenderEngine.apply()
    ep = EngineParams(
        data_source_params=URDataSourceParams(
            app_name="parityapp", event_names=["purchase", "view"]),
        algorithm_params_list=[("ur", URAlgorithmParams(
            app_name="parityapp", mesh_dp=1, max_correlators_per_item=8,
            min_llr=0.0, available_date_name="availableDate",
            expire_date_name="expireDate"))],
    )
    models = engine.train(ep, device=device)
    algo = URAlgorithm(ep.algorithm_params_list[0][1], device=device)
    model = models[0]
    queries = corpus(URQuery, FieldRule)

    runs = {}
    os.environ["PIO_UR_SERVE_CANDIDATES"] = "off"   # dense phase first
    for tail in ("host", "device"):
        os.environ["PIO_UR_SERVE_TAIL"] = tail
        runs[f"{tail}/serial"] = [canon(algo.predict(model, q))
                                  for q in queries]
        runs[f"{tail}/batch"] = [canon(r) for r in
                                 algo.serve_batch_predict(model, queries)]
    # candidate-pruned phase: the sparse host tail must reproduce the
    # dense reference exactly, serial and micro-batched
    os.environ["PIO_UR_SERVE_TAIL"] = "host"
    os.environ["PIO_UR_SERVE_CANDIDATES"] = "on"
    runs["cand/serial"] = [canon(algo.predict(model, q)) for q in queries]
    runs["cand/batch"] = [canon(r) for r in
                          algo.serve_batch_predict(model, queries)]
    problems = []
    reference = runs["device/serial"]
    some_nonempty = any(reference)
    if not some_nonempty:
        problems.append("corpus produced only empty results — the parity "
                        "check would be vacuous (fixture drift?)")
    for name, results in runs.items():
        for qi, (got, want) in enumerate(zip(results, reference)):
            if got != want:
                problems.append(
                    f"query #{qi} differs on {name} vs device/serial:\n"
                    f"  got:  {got}\n  want: {want}")
    # the all-masked query must be an exact empty result everywhere
    if reference[10] != []:
        problems.append(f"all-masked query returned items: {reference[10]}")
    # HTTP phase against the event-loop front end (host tail — the CPU
    # default a deployed server resolves), serial + pipelined wire modes
    os.environ["PIO_UR_SERVE_TAIL"] = "host"
    from predictionio_tpu_torch.storage.locator import get_storage

    if not problems:
        http_phase(engine, ep, URQuery, get_storage(),
                   runs["host/serial"], problems, device)
    # hot-swap phase: the same corpus under live mid-stream generation
    # swaps (embedded follow-trainer), then post-swap exactness
    os.environ["PIO_UR_SERVE_CANDIDATES"] = "off"
    if not problems:
        hotswap_phase(engine, ep, URQuery, get_storage(), problems, device)
    # shared-model-plane phase: mapped read-only generations, live
    # hot-swap through the arena, group-converging /reload — responses
    # must equal the PIO_MODEL_PLANE=off oracle established above
    if not problems:
        plane_phase(engine, ep, URQuery, get_storage(), problems, device)
    # response-cache phase: the same live-swap drill with the cache ON,
    # hits bit-identical to the cache-off oracle
    if not problems:
        cache_phase(engine, ep, URQuery, get_storage(), problems, device)
    # native-cores phase: the live-swap drill with PIO_NATIVE=on, then
    # post-drain exactness against the Python oracle
    if not problems:
        native_phase(engine, ep, URQuery, get_storage(), problems, device)
    _drill.print_launches(device)
    for p in problems:
        print(f"FAIL {p}", file=sys.stderr)
    if not problems:
        print(f"ok: {len(queries)} queries × (6 serving paths + "
              "http serial/pipelined × candidates on/off + live "
              "hot-swap phase + model-plane phase + response-cache "
              "phase + native-cores phase) identical (items, scores, "
              "order)")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
