#!/usr/bin/env python
"""End-to-end multi-node plane-replication check.

Builds a shared localfs store, trains a small UR model, then runs a
real three-node topology as separate OS processes on one box:

- a PUBLISHER node: ``pio deploy --follow 0.2 --plane-publish
  127.0.0.1:PORT`` — embedded follower folds live events and publishes
  generations into its node-local plane dir, which the in-process
  ``PlaneReplicator`` streams to subscribers;
- two SUBSCRIBER nodes: ``pio deploy --plane-from 127.0.0.1:PORT`` —
  each lands replicated containers into its OWN node-local plane dir
  and serves them through the unchanged watcher/compose/install path.

Asserts over plain HTTP:

- live folds propagate: after a delta batch, the publisher AND both
  subscribers converge on the same plane generation;
- replication parity (zero staleness): the same queries answered by the
  publisher and by each subscriber return identical documents;
- both subscribers converge to ``complete`` lineage records for the
  folded generation (the lineage dir is shared via the common store, so
  each node's merged view spans the publisher's fold/publish stages and
  every node's install/first_serve hops);
- the PUBLISHER's stitched record reaches ``cluster_complete``: every
  expected subscriber node's lane (repl.recv → repl.land → install →
  first_serve) is present with monotone stage starts, and the record
  carries ``cluster.propagationMs``;
- the federation view (``/cluster/metrics.json``, publisher-only)
  reports BOTH subscriber nodes up; after the kill below the dead node
  stays listed at ``up: false`` instead of vanishing;
- freshness reports the replication role on both sides: the publisher
  lists both subscriber sessions at lag 0, each subscriber reports
  role=subscriber, connected, lag 0;
- a subscriber SIGKILLed mid-stream misses a generation, is dropped by
  the publisher, and on restart RESUMES from its last-acked generation
  (the local manifest) — converging back to zero staleness.

Exit 0 = clean; 1 = any assertion failed (printed); 2 = the device
asked for is absent.  Run standalone (``python -m
predictionio_tpu_torch.tools.check_plane_replication [--device
cuda|cpu]``, or the file's path) or via the tier-1 suite
(tests/test_torch_drill_plane_replication.py wraps it).  The port's copy of
``scripts/check_plane_replication.py``: the same topology, checks and
messages; the model is trained in this process on ``--device`` (default
``cuda``) and the three nodes are the port's ``pio deploy`` with
``PIO_TORCH_DEVICE`` set to it, so on the card three processes share it,
each with its own CUDA context.  This process's K1/K2/K3 launch counts
(the train) are printed before the verdict.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from predictionio_tpu_torch.tools import _drill  # noqa: E402

READY_S = 180.0
CONVERGE_S = 120.0
PROBES = (
    {"user": "u2", "num": 5},
    {"user": "probe0", "num": 5},
    {"user": "u4", "num": 4},
    {"item": "i1", "num": 4},
)


def buy(u: str, i: str):
    from predictionio_tpu_torch.events.event import Event

    return Event(event="purchase", entity_type="user", entity_id=u,
                 target_entity_type="item", target_entity_id=i)


def build_store(path: str):
    from predictionio_tpu_torch.storage.base import App
    from predictionio_tpu_torch.storage.locator import (
        Storage, StorageConfig, set_storage,
    )

    storage = Storage(StorageConfig(
        sources={"FS": {"type": "localfs", "path": path}},
        repositories={r: "FS" for r in ("METADATA", "EVENTDATA",
                                        "MODELDATA")}))
    set_storage(storage)
    app_id = storage.apps.insert(App(0, "replapp"))
    events = [buy(f"u{u}", f"i{it}")
              for u in range(12) for it in range(8) if (u * it + u) % 3]
    storage.l_events.insert_batch(events, app_id)
    return storage, app_id


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def get_json(base: str, path: str, timeout: float = 10.0):
    with urllib.request.urlopen(base + path, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def post_query(base: str, body: dict, timeout: float = 30.0):
    req = urllib.request.Request(
        base + "/queries.json", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def wait_generation(base: str, want: int, timeout: float,
                    label: str) -> int:
    """Poll GET / until planeGeneration >= want; returns the value."""
    deadline = time.time() + timeout
    gen = -1
    while time.time() < deadline:
        try:
            _, d = get_json(base, "/", timeout=2)
            gen = int(d.get("planeGeneration") or 0)
            if gen >= want:
                return gen
        except Exception:
            pass
        time.sleep(0.05)
    raise RuntimeError(
        f"{label} never reached plane generation {want} in {timeout}s "
        f"(at {gen})")


def main(argv=None) -> int:
    _args, device = _drill.parse_args(argv, __doc__.splitlines()[0])
    from predictionio_tpu_torch.workflow import core_workflow
    from predictionio_tpu_torch.workflow.create_workflow import engine_from_variant

    problems = []
    tmp = tempfile.mkdtemp(prefix="pio-plane-repl-")
    store_path = os.path.join(tmp, "store")
    procs: dict = {}
    bases: dict = {}
    try:
        storage, app_id = build_store(store_path)
        variant = {
            "id": "plane-repl",
            "engineFactory": "predictionio_tpu_torch.models."
                             "universal_recommender."
                             "UniversalRecommenderEngine",
            "datasource": {"params": {
                "appName": "replapp", "eventNames": ["purchase"]}},
            "algorithms": [{"name": "ur", "params": {
                "appName": "replapp", "eventNames": [], "meshDp": 1,
                "maxCorrelatorsPerItem": 8}}],
        }
        engine_json = os.path.join(tmp, "engine.json")
        with open(engine_json, "w") as f:
            json.dump(variant, f)
        _factory, engine, ep = engine_from_variant(variant)
        core_workflow.run_train(engine, ep, engine_id="plane-repl",
                                storage=storage, device=device)

        repl_port = free_port()
        base_env = _drill.child_env(device, {
            "PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
            "PIO_STORAGE_SOURCES_FS_PATH": store_path,
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "FS",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "FS",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "FS",
            "PIO_MODEL_PLANE": "on",
            "PIO_MODEL_PLANE_POLL_S": "0.1",
            "PIO_PLANE_REPL_PING_S": "0.5",
            "PIO_PLANE_REPL_BACKOFF_S": "0.2",
            "PIO_METRICS_FLUSH_S": "0.25",
            "PIO_CLUSTER_SCRAPE_S": "0.25",
            "PIO_CLUSTER_SCRAPE_TIMEOUT_S": "2",
            # this process appends the live-fold events, so the serving
            # nodes never see notify_append: a per-node history cache
            # would hold per-node-staleness user histories and break the
            # byte-exact parity assertion (the documented multi-process-
            # ingest caveat in serve/history_cache.py)
            "PIO_HISTORY_CACHE": "off",
        })

        def spawn(name: str, extra_args, plane_dir: str):
            port = free_port()
            procs[name] = subprocess.Popen(
                _drill.PIO + ["deploy", "--engine-json", engine_json,
                              "--ip", "127.0.0.1", "--port", str(port)]
                + extra_args,
                env={**base_env,
                     "PIO_MODEL_PLANE_DIR": os.path.join(tmp, plane_dir),
                     # a STABLE cluster-node name per logical node: the
                     # restarted subB must rejoin under the same lane,
                     # not appear as a fourth node (the default stamp is
                     # pid-suffixed)
                     "PIO_CLUSTER_NODE": f"node-{name}"})
            bases[name] = f"http://127.0.0.1:{port}"
            return port

        spawn("pub", ["--follow", "0.2",
                      "--plane-publish", f"127.0.0.1:{repl_port}"],
              "plane-pub")
        for sub in ("subA", "subB"):
            spawn(sub, ["--plane-from", f"127.0.0.1:{repl_port}"],
                  f"plane-{sub}")

        # ready: every node answers and has installed a plane generation
        for name in ("pub", "subA", "subB"):
            deadline = time.time() + READY_S
            while True:
                if procs[name].poll() is not None:
                    raise RuntimeError(
                        f"{name} died during startup "
                        f"(rc {procs[name].returncode})")
                if time.time() > deadline:
                    raise RuntimeError(f"{name} not ready in {READY_S}s")
                try:
                    _, d = get_json(bases[name], "/", timeout=2)
                    if int(d.get("planeGeneration") or 0) >= 1:
                        break
                except Exception:
                    pass
                time.sleep(0.1)
        gref = wait_generation(bases["pub"], 1, 10, "pub")

        # -- live folds propagate cluster-wide ---------------------------
        storage.l_events.insert_batch(
            [buy("probe0", "i1")]
            + [buy(f"cob{j}", "i1") for j in range(6)]
            + [buy(f"cob{j}", "fresh_item") for j in range(6)], app_id)
        gen = wait_generation(bases["pub"], gref + 1, CONVERGE_S, "pub")
        for sub in ("subA", "subB"):
            got = wait_generation(bases[sub], gen, CONVERGE_S, sub)
            if got > gen:
                gen = got   # the fold may have ticked again; re-level
                gen = wait_generation(bases["pub"], gen, CONVERGE_S, "pub")

        # quiesce: no new folds mid-parity (events are drained)
        time.sleep(1.0)
        gen = wait_generation(bases["pub"], gen, 10, "pub")
        for sub in ("subA", "subB"):
            wait_generation(bases[sub], gen, CONVERGE_S, sub)

        # -- replication parity (zero staleness) -------------------------
        for q in PROBES:
            _, ref = post_query(bases["pub"], q)
            for sub in ("subA", "subB"):
                _, got = post_query(bases[sub], q)
                if got != ref:
                    problems.append(
                        f"{sub} answered {q} differently from the "
                        f"publisher: {got} != {ref}")

        # -- complete lineage on both subscribers ------------------------
        for sub in ("subA", "subB"):
            doc = None
            deadline = time.time() + 30
            while time.time() < deadline:
                st, d = get_json(bases[sub], f"/lineage/{gen}.json")
                if st == 200:
                    doc = d
                    if d.get("outcome") == "complete":
                        break
                time.sleep(0.25)
            if doc is None:
                problems.append(f"{sub}: /lineage/{gen}.json never "
                                "answered 200")
                continue
            if doc.get("outcome") != "complete":
                problems.append(
                    f"{sub}: generation {gen} lineage outcome="
                    f"{doc.get('outcome')!r}, expected 'complete'")
            names = {s.get("stage") for s in doc.get("stages", ())}
            for need in ("publish", "plane.write", "install",
                         "first_serve"):
                if need not in names:
                    problems.append(f"{sub}: lineage record missing "
                                    f"stage {need!r}")
            installs = {s.get("worker") for s in doc.get("stages", ())
                        if s.get("stage") == "install"}
            if len(installs) < 3:
                problems.append(
                    f"{sub}: install recorded by {sorted(installs)} — "
                    "expected the publisher and both subscriber nodes")

        # -- the publisher's STITCHED record: cluster_complete with a
        #    monotone per-node lane (repl.recv -> repl.land -> install
        #    -> first_serve) for BOTH subscriber nodes -------------------
        LANE_ORDER = ("repl.recv", "repl.land", "install", "first_serve")
        doc = None
        deadline = time.time() + 30
        while time.time() < deadline:
            st, d = get_json(bases["pub"], f"/lineage/{gen}.json")
            if st == 200:
                doc = d
                if d.get("outcome") == "cluster_complete":
                    break
            time.sleep(0.25)
        if doc is None or doc.get("outcome") != "cluster_complete":
            problems.append(
                f"pub: generation {gen} stitched record outcome="
                f"{(doc or {}).get('outcome')!r}, expected "
                f"'cluster_complete' (cluster="
                f"{(doc or {}).get('cluster')!r})")
        else:
            cl = doc.get("cluster") or {}
            if sorted(cl.get("expected") or []) != \
                    ["node-subA", "node-subB"]:
                problems.append(
                    f"pub: stitched record expects {cl.get('expected')}, "
                    "wanted both subscriber nodes")
            if not cl.get("propagationMs"):
                problems.append(
                    f"pub: cluster_complete record without "
                    f"propagationMs: {cl!r}")
            for node in ("node-subA", "node-subB"):
                starts = {}
                for s in doc.get("stages", ()):
                    if s.get("node") == node and \
                            s.get("stage") in LANE_ORDER:
                        starts.setdefault(s["stage"],
                                          float(s.get("start") or 0))
                missing = [n for n in LANE_ORDER if n not in starts]
                if missing:
                    problems.append(
                        f"pub: stitched lane for {node} missing "
                        f"{missing} (has {sorted(starts)})")
                    continue
                seq = [starts[n] for n in LANE_ORDER]
                if seq != sorted(seq):
                    problems.append(
                        f"pub: {node} lane stage starts not monotone: "
                        + ", ".join(f"{n}={starts[n]:.6f}"
                                    for n in LANE_ORDER))

        # -- federation: every subscriber node up on the publisher -------
        cl_doc = None
        deadline = time.time() + 20
        while time.time() < deadline:
            st, d = get_json(bases["pub"], "/cluster/metrics.json")
            if st == 200:
                cl_doc = d
                nodes = d.get("nodes") or {}
                # the scraped view lags by one tsdb sample: wait for
                # up-ness AND the converged generation to show through
                if len(nodes) >= 2 and all(
                        n.get("up") and n.get("generation") == gen
                        for n in nodes.values()):
                    break
            time.sleep(0.25)
        nodes = (cl_doc or {}).get("nodes") or {}
        if sorted(nodes) != ["node-subA", "node-subB"]:
            problems.append(
                f"pub /cluster/metrics.json lists {sorted(nodes)}, "
                "expected both subscriber nodes")
        for nm, st_ in nodes.items():
            if not st_.get("up"):
                problems.append(
                    f"pub /cluster/metrics.json: {nm} not up: "
                    f"{st_.get('error')!r}")
            elif st_.get("generation") != gen:
                problems.append(
                    f"pub /cluster/metrics.json: {nm} at generation "
                    f"{st_.get('generation')}, cluster is at {gen}")

        # -- freshness reports the replication role ----------------------
        _, stats = get_json(bases["pub"], "/stats.json")
        rep = (stats.get("freshness") or {}).get("replication") or {}
        if rep.get("role") != "publisher":
            problems.append(f"publisher freshness.replication={rep!r}")
        else:
            subs = rep.get("subscribers") or []
            if len(subs) != 2:
                problems.append(
                    f"publisher reports {len(subs)} subscribers, "
                    "expected 2")
            elif any(s.get("lagGenerations") for s in subs):
                problems.append(
                    f"subscriber lag nonzero after convergence: {subs}")
        for sub in ("subA", "subB"):
            _, stats = get_json(bases[sub], "/stats.json")
            rep = (stats.get("freshness") or {}).get("replication") or {}
            if (rep.get("role") != "subscriber"
                    or not rep.get("connected")
                    or rep.get("lagGenerations")):
                problems.append(
                    f"{sub} freshness.replication={rep!r} — expected "
                    "connected subscriber at lag 0")

        # -- kill one subscriber mid-stream, re-sync with zero staleness -
        procs["subB"].send_signal(signal.SIGKILL)
        procs["subB"].wait(timeout=15)
        storage.l_events.insert_batch(
            [buy(f"cob{j}", "fresh_item2") for j in range(6)]
            + [buy(f"cob{j}", "i2") for j in range(6)], app_id)
        gen2 = wait_generation(bases["pub"], gen + 1, CONVERGE_S, "pub")
        wait_generation(bases["subA"], gen2, CONVERGE_S, "subA")
        # the dead node must stay LISTED at up=false, not vanish
        deadline = time.time() + 20
        dead_seen = False
        while time.time() < deadline:
            st, d = get_json(bases["pub"], "/cluster/metrics.json")
            nodes = (d or {}).get("nodes") or {}
            if st == 200 and "node-subB" in nodes \
                    and not nodes["node-subB"].get("up"):
                dead_seen = True
                break
            time.sleep(0.25)
        if not dead_seen:
            problems.append(
                "pub /cluster/metrics.json never reported the killed "
                "node-subB as up=false (it must stay visible, stale-"
                f"flagged): {sorted(nodes)}")
        # restart B on the SAME plane dir + port: its first sync frame
        # must carry have=<last flipped generation> (resume, not cold)
        portB = int(bases["subB"].rsplit(":", 1)[1])
        procs["subB"] = subprocess.Popen(
            _drill.PIO + ["deploy", "--engine-json", engine_json,
                          "--ip", "127.0.0.1", "--port", str(portB),
                          "--plane-from", f"127.0.0.1:{repl_port}"],
            env={**base_env,
                 "PIO_MODEL_PLANE_DIR": os.path.join(tmp, "plane-subB"),
                 "PIO_CLUSTER_NODE": "node-subB"})
        # settle on the publisher's CURRENT generation (folds may have
        # ticked during the restart), then re-assert parity everywhere
        gen2 = wait_generation(bases["pub"], gen2, 10, "pub")
        time.sleep(1.0)
        gen2 = wait_generation(bases["pub"], gen2, 10, "pub")
        for sub in ("subA", "subB"):
            wait_generation(bases[sub], gen2, CONVERGE_S, sub)
        for q in PROBES + ({"user": "cob1", "num": 5},):
            _, ref = post_query(bases["pub"], q)
            for sub in ("subA", "subB"):
                _, got = post_query(bases[sub], q)
                if got != ref:
                    problems.append(
                        f"{sub} stale after kill/re-sync on {q}: "
                        f"{got} != {ref}")
        _, stats = get_json(bases["subB"], "/stats.json")
        rep = (stats.get("freshness") or {}).get("replication") or {}
        if rep.get("lagGenerations"):
            problems.append(
                f"subB lag nonzero after re-sync: {rep!r}")
    except Exception as e:  # noqa: BLE001 - the harness wants one rc
        problems.append(f"replication check aborted: {e!r}")
    finally:
        for name, proc in procs.items():
            base = bases.get(name)
            if proc.poll() is None and base:
                try:
                    with urllib.request.urlopen(base + "/stop",
                                                timeout=5) as r:
                        r.read()
                except Exception:
                    pass
            try:
                proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                proc.terminate()
                try:
                    proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    proc.kill()
        from predictionio_tpu_torch.storage.locator import set_storage

        set_storage(None)
        shutil.rmtree(tmp, ignore_errors=True)
    _drill.print_launches(device)
    for p in problems:
        print(f"FAIL {p}", file=sys.stderr)
    if not problems:
        print("ok: publisher + 2 subscribers converged (live folds, "
              "complete lineage on both subscriber nodes, stitched "
              "cluster_complete record with monotone per-node lanes, "
              "federation reporting every node up, byte-equal "
              "responses), SIGKILLed subscriber stayed visible as "
              "up=false and resumed from its last-acked generation "
              "with zero staleness")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
