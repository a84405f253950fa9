#!/usr/bin/env python
"""End-to-end generation-lineage roundtrip check.

Builds a localfs store, trains a small UR model, then deploys it as a
REAL ``pio deploy --workers 2 --follow`` prefork group in model-plane
mode — so the process that OPENS each lineage record (the dedicated
plane publisher, tag ``pub-*``) is never one of the processes that
serve ``/lineage.json`` (tags ``w0-*``/``w1-*``).  Appends a delta,
waits for the fold to converge every worker, makes sure BOTH workers
answered a query on the new generation, then asserts over plain HTTP:

- ``/lineage.json`` indexes the folded generation and the serving
  worker's tag differs from the record's origin (the cross-process
  proof: a worker that did not produce the generation can explain it);
- ``/lineage/<gen>.json`` returns the merged record with outcome
  ``complete``: the publisher-side stages (append_observed, fold.*,
  publish, plane.write), the watcher hops (watcher_wake, compose), an
  ``install`` from BOTH serving workers, the ``cache_invalidation``
  child parented under install, and at least one ``first_serve``;
- stage start times are monotone along the freshness waterfall
  (append_observed → publish → plane.write → watcher_wake → compose →
  install → first_serve);
- ``/lineage/<lid>.json`` (id-keyed fetch) returns the same record;
- ``/healthz`` answers HTTP 200 with a non-``burning`` verdict and
  ``/metrics/history.json`` serves at least one TSDB sample.

Exit 0 = roundtrip complete; 1 = any assertion failed (printed); 2 = the
device asked for is absent.  Run standalone (``python -m
predictionio_tpu_torch.tools.check_lineage_roundtrip [--device cuda|cpu]
[--topology prefork|replicated]``, or the file's path) or via the tier-1
suite (tests/test_torch_drill_lineage.py wraps it).  The port's copy of
``scripts/check_lineage_roundtrip.py``: the same checks and messages, the
model trained in this process on ``--device`` (default ``cuda``) and
served by the port's ``pio deploy`` with ``PIO_TORCH_DEVICE`` set to it;
this process's K1/K2/K3 launch counts (the train) are printed before the
verdict.

Topologies (``--topology``; the default follows the device):

- ``prefork`` (the CPU's default): the JAX drill's, above.
- ``replicated`` (the card's default; the port serves a CUDA device from
  one process, so a prefork group runs only on the CPU): a ``pio deploy
  --follow 0.2 --plane-publish`` publisher and a ``pio deploy
  --plane-from`` subscriber, each its own process with its own plane
  directory.  The subscriber serves and explains a generation it did not
  produce — the same cross-process proof.  The record must carry
  ``install`` and ``first_serve`` from both serving processes, its origin
  must be the publisher (which serves too), and the checks on the stages,
  the waterfall, the index, the id-keyed fetch, ``/healthz`` and
  ``/metrics/history.json`` are the prefork topology's, asked of the
  subscriber (``/healthz`` of both).
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from predictionio_tpu_torch.tools import _drill  # noqa: E402

WORKERS = 2
READY_S = 180.0
CONVERGE_S = 120.0
# the publisher-side stages every record must carry, in waterfall order
# (fold.* phases vary with the fold's shape and are asserted separately)
ORDERED = ("append_observed", "publish", "plane.write", "watcher_wake",
           "compose", "install", "first_serve")


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
    app_id = storage.apps.insert(App(0, "lineageapp"))
    events = [buy(f"u{u}", f"i{it}")
              for u in range(12) for it in range(8) if (u * it + u) % 3]
    storage.l_events.insert_batch(events, app_id)
    return storage, app_id


def get_json(base: str, path: str, timeout: float = 10.0):
    with urllib.request.urlopen(base + path, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def post_query(base: str, body: dict, timeout: float = 30.0):
    req = urllib.request.Request(
        base + "/queries.json", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parse_args(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--topology", choices=("prefork", "replicated"),
                    help="prefork: deploy --workers 2 --follow (the CPU's "
                         "default); replicated: a --plane-publish publisher "
                         "and a --plane-from subscriber (the card's default)")
    args, device = _drill.parse_args(argv, __doc__.splitlines()[0], ap)
    if args.topology is None:
        args.topology = "prefork" if device.type == "cpu" else "replicated"
    if args.topology == "prefork" and device.type != "cpu":
        ap.error("--topology prefork needs --device cpu: deploy --workers "
                 "serves a CUDA device from one process only")
    return args, device


def start_prefork(engine_json, env, procs):
    """One ``deploy --workers 2 --follow`` group; the (base, pid) of its
    serving workers once every worker is on the publisher's bootstrap
    generation (>= 2: 1 is the parent's initial publish)."""
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    procs[base] = subprocess.Popen(
        _drill.PIO + ["deploy", "--engine-json", engine_json,
                      "--ip", "127.0.0.1", "--port", str(port),
                      "--workers", str(WORKERS), "--follow", "0.2"],
        env=env)
    return base, [base] * WORKERS


def start_replicated(engine_json, env, procs, tmp):
    """A ``deploy --follow --plane-publish`` publisher and a ``deploy
    --plane-from`` subscriber, each with its own node-local plane
    directory; (the subscriber's base, [publisher base, subscriber
    base])."""
    repl_port = free_port()
    bases = []
    for name, extra in (("pub", ["--follow", "0.2", "--plane-publish",
                                 f"127.0.0.1:{repl_port}"]),
                        ("sub", ["--plane-from", f"127.0.0.1:{repl_port}"])):
        port = free_port()
        base = f"http://127.0.0.1:{port}"
        procs[base] = subprocess.Popen(
            _drill.PIO + ["deploy", "--engine-json", engine_json,
                          "--ip", "127.0.0.1", "--port", str(port)] + extra,
            env={**env,
                 "PIO_MODEL_PLANE_DIR": os.path.join(tmp, f"plane-{name}"),
                 "PIO_CLUSTER_NODE": f"node-{name}"})
        bases.append(base)
    return bases[1], bases


def worker_gens(bases, procs) -> dict:
    """GET / of each serving base (a prefork group's repeats: the kernel
    balances fresh connections): {pid: planeGeneration}."""
    seen = {}
    for base in bases:
        if procs[base].poll() is not None:
            raise RuntimeError(
                f"deploy died (rc {procs[base].returncode})")
        try:
            _, d = get_json(base, "/", timeout=2)
            seen[d["pid"]] = int(d.get("planeGeneration") or 0)
        except Exception:
            time.sleep(0.1)
    return seen


def main(argv=None) -> int:
    args, device = parse_args(argv)
    from predictionio_tpu_torch.workflow import core_workflow
    from predictionio_tpu_torch.workflow.create_workflow import engine_from_variant

    replicated = args.topology == "replicated"
    n_serving = 2 if replicated else WORKERS
    problems = []
    tmp = tempfile.mkdtemp(prefix="pio-lineage-rt-")
    store_path = os.path.join(tmp, "store")
    procs: dict = {}
    gen = origin = None
    installs = serves = set()
    try:
        storage, app_id = build_store(store_path)
        variant = {
            "id": "lineage-rt",
            "engineFactory": "predictionio_tpu_torch.models."
                             "universal_recommender."
                             "UniversalRecommenderEngine",
            "datasource": {"params": {
                "appName": "lineageapp", "eventNames": ["purchase"]}},
            "algorithms": [{"name": "ur", "params": {
                "appName": "lineageapp", "eventNames": [], "meshDp": 1,
                "maxCorrelatorsPerItem": 8}}],
        }
        engine_json = os.path.join(tmp, "engine.json")
        with open(engine_json, "w") as f:
            json.dump(variant, f)
        _factory, engine, ep = engine_from_variant(variant)
        core_workflow.run_train(engine, ep, engine_id="lineage-rt",
                                storage=storage, device=device)

        env = _drill.child_env(device, {
            "PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
            "PIO_STORAGE_SOURCES_FS_PATH": store_path,
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "FS",
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "FS",
            "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "FS",
            "PIO_MODEL_PLANE": "on",
            "PIO_MODEL_PLANE_POLL_S": "0.1",
            "PIO_METRICS_FLUSH_S": "0.25",
            "PIO_TSDB_INTERVAL_S": "0.5",
            "PIO_PLANE_REPL_PING_S": "0.5",
            "PIO_PLANE_REPL_BACKOFF_S": "0.2",
        })
        if replicated:
            base, serving = start_replicated(engine_json, env, procs, tmp)
        else:
            base, serving = start_prefork(engine_json, env, procs)

        # ready = every serving process visible AND on the publisher's
        # bootstrap generation (>= 2: 1 is the initial publish of the
        # stored instance)
        pids: dict = {}
        deadline = time.time() + READY_S
        while True:
            if time.time() > deadline:
                raise RuntimeError(f"group not ready in {READY_S}s ({pids})")
            pids.update(worker_gens(serving, procs))
            if len(pids) >= n_serving and all(g >= 2 for g in pids.values()):
                break
            time.sleep(0.05)
        gref = max(pids.values())

        # the delta: co-buyers couple a brand-new item to i1
        storage.l_events.insert_batch(
            [buy("probe0", "i1")]
            + [buy(f"cob{j}", "i1") for j in range(6)]
            + [buy(f"cob{j}", "fresh_item") for j in range(6)], app_id)

        conv: dict = {}
        deadline = time.time() + CONVERGE_S
        while time.time() < deadline:
            conv.update(worker_gens(serving, procs))
            if len(conv) >= n_serving and all(g > gref for g in conv.values()):
                break
            time.sleep(0.05)
        if len(conv) < n_serving or not all(g > gref for g in conv.values()):
            raise RuntimeError(
                f"fold never converged the group in {CONVERGE_S}s "
                f"(gref={gref}, seen={conv})")
        gen = max(conv.values())

        # make EVERY serving process answer on the new generation, so each
        # one records its first_serve hop (SO_REUSEPORT balances a prefork
        # group's fresh connections across it eventually)
        served = set()
        deadline = time.time() + 60
        while len(served) < n_serving and time.time() < deadline:
            for b in serving:
                try:
                    _, d = get_json(b, "/", timeout=2)
                    st, _doc = post_query(b, {"user": "probe0", "num": 5})
                    if st == 200:
                        served.add(d["pid"])
                except Exception:
                    pass
            time.sleep(0.02)
        if len(served) < n_serving:
            problems.append(
                f"only {len(served)}/{n_serving} workers answered queries "
                f"(cannot assert every first_serve hop)")

        # the record needs a persist cycle (0.5 s throttle) to cross
        # processes; poll for completeness instead of sleeping blind
        doc = None
        deadline = time.time() + 30
        while time.time() < deadline:
            st, d = get_json(base, f"/lineage/{gen}.json")
            if st == 200:
                doc = d
                installs = {s.get("worker") for s in d.get("stages", ())
                            if s.get("stage") == "install"}
                serves = {s.get("worker") for s in d.get("stages", ())
                          if s.get("stage") == "first_serve"}
                if (d.get("outcome") == "complete"
                        and len(installs) >= n_serving
                        and (not replicated or len(serves) >= n_serving)):
                    break
            time.sleep(0.25)
        if doc is None:
            raise RuntimeError(f"/lineage/{gen}.json never answered 200")

        stages = doc.get("stages", ())
        names = {s.get("stage") for s in stages}
        if doc.get("outcome") != "complete":
            problems.append(f"generation {gen} record outcome="
                            f"{doc.get('outcome')!r}, expected 'complete'")
        for need in ORDERED:
            if need not in names:
                problems.append(f"record is missing stage {need!r}")
        if not any(n.startswith("fold.") for n in names):
            problems.append("record carries no fold.* phase stage")
        cache_kids = [s for s in stages
                      if s.get("stage") == "cache_invalidation"]
        if not cache_kids:
            problems.append("no cache_invalidation stage (serve cache is "
                            "on by default — the install hook is broken)")
        elif any(s.get("parent") != "install" for s in cache_kids):
            problems.append("cache_invalidation not parented under install")
        installs = {s.get("worker") for s in stages
                    if s.get("stage") == "install"}
        if len(installs) < n_serving:
            problems.append(
                f"install recorded by {sorted(installs)} — expected all "
                f"{n_serving} serving workers")
        serves = {s.get("worker") for s in stages
                  if s.get("stage") == "first_serve"}
        if not serves:
            problems.append("no first_serve stage recorded")
        elif replicated and len(serves) < n_serving:
            problems.append(
                f"first_serve recorded by {sorted(serves)} — expected "
                f"both serving processes")
        origin = doc.get("origin") or ""
        if replicated:
            # the publisher folds AND serves: the origin is one of the two
            # serving processes, and the subscriber is the other
            if origin not in installs or origin not in serves:
                problems.append(
                    f"record origin {origin!r} is not the serving "
                    "publisher — the fold stages came from the wrong "
                    "process")
        else:
            if not origin.startswith("pub-"):
                problems.append(
                    f"record origin {origin!r} is not the plane publisher — "
                    "the fold stages came from the wrong process")
            if origin in installs | serves:
                problems.append(
                    f"origin {origin!r} also recorded install/first_serve — "
                    "the publisher must not serve")
        # waterfall monotonicity on earliest start per ordered stage
        starts = {}
        for s in stages:
            n = s.get("stage")
            if n in ORDERED:
                t = float(s.get("start") or 0)
                starts[n] = min(starts.get(n, t), t)
        seq = [(n, starts[n]) for n in ORDERED if n in starts]
        for (a, ta), (b, tb) in zip(seq, seq[1:]):
            if tb < ta - 1e-3:
                problems.append(
                    f"stage {b} starts before {a} ({tb:.6f} < {ta:.6f})")
        for s in stages:
            if not (0 <= float(s.get("duration_s") or 0) <= 300):
                problems.append(f"stage {s.get('stage')!r} has a bogus "
                                f"duration {s.get('duration_s')!r}")

        # index + id-keyed fetch + cross-process serving proof
        _, index = get_json(base, "/lineage.json")
        entry = next((e for e in index.get("records", ())
                      if e.get("generation") == gen), None)
        if entry is None:
            problems.append(f"/lineage.json does not index generation {gen}")
        elif entry.get("lid") != doc.get("lid"):
            problems.append("/lineage.json indexes a different lid than "
                            "the generation fetch returned")
        server_tag = index.get("worker") or ""
        if not server_tag or server_tag == origin:
            problems.append(
                f"/lineage.json served by {server_tag!r} — must be a "
                "worker that did NOT produce the record")
        st, by_lid = get_json(base, f"/lineage/{doc.get('lid')}.json")
        if st != 200 or by_lid.get("lid") != doc.get("lid"):
            problems.append("id-keyed /lineage/<lid>.json fetch failed")

        # the two lineage consumers answer on the same sockets
        for b in dict.fromkeys(serving):
            st, hz = get_json(b, "/healthz")
            if st != 200:
                problems.append(f"/healthz answered HTTP {st}")
            if hz.get("status") == "burning":
                problems.append(f"/healthz reports burning on an idle "
                                f"deploy: {hz}")
        st, hist = get_json(base, "/metrics/history.json")
        if st != 200 or not hist.get("samples"):
            problems.append("/metrics/history.json has no TSDB samples")
    except Exception as e:  # noqa: BLE001 - the harness wants one rc
        problems.append(f"roundtrip aborted: {e!r}")
    finally:
        # the subscriber first, so it never reconnects to a stopped
        # publisher; a prefork group answers /stop once a worker: repeat
        # while the port answers
        for b, proc in reversed(procs.items()):
            for _ in range(16):
                if proc.poll() is not None:
                    break
                try:
                    with urllib.request.urlopen(b + "/stop",
                                                timeout=5) as r:
                        r.read()
                    time.sleep(0.3)
                except Exception:
                    break
            try:
                proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                proc.terminate()
                try:
                    proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
        from predictionio_tpu_torch.storage.locator import set_storage

        set_storage(None)
        shutil.rmtree(tmp, ignore_errors=True)
    _drill.print_launches(device)
    for p in problems:
        print(f"FAIL {p}", file=sys.stderr)
    if not problems:
        if replicated:
            print(f"ok: generation {gen} lineage complete across a "
                  f"publisher and a subscriber that did not produce it "
                  f"(origin {origin}, installs {sorted(installs)}, first "
                  f"serves {sorted(serves)}), waterfall monotone, /healthz "
                  "+ /metrics/history.json live")
        else:
            print(f"ok: generation {gen} lineage complete across "
                  f"{WORKERS} serving workers + publisher "
                  f"(origin {origin}, installs {sorted(installs)}), "
                  "waterfall monotone, /healthz + /metrics/history.json live")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
