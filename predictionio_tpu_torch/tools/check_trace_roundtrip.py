#!/usr/bin/env python
"""Verify the flight-recorder round trip on a real deployed worker.

Trains a small Universal Recommender on the same deterministic commerce
fixture as check_serve_parity, deploys it (one worker, the memory store),
fires a forced-slow query — ``PIO_TRACE_SLOW_MS=0`` makes EVERY request
exceed the slow threshold, the honest analogue of a production p99
straggler — and asserts its full waterfall is retrievable and
stage-complete:

- the response echoes our X-Request-ID;
- ``/traces/<rid>.json`` returns the trace, kept for reason ``slow``;
- the waterfall carries the ``ur_predict`` span and its five stage
  children (history → score → mask → topk → assemble), each parented
  under ``ur_predict`` with non-negative durations inside the request
  envelope;
- ``/traces.json`` indexes the same rid;
- the request-latency histogram in ``/metrics`` carries a trace-id
  exemplar (the metrics→traces link).  The exemplar is recorded after the
  response's bytes are flushed, so ``/metrics`` is read again until
  ``EXEMPLAR_WAIT_S`` has passed; the check fails only if none ever comes.

Exit 0 = round trip complete; 1 = any assertion failed (printed); 2 = the
device asked for is absent.  Run standalone
(``python -m predictionio_tpu_torch.tools.check_trace_roundtrip
[--device cuda|cpu]``, or the file's path) or via the tier-1 suite
(tests/test_torch_drill_trace.py wraps it).  The port's copy of
``scripts/check_trace_roundtrip.py``: the same checks and messages, the
model trained and served on ``--device`` (default ``cuda``), and this
process's K1/K2/K3 launch counts printed before the verdict.  The query
server runs with ``PIO_SERVE_BATCH=off``: a model on the card turns the
micro-batcher on by default, and a micro-batched query records no
per-query ``ur_predict`` waterfall (``serve_batch_predict`` in neither
package does), so the drill serves the one-query path, the CPU's default.
"""

from __future__ import annotations

import json
import os
import sys
import time
import urllib.error
import urllib.request

# runnable from any cwd without an installed package
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from predictionio_tpu_torch.tools import _drill  # noqa: E402
from predictionio_tpu_torch.tools.check_serve_parity import build_app  # noqa: E402

RID = f"trace-rt-{os.getpid()}"
STAGES = ("history", "score", "mask", "topk", "assemble")
EXEMPLAR_WAIT_S = 5.0
VARIANT = {
    "id": "trace-rt",
    "engineFactory": "predictionio_tpu_torch.models."
                     "universal_recommender."
                     "UniversalRecommenderEngine",
    "datasource": {"params": {
        "appName": "parityapp",
        "eventNames": ["purchase", "view"]}},
    "algorithms": [{"name": "ur", "params": {
        "appName": "parityapp", "eventNames": [], "meshDp": 1,
        "maxCorrelatorsPerItem": 8}}],
}
QUERY = {"user": "u2", "num": 5}


def main(argv=None) -> int:
    import shutil
    import tempfile

    _args, device = _drill.parse_args(argv, __doc__.splitlines()[0])
    # forced-slow: every request's duration exceeds the threshold, so the
    # query below is retained exactly the way a production straggler would be
    os.environ["PIO_TRACE_SLOW_MS"] = "0"
    os.environ["PIO_TRACE_SAMPLE_N"] = "0"
    # the waterfall is the one-query path's: no micro-batcher on the card
    os.environ["PIO_SERVE_BATCH"] = "off"
    problems = []
    tmp = tempfile.mkdtemp(prefix="pio_trace_rt")
    try:
        from predictionio_tpu_torch.obs import tracing as obs_tracing
        from predictionio_tpu_torch.obs.exposition import parse_exemplars
        from predictionio_tpu_torch.workflow import core_workflow
        from predictionio_tpu_torch.workflow.create_server import deploy
        from predictionio_tpu_torch.workflow.create_workflow import (
            engine_from_variant,
        )

        # a fresh recorder so an armed one from earlier imports (or a
        # shared ~/.cache dir) can't satisfy the assertions for us
        obs_tracing.set_recorder(obs_tracing.FlightRecorder())
        storage = build_app()
        engine_json = os.path.join(tmp, "engine.json")
        with open(engine_json, "w") as f:
            json.dump(VARIANT, f)
        _factory, engine, ep = engine_from_variant(VARIANT)
        core_workflow.run_train(engine, ep, engine_id="trace-rt",
                                storage=storage, device=device)
        httpd = deploy(engine_json=engine_json, host="127.0.0.1", port=0,
                       storage=storage, background=True, device=device)
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            req = urllib.request.Request(
                base + "/queries.json",
                data=json.dumps(QUERY).encode(),
                headers={"Content-Type": "application/json",
                         "X-Request-ID": RID})
            with urllib.request.urlopen(req, timeout=30) as r:
                if r.status != 200:
                    problems.append(f"query answered HTTP {r.status}")
                if r.headers.get("X-Request-ID") != RID:
                    problems.append("response did not echo our request id")
                r.read()
            # retention happens in the middleware tail AFTER the response
            # bytes are flushed — a pool sibling can serve our immediate
            # fetch before the POST's thread has indexed the trace, so
            # poll briefly (normally lands within a few ms)
            doc = None
            deadline = time.time() + 5.0
            while True:
                try:
                    with urllib.request.urlopen(
                            base + f"/traces/{RID}.json", timeout=10) as r:
                        doc = json.loads(r.read())
                    break
                except urllib.error.HTTPError as e:
                    if e.code != 404 or time.time() > deadline:
                        raise
                    time.sleep(0.01)
            if doc.get("reason") != "slow":
                problems.append(
                    f"kept for {doc.get('reason')!r}, expected 'slow'")
            if doc.get("status") != 200 or doc.get("route") != "/queries.json":
                problems.append(f"trace envelope wrong: {doc.get('status')} "
                                f"{doc.get('route')!r}")
            by_name = {s["name"]: s for s in doc.get("spans", ())}
            ur = by_name.get("ur_predict")
            if ur is None:
                problems.append("waterfall is missing the ur_predict span")
            for name in STAGES:
                s = by_name.get(name)
                if s is None:
                    problems.append(f"waterfall is missing stage {name!r}")
                    continue
                if ur is not None and s.get("parent") != ur.get("id"):
                    problems.append(
                        f"stage {name!r} not parented under ur_predict")
                if not (0 <= s.get("duration_s", -1) <= 60):
                    problems.append(f"stage {name!r} has a bogus duration")
            with urllib.request.urlopen(base + "/traces.json",
                                        timeout=10) as r:
                index = json.loads(r.read())
            if RID not in {t.get("rid") for t in index.get("traces", ())}:
                problems.append("/traces.json does not index the request")
            # the latency histogram records its exemplar in the same
            # middleware tail as the retention above: read /metrics until
            # one is linked or the deadline passes
            deadline = time.time() + EXEMPLAR_WAIT_S
            while True:
                with urllib.request.urlopen(base + "/metrics",
                                            timeout=10) as r:
                    exemplars = parse_exemplars(r.read().decode())
                linked = {rid for _lb, rid, _v in exemplars.get(
                    "pio_http_request_duration_seconds_bucket", ())}
                if linked or time.time() > deadline:
                    break
                time.sleep(0.05)
            if not linked:
                problems.append(
                    "no trace-id exemplar on the request-latency histogram")
        finally:
            httpd.shutdown()
            httpd.server_close()
    finally:
        from predictionio_tpu_torch.storage.locator import set_storage

        set_storage(None)
        shutil.rmtree(tmp, ignore_errors=True)
    _drill.print_launches(device)
    for p in problems:
        print(f"FAIL {p}", file=sys.stderr)
    if not problems:
        print("ok: forced-slow query retained, waterfall stage-complete "
              f"({', '.join(STAGES)}), indexed, exemplar-linked")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
