"""The port stands alone: it imports neither JAX nor the JAX package, and
it never continues on the CPU unless told to."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "predictionio_tpu_torch"

# the port's ALS serving path, the UR path from the store (events with
# $set properties -> run_train -> load_latest_models -> deploy -> a rule
# query), ALS training of the recommendation and e-commerce templates, CCO's
# blocked layout and its chunked and sparse strategies, and the
# similar-product template on the CPU, in a fresh interpreter
_DRIVE = r"""
import json, sys, urllib.request
import numpy as np
from predictionio_tpu_torch.controller import EngineParams
from predictionio_tpu_torch.models import recommendation as reco
from predictionio_tpu_torch.workflow.create_server import deploy_models

rng = np.random.default_rng(0)
state = {
    "X": rng.normal(size=(4, 3)).astype(np.float32),
    "Y": rng.normal(size=(9, 3)).astype(np.float32),
    "users": [f"u{i}" for i in range(4)], "items": [f"i{i}" for i in range(9)],
    "seen": {"indptr": np.array([0, 2, 2, 3, 3]), "values": np.array([1, 4, 0])},
}
model = reco.als_model_from_state(state, device="cpu")
engine = reco.RecommendationEngine.apply()
ep = EngineParams(algorithm_params_list=[("als", reco.ALSAlgorithmParams())])
engine.predictor(ep, [model])(reco.RecoQuery(user="u0", num=3, unseen_only=True))
engine.batch_predictor(ep, [model])([reco.RecoQuery(user="u1", num=2)] * 3)
server = deploy_models(engine, ep, [model], query_class=reco.RecoQuery)
url = f"http://127.0.0.1:{server.server_address[1]}/queries.json"
req = urllib.request.Request(url, data=json.dumps({"user": "u2"}).encode())
assert json.loads(urllib.request.urlopen(req, timeout=30).read())["itemScores"]
server.shutdown(); server.server_close()

import os, tempfile
from predictionio_tpu_torch.events.event import Event
from predictionio_tpu_torch.models import universal_recommender as ur
from predictionio_tpu_torch.storage import App, Storage, StorageConfig, set_storage
from predictionio_tpu_torch.workflow.core_workflow import load_latest_models, run_train
from predictionio_tpu_torch.workflow.create_server import deploy
from predictionio_tpu_torch.workflow.create_workflow import engine_from_variant

store = Storage(StorageConfig.memory())
set_storage(store)
app = store.apps.insert(App(0, "a"))
u, i = rng.integers(0, 30, 300), rng.integers(0, 12, 300)
store.l_events.insert_batch(
    [Event("buy", "user", f"u{a}", "item", f"i{b}", event_time=1.7e9 + k,
           creation_time=1.7e9 + k) for k, (a, b) in enumerate(zip(u, i))]
    + [Event("$set", "item", f"i{j}", properties={"category": f"c{j % 3}"},
             event_time=1.7e9, creation_time=1.7e9) for j in range(12)], app)
variant = {"engineFactory": "universal_recommender",
           "datasource": {"params": {"appName": "a", "eventNames": ["buy"]}},
           "algorithms": [{"name": "ur", "params": {"appName": "a",
                                                    "maxCorrelatorsPerItem": 4}}]}
_, ur_engine, ur_ep = engine_from_variant(variant)
assert run_train(ur_engine, ur_ep, "smoke", storage=store, device="cpu").status == "COMPLETED"
_, (ur_model,) = load_latest_models("smoke", storage=store, device="cpu")
assert ur_engine.predictor(ur_ep, [ur_model])(ur.URQuery(user="u1", num=3)).item_scores
with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, "engine.json")
    with open(path, "w") as f:
        json.dump(variant, f)
    server = deploy(path, engine_id="smoke", host="127.0.0.1", port=0, storage=store,
                    device="cpu")
url = f"http://127.0.0.1:{server.server_address[1]}/queries.json"
for body in ({"item": "i2"}, {"user": "u1", "num": 4, "fields": [
        {"name": "category", "values": ["c1"], "bias": -1}]}):
    req = urllib.request.Request(url, data=json.dumps(body).encode())
    got = json.loads(urllib.request.urlopen(req, timeout=30).read())["itemScores"]
    assert got and ("fields" not in body or all(int(d["item"][1:]) % 3 == 1 for d in got))
server.shutdown(); server.server_close()

# ALS training (explicit, checkpointed) and the e-commerce template from the store
store.l_events.insert_batch(
    [Event("rate", "user", f"u{a}", "item", f"i{b}", properties={"rating": float(b % 5)},
           event_time=1.8e9 + k, creation_time=1.8e9 + k) for k, (a, b) in enumerate(zip(u, i))]
    + [Event("view", "user", f"u{a}", "item", f"i{b}", event_time=1.8e9 + k,
             creation_time=1.8e9 + k) for k, (a, b) in enumerate(zip(u, i))]
    + [Event("$set", "item", f"i{j}", properties={"categories": [f"c{j % 3}"]},
             event_time=1.8e9, creation_time=1.8e9) for j in range(12)], app)
for variant in (
        {"engineFactory": "recommendation", "datasource": {"params": {"appName": "a"}},
         "algorithms": [{"name": "als", "params": {"rank": 3, "numIterations": 2,
                                                   "checkpointEvery": 1}}]},
        {"engineFactory": "ecommerce", "datasource": {"params": {"appName": "a"}},
         "algorithms": [{"name": "ecomm", "params": {"appName": "a", "rank": 3,
                                                     "numIterations": 2}}]}):
    os.environ["PIO_CHECKPOINT_DIR"] = tempfile.mkdtemp()
    factory, engine, ep = engine_from_variant(variant)
    (model,) = engine.train(ep, device="cpu")
    assert engine.predictor(ep, [model])(factory.query_class.from_json(
        {"user": "u1", "num": 3})).item_scores

# CCO at every scale (the native blocked layout, the chunked and sparse
# strategies) and both algorithms of the similar-product template
from predictionio_tpu_torch.ops import cco
blocked = cco.block_interactions(u, i, 30, 12, user_block=8)
os.environ["PIO_CCO_SPARSE"], os.environ["PIO_CCO_DENSE"] = "0", "0"
cco._TILED_P_BYTES = 0
chunked = cco.cco_indicators(blocked, blocked, n_total_users=30, top_k=3, item_tile=4,
                             exclude_self=True, device="cpu")
os.environ["PIO_CCO_SPARSE"], os.environ["PIO_CCO_DENSE"] = "1", "auto"
sparse = cco.cco_indicators_coo(u, i, u, i, 30, 12, 12, top_k=3, exclude_self=True,
                                device="cpu")
assert (chunked[1] == sparse[1]).all() and (chunked[0] == sparse[0]).all()
for algo, params in (("cooccurrence", {"minLlr": 0.0}), ("als", {"rank": 3})):
    factory, engine, ep = engine_from_variant({
        "engineFactory": "similar_product", "datasource": {"params": {"appName": "a"}},
        "algorithms": [{"name": algo, "params": params}]})
    (model,) = engine.train(ep, device="cpu")
    assert engine.predictor(ep, [model])(factory.query_class.from_json(
        {"items": ["i1"], "num": 3, "categories": ["c1"]})).item_scores is not None

# the UR's host scorer and tails, the response and history caches, the
# native serve core and the checkpointed UR train
from predictionio_tpu_torch.native import core as ncore
from predictionio_tpu_torch.serve import history_cache, response_cache
_, ur_engine, ur_ep = engine_from_variant(variant_ur := {
    "engineFactory": "universal_recommender",
    "datasource": {"params": {"appName": "a", "eventNames": ["buy", "view"]}},
    "algorithms": [{"name": "ur", "params": {"appName": "a", "maxCorrelatorsPerItem": 4,
                                             "checkpoint": True}}]})
os.environ["PIO_CHECKPOINT_DIR"] = tempfile.mkdtemp()
(ur_model,) = ur_engine.train(ur_ep, device="cpu")
response_cache.get_cache().on_swap([ur_model])
predict = ur_engine.predictor(ur_ep, [ur_model])
first = predict(ur.URQuery(user="u1", num=4)).to_json()
assert predict(ur.URQuery(user="u1", num=4)).to_json() == first
assert response_cache.get_cache().hit_count == 1
assert history_cache.get_cache()._lru.get(("a", None, "user", "u1", "buy", 100),
                                          count=False) is not None
assert ncore.calls["serve"] > 0 or not ncore.serve_enabled()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "predictionio_tpu" or m.startswith("predictionio_tpu."))
print(json.dumps(bad))
"""


def _is_forbidden(module: str) -> bool:
    # the port's own name starts with "predictionio_tpu": match the JAX
    # package by its exact name or its dotted prefix only
    return module in ("jax", "predictionio_tpu") or module.startswith(
        ("jax.", "predictionio_tpu."))


def test_port_path_loads_no_jax_module():
    out = subprocess.run([sys.executable, "-c", _DRIVE], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


# the pio console's loop on a localfs store (native scan, train, export),
# in a fresh interpreter
_CLI = r"""
import json, os, sys, tempfile
d = tempfile.mkdtemp()
os.environ.update(PIO_FS_BASEDIR=os.path.join(d, "store"), PIO_TORCH_DEVICE="cpu")
from predictionio_tpu_torch.cli.main import main
with open(os.path.join(d, "events.jsonl"), "w") as f:
    for k in range(200):
        f.write(json.dumps({"event": "buy", "entityType": "user", "entityId": f"u{k % 17}",
                            "targetEntityType": "item", "targetEntityId": f"i{k % 11}"}) + "\n")
    f.write(json.dumps({"event": "$set", "entityType": "item", "entityId": "i1",
                        "properties": {"category": "c"}}) + "\n")
with open(os.path.join(d, "engine.json"), "w") as f:
    json.dump({"engineFactory": "universal_recommender",
               "datasource": {"params": {"appName": "a", "eventNames": ["buy"]}},
               "algorithms": [{"name": "ur", "params": {"appName": "a"}}]}, f)
os.chdir(d)
for argv in (["app", "new", "a"], ["import", "--app-name", "a", "--input", "events.jsonl"],
             ["build"], ["train"], ["export", "--app-name", "a", "--output", "out.jsonl"],
             ["status"]):
    assert main(argv) == 0, argv
from predictionio_tpu_torch.native import scanner
assert scanner.scans_served == 1
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "predictionio_tpu" or m.startswith("predictionio_tpu."))
print(json.dumps(bad))
"""


def test_cli_loads_no_jax_module():
    out = subprocess.run([sys.executable, "-c", _CLI], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


# the snapshot path in a fresh interpreter: pio import -> pio snapshot -> a
# tail import -> pio train from the mapped snapshot and its tail (the
# native header parse counted), then the staged cache's delta read
_SNAPSHOT = r"""
import json, os, sys, tempfile
d = tempfile.mkdtemp()
os.environ.update(PIO_FS_BASEDIR=os.path.join(d, "store"), PIO_TORCH_DEVICE="cpu",
                  PIO_NATIVE="on")
from predictionio_tpu_torch.cli.main import main
from predictionio_tpu_torch.native import core, scanner
from predictionio_tpu_torch.storage import snapshot
from predictionio_tpu_torch.store.event_store import PEventStore
for name, lo, hi in (("a.jsonl", 0, 150), ("b.jsonl", 150, 200)):
    with open(os.path.join(d, name), "w") as f:
        for k in range(lo, hi):
            f.write(json.dumps({"event": "buy", "entityType": "user", "entityId": f"u{k % 17}",
                                "targetEntityType": "item", "targetEntityId": f"i{k % 11}"}) + "\n")
with open(os.path.join(d, "engine.json"), "w") as f:
    json.dump({"engineFactory": "universal_recommender",
               "datasource": {"params": {"appName": "a", "eventNames": ["buy"]}},
               "algorithms": [{"name": "ur", "params": {"appName": "a"}}]}, f)
os.chdir(d)
for argv in (["app", "new", "a"], ["import", "--app-name", "a", "--input", "a.jsonl"],
             ["snapshot", "a"], ["import", "--app-name", "a", "--input", "b.jsonl"],
             ["snapshot", "a", "--status"], ["build"], ["train"]):
    assert main(argv) == 0, argv
assert snapshot.staged_counts() == {"snapshot": 150, "tail": 50, "delta": 0}
assert scanner.scans_served == 0 and core.calls["scan"] == 1
assert len(PEventStore.batch("a")) == 200
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "predictionio_tpu" or m.startswith("predictionio_tpu."))
print(json.dumps(bad))
"""


def test_snapshot_path_loads_no_jax_module():
    out = subprocess.run([sys.executable, "-c", _SNAPSHOT], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


# a store the JAX package wrote, read by the port's console in a fresh
# interpreter
_READ_JAX_STORE = r"""
import json, sys
from predictionio_tpu_torch.cli.main import main
from predictionio_tpu_torch.store.event_store import PEventStore
assert main(["export", "--app-name", "jaxapp", "--output", sys.argv[1]]) == 0
batch = PEventStore.native_batch("jaxapp")
print(len(batch), sorted(batch.prop_columns))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "predictionio_tpu" or m.startswith("predictionio_tpu."))
print(json.dumps(bad))
"""


def test_port_reads_a_jax_written_store_without_importing_it(tmp_path):
    import os

    from predictionio_tpu.events.event import Event as JaxEvent
    from predictionio_tpu.storage import App as JaxApp
    from predictionio_tpu.storage.locator import Storage as JaxStorage
    from predictionio_tpu.storage.locator import StorageConfig as JaxStorageConfig

    store = JaxStorage(JaxStorageConfig(
        sources={"S": {"type": "localfs", "path": str(tmp_path / "store")}},
        repositories={r: "S" for r in ("METADATA", "EVENTDATA", "MODELDATA")}))
    app = store.apps.insert(JaxApp(0, "jaxapp"))
    events = [JaxEvent("buy", "user", f"u{k % 5}", "item", f"i{k % 7}",
                       event_time=1.7e9 + k, creation_time=1.7e9 + k) for k in range(30)]
    events.append(JaxEvent("$set", "item", "i1", properties={"category": "c"},
                           event_time=1.7e9, creation_time=1.7e9))
    store.l_events.insert_batch(events, app)
    env = {**{k: v for k, v in os.environ.items() if not k.startswith("PIO_")},
           "PIO_FS_BASEDIR": str(tmp_path / "store")}
    out = subprocess.run([sys.executable, "-c", _READ_JAX_STORE, str(tmp_path / "out.jsonl")],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "[]"
    assert lines[-2] == "31 ['category']"
    want = [e.to_json_line() for e in store.l_events.find(app)]
    assert (tmp_path / "out.jsonl").read_text().splitlines() == want


def test_port_reads_what_the_jax_event_server_wrote_without_importing_it(tmp_path):
    """The JAX event server appends posted events to its localfs store; the
    port's console exports them in a fresh interpreter that never imports
    the JAX package."""
    import os

    from _torch_event_cases import T0, jax_event_server_writes
    from predictionio_tpu.storage.locator import Storage as JaxStorage
    from predictionio_tpu.storage.locator import StorageConfig as JaxStorageConfig

    store = JaxStorage(JaxStorageConfig(
        sources={"S": {"type": "localfs", "path": str(tmp_path / "store")}},
        repositories={r: "S" for r in ("METADATA", "EVENTDATA", "MODELDATA")}))
    specs = [("buy", "user", f"u{k % 5}", "item", f"i{k % 7}", {}, T0 + k, T0 + k)
             for k in range(30)]
    specs.append(("$set", "item", "i1", None, None, {"category": "c"}, T0, T0))
    app_id = jax_event_server_writes(store, "jaxapp", specs)
    env = {**{k: v for k, v in os.environ.items() if not k.startswith("PIO_")},
           "PIO_FS_BASEDIR": str(tmp_path / "store")}
    out = subprocess.run([sys.executable, "-c", _READ_JAX_STORE, str(tmp_path / "out.jsonl")],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "[]"
    assert lines[-2] == "31 ['category']"
    want = [e.to_json_line() for e in store.l_events.find(app_id)]
    assert (tmp_path / "out.jsonl").read_text().splitlines() == want


# the front end in a fresh interpreter: the event server (HTTP ingest,
# the native head parse), a micro-batched query server with feedback and
# auto-reload, /metrics through `pio metrics`, the admin server
_SERVERS = r"""
import json, os, sys, tempfile, threading, urllib.request
d = tempfile.mkdtemp()
os.environ.update(PIO_FS_BASEDIR=os.path.join(d, "store"), PIO_TORCH_DEVICE="cpu",
                  PIO_NATIVE="on", PIO_SERVE_BATCH="on")
from predictionio_tpu_torch.api.admin import run_admin_server
from predictionio_tpu_torch.api.event_server import run_event_server
from predictionio_tpu_torch.cli.main import main
from predictionio_tpu_torch.native import core
from predictionio_tpu_torch.storage import get_storage
from predictionio_tpu_torch.workflow.create_server import deploy

def call(method, url, body=None):
    req = urllib.request.Request(url, method=method, data=None if body is None
                                 else json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())

adm = run_admin_server(port=0, background=True)
key = call("POST", f"http://127.0.0.1:{adm.server_address[1]}/cmd/app", {"name": "a"})["accessKey"]
adm.shutdown(); adm.server_close()
es = run_event_server(host="127.0.0.1", port=0, background=True)
url = f"http://127.0.0.1:{es.server_address[1]}/batch/events.json?accessKey={key}"
for k in range(0, 300, 50):
    res = call("POST", url, [{"event": "rate", "entityType": "user", "entityId": f"u{j % 13}",
                              "targetEntityType": "item", "targetEntityId": f"i{j % 17}",
                              "properties": {"rating": float(j % 5 + 1)}}
                             for j in range(k, k + 50)])
    assert {r["status"] for r in res} == {201}
assert core.calls["http"] > 0
with open(os.path.join(d, "engine.json"), "w") as f:
    json.dump({"id": "e", "engineFactory": "recommendation",
               "datasource": {"params": {"appName": "a"}},
               "algorithms": [{"name": "als", "params": {"rank": 3, "numIterations": 2}}]}, f)
os.chdir(d)
assert main(["train"]) == 0
srv = deploy("engine.json", host="127.0.0.1", port=0, device="cpu", feedback=True,
             auto_reload=0.05)
assert srv.pio_state.batcher is not None
q = f"http://127.0.0.1:{srv.server_address[1]}/queries.json"
ts = [threading.Thread(target=call, args=("POST", q, {"user": f"u{u}", "num": 3}))
      for u in range(8)]
[t.start() for t in ts]; [t.join(30) for t in ts]
assert main(["metrics", f"127.0.0.1:{srv.server_address[1]}"]) == 0
srv.shutdown(); srv.server_close(); es.shutdown(); es.server_close()
assert len(list(get_storage().l_events.find(1, event_names=["predict"]))) == 8
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "predictionio_tpu" or m.startswith("predictionio_tpu."))
print(json.dumps(bad))
"""


def test_servers_load_no_jax_module():
    out = subprocess.run([sys.executable, "-c", _SERVERS], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


# the evaluation workflow, the five remaining templates trained from a
# memory store and served, basket rules, the e2 helpers and pio template,
# in a fresh interpreter
_SLICE13 = r"""
import json, os, sys, tempfile
import numpy as np
from predictionio_tpu_torch.controller import EngineParams, Evaluation, OptionAverageMetric
from predictionio_tpu_torch.e2 import CategoricalNaiveBayes, MarkovChain, k_fold_split
from predictionio_tpu_torch.events.event import Event
from predictionio_tpu_torch.models.recommendation import engine as reco
from predictionio_tpu_torch.ops import cco
from predictionio_tpu_torch.storage import App, Storage, StorageConfig, set_storage
from predictionio_tpu_torch.workflow.core_workflow import run_eval
from predictionio_tpu_torch.workflow.create_workflow import engine_from_variant
from predictionio_tpu_torch.workflow.fast_eval import FastEvalEngine

rng = np.random.default_rng(0)
store = Storage(StorageConfig.memory())
set_storage(store)
app = store.apps.insert(App(0, "a"))
ev = []
for k in range(400):
    u, i, t = int(rng.integers(20)), int(rng.integers(15)), 1.7e9 + 60.0 * k
    ev.append(Event("rate", "user", f"u{u}", "item", f"i{i}", properties={"rating": float(i % 5)},
                    event_time=t, creation_time=t))
    ev.append(Event("buy", "user", f"u{u}", "item", f"i{(i * 7) % 15}", event_time=t,
                    creation_time=t))
    ev.append(Event("view", "user", f"u{u}", "item", f"/p{i % 3}",
                    properties={"sessionId": f"s{k // 2}", "landingPageId": f"/p{i % 3}",
                                "referrerId": "r", "browser": "b"}, event_time=t,
                    creation_time=t))
    ev.append(Event("train", "content", f"d{k}", properties={
        "text": "win free cash" if k % 3 else "see you at lunch",
        "label": "spam" if k % 3 else "ham"}, event_time=t, creation_time=t))
for u in range(20):
    ev.append(Event("$set", "user", f"u{u}", properties={
        "attr0": float(u % 3), "attr1": float(u % 2), "attr2": 1.0,
        "label": "y" if u % 3 else "n"}, event_time=1.7e9, creation_time=1.7e9))
store.l_events.insert_batch(ev, app)

class P10(OptionAverageMetric):
    def score_one(self, q, p, a):
        return None if a[1] < 4.0 else float(a[0] in [s.item for s in p.item_scores])

evaluation = Evaluation(engine=reco.RecommendationEngine.apply(), metric=P10(),
                        engine_params_list=[EngineParams(
                            data_source_params=reco.DataSourceParams(app_name="a", eval_k=2),
                            algorithm_params_list=[("als", reco.ALSAlgorithmParams(
                                rank=r, num_iterations=2))]) for r in (2, 3)])
fast = FastEvalEngine(evaluation.engine, device="cpu")
result = run_eval(evaluation, storage=store, device="cpu", eval_runner=fast.eval)
assert fast.stats["folds"] == 1 and store.evaluation_instances.get_completed()
for factory, algos, query in (
        ("product_ranking", [("als", {"rank": 3, "numIterations": 2})],
         {"user": "u1", "items": ["i1", "i2", "nope"]}),
        ("complementary_purchase", [("rules", {})], {"items": ["i1"], "num": 3}),
        ("classification", [("logreg", {"iterations": 5}), ("naivebayes", {})],
         {"attr0": 1.0, "attr1": 0.0, "attr2": 1.0}),
        ("lead_scoring", [("logreg", {"iterations": 5})], {"landingPageId": "/p1"}),
        ("text", [("nb", {"dim": 64}), ("logreg", {"dim": 64, "iterations": 3}),
                  ("mlp", {"vocabSize": 64, "iterations": 3})], {"text": "free cash"})):
    for algo in algos:
        f, engine, ep = engine_from_variant({
            "engineFactory": factory, "datasource": {"params": {"appName": "a"}},
            "algorithms": [{"name": algo[0], "params": algo[1]}]})
        models = engine.train(ep, device="cpu")
        assert engine.predictor(ep, models)(f.query_class.from_json(query)).to_json()
b = rng.integers(0, 50, 300).astype(np.int32)
cco._BASKET_RULES_DENSE_MAX_ITEMS = 4
assert (cco.basket_rules(np.sort(b), b % 9, 50, 9, top_k=3, item_tile=4,
                         device="cpu")[1] >= -1).all()
assert CategoricalNaiveBayes.predict(CategoricalNaiveBayes.train(
    [("a", ["x"]), ("b", ["y"])]), ["x"]) == "a"
assert MarkovChain.train([(0, 1)], 2, 1).next_states(0) == [(1, 1.0)]
assert len(list(k_fold_split(list(range(9)), 3))) == 3
from predictionio_tpu_torch.cli.main import main
d = tempfile.mkdtemp()
assert main(["template", "list"]) == 0
assert main(["template", "new", "text", os.path.join(d, "t")]) == 0
assert main(["build", "--engine-json", os.path.join(d, "t", "engine.json")]) == 0
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "predictionio_tpu" or m.startswith("predictionio_tpu."))
print(json.dumps(bad))
"""


def test_slice13_path_loads_no_jax_module():
    out = subprocess.run([sys.executable, "-c", _SLICE13], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


# the model plane and its replication in a fresh interpreter: a CPU fold's
# model published through a plane, replicated over loopback and composed
_PLANE = r"""
import json, os, sys, tempfile
from predictionio_tpu_torch.events.event import Event
from predictionio_tpu_torch.models.universal_recommender.engine import (
    URAlgorithmParams, URDataSourceParams)
from predictionio_tpu_torch.store.columnar import EventBatch
from predictionio_tpu_torch.streaming.fold import URFoldState
from predictionio_tpu_torch.streaming.plane import ModelPlane
from predictionio_tpu_torch.streaming.replicate import PlaneReplicator, PlaneSubscriber

d = tempfile.mkdtemp()
batch = EventBatch.from_events([Event("buy", "user", f"u{j // 3}", "item", f"i{j}")
                                for j in range(60)])
batch.prop_columns = {}
state = URFoldState.bootstrap(URAlgorithmParams(app_name="p", max_correlators_per_item=4),
                              URDataSourceParams(app_name="p", event_names=["buy"]), batch,
                              device="cpu")
pub = ModelPlane(os.path.join(d, "pub"), device="cpu")
pub.publish([state.model])
repl = PlaneReplicator(pub, bind="127.0.0.1:0")
repl.start()
sub = PlaneSubscriber(os.path.join(d, "sub"), f"127.0.0.1:{repl.port}")
sub.start()
assert sub.wait_generation(1, timeout=60)
sub.stop()
repl.stop()
reader = ModelPlane(os.path.join(d, "sub"), device="cpu")
model, info = reader.load(reader.current())
assert info["planeGeneration"] == 1 and len(model.item_dict) == 60
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "predictionio_tpu" or m.startswith("predictionio_tpu."))
print(json.dumps(bad))
"""


def test_plane_path_loads_no_jax_module():
    out = subprocess.run([sys.executable, "-c", _PLANE], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


# the store backends streaming runs on, in a fresh interpreter: events on a
# 2 x 2 sharded store (the merged snapshot, a tail, a promotion), metadata in
# SQLite, models on sharedfs, a fold over the sharded tail
_STORES = r"""
import json, os, shutil, sys, tempfile
from pathlib import Path
from predictionio_tpu_torch.events.event import Event
from predictionio_tpu_torch.models.universal_recommender.engine import (
    URAlgorithmParams, URDataSourceParams)
from predictionio_tpu_torch.storage import App, Storage, StorageConfig
from predictionio_tpu_torch.streaming.fold import URFoldState

d = Path(tempfile.mkdtemp())
store = Storage(StorageConfig(
    sources={"EV": {"type": "sharded", "path": str(d / "ev"), "shards": "2", "replicas": "2"},
             "META": {"type": "sql", "path": str(d / "meta.db")},
             "MOD": {"type": "sharedfs", "path": str(d / "models")}},
    repositories={"EVENTDATA": "EV", "METADATA": "META", "MODELDATA": "MOD"}))
app = store.apps.insert(App(0, "s"))
ev = store.l_events
ev.insert_batch([Event("buy", "user", f"u{j % 9}", "item", f"i{j % 7}") for j in range(80)], app)
ev.build_snapshot(app)
res = ev.snapshot_scan(app)
state = URFoldState.bootstrap(URAlgorithmParams(app_name="s", max_correlators_per_item=4),
                              URDataSourceParams(app_name="s", event_names=["buy"]),
                              res["batch"], device="cpu")
shutil.move(str(d / "ev" / "shard_00" / "a"), str(d / "lost"))
ev.insert_batch([Event("buy", "user", f"v{j}", "item", "i1") for j in range(6)], app)
tail = ev.scan_tail_from(app, None, res["watermark"], base=state.batch, heads=res["heads"])
state.fold(tail["batch"])
store.models.insert("m", b"x")
assert tail["events"] == 6 and store.models.get("m") == b"x"
assert ev.topology_status()["perShard"][0]["epoch"] == 1
ev.close()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "predictionio_tpu" or m.startswith("predictionio_tpu."))
print(json.dumps(bad))
"""


def test_store_backends_load_no_jax_module():
    out = subprocess.run([sys.executable, "-c", _STORES], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _registered_families(path):
    """(name, kind, help) of every ``_REG.counter/gauge/histogram`` call at
    the top of a module's source (read, not imported)."""
    tree = ast.parse(Path(path).read_text())
    out = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("counter", "gauge", "histogram")
                and isinstance(node.func.value, ast.Name) and node.func.value.id == "_REG"):
            name, help_ = (ast.literal_eval(a) for a in node.args[:2])
            out.append((name, node.func.attr, help_))
    return out


def test_pio_store_families_are_the_jax_ones():
    """The nine ``pio_store_*`` families of the JAX sharded store (its
    ``sharded.py``, read as source) are in the port's registry under the
    same names, kinds and help texts once the port's store is imported."""
    from predictionio_tpu_torch.obs.metrics import get_registry
    from predictionio_tpu_torch.storage import sharded  # noqa: F401  (registers them)

    want = _registered_families(REPO / "predictionio_tpu" / "storage" / "sharded.py")
    assert [w[0] for w in want] == [
        "pio_store_shard_events_total", "pio_store_replica_lag_events",
        "pio_store_replicated_bytes_total", "pio_store_replica_heals_total",
        "pio_store_promotions_total", "pio_store_shards",
        "pio_store_scan_shard_duration_seconds", "pio_store_scan_workers",
        "pio_store_scan_merged_events_per_sec"]
    assert _registered_families(PORT / "storage" / "sharded.py") == want
    reg = get_registry()
    for name, kind, help_ in want:
        m = reg._metrics[name]
        assert (m.kind, m.help) == (kind, help_), name


# the observability slice in a fresh interpreter: the event and query
# servers' trace, lineage, history, healthz and cluster routes, a traced
# train's span journal, the dashboard, `pio trace|lineage|top` and the SDK
_OBS = r"""
import json, os, sys, tempfile, urllib.error, urllib.request
d = tempfile.mkdtemp()
os.environ.update(PIO_FS_BASEDIR=os.path.join(d, "store"), PIO_TORCH_DEVICE="cpu",
                  PIO_TSDB_INTERVAL_S="0.2")
from predictionio_tpu_torch.api.dashboard import run_dashboard
from predictionio_tpu_torch.api.event_server import run_event_server
from predictionio_tpu_torch.cli.main import main
from predictionio_tpu_torch.obs import spans
from predictionio_tpu_torch.sdk import EngineClient, EventClient
from predictionio_tpu_torch.storage import AccessKey, App, get_storage
from predictionio_tpu_torch.utils import load_pio_env, profile_to, timed
from predictionio_tpu_torch.workflow.create_server import deploy

def get(url, headers=None):
    try:
        with urllib.request.urlopen(urllib.request.Request(url, headers=headers or {}),
                                    timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, None

store = get_storage()
app = store.apps.insert(App(0, "a"))
key = store.access_keys.insert(AccessKey("", app, []))
es = run_event_server(host="127.0.0.1", port=0, background=True)
base = f"http://127.0.0.1:{es.server_address[1]}"
pipe = EventClient(key, base).pipeline(depth=8)
for j in range(300):
    pipe.create_event("rate", "user", f"u{j % 13}", "item", f"i{j % 17}",
                      {"rating": float(j % 5 + 1)})
pipe.close()
get(base + "/", {"X-Request-ID": "obs-1", "X-PIO-Debug": "1"})
with open(os.path.join(d, "engine.json"), "w") as f:
    json.dump({"id": "e", "engineFactory": "recommendation",
               "datasource": {"params": {"appName": "a"}},
               "algorithms": [{"name": "als", "params": {"rank": 3, "numIterations": 2}}]}, f)
os.chdir(d)
assert main(["train"]) == 0
inst = store.engine_instances.get_latest_completed("e", "1", "default")
tree = [s["name"] for s in spans.read_journal(spans.journal_path(store, inst.id))]
assert sorted(tree) == ["engine_train", "save_models", "staging_summary", "train"], tree
srv = deploy("engine.json", host="127.0.0.1", port=0, device="cpu")
q = f"http://127.0.0.1:{srv.server_address[1]}"
assert EngineClient(q).send_query({"user": "u1", "num": 3})["itemScores"]
statuses = [get(q + p)[0] for p in ("/traces.json", "/lineage.json", "/metrics/history.json",
                                    "/healthz", "/cluster/metrics.json")]
assert statuses == [200, 200, 200, 200, 404], statuses
assert get(base + "/traces/obs-1.json")[0] == 200
for argv in (["trace", base, "--rid", "obs-1"], ["lineage", q], ["top", q]):
    main(argv)
dash = run_dashboard(host="127.0.0.1", port=0, background=True)
doc = get(f"http://127.0.0.1:{dash.server_address[1]}/dashboard.json")[1]
assert [e["id"] for e in doc["engineInstances"]] == [inst.id]
with timed("probe"), profile_to(os.path.join(d, "prof"), host_tracer_level=0):
    pass
load_pio_env(apply=False)
for s in (srv, es, dash):
    s.shutdown(); s.server_close()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "predictionio_tpu" or m.startswith("predictionio_tpu."))
print(json.dumps(bad))
"""


def test_observability_path_loads_no_jax_module():
    out = subprocess.run([sys.executable, "-c", _OBS], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


# the workflow package's exports and create_server's module-level names,
# as the JAX package has them, in a fresh interpreter
_WORKFLOW_NAMES = r"""
import json, sys
from predictionio_tpu_torch.workflow import (load_engine_variant, resolve_engine_factory,
                                             run_eval, run_train)
from predictionio_tpu_torch.workflow import core_workflow, create_workflow
from predictionio_tpu_torch.workflow.create_server import (engine_from_variant,
                                                           resolve_engine_id)
from predictionio_tpu_torch.workflow.create_server import load_engine_variant as lev
assert (run_train, run_eval) == (core_workflow.run_train, core_workflow.run_eval)
assert load_engine_variant is lev is create_workflow.load_engine_variant
assert resolve_engine_factory is create_workflow.resolve_engine_factory
assert engine_from_variant is create_workflow.engine_from_variant
assert resolve_engine_id is create_workflow.resolve_engine_id
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "predictionio_tpu" or m.startswith("predictionio_tpu."))
print(json.dumps(bad))
"""


def test_workflow_exports_load_no_jax_module():
    out = subprocess.run([sys.executable, "-c", _WORKFLOW_NAMES], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


_OBS_FAMILIES = {
    "obs/tracing.py": ("pio_trace",), "obs/lineage.py": ("pio_lineage_",),
    "obs/slo.py": ("pio_slo_burn_rate",), "obs/cluster.py": ("pio_cluster_",),
    "workflow/core_workflow.py": ("pio_train_runs_total", "pio_train_duration_seconds",
                                  "pio_eval_runs_total", "pio_train_staged_events_total"),
}


@pytest.mark.parametrize("module", sorted(_OBS_FAMILIES))
def test_observability_families_are_the_jax_ones(module):
    """The families the JAX module registers (read as source) are the
    port's module's, in order, with the same names, kinds and help texts,
    and the port's registry holds them once the module is imported."""
    import importlib

    from predictionio_tpu_torch.obs.metrics import get_registry

    want = _registered_families(REPO / "predictionio_tpu" / module)
    assert want and all(n.startswith(_OBS_FAMILIES[module]) for n, _, _ in want)
    assert _registered_families(PORT / module) == want
    importlib.import_module("predictionio_tpu_torch." + module[:-3].replace("/", "."))
    reg = get_registry()
    for name, kind, help_ in want:
        m = reg._metrics[name]
        assert (m.kind, m.help) == (kind, help_), name


def test_forbidden_module_match_is_exact():
    assert _is_forbidden("jax") and _is_forbidden("jax.numpy")
    assert _is_forbidden("predictionio_tpu")
    assert _is_forbidden("predictionio_tpu.ops.als")
    assert not _is_forbidden("predictionio_tpu_torch")
    assert not _is_forbidden("predictionio_tpu_torch.ops.als")
    assert not _is_forbidden("jaxlib_free")


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(REPO).as_posix() for p in PORT.rglob("*.py")]
    + ["chip_smoke.py", "profile_torch.py"]))
def test_no_file_of_the_port_imports_jax(path):
    tree = ast.parse((REPO / path).read_text(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _is_forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_model_without_card_raises_unless_cpu_asked(monkeypatch):
    from predictionio_tpu_torch.device import resolve_device
    from predictionio_tpu_torch.models.recommendation import als_model_from_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    state = {"X": [[1.0]], "Y": [[1.0]], "users": ["u"], "items": ["i"],
             "seen": {"indptr": [0, 0], "values": []}}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        als_model_from_state(state)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    assert als_model_from_state(state, device="cpu").device == torch.device("cpu")
