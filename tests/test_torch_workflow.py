"""The port's train → persist → deploy workflow on its memory store.

``run_train`` records an engine instance (INIT → TRAINING → COMPLETED, or
FAILED with the exception re-raised, with retries), ``load_latest_models``
finds the latest COMPLETED one, ``deploy`` serves it over HTTP.  The model
store loads the port's own pickles on a box without a card, and a blob
written by the JAX package's ``run_train`` in a fresh interpreter that
never imports the JAX package, serving the JAX predictor's answers.
"""

import json
import pickle
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from predictionio_tpu.controller.engine import (
    serialize_engine_params as jax_serialize_engine_params,
)
from predictionio_tpu.models.recommendation import engine as jax_reco
from predictionio_tpu.models.universal_recommender import engine as jax_ur
from predictionio_tpu.workflow import core_workflow as jax_workflow
from predictionio_tpu_torch.controller.engine import serialize_engine_params
from predictionio_tpu_torch.models.ecommerce import ECommerceEngine
from predictionio_tpu_torch.models import recommendation as reco
from predictionio_tpu_torch.models import universal_recommender as ur
from predictionio_tpu_torch.models.universal_recommender import engine as port_ur
from predictionio_tpu_torch.storage import set_storage as port_set_storage
from predictionio_tpu_torch.workflow import core_workflow, persistence
from predictionio_tpu_torch.workflow.create_server import deploy
from predictionio_tpu_torch.workflow.create_workflow import (
    engine_from_variant,
    resolve_engine_factory,
)

from _torch_event_cases import fill_both, port_memory_storage, rule_corpus
from _torch_ur_cases import assert_same_answer

REPO = Path(__file__).resolve().parents[1]
APP = "urapp"
VARIANT = {
    "id": "ur-smoke", "engineFactory": "universal_recommender",
    "datasource": {"params": {"appName": APP, "eventNames": ["purchase", "view"]}},
    "algorithms": [{"name": "ur", "params": {
        "appName": APP, "maxCorrelatorsPerItem": 8, "expireDateName": "expireDate"}}],
}
STAMPS = [("b2", {"expireDate": "2026-07-29T00:00:00"}),
          ("e1", {"expireDate": "2027-01-01T00:00:00"})]
QUERIES = [{"user": "u20", "num": 6}, {"user": "u2", "num": 4},
           {"user": "u20", "num": 8, "currentDate": "2026-07-29T00:00:00"},
           {"user": "u2", "num": 4, "fields": [
               {"name": "category", "values": ["books"], "bias": -1}]},
           {"item": "e1", "num": 3}, {"user": "stranger", "num": 5}]


@pytest.fixture()
def stores(mem_storage, monkeypatch, tmp_path):
    """(JAX store, port store) holding the rule corpus with two expiry
    stamps, each its package's process default."""
    for k in ("PIO_HISTORY_CACHE", "PIO_SERVE_CACHE"):
        monkeypatch.setenv(k, "off")
    monkeypatch.setenv("PIO_SPANS_DIR", str(tmp_path / "spans"))
    monkeypatch.delenv("PIO_TRAIN_RETRIES", raising=False)
    port_store = port_memory_storage()
    port_set_storage(port_store)
    fill_both(mem_storage, port_store, APP, rule_corpus(STAMPS))
    yield mem_storage, port_store
    port_set_storage(None)


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def _port_train(port_store, **kw):
    _, engine, ep = engine_from_variant(VARIANT)
    return core_workflow.run_train(engine, ep, "ur-smoke", storage=port_store,
                                   device="cpu", **kw)


def test_run_train_load_deploy_on_the_port(stores, tmp_path):
    _, port_store = stores
    instance = _port_train(port_store)
    assert instance.status == "COMPLETED" and instance.end_time >= instance.start_time
    assert port_store.engine_instances.get(instance.id).status == "COMPLETED"
    assert json.loads(instance.algorithms_params)[0]["params"]["expire_date_name"] == "expireDate"
    found, (model,) = core_workflow.load_latest_models("ur-smoke", storage=port_store,
                                                       device="cpu")
    assert found.id == instance.id and model.device == torch.device("cpu")
    path = tmp_path / "engine.json"
    path.write_text(json.dumps(VARIANT))
    _, engine, ep = engine_from_variant(VARIANT)
    predict = engine.predictor(ep, [model])
    server = deploy(str(path), host="127.0.0.1", port=0, storage=port_store, device="cpu")
    try:
        assert server.state.instance.id == instance.id
        url = f"http://127.0.0.1:{server.server_address[1]}/queries.json"
        for body in QUERIES:
            assert _post(url, body) == predict(ur.URQuery.from_json(body)).to_json()
        at = [d["item"] for d in _post(url, QUERIES[2])["itemScores"]]
        assert at and "b2" in at and set(at) <= {"b2", "e1"}
    finally:
        server.shutdown()
        server.server_close()


def test_latest_completed_instance_is_deployed(stores):
    _, port_store = stores
    first = _port_train(port_store)
    second = _port_train(port_store)
    _, engine, ep = engine_from_variant(
        dict(VARIANT, datasource={"params": {"appName": "no-such-app"}}))
    with pytest.raises(ValueError, match="does not exist"):
        core_workflow.run_train(engine, ep, "ur-smoke", storage=port_store, device="cpu")
    statuses = sorted(i.status for i in port_store.engine_instances.get_all())
    assert statuses == ["COMPLETED", "COMPLETED", "FAILED"]
    found, _ = core_workflow.load_latest_models("ur-smoke", storage=port_store, device="cpu")
    assert found.id == second.id != first.id
    with pytest.raises(LookupError):
        core_workflow.load_latest_models("ur-smoke", engine_variant="other",
                                         storage=port_store, device="cpu")


class _Flaky(port_ur.URDataSource):
    """Fails its first ``fails`` reads."""

    fails = 0

    def read_training(self):
        if _Flaky.fails > 0:
            _Flaky.fails -= 1
            raise RuntimeError("transient read failure")
        return super().read_training()


@pytest.mark.parametrize("how", ["argument", "env", "none"])
def test_train_retries_then_records_failed(stores, monkeypatch, how):
    _, port_store = stores
    _, engine, ep = engine_from_variant(VARIANT)
    engine.data_source_class = _Flaky
    _Flaky.fails = 2
    kw = {}
    if how == "argument":
        kw["retries"] = 2
    elif how == "env":
        monkeypatch.setenv("PIO_TRAIN_RETRIES", "2")
    if how == "none":
        with pytest.raises(RuntimeError, match="transient"):
            core_workflow.run_train(engine, ep, "flaky", storage=port_store, device="cpu")
        (instance,) = port_store.engine_instances.get_all()
        assert instance.status == "FAILED" and instance.end_time is not None
        assert port_store.models.get(instance.id) is None
    else:
        instance = core_workflow.run_train(engine, ep, "flaky", storage=port_store,
                                           device="cpu", **kw)
        assert instance.status == "COMPLETED" and _Flaky.fails == 0
        assert port_store.models.get(instance.id)


@pytest.mark.parametrize("entry", ["run_train", "load_latest_models", "load_models",
                                   "deploy", "model_staging", "rule_mask"])
def test_entry_points_raise_without_a_card(stores, monkeypatch, tmp_path, entry):
    _, port_store = stores
    instance = _port_train(port_store)
    path = tmp_path / "engine.json"
    path.write_text(json.dumps(VARIANT))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, engine, ep = engine_from_variant(VARIANT)
    calls = {
        "run_train": lambda: core_workflow.run_train(engine, ep, "x", storage=port_store),
        "load_latest_models": lambda: core_workflow.load_latest_models(
            "ur-smoke", storage=port_store),
        "load_models": lambda: persistence.load_models(port_store, instance.id),
        "deploy": lambda: deploy(str(path), port=0, storage=port_store),
        "model_staging": lambda: pickle.loads(pickle.dumps(
            core_workflow.load_latest_models("ur-smoke", storage=port_store,
                                             device="cpu")[1][0])).warm(),
        "rule_mask": lambda: ur.URAlgorithm(ep.algorithm_params_list[0][1])._mask_from_key(
            pickle.loads(pickle.dumps(core_workflow.load_latest_models(
                "ur-smoke", storage=port_store, device="cpu")[1][0])),
            ((("category", ("books",), -1.0),), None, None, "", "expireDate")),
    }
    n_instances = len(port_store.engine_instances.get_all())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()
    assert len(port_store.engine_instances.get_all()) == n_instances


@pytest.mark.parametrize("option,value", [
    ("follow", 1.0), ("plane_publish", "7000"), ("plane_from", "host:7000")])
def test_deploy_refuses_options_it_cannot_honour(tmp_path, option, value):
    """The model plane's topologies refuse what they cannot honour before
    any state exists: a subscriber that also folds or also publishes, and
    replication without a node-local plane directory (a memory store
    resolves none; tests/test_torch_plane_replication.py drives the rest)."""
    from predictionio_tpu_torch.storage import Storage, StorageConfig

    path = tmp_path / "engine.json"
    path.write_text(json.dumps(VARIANT))
    extra, why = {
        "follow": ({"plane_from": "host:7000"}, "drop --follow"),
        "plane_publish": ({"plane_from": "host:7000"}, "relaying"),
        "plane_from": ({"storage": Storage(StorageConfig.memory())},
                       "model-plane directory"),
    }[option]
    with pytest.raises(ValueError, match=why):
        deploy(str(path), device="cpu", **{option: value}, **extra)


def test_deploy_workers_on_cuda_raises(tmp_path):
    """Prefork workers serve the CPU only: a CUDA deploy with workers > 1
    raises before it touches the card, as the JAX package raises on an
    accelerator."""
    path = tmp_path / "engine.json"
    path.write_text(json.dumps(VARIANT))
    with pytest.raises(ValueError, match="--workers requires the CPU"):
        deploy(str(path), device="cuda", workers=2)


@pytest.mark.parametrize("name,want", [
    ("universal_recommender", ur.UniversalRecommenderEngine),
    ("predictionio_tpu.models.universal_recommender.UniversalRecommenderEngine",
     ur.UniversalRecommenderEngine),
    ("recommendation", reco.RecommendationEngine),
    ("predictionio_tpu.models.recommendation.engine.RecommendationEngine",
     reco.RecommendationEngine),
    ("ecommerce", ECommerceEngine),
    ("predictionio_tpu.models.ecommerce.ECommerceEngine", ECommerceEngine),
])
def test_engine_factories_resolve_to_the_port(name, want):
    assert resolve_engine_factory(name) is want


# a misspelt engineFactory: the JAX package's import error propagates, and
# the port's names the module on the port's path
MISSPELT = [
    ("predictionio_tpu.models.recomendation.RecommendationEngine", ModuleNotFoundError,
     "predictionio_tpu_torch.models.recomendation"),
    ("predictionio_tpu_torch.models.nosuch.X", ModuleNotFoundError,
     "predictionio_tpu_torch.models.nosuch"),
    ("nosuchpkg.mod.X", ModuleNotFoundError, "nosuchpkg"),
    ("predictionio_tpu.models.recommendation.NoSuchEngine", AttributeError,
     "predictionio_tpu_torch.models.recommendation"),
]


@pytest.mark.parametrize("name,error,port_module", MISSPELT)
def test_misspelt_engine_factory_raises_as_jax_does(name, error, port_module):
    from predictionio_tpu.workflow.create_workflow import (
        resolve_engine_factory as jax_resolve_engine_factory,
    )

    with pytest.raises(Exception) as want:
        jax_resolve_engine_factory(name)
    with pytest.raises(Exception) as got:
        resolve_engine_factory(name)
    assert type(want.value) is type(got.value) is error
    assert repr(port_module) in str(got.value)


@pytest.mark.parametrize("command", ["build", "train", "deploy"])
def test_misspelt_engine_factory_fails_each_console_alike(mem_storage, tmp_path, monkeypatch,
                                                          capsys, command):
    """``pio build|train|deploy`` of an engine.json whose engineFactory is
    misspelt: both consoles exit 1 and report the same import error, each
    naming the module on its own package's path."""
    from predictionio_tpu.cli import main as jax_cli
    from predictionio_tpu_torch.cli import main as cli

    name = MISSPELT[0][0]
    path = tmp_path / "engine.json"
    path.write_text(json.dumps({**VARIANT, "engineFactory": name}))
    monkeypatch.setenv("PIO_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("PIO_JAX_CACHE", "off")
    argv = [command, "--engine-json", str(path)]
    if command == "deploy":
        argv += ["--ip", "127.0.0.1", "--port", "0"]
    port_set_storage(port_memory_storage())
    try:
        assert jax_cli.main(argv) == 1
        want = capsys.readouterr().err
        assert cli.main(argv) == 1
        got = capsys.readouterr().err
    finally:
        port_set_storage(None)
    assert want == "Error: No module named 'predictionio_tpu.models.recomendation'\n"
    assert got == want.replace("predictionio_tpu.", "predictionio_tpu_torch.")


def test_serialize_engine_params_matches_jax():
    _, _, ep = engine_from_variant(VARIANT)
    jax_ep = jax_ur.UniversalRecommenderEngine.apply().engine_params_from_variant(VARIANT)
    got, want = serialize_engine_params(ep), jax_serialize_engine_params(jax_ep)
    assert {k: json.loads(v) for k, v in got.items()} == {
        k: json.loads(v) for k, v in want.items()}


# -- pickles on a box without a card ----------------------------------------------------------------


def _models(stores):
    """A port-trained UR model and a carried-across ALS model, on CPU."""
    _, port_store = stores
    _port_train(port_store)
    _, (ur_model,) = core_workflow.load_latest_models("ur-smoke", storage=port_store,
                                                      device="cpu")
    rng = np.random.default_rng(0)
    als = reco.als_model_from_state({
        "X": rng.normal(size=(5, 3)).astype(np.float32),
        "Y": rng.normal(size=(9, 3)).astype(np.float32),
        "users": [f"u{i}" for i in range(5)], "items": [f"i{i}" for i in range(9)],
        "seen": {"indptr": np.array([0, 2, 2, 3, 3, 3]), "values": np.array([1, 4, 0])}},
        device="cpu")
    return {"ur": (ur_model, ur.UniversalRecommenderEngine, "ur", QUERIES[3]),
            "als": (als, reco.RecommendationEngine, "als", {"user": "u0", "num": 4})}


@pytest.mark.parametrize("kind", ["als", "ur"])
def test_pickled_model_loads_without_a_card(stores, monkeypatch, kind):
    model, factory, algo, body = _models(stores)[kind]
    engine = factory.apply()
    from predictionio_tpu_torch.controller import EngineParams

    ep = EngineParams(algorithm_params_list=[
        (algo, engine.algorithm_classes[algo].params_class.from_json(
            VARIANT["algorithms"][0]["params"] if algo == "ur" else {}))])
    want = engine.predictor(ep, [model])(factory.query_class.from_json(body)).to_json()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    back = pickle.loads(pickle.dumps(model))
    assert "_torch_device" not in back.__dict__
    assert back.__getstate__().keys() == model.__getstate__().keys()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        back.device
    (loaded,) = persistence.deserialize_models(persistence.serialize_models([model]),
                                               device="cpu")
    for m in (back.to_device("cpu"), loaded):
        got = engine.predictor(ep, [m])(factory.query_class.from_json(body)).to_json()
        assert got == want and got["itemScores"]


def test_to_device_drops_staged_tensors(stores, monkeypatch):
    # the device halves stage tensors; on the CPU ``auto`` serves on the host
    monkeypatch.setenv("PIO_UR_SERVE_SCORER", "device")
    monkeypatch.setenv("PIO_UR_SERVE_TAIL", "device")
    model = _models(stores)["ur"][0]
    ur.URAlgorithm(ur.URAlgorithmParams.from_json(VARIANT["algorithms"][0]["params"])
                   ).predict(model, ur.URQuery.from_json(QUERIES[3]))
    staged = set(model.__dict__["_staged"])
    assert {"_dev_indicators", "_dev_value_mask", "_dev_ones"} <= staged
    model.to_device("cpu")                    # same device: kept
    assert set(model.__dict__["_staged"]) == staged
    model.__dict__["_torch_device"] = torch.device("meta")   # pretend another device
    model.to_device("cpu")
    assert not any(a in model.__dict__ for a in staged)


# -- a JAX-written blob in the port ---------------------------------------------------------------

_LOAD_JAX_BLOB = r"""
import json, sys
from predictionio_tpu_torch.events.event import Event
from predictionio_tpu_torch.storage import App, Storage, StorageConfig, set_storage
from predictionio_tpu_torch.workflow.create_workflow import engine_from_variant
from predictionio_tpu_torch.workflow.persistence import load_models

work = json.load(open(sys.argv[1]))
store = Storage(StorageConfig.memory())
set_storage(store)
app = store.apps.insert(App(0, work["app"]))
store.l_events.insert_batch(
    [Event(event=ev, entity_type=et, entity_id=eid, target_entity_type=tt,
           target_entity_id=tid, properties=props, event_time=t, creation_time=ct)
     for ev, et, eid, tt, tid, props, t, ct in work["events"]], app)
store.models.insert(work["instance"], open(sys.argv[2], "rb").read())
models = load_models(store, work["instance"], device="cpu")
_, engine, ep = engine_from_variant(work["variant"])
factory = type(engine)
predict = engine.predictor(ep, models)
query_class = {"ur": __import__("predictionio_tpu_torch.models.universal_recommender",
                                fromlist=["URQuery"]).URQuery,
               "als": __import__("predictionio_tpu_torch.models.recommendation",
                                 fromlist=["RecoQuery"]).RecoQuery}[work["kind"]]
answers = [predict(query_class.from_json(b)).to_json() for b in work["queries"]]
bad = sorted(m for m in sys.modules
             if m in ("jax", "predictionio_tpu") or m.startswith(("jax.", "predictionio_tpu.")))
print(json.dumps({"answers": answers, "bad": bad,
                  "classes": [type(m).__module__ + "." + type(m).__name__ for m in models]}))
"""

ALS_VARIANT = {
    "engineFactory": "recommendation",
    "datasource": {"params": {"appName": "alsapp"}},
    "algorithms": [{"name": "als", "params": {"rank": 4, "numIterations": 6,
                                              "lambda": 0.05, "meshDp": 1}}]}


def _als_specs():
    rng = np.random.default_rng(5)
    out = []
    for u in range(16):
        for i in range(20):
            if rng.random() < 0.5:
                t = 1.78e9 + u * 100 + i
                out.append(("rate", "user", f"u{u}", "item", f"i{i}",
                            {"rating": 5.0 if i % 2 == u % 2 else 1.0}, t, t))
    return out


@pytest.mark.parametrize("kind", ["ur", "als"])
def test_jax_blob_serves_in_the_port_without_the_jax_package(stores, tmp_path, kind):
    from predictionio_tpu.workflow.create_workflow import engine_from_variant as jax_from

    jax_store, port_store = stores
    if kind == "ur":
        variant, specs, app, queries = VARIANT, rule_corpus(STAMPS), APP, QUERIES
    else:
        variant, specs, app = ALS_VARIANT, _als_specs(), "alsapp"
        fill_both(jax_store, port_store, app, specs)
        queries = [{"user": "u1", "num": 5}, {"user": "u4", "num": 20},
                   {"user": "u7", "num": 3, "blackList": ["i0", "i2"]}, {"user": "ghost"}]
    _, jax_engine, jax_ep = jax_from(variant)
    instance = jax_workflow.run_train(jax_engine, jax_ep, "jax-written", storage=jax_store)
    blob = jax_store.models.get(instance.id)
    assert b"predictionio_tpu.models" in blob
    jax_models = jax_workflow.load_latest_models("jax-written", storage=jax_store)[1]
    jax_predict = jax_engine.predictor(jax_ep, jax_models)
    query_class = jax_ur.URQuery if kind == "ur" else jax_reco.RecoQuery
    want = [jax_predict(query_class.from_json(b)).to_json() for b in queries]
    (tmp_path / "blob").write_bytes(blob)
    (tmp_path / "work.json").write_text(json.dumps({
        "app": app, "events": specs, "instance": instance.id, "variant": variant,
        "kind": kind, "queries": queries}))
    out = subprocess.run([sys.executable, "-c", _LOAD_JAX_BLOB, str(tmp_path / "work.json"),
                          str(tmp_path / "blob")], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert res["classes"][0].startswith("predictionio_tpu_torch.models.")
    assert any(w["itemScores"] for w in want)
    for got, w in zip(res["answers"], want):
        if kind == "ur":
            assert_same_answer(got, w)
        else:   # factor products: rtol 1e-5 with an absolute floor near 0
            assert [d["item"] for d in got["itemScores"]] == [d["item"] for d in w["itemScores"]]
            np.testing.assert_allclose([d["score"] for d in got["itemScores"]],
                                       [d["score"] for d in w["itemScores"]],
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("module,name", [
    ("predictionio_tpu.models.classification.engine", "NaiveBayesModel"),
    ("jax._src.array", "ArrayImpl")])
def test_blob_naming_a_class_the_port_lacks_raises(module, name):
    blob = pickle.dumps([("persistent", module, name, b"")])
    with pytest.raises(pickle.UnpicklingError, match=name):
        persistence.deserialize_models(blob, device="cpu")
