"""The port's ALS recommendation serving against the JAX package.

A tiny ALS model is trained with the JAX package, its state is carried
across with ``als_model_from_state(..., device="cpu")``, and the port's
predict, batch predict and HTTP ``/queries.json`` are held against the JAX
predictor on the same queries: item lists exact, scores within rtol 1e-5,
atol 1e-6 (the CPU matmuls of XLA and torch sum in different orders).
"""

import json
import urllib.request

import numpy as np
import pytest

from predictionio_tpu.controller.engine import EngineParams as JaxEngineParams
from predictionio_tpu.events.event import DataMap, Event
from predictionio_tpu.models import recommendation as jax_reco
from predictionio_tpu.models.recommendation.engine import (
    ALSAlgorithmParams as JaxALSParams,
    DataSourceParams as JaxDataSourceParams,
)
from predictionio_tpu.storage import App
from predictionio_tpu.storage.locator import Storage, StorageConfig, set_storage
from predictionio_tpu_torch.controller import EngineParams
from predictionio_tpu_torch.models import recommendation as reco
from predictionio_tpu_torch.workflow.create_server import deploy_models

RTOL, ATOL = 1e-5, 1e-6

QUERIES = [
    {"user": "u1", "num": 10},
    {"user": "u3", "num": 10, "unseenOnly": True},
    {"user": "u12", "num": 5, "blackList": ["i0", "i21", "no-such-item"]},
    {"user": "u7", "num": 1},
    {"user": "u18", "num": 100},
    {"user": "u5", "num": 8, "unseenOnly": True, "blackList": ["i2"]},
    {"user": "ghost", "num": 10},
]


@pytest.fixture(scope="module")
def jax_models():
    """JAX ALS trained on two taste groups (the corpus style of
    tests/test_recommendation.py, with a wider catalog)."""
    storage = Storage(StorageConfig(
        sources={"MEM": {"type": "memory"}},
        repositories={"METADATA": "MEM", "EVENTDATA": "MEM", "MODELDATA": "MEM"},
    ))
    set_storage(storage)
    try:
        app_id = storage.apps.insert(App(0, "torchreco"))
        rng = np.random.default_rng(5)
        events = []
        for u in range(24):
            group = u % 2
            for i in range(40):
                if rng.random() < 0.5:
                    r = 5.0 if (i % 2) == group else 1.0
                    events.append(Event(
                        event="rate", entity_type="user", entity_id=f"u{u}",
                        target_entity_type="item", target_entity_id=f"i{i}",
                        properties=DataMap({"rating": r})))
        storage.l_events.insert_batch(events, app_id)
        engine = jax_reco.RecommendationEngine.apply()
        ep = JaxEngineParams(
            data_source_params=JaxDataSourceParams(app_name="torchreco"),
            algorithm_params_list=[("als", JaxALSParams(
                rank=6, num_iterations=8, lambda_=0.05, mesh_dp=1))],
        )
        models = engine.train(ep)
        yield engine, ep, models
    finally:
        set_storage(None)


@pytest.fixture(scope="module")
def port(jax_models):
    _, _, models = jax_models
    model = reco.als_model_from_state(models[0].__getstate__(), device="cpu")
    engine = reco.RecommendationEngine.apply()
    ep = EngineParams(algorithm_params_list=[("als", reco.ALSAlgorithmParams())])
    return engine, ep, [model]


def _assert_same(got, want):
    """Wire-format results: same items in the same order, close scores."""
    g_items = [s["item"] for s in got["itemScores"]]
    w_items = [s["item"] for s in want["itemScores"]]
    assert g_items == w_items
    np.testing.assert_allclose([s["score"] for s in got["itemScores"]],
                               [s["score"] for s in want["itemScores"]],
                               rtol=RTOL, atol=ATOL)


def test_state_carries_across(jax_models, port):
    jax_model, model = jax_models[2][0], port[2][0]
    state, carried = jax_model.__getstate__(), model.__getstate__()
    assert set(carried) == set(state) == {"X", "Y", "users", "items", "seen"}
    np.testing.assert_array_equal(carried["X"], state["X"])
    np.testing.assert_array_equal(carried["Y"], state["Y"])
    assert carried["users"] == list(state["users"])
    assert carried["items"] == list(state["items"])
    np.testing.assert_array_equal(carried["seen"]["values"], state["seen"]["values"])
    assert model.item_factors_device().device.type == "cpu"


@pytest.mark.parametrize("body", QUERIES, ids=lambda b: json.dumps(b, sort_keys=True))
def test_predict_matches_jax(jax_models, port, body):
    j_engine, j_ep, j_models = jax_models
    engine, ep, models = port
    want = j_engine.predictor(j_ep, j_models)(jax_reco.RecoQuery.from_json(body))
    got = engine.predictor(ep, models)(reco.RecoQuery.from_json(body))
    _assert_same(got.to_json(), want.to_json())
    if body["user"] == "ghost":
        assert got.item_scores == []
    else:
        assert got.item_scores


def test_batch_predict_matches_jax(jax_models, port):
    j_engine, j_ep, j_models = jax_models
    engine, ep, models = port
    # 3 copies of the query kinds: 21 queries, edge-padded to a batch of 32
    bodies = QUERIES * 3
    want = j_engine.batch_predictor(j_ep, j_models)(
        [jax_reco.RecoQuery.from_json(b) for b in bodies])
    got = engine.batch_predictor(ep, models)(
        [reco.RecoQuery.from_json(b) for b in bodies])
    assert len(got) == len(want) == len(bodies)
    for g, w in zip(got, want):
        _assert_same(g.to_json(), w.to_json())


def test_unseen_only_and_blacklist_exclude(port):
    engine, ep, models = port
    model = models[0]
    predict = engine.predictor(ep, models)
    uid = model.user_dict.id("u3")
    rated = {model.item_dict.str(int(j)) for j in model.seen.row(uid)}
    got = predict(reco.RecoQuery(user="u3", num=40, unseen_only=True))
    assert rated and not rated & {s.item for s in got.item_scores}
    got = predict(reco.RecoQuery(user="u3", num=40, blacklist=["i0", "i1"]))
    assert not {"i0", "i1"} & {s.item for s in got.item_scores}


def test_http_queries_match_jax(jax_models, port):
    j_engine, j_ep, j_models = jax_models
    engine, ep, models = port
    jax_predict = j_engine.predictor(j_ep, j_models)
    server = deploy_models(engine, ep, models, port=0,
                           query_class=reco.RecommendationEngine.query_class)
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        for body in QUERIES:
            req = urllib.request.Request(
                url + "/queries.json", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as resp:
                assert resp.status == 200
                got = json.loads(resp.read())
            want = jax_predict(jax_reco.RecoQuery.from_json(body)).to_json()
            _assert_same(got, want)
        with urllib.request.urlopen(url + "/", timeout=30) as resp:
            info = json.loads(resp.read())
        assert info["status"] == "alive" and info["queryCount"] == len(QUERIES)
        bad = urllib.request.Request(url + "/queries.json", data=b"{not json")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(bad, timeout=30)
        assert err.value.code == 400
    finally:
        server.shutdown()
        server.server_close()


def test_training_is_not_ported_yet(port):
    engine, ep, _ = port
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        engine.train(ep)
