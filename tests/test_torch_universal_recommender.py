"""The port's Universal Recommender serving against the JAX package:
predict, batch predict, HTTP ``/queries.json`` and business rules on the
corpus' ``category`` property.

The corpus is the two-cluster one of tests/_torch_ur_cases.py, trained by
the JAX package and carried across to the port.  Served answers agree item
for item, with scores within rtol 1e-5; items may trade places only inside
a run of scores within that tolerance.  Both packages read the users'
histories from their event stores: the JAX package from its LocalFS event
log (the ``fs_storage`` fixture), through its host tail with the history
and response caches and the native lane off (its exact oracles); the port
from its in-memory store, through the host scorer and the candidate-pruned
host tail (``auto`` on a CPU model); the ``*_device_halves_*`` cases pin
``PIO_UR_SERVE_SCORER``/``PIO_UR_SERVE_TAIL`` to ``device`` in both
packages, so the port's device tail runs on CPU tensors.
Training, the model state, the history store and the popularity backfill
are in tests/test_torch_ur_model.py; the rule tests of the JAX package's
own suite, trained from events by each package, are in
tests/test_torch_ur_rules.py.
"""

import json
import urllib.error
import urllib.request

import pytest

from predictionio_tpu.controller.engine import EngineParams as JaxEngineParams
from predictionio_tpu.models.universal_recommender import engine as jax_ur
from predictionio_tpu_torch.controller import EngineParams
from predictionio_tpu_torch.models import universal_recommender as ur
from predictionio_tpu_torch.storage import set_storage as port_set_storage
from predictionio_tpu_torch.workflow.create_server import deploy_models

from _torch_ur_cases import assert_same_answer, fill_stores, params, train_jax_model


@pytest.fixture(scope="module")
def jax_model():
    return train_jax_model()


@pytest.fixture(autouse=True)
def _oracles(monkeypatch):
    """The JAX package serves through its exact oracles: no history or
    response cache, no native lane."""
    for k, v in (("PIO_HISTORY_CACHE", "off"), ("PIO_SERVE_CACHE", "off"),
                 ("PIO_NATIVE", "off")):
        monkeypatch.setenv(k, v)


@pytest.fixture(autouse=True)
def _stores(_oracles, fs_storage):
    """Both packages' history stores hold the corpus' events."""
    fill_stores(fs_storage)
    yield
    port_set_storage(None)


QUERIES = {
    "user_with_history": {"user": "u2", "num": 4},
    "unknown_user_backfill": {"user": "stranger", "num": 5},
    "item": {"item": "e1", "num": 3},
    "item_set": {"itemSet": ["b1", "b2"], "num": 4},
    "blacklist": {"user": "u20", "num": 4, "blacklistItems": ["b3", "e0"]},
    "num_1": {"user": "u3", "num": 1},
    "num_100": {"user": "u5", "num": 100},
    "item_return_self": {"item": "b4", "num": 3, "returnSelf": True},
}


def _engines(jax_model, use_llr):
    jax_engine = jax_ur.UniversalRecommenderEngine.apply()
    jax_ep = JaxEngineParams(algorithm_params_list=[
        ("ur", params(jax_ur, "reference_ep", use_llr_weights=use_llr))])
    port_model = ur.ur_model_from_state(jax_model.__getstate__(), device="cpu")
    port_engine = ur.UniversalRecommenderEngine.apply()
    port_ep = EngineParams(algorithm_params_list=[
        ("ur", params(ur, "reference_ep", use_llr_weights=use_llr))])
    return (jax_engine, jax_ep), (port_engine, port_ep, port_model)


@pytest.mark.parametrize("use_llr", [False, True])
@pytest.mark.parametrize("kind", sorted(QUERIES))
def test_predict_matches_jax(jax_model, kind, use_llr):
    (je, jep), (pe, pep, pm) = _engines(jax_model, use_llr)
    body = QUERIES[kind]
    want = je.predictor(jep, [jax_model])(jax_ur.URQuery.from_json(body)).to_json()
    got = pe.predictor(pep, [pm])(ur.URQuery.from_json(body)).to_json()
    assert got["itemScores"] or kind == "num_1" and not want["itemScores"]
    assert_same_answer(got, want)


@pytest.mark.parametrize("use_llr", [False, True])
def test_batch_predict_matches_jax(jax_model, use_llr):
    jax_algo = jax_ur.URAlgorithm(params(jax_ur, "reference_ep", use_llr_weights=use_llr))
    port_algo = ur.URAlgorithm(params(ur, "reference_ep", use_llr_weights=use_llr))
    port_model = ur.ur_model_from_state(jax_model.__getstate__(), device="cpu")
    bodies = [QUERIES[k] for k in sorted(QUERIES)]
    want = jax_algo.batch_predict(jax_model, [jax_ur.URQuery.from_json(b) for b in bodies])
    got = port_algo.batch_predict(port_model, [ur.URQuery.from_json(b) for b in bodies])
    for g, w in zip(got, want):
        assert_same_answer(g.to_json(), w.to_json())


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("use_llr", [False, True])
def test_http_queries_match_jax(jax_model, use_llr):
    (je, jep), (pe, pep, pm) = _engines(jax_model, use_llr)
    jax_predict = je.predictor(jep, [jax_model])
    server = deploy_models(pe, pep, [pm], port=0, query_class=ur.URQuery)
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/queries.json"
        for body in QUERIES.values():
            status, got = _post(url, body)
            assert status == 200, got
            assert_same_answer(got, jax_predict(jax_ur.URQuery.from_json(body)).to_json())
        # a business rule is answered as the JAX package answers it
        body = {"user": "u2", "num": 4, "fields": [
            {"name": "category", "values": ["books"], "bias": -1}]}
        status, got = _post(url, body)
        assert status == 200, got
        assert got["itemScores"] and all(d["item"].startswith("b") for d in got["itemScores"])
        assert_same_answer(got, jax_predict(jax_ur.URQuery.from_json(body)).to_json())
        # a malformed rule date is a bad query
        status, got = _post(url, {"user": "u2", "currentDate": "29/07/2026"})
        assert status == 400 and "ISO-8601" in got["message"]
    finally:
        server.shutdown()
        server.server_close()


@pytest.mark.parametrize("body", [
    {"user": "u2", "dateRange": {"name": "releaseDate", "after": "2026-01-01T00:00:00"}},
    {"user": "u2", "fields": [{"name": "category", "values": ["books"], "bias": 2.0}]},
])
def test_rule_queries_raise_naming_the_roadmap(jax_model, body):
    """Rule queries the port once refused (naming its ROADMAP item) are
    answered as the JAX package answers them: a date rule on a property
    no item has matches nothing, a boost reorders."""
    (je, jep), (pe, pep, pm) = _engines(jax_model, False)
    want = je.predictor(jep, [jax_model])(jax_ur.URQuery.from_json(body)).to_json()
    got = pe.predictor(pep, [pm])(ur.URQuery.from_json(body)).to_json()
    assert bool(got["itemScores"]) == ("fields" in body)
    assert_same_answer(got, want)


def test_current_date_is_a_rule_only_with_date_properties(jax_model):
    (je, jep), (pe, pep, pm) = _engines(jax_model, False)
    body = {"user": "u2", "num": 4, "currentDate": "2026-06-01T00:00:00"}
    want = je.predictor(jep, [jax_model])(jax_ur.URQuery.from_json(body)).to_json()
    assert_same_answer(pe.predictor(pep, [pm])(ur.URQuery.from_json(body)).to_json(), want)
    with pytest.raises(ValueError, match="ISO-8601"):
        pe.predictor(pep, [pm])(ur.URQuery.from_json({**body, "currentDate": "nope"}))
    with pytest.raises(ValueError, match="ISO-8601"):
        je.predictor(jep, [jax_model])(jax_ur.URQuery.from_json({**body, "currentDate": "nope"}))
    # with an availableDate property named, currentDate is a rule: no item
    # of the corpus has the property, so it matches nothing in both
    live = EngineParams(algorithm_params_list=[
        ("ur", params(ur, "reference_ep", available_date_name="availableDate"))])
    jax_live = JaxEngineParams(algorithm_params_list=[
        ("ur", params(jax_ur, "reference_ep", available_date_name="availableDate"))])
    got = pe.predictor(live, [pm])(ur.URQuery.from_json(body)).to_json()
    assert got == {"itemScores": []}
    assert_same_answer(got, je.predictor(jax_live, [jax_model])(
        jax_ur.URQuery.from_json(body)).to_json())


@pytest.mark.parametrize("use_llr", [False, True])
def test_serve_batch_predict_matches_serial_and_jax(jax_model, use_llr):
    """The micro-batcher's path: the port's ``serve_batch_predict`` over
    every listed query and a category rule answers as its own serial
    predict does, and as the JAX ``serve_batch_predict`` (its response
    cache off) does, within the UR bar."""
    jax_algo = jax_ur.URAlgorithm(params(jax_ur, "reference_ep", use_llr_weights=use_llr))
    port_algo = ur.URAlgorithm(params(ur, "reference_ep", use_llr_weights=use_llr))
    port_model = ur.ur_model_from_state(jax_model.__getstate__(), device="cpu")
    bodies = [QUERIES[k] for k in sorted(QUERIES)] + [
        {"user": "u2", "num": 4, "fields": [
            {"name": "category", "values": ["books"], "bias": -1}]},
        {"user": "u20", "num": 6, "fields": [
            {"name": "category", "values": ["electronics"], "bias": 3.0}]}]
    got = port_algo.serve_batch_predict(port_model, [ur.URQuery.from_json(b) for b in bodies])
    want = jax_algo.serve_batch_predict(jax_model, [jax_ur.URQuery.from_json(b)
                                                    for b in bodies])
    assert ur.URAlgorithm.serve_batch_max == jax_ur.URAlgorithm.serve_batch_max == 16
    assert len(got) == len(bodies)
    for body, g, w in zip(bodies, got, want):
        serial = port_algo.predict(port_model, ur.URQuery.from_json(body)).to_json()
        assert_same_answer(g.to_json(), serial)
        assert_same_answer(g.to_json(), w.to_json())
    assert port_algo.serve_batch_predict(port_model, []) == []


def _device_halves(monkeypatch):
    for k in ("PIO_UR_SERVE_SCORER", "PIO_UR_SERVE_TAIL"):
        monkeypatch.setenv(k, "device")


@pytest.mark.parametrize("use_llr", [False, True])
@pytest.mark.parametrize("kind", sorted(QUERIES))
def test_predict_device_halves_match_jax(jax_model, kind, use_llr, monkeypatch):
    _device_halves(monkeypatch)
    test_predict_matches_jax(jax_model, kind, use_llr)


@pytest.mark.parametrize("use_llr", [False, True])
def test_serve_batch_device_halves_match_serial_and_jax(jax_model, use_llr, monkeypatch):
    _device_halves(monkeypatch)
    test_serve_batch_predict_matches_serial_and_jax(jax_model, use_llr)
