"""The port's product-ranking template against the JAX package.

Each package trains implicit ALS from its own memory store of the same
view/buy events (the port's ``_als_init`` monkeypatched to the JAX arrays,
JAX at ``meshDp`` 1): the factors agree within rtol 1e-4 / atol 2e-4 (f32
sums in another order through the implicit sweeps, the bar of
tests/test_torch_ecommerce.py), and every query's ranking equals the JAX
one, items in the same order away from ties and scores within the same
bar; unrankable queries (an unknown user, only unknown items) answer in
the original order with ``isOriginal``.  On one model carried across, the
gathered scores equal the JAX ``_rank_scores`` within 1e-6, and
``serve_batch_predict`` answers as ``predict`` does, one device pass a
micro-batch (scores within 1e-6: a batched product against a
matrix-vector one).
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.controller.engine import EngineParams as JaxEngineParams
from predictionio_tpu.models.product_ranking import engine as jax_pr
from predictionio_tpu.ops import als as jax_als
from predictionio_tpu_torch.controller import EngineParams
from predictionio_tpu_torch.models.product_ranking import engine as port_pr
from predictionio_tpu_torch.ops import als
from predictionio_tpu_torch.storage import set_storage as port_set_storage
from predictionio_tpu_torch.workflow import persistence

from _torch_event_cases import fill_both, port_memory_storage, seeded_corpus

RTOL, ATOL = 1e-4, 2e-4
APP = "prapp"
QUERIES = [{"user": "u1", "items": ["i3", "i1", "i9", "i20"]},
           {"user": "u2", "items": ["i0", "nope", "i5"]},
           {"user": "u7", "items": [f"i{k}" for k in range(30)]},
           {"user": "u3", "items": ["i4"]},
           {"user": "stranger", "items": ["i1", "i2"]},
           {"user": "u4", "items": ["nope", "nada"]},
           {"user": "u5", "items": []}]


@pytest.fixture()
def jax_init_in_port(monkeypatch):
    def init(data, k, seed):
        x0, y0 = jax_als._als_init(data, k, seed)
        return torch.as_tensor(np.array(x0)), torch.as_tensor(np.array(y0))

    monkeypatch.setattr(als, "_als_init", init)


def _ep(mod, ep_cls):
    return ep_cls(
        data_source_params=mod.PRDataSourceParams(app_name=APP, event_names=["view", "buy"]),
        algorithm_params_list=[("als", mod.PRAlgorithmParams(rank=6, num_iterations=8,
                                                             alpha=2.0, mesh_dp=1))])


@pytest.fixture()
def trained(mem_storage, jax_init_in_port):
    port_store = port_memory_storage()
    port_set_storage(port_store)
    fill_both(mem_storage, port_store, APP,
              seeded_corpus(12, n_users=20, n_items=30, n_inter=500, names=("view", "buy")))
    engine, ep = port_pr.ProductRankingEngine.apply(), _ep(port_pr, EngineParams)
    jax_engine, jax_ep = jax_pr.ProductRankingEngine.apply(), _ep(jax_pr, JaxEngineParams)
    yield (engine, ep, engine.train(ep, device="cpu")), \
        (jax_engine, jax_ep, jax_engine.train(jax_ep))
    port_set_storage(None)


def assert_same(got, want, rtol=RTOL, atol=ATOL):
    assert got["isOriginal"] == want["isOriginal"]
    g = [(s["item"], s["score"]) for s in got["itemScores"]]
    w = [(s["item"], s["score"]) for s in want["itemScores"]]
    assert sorted(i for i, _ in g) == sorted(i for i, _ in w)
    np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=rtol, atol=atol)
    for (gi, _), (wi, ws) in zip(g, w):
        if gi != wi:   # a swap only between scores that tie within the bar
            assert abs(dict(w)[gi] - ws) <= atol + rtol * abs(ws)


def test_factors_and_rankings_match_jax(trained):
    (engine, ep, (model,)), (jax_engine, jax_ep, (jax_model,)) = trained
    np.testing.assert_allclose(model.user_factors, jax_model.user_factors, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(model.item_factors, jax_model.item_factors, rtol=RTOL, atol=ATOL)
    predict = engine.predictor(ep, [model])
    jax_predict = jax_engine.predictor(jax_ep, [jax_model])
    for q in QUERIES:
        got = predict(port_pr.PRQuery.from_json(q)).to_json()
        assert_same(got, jax_predict(jax_pr.PRQuery.from_json(q)).to_json())
        assert [s["item"] for s in got["itemScores"]] != [] or q["items"] == []
    assert predict(port_pr.PRQuery.from_json(QUERIES[4])).is_original
    assert predict(port_pr.PRQuery.from_json(QUERIES[5])).is_original
    assert not predict(port_pr.PRQuery.from_json(QUERIES[1])).is_original


def test_carried_model_scores_and_batch_path(trained):
    _, (jax_engine, jax_ep, (jax_model,)) = trained
    model = persistence.loads(pickle.dumps(jax_model))
    model.to_device("cpu")
    ids = np.array([3, -1, 0, 7, -1], np.int32)
    got = port_pr._rank_scores(torch.tensor(jax_model.user_factors[2]),
                               torch.tensor(jax_model.item_factors), torch.tensor(ids,
                                                                                  dtype=torch.int64))
    want = jax_pr._rank_scores(jnp.asarray(jax_model.user_factors[2]),
                               jnp.asarray(jax_model.item_factors), jnp.asarray(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    engine = port_pr.ProductRankingEngine.apply()
    ep = _ep(port_pr, EngineParams)
    predict, predict_batch = engine.serving_bundle(ep, [model])
    jax_predict = jax_engine.predictor(jax_ep, [jax_model])
    queries = [port_pr.PRQuery.from_json(q) for q in QUERIES * 3]
    batch = predict_batch(queries)
    for q, b in zip(queries, batch):
        # one batched product against a matrix-vector one: within 1e-6
        assert_same(b.to_json(), predict(q).to_json(), rtol=1e-6, atol=1e-6)
        assert_same(b.to_json(), jax_predict(jax_pr.PRQuery(q.user, q.items)).to_json())


def test_mesh_dp_raises(mem_storage):
    port_store = port_memory_storage()
    port_set_storage(port_store)
    try:
        fill_both(mem_storage, port_store, APP, seeded_corpus(1, names=("view", "buy")))
        ep = _ep(port_pr, EngineParams)
        ep.algorithm_params_list[0][1].mesh_dp = 2
        # a dp above the ranks (one here) raises MeshSpec.resolve's error, as JAX
        with pytest.raises(ValueError, match=r"mesh 2x1 != 1 devices"):
            port_pr.ProductRankingEngine.apply().train(ep, device="cpu")
    finally:
        port_set_storage(None)
