"""The port's e-commerce template against the JAX package.

The ten cases of tests/test_ecommerce.py run here with their corpus (two
taste clusters of view/buy events and ``$set`` categories, explicit event
times) written into each package's memory store.  Each package trains from
its own store through ``Engine.train`` (the port on CPU tensors, its
``_als_init`` monkeypatched to JAX's arrays so both start from the same
factors; JAX at ``meshDp`` 1), each case's own assertions hold for the
port, and every answer equals the JAX answer to the same query: items in
the same order away from ties, scores within rtol 1e-4, atol 2e-4.  The
trained factors agree within the same bar.  The bar is f32 sums taken in
another order (the port's per-row batched products against XLA's
segment-summed outer products) through ten implicit sweeps of a rank-8
model of 12 items, whose systems are poorly conditioned: the factors
reach |3.4|, and the two packages part by up to 4.6e-5.  A JAX-pickled
``ECommModel``, in its current and its first revision, loads through the
port's model store and serves as the JAX model does.
"""

import pickle

import numpy as np
import pytest
import torch

from predictionio_tpu.controller.engine import EngineParams as JaxEngineParams
from predictionio_tpu.events.event import Event as JaxEvent
from predictionio_tpu.models.ecommerce import engine as jax_ecomm
from predictionio_tpu.ops import als as jax_als
from predictionio_tpu_torch.controller import EngineParams
from predictionio_tpu_torch.events.event import Event as PortEvent
from predictionio_tpu_torch.models import ecommerce as ecomm
from predictionio_tpu_torch.models.ecommerce import engine as port_ecomm
from predictionio_tpu_torch.ops import als
from predictionio_tpu_torch.storage import set_storage as port_set_storage
from predictionio_tpu_torch.workflow import persistence

from _torch_event_cases import ecommerce_corpus, fill_both, port_memory_storage

APP = "ecommapp"
T0 = 1_780_000_000.0
RTOL, ATOL = 1e-4, 2e-4


@pytest.fixture()
def jax_init_in_port(monkeypatch):
    def init(data, k, seed):
        x0, y0 = jax_als._als_init(data, k, seed)
        return torch.as_tensor(np.array(x0)), torch.as_tensor(np.array(y0))

    monkeypatch.setattr(als, "_als_init", init)


class Both:
    """The test's engine params trained from events by each package; live
    events go into both stores."""

    def __init__(self, jax_store, port_store, **overrides):
        self.stores = (jax_store, port_store)
        self.app_ids = fill_both(jax_store, port_store, APP, ecommerce_corpus())
        params = dict(app_name=APP, rank=8, num_iterations=10, alpha=2.0, mesh_dp=1)
        params.update(overrides)
        self.jax_engine = jax_ecomm.ECommerceEngine.apply()
        self.jax_ep = JaxEngineParams(
            data_source_params=jax_ecomm.ECommDataSourceParams(app_name=APP),
            algorithm_params_list=[("ecomm", jax_ecomm.ECommAlgorithmParams(**params))])
        self.engine = ecomm.ECommerceEngine.apply()
        self.ep = EngineParams(
            data_source_params=port_ecomm.ECommDataSourceParams(app_name=APP),
            algorithm_params_list=[("ecomm", ecomm.ECommAlgorithmParams(**params))])
        self.jax_models = self.jax_engine.train(self.jax_ep)
        self.models = self.engine.train(self.ep, device="cpu")
        self.jax_predict = self.jax_engine.predictor(self.jax_ep, self.jax_models)
        self.predict_port = self.engine.predictor(self.ep, self.models)
        self._t = T0 + 50_000

    def insert(self, event, entity_type, entity_id, target=None, props=None):
        self._t += 1.0
        kw = dict(target_entity_type="item" if target else None, target_entity_id=target,
                  properties=props or {}, event_time=self._t, creation_time=self._t)
        self.stores[0].l_events.insert(
            JaxEvent(event, entity_type, entity_id, **kw), self.app_ids[0])
        self.stores[1].l_events.insert(
            PortEvent(event, entity_type, entity_id, **kw), self.app_ids[1])

    def predict(self, **q):
        """The port's answer, held against the JAX answer to the query."""
        got = self.predict_port(ecomm.ECommQuery(**q))
        assert_same(got.to_json(), self.jax_predict(jax_ecomm.ECommQuery(**q)).to_json())
        return got


def assert_same(got, want):
    g = [(s["item"], s["score"]) for s in got["itemScores"]]
    w = [(s["item"], s["score"]) for s in want["itemScores"]]
    assert len(g) == len(w), (g, w)
    np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=RTOL, atol=ATOL)
    for (gi, gs), (wi, ws) in zip(g, w):
        if gi != wi:   # a swap only between scores that tie within the bar
            assert dict(w).get(gi) is not None and abs(dict(w)[gi] - ws) <= ATOL + RTOL * abs(ws)


@pytest.fixture()
def both(mem_storage, jax_init_in_port):
    port_store = port_memory_storage()
    port_set_storage(port_store)
    made = []

    def make(**overrides):
        made.append(Both(mem_storage, port_store, **overrides))
        return made[-1]

    yield make
    port_set_storage(None)


def items_of(res):
    return [s.item for s in res.item_scores]


def test_factors_match_jax(both):
    b = both()
    got, want = b.models[0], b.jax_models[0]
    assert got.user_dict.strings() == want.user_dict.strings()
    assert got.item_dict.strings() == want.item_dict.strings()
    np.testing.assert_allclose(got.user_factors, want.user_factors, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.item_factors, want.item_factors, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.popular, want.popular)
    np.testing.assert_array_equal(got.cat_masks, want.cat_masks)
    assert got.cat_dict.strings() == want.cat_dict.strings()
    assert got.item_factors_device().device.type == "cpu"


def test_known_user_stays_in_cluster(both):
    b = both()
    res = b.predict(user="u0", num=4)
    assert res.item_scores
    assert all(i.startswith("a") for i in items_of(res)), items_of(res)
    res = b.predict(user="u1", num=4)
    assert all(i.startswith("z") for i in items_of(res)), items_of(res)


def test_category_white_black_rules(both):
    b = both()
    res = b.predict(user="u0", num=6, categories=["zeta"])
    assert res.item_scores and all(i.startswith("z") for i in items_of(res))
    res = b.predict(user="u0", num=6, white_list=["a1", "a2"])
    assert set(items_of(res)) <= {"a1", "a2"}
    res = b.predict(user="u0", num=6, black_list=["a0", "a1"])
    assert not {"a0", "a1"} & set(items_of(res))
    assert b.predict(user="u0", num=6, categories=["nope"]).item_scores == []


def test_unavailable_items_update_live(both):
    b = both()
    base = items_of(b.predict(user="u0", num=3))
    assert base
    b.insert("$set", "constraint", "unavailableItems", props={"items": [base[0]]})
    after = items_of(b.predict(user="u0", num=3))
    assert base[0] not in after and after
    b.insert("$set", "constraint", "unavailableItems", props={"items": []})
    assert base[0] in items_of(b.predict(user="u0", num=3))


def test_unseen_only_excludes_live_seen(both):
    b = both(unseen_only=True)
    res = items_of(b.predict(user="u0", num=6))
    port_store, app_id = b.stores[1], b.app_ids[1]
    seen = {e.target_entity_id for e in port_store.l_events.find(
        app_id, entity_type="user", entity_id="u0")}
    assert res and not (set(res) & seen)
    b.insert("view", "user", "u0", res[0])
    assert res[0] not in items_of(b.predict(user="u0", num=6))


def test_unknown_user_with_recent_views_gets_similar(both):
    b = both()
    for it in ["z0", "z1"]:
        b.insert("view", "user", "unew", it)
    res = items_of(b.predict(user="unew", num=3))
    assert res, "similar-items fallback should fire"
    assert all(i.startswith("z") for i in res), res
    assert not {"z0", "z1"} & set(res), "recently viewed items are excluded"


def test_cold_user_popular_fallback_respects_rules(both):
    b = both()
    assert items_of(b.predict(user="nobody", num=4))
    res = items_of(b.predict(user="nobody", num=4, categories=["alpha"]))
    assert res and all(i.startswith("a") for i in res)


def test_model_roundtrip_serves_identically(both):
    b = both()
    restored = [pickle.loads(pickle.dumps(m)) for m in b.models]
    restored[0].to_device("cpu")
    q = ecomm.ECommQuery(user="u0", num=4)
    assert (b.engine.predictor(b.ep, b.models)(q).to_json()
            == b.engine.predictor(b.ep, restored)(q).to_json())


def test_explicitly_empty_whitelist_returns_nothing(both):
    b = both()
    assert items_of(b.predict(user="u0", num=4, white_list=[])) == []
    q = ecomm.ECommQuery.from_json({"user": "u0", "num": 4, "whiteList": []})
    assert q.white_list == []
    assert ecomm.ECommQuery.from_json({"user": "u0"}).white_list is None


@pytest.mark.parametrize("first_revision", [False, True])
def test_jax_pickled_model_serves_in_the_port(fs_storage, monkeypatch, first_revision):
    """The JAX package trains from its localfs store through its
    ``run_train`` and writes the blob to its model store; the port loads
    that blob and serves as the JAX model loaded back from it does.  The
    first revision pickled the dense masks and the category-name dict
    instead of the per-item lists."""
    from predictionio_tpu.workflow import core_workflow as jax_workflow

    port_store = port_memory_storage()
    fill_both(fs_storage, port_store, APP, ecommerce_corpus())
    port_set_storage(port_store)
    try:
        if first_revision:
            monkeypatch.setattr(jax_ecomm.ECommModel, "__getstate__", lambda m: {
                "X": m.user_factors, "Y": m.item_factors, "users": m.user_dict.to_state(),
                "items": m.item_dict.to_state(), "cats": m.cat_dict.to_state(),
                "cat_masks": m.cat_masks, "popular": m.popular})
        params = dict(app_name=APP, rank=8, num_iterations=10, alpha=2.0, mesh_dp=1)
        jax_engine = jax_ecomm.ECommerceEngine.apply()
        jax_ep = JaxEngineParams(
            data_source_params=jax_ecomm.ECommDataSourceParams(app_name=APP),
            algorithm_params_list=[("ecomm", jax_ecomm.ECommAlgorithmParams(**params))])
        instance = jax_workflow.run_train(jax_engine, jax_ep, engine_id="ecomm-jax",
                                          storage=fs_storage)
        blob = fs_storage.models.get(instance.id)
        assert b"cat_masks" in blob if first_revision else b"cat_masks" not in blob
        _, (jax_model,) = jax_workflow.load_latest_models("ecomm-jax", storage=fs_storage)
        (model,) = persistence.deserialize_models(blob, device="cpu")
        assert type(model) is ecomm.ECommModel
        assert sorted(model.item_categories) == sorted(jax_model.item_categories)
        np.testing.assert_array_equal(model.cat_masks, jax_model.cat_masks)
        np.testing.assert_array_equal(model.user_factors, jax_model.user_factors)
        engine = ecomm.ECommerceEngine.apply()
        ep = EngineParams(
            data_source_params=port_ecomm.ECommDataSourceParams(app_name=APP),
            algorithm_params_list=[("ecomm", ecomm.ECommAlgorithmParams(**params))])
        predict = engine.predictor(ep, [model])
        jax_predict = jax_engine.predictor(jax_ep, [jax_model])
        for q in ({"user": "u0", "num": 4, "categories": ["alpha"]},
                  {"user": "u1", "num": 6, "black_list": ["z0"]},
                  {"user": "nobody", "num": 3}):
            got = predict(ecomm.ECommQuery(**q))
            want = jax_predict(jax_ecomm.ECommQuery(**q))
            assert got.item_scores and [s.item for s in got.item_scores] == [
                s.item for s in want.item_scores]
            np.testing.assert_allclose([s.score for s in got.item_scores],
                                       [s.score for s in want.item_scores],
                                       rtol=1e-5, atol=1e-6)
    finally:
        port_set_storage(None)


def test_first_revision_pickle_format_migrates(both):
    b = both()
    m = b.models[0]
    old_state = {
        "X": m.user_factors, "Y": m.item_factors,
        "users": m.user_dict.to_state(), "items": m.item_dict.to_state(),
        "cats": m.cat_dict.to_state(), "cat_masks": m.cat_masks,
        "popular": m.popular,
    }
    restored = type(m).__new__(type(m))
    restored.__setstate__(old_state)
    restored.to_device("cpu")
    assert sorted(restored.item_categories) == sorted(m.item_categories)
    assert (restored.cat_masks == m.cat_masks).all()
    q = ecomm.ECommQuery(user="u0", num=4, categories=["alpha"])
    assert (b.engine.predictor(b.ep, b.models)(q).to_json()
            == b.engine.predictor(b.ep, [restored])(q).to_json())


def test_ecomm_serve_batch_matches_serial(both):
    """serve_batch_predict ≡ predict across the known-user, recent-similar
    and popularity tiers, rules, and infeasible queries in one batch, and
    both equal the JAX batch."""
    b = both()
    model = b.models[0]
    name, params = b.ep.algorithm_params_list[0]
    algo = b.engine.algorithm_classes[name](params)
    jax_algo = b.jax_engine.algorithm_classes[name](b.jax_ep.algorithm_params_list[0][1])
    b.insert("view", "user", "unew", "z2")
    bodies = [dict(user="u0", num=4), dict(user="u1", num=4),
              dict(user="totally-new", num=4), dict(user="unew", num=3),
              dict(user="u0", num=6, categories=["zeta"]),
              dict(user="u0", num=6, white_list=["a1", "a2"]),
              dict(user="u0", num=6, black_list=["a0", "a1"]),
              dict(user="u0", num=6, categories=["nope"])]
    queries = [ecomm.ECommQuery(**q) for q in bodies]
    serial = [algo.predict(model, q) for q in queries]
    batched = algo.serve_batch_predict(model, queries)
    jax_batched = jax_algo.serve_batch_predict(
        b.jax_models[0], [jax_ecomm.ECommQuery(**q) for q in bodies])
    for q, s, bt, jb in zip(queries, serial, batched, jax_batched):
        s_i = [(r.item, round(r.score, 4)) for r in s.item_scores]
        b_i = [(r.item, round(r.score, 4)) for r in bt.item_scores]
        assert s_i == b_i, (q, s_i, b_i)
        assert_same(bt.to_json(), jb.to_json())


def test_mesh_dp_above_one_names_the_roadmap(both):
    b = both()
    params = ecomm.ECommAlgorithmParams(app_name=APP, mesh_dp=2)
    td = b.engine.make_components(b.ep)[0].read_training()
    with pytest.raises(NotImplementedError, match="torch.distributed"):
        ecomm.ECommAlgorithm(params, device="cpu").train(td)
