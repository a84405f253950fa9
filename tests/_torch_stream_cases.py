"""Shared cases of the port's streaming tests
(tests/test_torch_streaming_fold.py, tests/test_torch_streaming_follow.py):
the JAX streaming suite's event builders, UR engine setup and exactness
check, written for the port's store, engine and fold.

Every fold is held against a from-scratch ``engine.train`` on the same
device (the CPU here): indicator ids and LLR scores per type, item
dictionaries, popularity, properties and answers, bit for bit.
"""

import numpy as np
import pytest

from predictionio_tpu_torch.controller import EngineParams
from predictionio_tpu_torch.events.event import DataMap, Event
from predictionio_tpu_torch.models.universal_recommender import UniversalRecommenderEngine
from predictionio_tpu_torch.models.universal_recommender.engine import (
    URAlgorithm,
    URAlgorithmParams,
    URDataSourceParams,
)
from predictionio_tpu_torch.serve import history_cache as port_history_cache
from predictionio_tpu_torch.serve import response_cache as port_response_cache
from predictionio_tpu_torch.storage import App, set_storage
from predictionio_tpu_torch.store.event_store import invalidate_staging_cache

from _torch_event_cases import port_localfs_storage

CPU = "cpu"


def buy(u, i, event="purchase"):
    return Event(event=event, entity_type="user", entity_id=u,
                 target_entity_type="item", target_entity_id=i)


def set_item(i, props):
    return Event(event="$set", entity_type="item", entity_id=i, properties=DataMap(props))


def seed_events(n_users=12, n_items=8, seed=1, base_u=0):
    """The JAX suite's ``_seed_events``: purchases and views of a seeded
    user x item grid."""
    rng = np.random.default_rng(seed)
    out = []
    for u in range(base_u, base_u + n_users):
        for it in range(n_items):
            if rng.random() < 0.45:
                out.append(buy(f"u{u}", f"i{it}"))
            if rng.random() < 0.6:
                out.append(buy(f"u{u}", f"i{it}", event="view"))
    return out


@pytest.fixture()
def port_fs(tmp_path):
    """A port localfs store bound as the process default (the serving
    history read uses it), with the serving caches emptied around it."""
    store = port_localfs_storage(tmp_path / "store")
    set_storage(store)
    port_response_cache.get_cache().reset_for_tests()
    port_history_cache.get_cache().reset_for_tests()
    yield store
    set_storage(None)
    port_response_cache.get_cache().reset_for_tests()
    port_history_cache.get_cache().reset_for_tests()


@pytest.fixture()
def host_serving(monkeypatch):
    monkeypatch.setenv("PIO_UR_SERVE_SCORER", "host")
    monkeypatch.setenv("PIO_UR_SERVE_TAIL", "host")


def ur_params(app_name="sfapp", event_names=("purchase", "view"), **algo_kw):
    """(engine, algorithm params, engine params) of a UR engine."""
    engine = UniversalRecommenderEngine.apply()
    algo_kw.setdefault("max_correlators_per_item", 6)
    ap = URAlgorithmParams(app_name=app_name, **algo_kw)
    ep = EngineParams(
        data_source_params=URDataSourceParams(app_name=app_name,
                                              event_names=list(event_names)),
        algorithm_params_list=[("ur", ap)])
    return engine, ap, ep


def ur_setup(store, app_name="sfapp", event_names=("purchase", "view"), **algo_kw):
    """(app id, engine, algorithm params, engine params) of a new UR app."""
    app_id = store.apps.insert(App(0, app_name))
    return (app_id,) + ur_params(app_name, event_names, **algo_kw)


def tail(store, app_id, wm, base, heads):
    return store.l_events.scan_tail_from(app_id, None, wm, base=base, heads=heads)


def canon(res):
    return [(s.item, float(s.score)) for s in res.item_scores]


def fresh_ref(engine, ep):
    invalidate_staging_cache()
    return engine.train(ep, device=CPU)[0]


def assert_models_equal(ma, mb, ctx=""):
    """Two URModels array-identical (the JAX suite's check)."""
    assert ma.item_dict.strings() == mb.item_dict.strings(), ctx
    assert set(ma.indicator_idx) == set(mb.indicator_idx), ctx
    for name in ma.indicator_idx:
        assert np.array_equal(ma.indicator_idx[name], mb.indicator_idx[name]), (ctx, name)
        assert np.array_equal(ma.indicator_llr[name], mb.indicator_llr[name]), (ctx, name)
        assert (ma.event_item_dicts[name].strings()
                == mb.event_item_dicts[name].strings()), (ctx, name)
    assert np.array_equal(ma.popularity, mb.popularity), ctx
    assert ma.item_properties == mb.item_properties, ctx


def assert_models_equivalent(ma, mb):
    """Two URModels equal up to the order of their item ids (two reads of
    one log in different orders): per primary item, the same correlators
    with the same scores, and the same popularity per item.  Holds
    exactly only where no row is cut at the top-k (ties there break by
    id)."""
    assert sorted(ma.item_dict.strings()) == sorted(mb.item_dict.strings())
    assert set(ma.indicator_idx) == set(mb.indicator_idx)

    def rows(m, name):
        names, targets = m.item_dict.strings(), m.event_item_dicts[name].strings()
        idx, llr = m.indicator_idx[name], m.indicator_llr[name]
        assert (idx >= 0).sum(axis=1).max(initial=0) < idx.shape[1], "a row was cut"
        return {names[r]: sorted((targets[j], float(w)) for j, w in zip(idx[r], llr[r])
                                 if j >= 0) for r in range(idx.shape[0])}

    for name in ma.indicator_idx:
        assert rows(ma, name) == rows(mb, name), name
    pop = dict(zip(mb.item_dict.strings(), np.asarray(mb.popularity).tolist()))
    assert dict(zip(ma.item_dict.strings(), np.asarray(ma.popularity).tolist())) == pop


def assert_model_equals_fresh(model, engine, ep, queries, algo=None):
    """A folded model's arrays AND answers equal a from-scratch train."""
    ref = fresh_ref(engine, ep)
    assert_models_equal(model, ref, "vs train")
    algo = algo or URAlgorithm(ep.algorithm_params_list[0][1], device=CPU)
    for q in queries:
        assert canon(algo.predict(ref, q)) == canon(algo.predict(model, q)), q


def follow_pair(store, engine, ep, engine_id="swap-eng"):
    """(query server state, follower): a trained and deployed engine with
    the embedded swap wired, bootstrapped, on the CPU."""
    from predictionio_tpu_torch.streaming.follow import FollowTrainer
    from predictionio_tpu_torch.workflow import core_workflow
    from predictionio_tpu_torch.workflow.create_server import QueryServerState

    core_workflow.run_train(engine, ep, engine_id=engine_id, storage=store, device=CPU)
    state = QueryServerState(engine, ep, UniversalRecommenderEngine.query_class, engine_id,
                             "1", "default", storage=store, device=CPU)
    follower = state.follower = FollowTrainer(
        engine, ep, engine_id, storage=store, interval=3600,
        on_publish=state.swap_models, persist=False, device=CPU)
    assert follower.mode == "fold"
    assert follower.bootstrap()
    return state, follower
