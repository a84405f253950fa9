"""Shared cases of the port's model-plane tests
(tests/test_torch_model_plane.py, tests/test_torch_plane_replication.py):
the JAX plane suite's UR fixture, synthetic fold states and exactness
check, written for the port (on the CPU), beside the JAX suite's own
helpers for the reference side.

Every composed generation is held to its source model bit for bit: every
serialized array with its dtype, the derived inverted CSRs and popularity
order, the dictionaries and the item properties.
"""

import numpy as np
import pytest

from predictionio_tpu_torch.controller import EngineParams
from predictionio_tpu_torch.events.event import Event
from predictionio_tpu_torch.models.universal_recommender import (
    UniversalRecommenderEngine,
    URQuery,
)
from predictionio_tpu_torch.models.universal_recommender.engine import (
    URAlgorithm,
    URAlgorithmParams,
    URDataSourceParams,
)
from predictionio_tpu_torch.serve import history_cache as port_history_cache
from predictionio_tpu_torch.serve import response_cache as port_response_cache
from predictionio_tpu_torch.storage import App, set_storage
from predictionio_tpu_torch.store.columnar import EventBatch
from predictionio_tpu_torch.streaming.fold import URFoldState

from _torch_event_cases import port_memory_storage
from _torch_stream_cases import CPU, buy, host_serving, set_item  # noqa: F401  (fixture)


def seed_app(store, app_name="mpapp", n_users=14, n_items=9, seed=5):
    """The JAX plane suite's ``_seed``: purchases of a seeded grid and a
    category on every item."""
    app_id = store.apps.insert(App(0, app_name))
    rng = np.random.default_rng(seed)
    evs = [buy(f"u{u}", f"i{it}") for u in range(n_users) for it in range(n_items)
           if rng.random() < 0.5]
    evs += [set_item(f"i{it}", {"category": f"c{it % 3}"}) for it in range(n_items)]
    store.l_events.insert_batch(evs, app_id)
    return app_id


def ur(app_name="mpapp"):
    """(engine, engine params, algorithm) of the suite's UR on the CPU."""
    engine = UniversalRecommenderEngine.apply()
    ap = URAlgorithmParams(app_name=app_name, max_correlators_per_item=5)
    ep = EngineParams(data_source_params=URDataSourceParams(app_name=app_name,
                                                            event_names=["purchase"]),
                      algorithm_params_list=[("ur", ap)])
    return engine, ep, URAlgorithm(ap, device=CPU)


def canon(res):
    return [(s.item, float(s.score)) for s in res.item_scores]


def corpus():
    return [URQuery.from_json(b) for b in (
        {"user": "u2", "num": 5},
        {"user": "nobody", "num": 4},
        {"user": "u3", "num": 5,
         "fields": [{"name": "category", "values": ["c1"], "bias": -1}]},
        {"user": "u4", "num": 5,
         "fields": [{"name": "category", "values": ["c0"], "bias": 2.0}]},
        {"user": "u5", "num": 5, "blacklistItems": ["i1", "i2"]},
        {"item": "i1", "num": 4},
    )]


@pytest.fixture()
def port_mem():
    """A port memory store bound as the process default (the serving
    history read uses it), the serving caches emptied around it."""
    store = port_memory_storage()
    set_storage(store)
    port_response_cache.get_cache().reset_for_tests()
    port_history_cache.get_cache().reset_for_tests()
    yield store
    set_storage(None)
    port_response_cache.get_cache().reset_for_tests()
    port_history_cache.get_cache().reset_for_tests()


@pytest.fixture()
def plane_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_MODEL_PLANE_POLL_S", "0.05")
    return str(tmp_path / "plane")


def port_fold_state(n_items=1200, hist=4, k=5):
    """The JAX suite's ``_fold_state`` for the port: one buy per item,
    ``hist``-item user histories, on the CPU."""
    ap = URAlgorithmParams(app_name="delta", max_correlators_per_item=k)
    dp = URDataSourceParams(app_name="delta", event_names=["buy"])
    batch = EventBatch.from_events([buy(f"u{j // hist}", f"i{j}", "buy")
                                    for j in range(n_items)])
    batch.prop_columns = {}
    return URFoldState.bootstrap(ap, dp, batch, device=CPU)


def port_fold_delta(state, events):
    """Fold a delta sharing the state's dictionaries (the scan_tail
    contract); the emitted model with its host serving state built."""
    d = EventBatch.from_events(events, entity_dict=state.batch.entity_dict,
                               target_dict=state.batch.target_dict,
                               event_dict=state.batch.event_dict)
    d.prop_columns = {}
    model = state.fold(d)
    model.ensure_host_serving_state()
    return model


def freshness_delta(r, n_items, event_cls=Event):
    """The JAX suite's freshness round: a probe buys a seed item, four
    co-buyers buy the seed and a brand-new item (every finite LLR moves)."""
    seed = f"i{(r * 97) % n_items}"
    evs = [event_cls(event="buy", entity_type="user", entity_id=f"probe{r}",
                     target_entity_type="item", target_entity_id=seed)]
    for j in range(4):
        for tgt in (seed, f"fresh_item_{r}"):
            evs.append(event_cls(event="buy", entity_type="user", entity_id=f"cob{r}_{j}",
                                 target_entity_type="item", target_entity_id=tgt))
    return evs


def _same(x, y, what):
    x, y = np.asarray(x), np.asarray(y)
    assert x.dtype == y.dtype, (what, x.dtype, y.dtype)
    assert x.shape == y.shape, (what, x.shape, y.shape)
    assert np.array_equal(x.view(np.uint8) if x.size else x,
                          y.view(np.uint8) if y.size else y), what


def assert_models_identical(a, b):
    """``a`` (a composed plane model, either package) equals ``b`` (the
    source model, either package) bit for bit: every array and its dtype,
    the derived CSRs and popularity order, dictionaries and properties."""
    assert list(a.indicator_idx) == list(b.indicator_idx)
    for n in b.indicator_idx:
        _same(a.indicator_idx[n], b.indicator_idx[n], ("idx", n))
        _same(a.indicator_llr[n], b.indicator_llr[n], ("llr", n))
        for part, x, y in zip(("indptr", "rows", "w"), a.__dict__["_host_inv"][n],
                              b.host_inverted(n)):
            _same(x, y, ("inv", n, part))
        assert a.event_item_dicts[n].strings() == b.event_item_dicts[n].strings(), n
    _same(a.popularity, b.popularity, "popularity")
    _same(a.__dict__["_host_pop_order"], b.host_pop_order(), "pop_order")
    _same(a.user_seen.indptr, b.user_seen.indptr, "user_seen.indptr")
    _same(a.user_seen.values, b.user_seen.values, "user_seen.values")
    assert set(a.user_seen_by_event) == set(b.user_seen_by_event)
    for n, csr in b.user_seen_by_event.items():
        _same(a.user_seen_by_event[n].indptr, csr.indptr, ("seen", n))
        _same(a.user_seen_by_event[n].values, csr.values, ("seen", n))
    assert a.item_dict.strings() == b.item_dict.strings()
    assert a.user_dict.strings() == b.user_dict.strings()
    assert dict(a.item_properties) == dict(b.item_properties)
    assert a.primary_event == b.primary_event


def read_only_views(model):
    """The arrays of a composed model that must refuse a write."""
    name = next(iter(model.indicator_idx))
    return (model.indicator_idx[name], model.indicator_llr[name], model.popularity,
            model.user_seen.values, model.__dict__["_host_pop_order"],
            model.__dict__["_host_inv"][name][2])
