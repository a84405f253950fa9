"""The port's Universal Recommender business rules against the JAX package.

Every rule test of tests/test_universal_recommender.py runs here with its
corpus (the two-cluster ``ur_app`` events and the test's ``$set`` stamps,
with explicit event times) written into each package's memory store; each
package trains from its own store through ``Engine.train`` (the port on
CPU tensors) and both serve the test's queries.  The answers agree under
``assert_same_answer`` and each test's own assertions hold for the port.
A seeded sweep of random item properties and rule sets holds the port's
composed rule mask against the JAX ``_mask_from_key_device`` bit for bit
(f32), and the answers against the JAX answers.  On the CPU both packages'
``auto`` serves through the host halves; the ``*_device_halves_*`` sweep
pins both to the device scorer and tail.
"""

import json
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.controller.engine import EngineParams as JaxEngineParams
from predictionio_tpu.models.universal_recommender import engine as jax_ur
from predictionio_tpu_torch.controller import EngineParams
from predictionio_tpu_torch.models import universal_recommender as ur
from predictionio_tpu_torch.models.universal_recommender import engine as port_ur
from predictionio_tpu_torch.storage import set_storage as port_set_storage
from predictionio_tpu_torch.workflow.create_server import deploy_models

from _torch_event_cases import (DAY, T0, fill_both, iso, port_memory_storage,
                                rule_corpus, seeded_corpus)
from _torch_ur_cases import assert_same_answer

APP = "urapp"


@pytest.fixture()
def stores(mem_storage, monkeypatch):
    """(JAX store, port store), each its package's process default; the JAX
    package serves through its exact oracles (no history or response
    cache)."""
    for k in ("PIO_HISTORY_CACHE", "PIO_SERVE_CACHE"):
        monkeypatch.setenv(k, "off")
    port_store = port_memory_storage()
    port_set_storage(port_store)
    yield mem_storage, port_store
    port_set_storage(None)


class Both:
    """The same engine.json params trained from events by each package."""

    def __init__(self, stores, specs, app=APP, ds=None, **algo):
        jax_store, port_store = stores
        fill_both(jax_store, port_store, app, specs)
        algo = {"app_name": app, "max_correlators_per_item": 8, "min_llr": 2.0, **algo}
        ds = {"app_name": app, **(ds or {})}
        self.jax_engine = jax_ur.UniversalRecommenderEngine.apply()
        self.jax_ep = JaxEngineParams(
            data_source_params=jax_ur.URDataSourceParams(**ds),
            algorithm_params_list=[("ur", jax_ur.URAlgorithmParams(mesh_dp=1, **algo))])
        self.jax_models = self.jax_engine.train(self.jax_ep)
        self.engine = ur.UniversalRecommenderEngine.apply()
        self.ep = EngineParams(
            data_source_params=port_ur.URDataSourceParams(**ds),
            algorithm_params_list=[("ur", ur.URAlgorithmParams(**algo))])
        self.models = self.engine.train(self.ep, device="cpu")
        self.jax_predict = self.jax_engine.predictor(self.jax_ep, self.jax_models)
        self.predict = self.engine.predictor(self.ep, self.models)

    def answer(self, body):
        """The port's answer, held against the JAX answer."""
        got = self.predict(ur.URQuery.from_json(body)).to_json()
        assert_same_answer(got, self.jax_predict(jax_ur.URQuery.from_json(body)).to_json())
        return [d["item"] for d in got["itemScores"]]

    def raises_in_both(self, body):
        for predict, mod in ((self.predict, ur), (self.jax_predict, jax_ur)):
            with pytest.raises(ValueError, match="ISO-8601"):
                predict(mod.URQuery.from_json(body))


# -- the rule tests of tests/test_universal_recommender.py --------------------------------


def test_field_filter_and_boost(stores):
    both = Both(stores, rule_corpus([]))
    books = {"name": "category", "values": ["books"], "bias": -1}
    items = both.answer({"user": "u2", "num": 6, "fields": [books]})
    assert all(i.startswith("b") for i in items)
    items = both.answer({"user": "stranger", "num": 6, "fields": [books]})
    assert items and all(i.startswith("b") for i in items)
    items = both.answer({"user": "u2", "num": 6, "fields": [
        {"name": "category", "values": ["books"], "bias": 3.0}]})
    assert items


def test_date_range_rule(stores):
    stamps = [(f"e{i}", {"releaseDate": "2026-06-01T00:00:00"}) for i in range(6)] + [
        (f"b{i}", {"releaseDate": "2020-01-01T00:00:00"}) for i in range(6)]
    both = Both(stores, rule_corpus(stamps))
    items = both.answer({"user": "u20", "num": 4})
    assert items and items[0].startswith("b")
    items = both.answer({"user": "u20", "num": 4, "dateRange": {
        "name": "releaseDate", "after": "2026-01-01T00:00:00",
        "before": "2026-12-31T00:00:00"}})
    assert all(i.startswith("e") for i in items)


def test_available_expire_dates(stores):
    open_window = {"availableDate": "2024-01-01T00:00:00",
                   "expireDate": "2028-01-01T00:00:00"}
    stamps = [("b0", {"availableDate": "2027-01-01T00:00:00",
                      "expireDate": "2028-01-01T00:00:00"}),
              ("b1", {"availableDate": "2024-01-01T00:00:00",
                      "expireDate": "2025-01-01T00:00:00"})]
    stamps += [(it, open_window) for it in ["b3", "b4", "b5"] + [f"e{i}" for i in range(6)]]
    both = Both(stores, rule_corpus(stamps), available_date_name="availableDate",
                expire_date_name="expireDate")
    items = both.answer({"user": "u20", "num": 6, "currentDate": "2026-07-29T00:00:00"})
    assert items and not {"b0", "b1", "b2"} & set(items)
    assert len(both.answer({"user": "u20", "num": 6})) >= len(items)


def test_date_range_in_range_items_survive(stores):
    stamps = [(f"e{i}", {"releaseDate": "2026-06-01T00:00:00"}) for i in range(6)]
    both = Both(stores, rule_corpus(stamps))
    items = both.answer({"user": "u2", "num": 4, "dateRange": {
        "name": "releaseDate", "after": "2026-01-01T00:00:00"}})
    assert items and all(i.startswith("e") for i in items)
    both.raises_in_both({"user": "u2", "num": 4,
                         "dateRange": {"name": "releaseDate", "after": "01/2026"}})
    both.raises_in_both({"user": "u2", "currentDate": "2026/07/29"})


def test_expire_date_boundary_instant_valid(stores):
    both = Both(stores, rule_corpus([("b2", {"expireDate": "2026-07-29T00:00:00"})]),
                expire_date_name="expireDate")
    at = both.answer({"user": "u20", "num": 8, "currentDate": "2026-07-29T00:00:00"})
    past = both.answer({"user": "u20", "num": 8, "currentDate": "2026-07-29T00:00:01"})
    assert "b2" in at and "b2" not in past


def test_field_boost_reorders_backfill(stores):
    both = Both(stores, rule_corpus([]))
    plain = both.answer({"user": "cold", "num": 12})
    boosted = both.answer({"user": "cold", "num": 12, "fields": [
        {"name": "category", "values": ["books"], "bias": 50.0}]})
    assert len(boosted) == len(plain) > 0
    assert all(i.startswith("b") for i in boosted[:6])


def test_unknown_property_names_match_nothing(stores):
    both = Both(stores, rule_corpus([]))
    assert both.answer({"user": "u2", "num": 5, "fields": [
        {"name": "no-such-prop", "values": ["x"], "bias": -1}]}) == []
    assert both.answer({"user": "u2", "num": 5, "dateRange": {
        "name": "not-a-date", "after": "2020-01-01"}}) == []
    assert both.answer({"user": "u2", "num": 5, "fields": [
        {"name": "category", "values": ["no-such-value"], "bias": -1}]}) == []
    model = both.models[0]
    assert not model.__dict__.get("_dev_date")
    assert ("no-such-prop", "x") not in (model.__dict__.get("_dev_value_mask") or ())


# -- the seeded sweep: composed masks bit for bit, and the answers ---------------------------------


def _random_rules(rng, users, n):
    """``n`` query bodies with random rule sets over the seeded corpus'
    properties (tests/_torch_event_cases.py:seeded_corpus), unknown names
    and values included, dates at and around item bounds."""
    names = ["category", "tags", "no-such-prop"]
    values = {"category": [f"c{j}" for j in range(6)], "tags": [f"t{j}" for j in range(9)],
              "no-such-prop": ["x"]}
    bodies = []
    for _ in range(n):
        body = {"user": str(rng.choice(users)), "num": int(rng.choice([3, 8, 40]))}
        fields = []
        for _ in range(int(rng.integers(0, 3))):
            name = str(rng.choice(names))
            fields.append({"name": name, "bias": float(rng.choice([-1.0, 0.5, 2.0, 1.0, 0.0])),
                           "values": [str(v) for v in rng.choice(
                               values[name], int(rng.integers(1, 3)))]})
        if fields:
            body["fields"] = fields
        if rng.random() < 0.5:
            dr = {"name": str(rng.choice(["releaseDate", "availableDate", "no-date"]))}
            if rng.random() < 0.7:
                dr["after"] = iso(T0 - float(rng.integers(0, 4000)) * DAY)
            if rng.random() < 0.7:
                dr["before"] = iso(T0 - float(rng.integers(-300, 3000)) * DAY)
            body["dateRange"] = dr
        if rng.random() < 0.5:
            body["currentDate"] = iso(T0 + float(rng.integers(-40, 40)) * DAY)
        bodies.append(body)
    return bodies


@pytest.mark.parametrize("seed", range(6))
def test_rule_mask_sweep_matches_jax(stores, seed):
    both = Both(stores, seeded_corpus(seed), min_llr=0.0,
                available_date_name="availableDate",
                expire_date_name="expireDate" if seed % 2 else "")
    (jm,), (pm,) = both.jax_models, both.models
    jax_algo = jax_ur.URAlgorithm(both.jax_ep.algorithm_params_list[0][1])
    port_algo = ur.URAlgorithm(both.ep.algorithm_params_list[0][1])
    rng = np.random.default_rng(100 + seed)
    n_rules = 0
    for body in _random_rules(rng, pm.user_dict.strings() + ["cold"], 30):
        key = port_algo._mask_rule_key(ur.URQuery.from_json(body))
        assert key == jax_algo._mask_rule_key(jax_ur.URQuery.from_json(body))
        if key is not None:
            got = port_algo._mask_from_key(pm, key).numpy()
            want = np.asarray(jax_algo._mask_from_key_device(jm, *key))
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
            n_rules += 1
        both.answer(body)
    assert n_rules >= 20


@pytest.mark.parametrize("seed", range(2))
def test_rule_mask_sweep_device_halves_match_jax(stores, seed, monkeypatch):
    """The sweep with both packages pinned to the device scorer and tail
    (the port's on CPU tensors): on the CPU ``auto`` serves the host
    halves."""
    for k in ("PIO_UR_SERVE_SCORER", "PIO_UR_SERVE_TAIL"):
        monkeypatch.setenv(k, "device")
    test_rule_mask_sweep_matches_jax(stores, seed)


def test_mask_ops_match_jax():
    rng = np.random.default_rng(0)
    mask = rng.choice(np.float32([0.0, 0.5, 1.0, 2.0, 3.25]), 257).astype(np.float32)
    match = (rng.random(257) < 0.4).astype(np.float32)
    ts = rng.integers(-1, 50, 257).astype(np.int32)
    cases = [("_m_or", (mask, match)), ("_m_hard", (mask, match)),
             ("_m_boost", (mask, match, 0.3)), ("_m_boost", (mask, match, 2.0)),
             ("_m_present", (mask, ts)), ("_m_ge", (mask, ts, 17)),
             ("_m_le", (mask, ts, 17)), ("_m_ge", (mask, ts, -1))]
    for name, args in cases:
        got = getattr(port_ur, name)(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                                       for a in args]).numpy()
        want = np.asarray(getattr(jax_ur, name)(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                                                  else a for a in args]))
        assert got.dtype == want.dtype == np.float32, name
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32), err_msg=name)


# -- malformed query dates ------------------------------------------------------------------


BAD_DATES = [
    {"user": "u2", "currentDate": "29/07/2026"},
    {"user": "u2", "currentDate": True},
    {"user": "u2", "dateRange": {"name": "releaseDate", "after": "2026-13-01"}},
    {"user": "u2", "dateRange": {"name": "releaseDate", "before": "yesterday"}},
]


@pytest.mark.parametrize("body", BAD_DATES)
def test_malformed_query_dates_are_bad_requests(stores, body):
    both = Both(stores, rule_corpus([(f"e{i}", {"releaseDate": "2026-06-01T00:00:00"})
                                     for i in range(6)]))
    both.raises_in_both(body)
    server = deploy_models(both.engine, both.ep, both.models, port=0,
                           query_class=ur.URQuery)
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/queries.json"
        req = urllib.request.Request(url, data=json.dumps(body).encode())
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=60)
        assert err.value.code == 400
        assert "ISO-8601" in json.loads(err.value.read())["message"]
    finally:
        server.shutdown()
        server.server_close()
