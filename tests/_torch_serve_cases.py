"""Shared cases of the port's UR serving tests (tests/test_torch_serve_tail.py,
tests/test_torch_serve_candidates.py, tests/test_torch_response_cache.py,
tests/test_torch_history_cache.py): fabricated models with planted score
and popularity pathologies, seeded store corpora served by both packages,
random query bodies, and the switches that make the JAX package serve
through its exact oracles.

The JAX package and the port read the same ``PIO_*`` variables, so a JAX
call runs under ``jax_oracles()`` (no native lane, no history or response
cache: its numpy oracles) and the port's calls under the caller's own
settings.
"""

import contextlib
import json
import os

import numpy as np
import pytest

from predictionio_tpu.controller.engine import EngineParams as JaxEngineParams
from predictionio_tpu.models.universal_recommender import engine as jax_ur
from predictionio_tpu.store.columnar import CSRLookup as JaxCSRLookup
from predictionio_tpu.store.columnar import IdDict as JaxIdDict
from predictionio_tpu_torch.models import universal_recommender as ur
from predictionio_tpu_torch.serve import history_cache as port_history_cache
from predictionio_tpu_torch.serve import response_cache as port_response_cache
from predictionio_tpu_torch.storage import set_storage as port_set_storage

from _torch_event_cases import DAY, T0, fill_both, iso, port_memory_storage, seeded_corpus

APP = "serveapp"
ORACLES = {"PIO_NATIVE": "off", "PIO_HISTORY_CACHE": "off", "PIO_SERVE_CACHE": "off"}
SERVE_KNOBS = ("PIO_UR_SERVE_SCORER", "PIO_UR_SERVE_TAIL", "PIO_UR_SERVE_CANDIDATES")


@contextlib.contextmanager
def env(**values):
    """Set (str) or unset (None) environment variables for the block."""
    saved = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def jax_oracles():
    """The JAX package's exact oracles, and its ``auto`` halves (the host
    ones under ``JAX_PLATFORMS=cpu``)."""
    return env(**ORACLES, **{k: None for k in SERVE_KNOBS})


@pytest.fixture()
def fresh_caches():
    """The port's process-wide serving caches emptied around a test."""
    port_response_cache.get_cache().reset_for_tests()
    port_history_cache.get_cache().reset_for_tests()
    yield
    port_response_cache.get_cache().reset_for_tests()
    port_history_cache.get_cache().reset_for_tests()


def canon(result):
    """An answer as (item, score) pairs, scores exact."""
    return [(s.item, float(s.score)) for s in result.item_scores]


def dumps(result) -> bytes:
    """The bytes the query server writes for an answer (``json.dumps``)."""
    return json.dumps(result.to_json()).encode()


# -- fabricated models: full control over score and popularity pathologies ----


def make_models(n_items=400, k=8, seed=0, popularity=None, const_llr=False,
                blank_type=None, n_users=20):
    """A JAX ``URModel`` built directly (tests/test_serve_candidates.py's
    ``make_model``) and the port's model of its state on the CPU: random
    indicator tables with -1 padding over two event types sharing the
    primary item space; ``const_llr`` makes every weight 1.0; ``blank_type``
    makes one type's table all -1 (empty postings); the popularity has few
    distinct values (the backfill order is mostly ties)."""
    rng = np.random.default_rng(seed)
    item_dict = JaxIdDict([f"i{j}" for j in range(n_items)])
    user_dict = JaxIdDict([f"u{j}" for j in range(n_users)])
    idx, llr, dicts = {}, {}, {}
    for name in ("ev0", "ev1"):
        tbl = rng.integers(0, n_items, (n_items, k)).astype(np.int32)
        tbl[:, -1] = -1
        if name == blank_type:
            tbl = np.full((n_items, k), -1, np.int32)
        idx[name] = tbl
        llr[name] = (np.ones((n_items, k), np.float32) if const_llr
                     else np.sort(rng.random((n_items, k)).astype(np.float32) * 4,
                                  axis=1)[:, ::-1].copy())
        dicts[name] = item_dict
    if popularity is None:
        popularity = (np.round(rng.random(n_items).astype(np.float32) * 4) / 2
                      ).astype(np.float32)
    props = {f"i{j}": {"category": f"c{j % 5}"} for j in range(0, n_items, 3)}
    jax_model = jax_ur.URModel(
        primary_event="ev0", item_dict=item_dict, user_dict=user_dict,
        indicator_idx=idx, indicator_llr=llr, event_item_dicts=dicts,
        popularity=np.asarray(popularity, np.float32), item_properties=props,
        user_seen=JaxCSRLookup.from_pairs(np.zeros(0, np.int32), np.zeros(0, np.int32),
                                          len(user_dict)))
    return jax_model, ur.ur_model_from_state(jax_model.__getstate__(), device="cpu")


def algos(**over):
    """(JAX algorithm, port algorithm) of the same params."""
    kw = dict(app_name=APP, mesh_dp=1)
    kw.update(over)
    return (jax_ur.URAlgorithm(jax_ur.URAlgorithmParams(**kw)),
            ur.URAlgorithm(ur.URAlgorithmParams(**kw)))


def hist_for(ids, types=("ev0", "ev1")):
    return {t: np.asarray(sorted(set(ids)), np.int32) for t in types}


# -- seeded store corpora served by both packages --------------------------------


class Served:
    """``seeded_corpus(seed)`` in each package's memory store (each its
    package's process default), trained by the JAX package and carried to
    the port on the CPU, so the two serve the same model from the same
    events."""

    def __init__(self, jax_store, seed, **algo):
        self.port_store = port_memory_storage()
        port_set_storage(self.port_store)
        fill_both(jax_store, self.port_store, APP, seeded_corpus(seed))
        self.algo_params = {"app_name": APP, "max_correlators_per_item": 8,
                            "min_llr": 0.0, "available_date_name": "availableDate",
                            "expire_date_name": "expireDate" if seed % 2 else "", **algo}
        engine = jax_ur.UniversalRecommenderEngine.apply()
        ep = JaxEngineParams(
            data_source_params=jax_ur.URDataSourceParams(app_name=APP),
            algorithm_params_list=[("ur", jax_ur.URAlgorithmParams(
                mesh_dp=1, **self.algo_params))])
        with jax_oracles():
            (self.jax_model,) = engine.train(ep)
        self.jax_algo = jax_ur.URAlgorithm(ep.algorithm_params_list[0][1])
        self.model = ur.ur_model_from_state(self.jax_model.__getstate__(), device="cpu")
        self.algo = ur.URAlgorithm(ur.URAlgorithmParams(**self.algo_params))

    def jax_answer(self, body):
        with jax_oracles():
            return self.jax_algo.predict(self.jax_model, jax_ur.URQuery.from_json(body))

    def answer(self, body, model=None):
        return self.algo.predict(model or self.model, ur.URQuery.from_json(body))

    def users(self):
        return self.model.user_dict.strings()


def random_bodies(rng, users, items, n):
    """``n`` query bodies over the seeded corpus: users with history and
    cold ones, items and item sets, random rule sets (field filters and
    boosts on known and unknown names and values, dateRange, currentDate),
    blacklists, and num 0, 1, 4 and 1,000."""
    names = ["category", "tags", "no-such-prop"]
    values = {"category": [f"c{j}" for j in range(6)], "tags": [f"t{j}" for j in range(9)],
              "no-such-prop": ["x"]}
    bodies = []
    for j in range(n):
        kind = j % 6
        if kind < 3:
            body = {"user": str(rng.choice(users + ["cold-user"]))}
        elif kind == 3:
            body = {"item": str(rng.choice(items + ["no-such-item"]))}
        elif kind == 4:
            body = {"itemSet": [str(x) for x in rng.choice(items, 3)]}
        else:
            body = {}
        body["num"] = int(rng.choice([0, 1, 4, 1000]))
        fields = []
        for _ in range(int(rng.integers(0, 3))):
            name = str(rng.choice(names))
            fields.append({"name": name, "bias": float(rng.choice([-1.0, 0.5, 2.0, 1.0, 0.0])),
                           "values": [str(v) for v in rng.choice(
                               values[name], int(rng.integers(1, 3)))]})
        if fields:
            body["fields"] = fields
        if rng.random() < 0.3:
            dr = {"name": str(rng.choice(["releaseDate", "availableDate", "no-date"]))}
            if rng.random() < 0.7:
                dr["after"] = iso(T0 - float(rng.integers(0, 4000)) * DAY)
            if rng.random() < 0.7:
                dr["before"] = iso(T0 - float(rng.integers(-300, 3000)) * DAY)
            body["dateRange"] = dr
        if rng.random() < 0.3:
            body["currentDate"] = iso(T0 + float(rng.integers(-40, 40)) * DAY)
        if rng.random() < 0.3:
            body["blacklistItems"] = [str(x) for x in rng.choice(items, 4)]
        bodies.append(body)
    return bodies
