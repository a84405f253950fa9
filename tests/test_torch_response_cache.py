"""The port's response cache (``serve/response_cache.py``) against the JAX
package's.

Unit level: ``make_key``'s canonical form equals the JAX key for the same
inputs; ``_intersects``; the LRU bound, refused puts from a superseded
generation and the kill switch; a swap without provenance flushes; swaps
racing lookups and puts stay consistent; and ``_swap_provenance`` and
``_affected_targets`` equal the JAX functions' on hand-built fold and plane
provenance, with the same entries dropped by a selective sweep.

Served: on a seeded corpus in the port's memory store (the model carried
from the JAX package), a hit is bit-identical to ``PIO_SERVE_CACHE=off``
and to the JAX answer; an audited round (``PIO_SERVE_CACHE_AUDIT_N=1``)
recomputes every hit with no mismatch; an append reroutes the user's key;
a retrain swap through the query server's install flushes everything; and
``serve_batch_predict`` shares the cache with ``predict``.
"""

import threading
import types
import weakref

import numpy as np
import pytest

from predictionio_tpu.serve import response_cache as jax_rc
from predictionio_tpu_torch.controller import EngineParams
from predictionio_tpu_torch.events.event import Event
from predictionio_tpu_torch.models import universal_recommender as ur
from predictionio_tpu_torch.serve import response_cache as rc
from predictionio_tpu_torch.storage import set_storage as port_set_storage
from predictionio_tpu_torch.workflow.create_server import deploy_models

from _torch_serve_cases import (APP, Served, canon, env, fresh_caches,  # noqa: F401
                                make_models, random_bodies)

KNOBS = ("PIO_SERVE_CACHE", "PIO_SERVE_CACHE_MAX", "PIO_SERVE_CACHE_TTL_S",
         "PIO_SERVE_CACHE_AUDIT_N")


@pytest.fixture(autouse=True)
def _defaults(monkeypatch, fresh_caches):  # noqa: F811
    for var in KNOBS:
        monkeypatch.delenv(var, raising=False)


def _fake_model():
    return types.SimpleNamespace(indicator_idx={}, item_dict=None, popularity=None)


def _entry_args(seed):
    hist = {"purchase": np.array([seed, seed + 10], np.int64)}
    return (((f"it{seed}", 1.0),), hist, [seed], False, False, False)


# -- unit ---------------------------------------------------------------------------


def test_make_key_canonical_form_matches_jax():
    h = {"purchase": np.array([3, 7, 9], np.int32), "view": np.zeros(0, np.int32)}
    rule = ((("category", ("c1",), -1.0),), None, 1780000000, "availableDate", "")
    cases = [(5, None, h, [4, 2, 2]), (5, None, h, [2, 4]),
             (5, None, {"purchase": np.array([3, 7, 9], np.int32)}, [2, 4]),
             (6, rule, h, []), (5, None, None, []), (5, None, {}, [])]
    for args in cases:
        assert rc.make_key(*args) == jax_rc.make_key(*args)
    k1 = rc.make_key(5, None, h, [4, 2, 2])
    assert k1 == rc.make_key(5, None, h, [2, 4])
    assert k1 == rc.make_key(5, None, {"purchase": np.array([3, 7, 9], np.int32)}, [2, 4])
    assert k1 != rc.make_key(6, None, h, [2, 4])
    assert k1 != rc.make_key(5, ("f",), h, [2, 4])
    assert k1 != rc.make_key(5, None, h, [2])
    assert k1 != rc.make_key(5, None, {"purchase": np.array([3, 7], np.int32)}, [2, 4])
    assert rc.make_key(5, None, None, []) == rc.make_key(5, None, {}, [])


def test_intersects_sorted_arrays():
    a = np.array([1, 5, 9], np.int64)
    for fn in (rc._intersects, jax_rc._intersects):
        assert fn(a, np.array([5], np.int64))
        assert fn(np.array([9], np.int64), a)
        assert not fn(a, np.array([2, 4, 10], np.int64))
        assert not fn(a, np.zeros(0, np.int64))
        assert not fn(np.zeros(0, np.int64), a)


def test_lru_bound_eviction_and_stale_put(monkeypatch):
    monkeypatch.setenv("PIO_SERVE_CACHE_MAX", "4")
    cache = rc.ResponseCache()
    model = _fake_model()
    cache.on_swap([model])
    for k in range(6):
        cache.put(model, ("k", k), *_entry_args(k))
    assert len(cache) == 4
    assert cache.lookup(model, ("k", 0))[0] is None
    assert cache.lookup(model, ("k", 1))[0] is None
    for k in range(2, 6):
        assert cache.lookup(model, ("k", k))[0] == ((f"it{k}", 1.0),)
    cache.put(_fake_model(), ("stale",), *_entry_args(99))   # superseded generation
    assert cache.lookup(model, ("stale",))[0] is None
    assert cache.lookup(_fake_model(), ("k", 5))[0] is None
    monkeypatch.setenv("PIO_SERVE_CACHE", "off")
    assert not cache.armed_for(model)
    cache.put(model, ("dark",), *_entry_args(7))
    monkeypatch.delenv("PIO_SERVE_CACHE")
    assert cache.lookup(model, ("dark",))[0] is None


def test_swap_without_provenance_flushes_unit():
    cache = rc.ResponseCache()
    m1, m2 = _fake_model(), _fake_model()
    cache.on_swap([m1])
    cache.put(m1, ("k",), *_entry_args(1))
    assert len(cache) == 1
    cache.on_swap([m2])
    assert len(cache) == 0
    assert cache.last_swap_reason == "no_provenance" and cache.last_swap_invalidated == 1
    cache.put(m2, ("k2",), *_entry_args(2))
    cache.on_swap([m2, m2])           # a multi-model install disarms
    assert len(cache) == 0 and not cache.armed_for(m2)


def test_thread_safety_under_concurrent_swaps(monkeypatch):
    monkeypatch.setenv("PIO_SERVE_CACHE_MAX", "64")
    cache = rc.ResponseCache()
    models = [_fake_model() for _ in range(3)]
    cache.on_swap([models[0]])
    errors = []
    barrier = threading.Barrier(8)

    def worker(tid):
        try:
            barrier.wait()
            for j in range(400):
                m = models[(tid + j) % 3]
                if j % 97 == 0:
                    cache.on_swap([m])
                elif j % 31 == 0:
                    cache.clear() if j % 62 else cache.on_swap([m])
                else:
                    key = ("t", tid, j % 40)
                    items, _ = cache.lookup(m, key)
                    if items is None:
                        cache.put(m, key, *_entry_args(j))
                len(cache)
        except Exception as e:   # pragma: no cover - the failure path
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(cache) <= 64


def _provenance_pair(kind):
    """(cur, new) fabricated model pairs of each package with hand-built
    provenance of ``kind`` ("fold": ``_plane_prov`` with a weakref to the
    cached generation; "plane": ``_serve_prov`` keyed by generation)."""
    out = []
    for jm_cur, pm_cur in [make_models(n_items=60, seed=1)]:
        jm_new, pm_new = make_models(n_items=60, seed=2)
        inv = {"ev0": np.array([3, 17, 40], np.int64), "ev1": np.array([], np.int64)}
        pop = np.array([5, 6], np.int64)
        for cur, new in ((jm_cur, jm_new), (pm_cur, pm_new)):
            if kind == "fold":
                new.__dict__["_plane_prov"] = {"prev": weakref.ref(cur),
                                               "serve": {"inv": inv, "pop": pop}}
            else:
                cur.__dict__["_plane_generation"] = 7
                new.__dict__["_serve_prov"] = {"prev_gen": 7, "inv": inv, "pop": pop,
                                               "props_changed": False}
            out.append((cur, new))
    return out


@pytest.mark.parametrize("kind", ["fold", "plane"])
def test_swap_provenance_and_affected_targets_match_jax(kind):
    (jcur, jnew), (pcur, pnew) = _provenance_pair(kind)
    jprov = jax_rc._swap_provenance(jnew, jcur)
    pprov = rc._swap_provenance(pnew, pcur)
    assert jprov is not None and pprov is not None
    assert pprov["props_changed"] == jprov["props_changed"]
    np.testing.assert_array_equal(pprov["pop"], jprov["pop"])
    for name in jprov["inv"]:
        np.testing.assert_array_equal(pprov["inv"][name], jprov["inv"][name])
    jaff = jax_rc._affected_targets(jprov, jnew, jcur)
    paff = rc._affected_targets(pprov, pnew, pcur)
    assert sorted(paff) == sorted(jaff)
    for name in jaff:
        np.testing.assert_array_equal(paff[name], jaff[name])
    # the same entries survive the same selective sweep in both packages
    rng = np.random.default_rng(3)
    entries = []
    for j in range(40):
        hist = {"ev0": np.unique(rng.integers(0, 60, 3)).astype(np.int64)}
        entries.append((("e", j), ((f"i{j}", 1.0),), hist,
                        rng.integers(0, 60, 2).tolist(), bool(j % 5 == 0), bool(j % 7 == 0),
                        False))
    kept = []
    for mod, cur, new in ((jax_rc, jcur, jnew), (rc, pcur, pnew)):
        cache = mod.ResponseCache()
        cache.on_swap([cur])
        for key, *args in entries:
            cache.put(cur, key, *args)
        cache.on_swap([new])
        assert cache.last_swap_reason == "selective"
        kept.append(sorted(k for k, *_ in entries if cache.lookup(new, k)[0] is not None))
    assert kept[0] == kept[1] and 0 < len(kept[1]) < len(entries)
    pnew.__dict__.pop("_plane_prov", None)
    pnew.__dict__.pop("_serve_prov", None)
    assert rc._swap_provenance(pnew, pcur) is None


# -- served -----------------------------------------------------------------------


@pytest.fixture()
def served(mem_storage):
    s = Served(mem_storage, 2)
    rc.get_cache().on_swap([s.model])     # what the query server's install does
    yield s
    port_set_storage(None)


def _bodies(s, n=24, seed=8):
    rng = np.random.default_rng(seed)
    return random_bodies(rng, s.users(), s.model.item_dict.strings(), n)


def test_hit_bit_identical_to_cache_off_and_jax(served, monkeypatch):
    s, cache = served, rc.get_cache()
    bodies = _bodies(s)
    first = [canon(s.answer(b)) for b in bodies]
    assert cache.miss_count + cache.hit_count == len(bodies) and cache.miss_count > 20
    hits = cache.hit_count
    again = [canon(s.answer(b)) for b in bodies]
    assert again == first and cache.hit_count == hits + len(bodies)
    with env(PIO_SERVE_CACHE="off"):
        assert [canon(s.answer(b)) for b in bodies] == first
    assert [canon(s.jax_answer(b)) for b in bodies] == first
    # an audited round recomputes every hit: no mismatch
    monkeypatch.setenv("PIO_SERVE_CACHE_AUDIT_N", "1")
    before = rc._M_AUDIT.value()
    assert [canon(s.answer(b)) for b in bodies] == first
    assert rc._M_AUDIT.value() == before
    # blacklist duplicates and order share one entry
    user = s.users()[0]
    s.answer({"user": user, "num": 4, "blacklistItems": ["i1", "i1", "i2"]})
    hits = cache.hit_count
    s.answer({"user": user, "num": 4, "blacklistItems": ["i2", "i1"]})
    assert cache.hit_count == hits + 1


def test_user_drift_reroutes_key_without_invalidation(served):
    """An append changes the user's history, so the same query text
    misses under a new key with no swap, and answers as the oracle."""
    s, cache = served, rc.get_cache()
    user = s.users()[3]
    body = {"user": user, "num": 5}
    s.answer(body)
    assert cache.miss_count == 1
    app_id = s.port_store.apps.get_by_name(APP).id
    s.port_store.l_events.insert(
        Event("purchase", "user", user, target_entity_type="item",
              target_entity_id="i7"), app_id)
    got = canon(s.answer(body))
    assert cache.miss_count == 2 and len(cache) == 2
    with env(PIO_SERVE_CACHE="off", PIO_HISTORY_CACHE="off"):
        assert got == canon(s.answer(body))


def test_retrain_swap_through_install_flushes(served):
    """The query server's install re-arms the cache on the new model: a
    swap without provenance (a reload) drops every entry, and the next
    answers fill it again, equal to the oracle."""
    s, cache = served, rc.get_cache()
    engine = ur.UniversalRecommenderEngine.apply()
    ep = EngineParams(algorithm_params_list=[("ur", ur.URAlgorithmParams(**s.algo_params))])
    server = deploy_models(engine, ep, [s.model], port=0, query_class=ur.URQuery)
    try:
        state = server.pio_state
        bodies = _bodies(s, 8, seed=9)
        for b in bodies:
            state.predict(b)
        assert len(cache) > 0
        reloaded = ur.ur_model_from_state(s.model.__getstate__(), device="cpu")
        assert state._install([reloaded])
        assert len(cache) == 0 and cache.last_swap_reason == "no_provenance"
        assert cache.armed_for(reloaded) and not cache.armed_for(s.model)
        got = [canon(state.predict(b)) for b in bodies]
        assert len(cache) > 0
        with env(PIO_SERVE_CACHE="off"):
            assert got == [canon(state.predict(b)) for b in bodies]
    finally:
        server.shutdown()
        server.server_close()


def test_serve_batch_predict_shares_the_cache(served):
    s, cache = served, rc.get_cache()
    users = s.users()
    queries = [ur.URQuery(user=users[1], num=3), ur.URQuery(user=users[2], num=3),
               ur.URQuery(user="nobody", num=2)]
    single = canon(s.algo.predict(s.model, queries[0]))
    assert cache.miss_count == 1
    batch = s.algo.serve_batch_predict(s.model, queries)
    assert cache.hit_count == 1 and cache.miss_count == 3
    assert canon(batch[0]) == single
    for q, res in zip(queries, batch):
        assert canon(s.algo.predict(s.model, q)) == canon(res)
    again = s.algo.serve_batch_predict(s.model, queries)
    assert cache.miss_count == 3
    assert [canon(r) for r in again] == [canon(r) for r in batch]
    with env(PIO_SERVE_CACHE="off"):
        assert [canon(r) for r in s.algo.serve_batch_predict(s.model, queries)] \
            == [canon(r) for r in batch]
