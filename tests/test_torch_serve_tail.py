"""The port's UR host scorer and host tail against the JAX package's, and
against the port's own device tail.

Seeded corpora (tests/_torch_event_cases.py:seeded_corpus: two event
types, categories, multi-valued tags, release/available/expire dates) go
into each package's memory store; the JAX package trains and the model is
carried to the port, so the two serve one model from the same events.  On
the CPU both packages' ``auto`` picks the host scorer and the
candidate-pruned host tail: the port's ``/queries.json`` bytes must equal
``json.dumps`` of the JAX answer (which serves through its numpy oracles),
over users with history and cold ones, items, item sets, rule sets, date
rules, blacklists and num 0, 1, 4 and 1,000.  Pinned to the device halves
(CPU tensors), the port's answers hold the same items with the same
scores (counts exact; LLR weights within rtol 1e-5, the f32 sums' order).
Also here: ``host_topk_desc`` against ``lax.top_k`` with planted ties and
±0.0, the composed rule-mask cache and the one-build postings inversion.
"""

import json
import pickle
import threading
import urllib.request

import jax
import numpy as np
import pytest

from predictionio_tpu.models import common as jax_common
from predictionio_tpu_torch.controller import EngineParams
from predictionio_tpu_torch.models import common as port_common
from predictionio_tpu_torch.models import universal_recommender as ur
from predictionio_tpu_torch.models.universal_recommender import engine as port_ur
from predictionio_tpu_torch.native import core as port_native
from predictionio_tpu_torch.ops.topk import topk_desc
from predictionio_tpu_torch.storage import set_storage as port_set_storage
from predictionio_tpu_torch.workflow.create_server import deploy_models

from _torch_serve_cases import (Served, canon, dumps, env, fresh_caches,  # noqa: F401
                                random_bodies)
from _torch_ur_cases import assert_same_answer

SEEDS = range(4)


@pytest.fixture()
def served(mem_storage, fresh_caches, request):  # noqa: F811
    yield Served(mem_storage, request.param, use_llr_weights=request.param % 2 == 1)
    port_set_storage(None)


def _bodies(s, seed, n=48):
    rng = np.random.default_rng(1000 + seed)
    return random_bodies(rng, s.users(), s.model.item_dict.strings(), n)


@pytest.mark.parametrize("served", SEEDS, indirect=True)
def test_host_tail_json_matches_jax(served):
    """``auto`` on a CPU model: the pruned host tail, then the dense host
    tail (candidates off), each byte-equal to the JAX answer."""
    s = served
    assert port_ur._serve_tail(s.model) == "host"
    assert port_ur._serve_candidates(s.model) == "on"
    n_rules = 0
    for body in _bodies(s, s.algo_params["use_llr_weights"]):
        want = dumps(s.jax_answer(body))
        assert dumps(s.answer(body)) == want, body
        with env(PIO_UR_SERVE_CANDIDATES="off"):
            assert dumps(s.answer(body)) == want, body
        n_rules += "fields" in body or "dateRange" in body
    assert n_rules >= 10


@pytest.mark.parametrize("served", SEEDS, indirect=True)
def test_device_tail_matches_host_tail(served):
    """Pinned to the device scorer and tail on CPU tensors: the host
    tail's items; scores exact with counts, within rtol 1e-5 with LLR
    weights (the f32 sums run in another order)."""
    s = served
    llr = s.algo_params["use_llr_weights"]
    for body in _bodies(s, 10 + s.algo_params["use_llr_weights"], 36):
        host = s.answer(body)
        with env(PIO_UR_SERVE_SCORER="device", PIO_UR_SERVE_TAIL="device"):
            dev = s.answer(body)
        if llr:
            assert_same_answer(dev.to_json(), host.to_json())
        else:
            assert canon(dev) == canon(host), body


@pytest.mark.parametrize("tail", ["host", "device"])
@pytest.mark.parametrize("scorer", ["host", "device"])
def test_serve_batch_matches_serial_all_paths(mem_storage, fresh_caches, scorer, tail):  # noqa: F811
    """Within each scorer x tail cell the micro-batch path answers as
    serial ``predict`` does, exactly."""
    s = Served(mem_storage, 2)
    try:
        queries = [ur.URQuery.from_json(b) for b in _bodies(s, 20, 24)]
        with env(PIO_UR_SERVE_SCORER=scorer, PIO_UR_SERVE_TAIL=tail):
            serial = [canon(s.algo.predict(s.model, q)) for q in queries]
            batched = [canon(r) for r in s.algo.serve_batch_predict(s.model, queries)]
        assert serial == batched
        assert any(serial)
    finally:
        port_set_storage(None)


def test_http_bytes_equal_jax(mem_storage, fresh_caches):  # noqa: F811
    """The port's query server writes the JAX answer's ``json.dumps``
    bytes, response cache on (repeats served from it)."""
    s = Served(mem_storage, 3)
    engine = ur.UniversalRecommenderEngine.apply()
    ep = EngineParams(algorithm_params_list=[("ur", ur.URAlgorithmParams(**s.algo_params))])
    server = deploy_models(engine, ep, [s.model], port=0, query_class=ur.URQuery)
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/queries.json"
        bodies = _bodies(s, 30, 20)
        for body in bodies + bodies:
            req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                got = resp.read()
            assert got == dumps(s.jax_answer(body)), body
    finally:
        server.shutdown()
        server.server_close()
        port_set_storage(None)


def test_host_topk_desc_matches_lax_top_k():
    """``host_topk_desc`` (the native core and its numpy oracle) in
    ``lax.top_k``'s order — descending values, lower index first on ties,
    -0.0 < +0.0 — as ``ops.topk.topk_desc`` and the JAX host_topk_desc."""
    import torch

    rng = np.random.default_rng(3)
    sparse = np.zeros(20_000, np.float32)
    sparse[rng.integers(0, 20_000, 500)] = rng.random(500).astype(np.float32)
    ties = np.round(rng.random(5_000).astype(np.float32) * 4) / 2
    ties[rng.integers(0, 5_000, 800)] = -np.inf
    zeros = np.where(rng.random(2_000) < 0.5, 0.0, -0.0).astype(np.float32)
    cases = [
        (np.array([0.0, -0.0, 1.0, -0.0, 0.0, 0.5], np.float32), 6),
        (rng.normal(size=3_000).astype(np.float32), 77),
        (sparse, 64), (ties, 128), (zeros, 1_000),
        (np.full(300, -np.inf, np.float32), 32),
        (rng.normal(size=10).astype(np.float32), 10),   # k == n
        (rng.normal(size=5).astype(np.float32), 9),     # k > n
    ]
    for arr, k in cases:
        sv, si = jax.lax.top_k(arr, min(k, len(arr)))
        tv, ti = topk_desc(torch.from_numpy(arr), min(k, len(arr)))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(si))
        jv, ji = jax_common.host_topk_desc(arr, k)
        for native in ("on", "off"):
            with env(PIO_NATIVE=native):
                hv, hi = port_common.host_topk_desc(arr, k)
            np.testing.assert_array_equal(hi, np.asarray(si))
            np.testing.assert_array_equal(hv.view(np.int32), np.asarray(sv).view(np.int32))
            np.testing.assert_array_equal(hi, ji)
    assert port_native.calls["serve"] > 0
    hv, hi = port_common.host_topk_desc(np.ones(4, np.float32), 0)
    assert len(hv) == 0 and len(hi) == 0


@pytest.fixture()
def rules_model(mem_storage, fresh_caches, monkeypatch):  # noqa: F811
    """The dense host tail (the rule-mask cache's filler): the pruned tail
    only probes the cache."""
    s = Served(mem_storage, 1)
    monkeypatch.setenv("PIO_UR_SERVE_CANDIDATES", "off")
    yield s
    port_set_storage(None)


def test_rule_mask_cache_hits_and_canonicalization(rules_model):
    """Repeated rules hit the composed-mask cache, rule ORDER does not
    fragment it (the canonical key equals the JAX key), and a query
    without rules never touches it."""
    s = rules_model
    user = s.users()[0]
    f1 = {"name": "category", "values": ["c1"], "bias": -1}
    f2 = {"name": "tags", "values": ["t2"], "bias": 2.0}
    qa = {"user": user, "num": 5, "fields": [f1, f2]}
    qb = {"user": s.users()[1], "num": 5, "fields": [f2, f1]}
    key = s.algo._mask_rule_key(ur.URQuery.from_json(qa))
    from predictionio_tpu.models.universal_recommender import engine as jax_ur
    assert key == s.jax_algo._mask_rule_key(jax_ur.URQuery.from_json(qb))
    s.answer(qa)
    cache = s.model.rule_mask_cache("host")
    assert len(cache) == 1 and cache.misses == 1
    s.answer(qb)
    assert len(cache) == 1 and cache.hits >= 1
    s.answer({"user": user, "num": 5})
    assert cache.hits + cache.misses == 2
    np.testing.assert_array_equal(
        cache.peek(key).view(np.int32),
        s.algo._mask_from_key(s.model, key, host=False).numpy().view(np.int32))


def test_rule_mask_cache_per_generation_and_bounded(rules_model, monkeypatch):
    """A reload loads a NEW model object whose rule-mask cache starts
    empty (nothing survives pickling); ``PIO_UR_RULE_MASK_CACHE`` bounds
    the entries, evicting the least recent."""
    s = rules_model
    q = {"user": s.users()[0], "num": 5, "fields": [
        {"name": "category", "values": ["c0"], "bias": -1}]}
    s.answer(q)
    assert len(s.model.rule_mask_cache("host")) == 1
    swapped = pickle.loads(pickle.dumps(s.model))
    assert "_rule_mask_host" not in swapped.__dict__
    swapped.to_device("cpu")
    s.answer(q, model=swapped)
    fresh = swapped.rule_mask_cache("host")
    assert fresh.misses == 1 and fresh.hits == 0
    monkeypatch.setenv("PIO_UR_RULE_MASK_CACHE", "2")
    bounded = pickle.loads(pickle.dumps(s.model)).to_device("cpu")
    for bias in (2.0, 3.0, 4.0):
        s.answer({**q, "fields": [{"name": "category", "values": ["c0"], "bias": bias}]},
                 model=bounded)
    cache = bounded.rule_mask_cache("host")
    assert len(cache) == 2 and cache.evictions == 1
    # the device tail's cache is its own, staged with the model's tensors
    with env(PIO_UR_SERVE_SCORER="device", PIO_UR_SERVE_TAIL="device"):
        s.answer(q, model=bounded)
    assert len(bounded.rule_mask_cache("device")) == 1
    assert "_rule_mask_device" in bounded.__dict__["_staged"]


def test_lru_cache_peek_count_and_threads():
    """``get(count=False)`` and ``peek`` touch the order without counting;
    ``clear`` empties; concurrent readers and writers keep the bound."""
    events = []
    c = port_common.LRUCache(2, on_event=events.append)
    c.put("a", 1)
    c.put("b", 2)
    assert c.peek("a") == 1 and c.get("zz", count=False) is None
    assert c.hits == 0 and c.misses == 0 and events == []
    c.put("c", 3)                    # evicts b: the peek touched a
    assert c.get("a") == 1 and c.get("b") is None and events == ["evict", "hit", "miss"]
    c.clear()
    assert len(c) == 0
    big = port_common.LRUCache(8)
    errors = []

    def hammer(seed):
        try:
            rng = np.random.default_rng(seed)
            for _ in range(2_000):
                k = int(rng.integers(0, 32))
                if big.get(k) is None:
                    big.put(k, k)
        except Exception as e:   # pragma: no cover - the assertion target
            errors.append(e)

    threads = [threading.Thread(target=hammer, args=(s,)) for s in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(big) <= 8


def test_host_inverted_builds_once_under_race(rules_model):
    """Concurrent first queries share ONE postings-index build (the same
    arrays for every thread, equal to the JAX inversion), and the build
    gauges are set."""
    s = rules_model
    name = next(iter(s.model.indicator_idx))
    got = []
    barrier = threading.Barrier(8)

    def build():
        barrier.wait()
        got.append(s.model.host_inverted(name))

    threads = [threading.Thread(target=build) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(got) == 8 and all(g[0] is got[0][0] for g in got), "race built twice"
    for a, b in zip(got[0], s.jax_model.host_inverted(name)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert port_ur._M_INV_BUILD.value(event=name) > 0.0
    assert port_ur._M_INV_BYTES.value(event=name) == sum(a.nbytes for a in got[0])


def test_malformed_date_rejected_and_stage_metrics(rules_model):
    """A malformed query date is a ValueError (HTTP 400) before any cache
    work; a served query lands its stage laps in the stage histogram."""
    s = rules_model
    with pytest.raises(ValueError, match="ISO-8601"):
        s.answer({"user": s.users()[0], "currentDate": "01/03/2026"})
    before = port_ur._M_STAGE._snapshot_series()
    s.answer({"user": s.users()[0], "num": 3})
    after = port_ur._M_STAGE._snapshot_series()
    assert after != before


def test_adopt_rule_caches_carries_or_counts_the_drop():
    """A swap that proves the item dictionary and properties unchanged
    carries the rule caches BY OBJECT to the new generation (device ones
    only between models on one device); otherwise the old entries are
    counted as dropped and the new generation starts empty."""
    from _torch_serve_cases import algos, make_models

    _, old = make_models(n_items=60)
    _, algo = algos()
    key = algo._mask_rule_key(ur.URQuery.from_json(
        {"user": "u1", "fields": [{"name": "category", "values": ["c1"], "bias": 2.0}]}))
    for host in (True, False):
        old.rule_mask_cache("host" if host else "device").put(
            key, algo._mask_from_key(old, key, host=host))
    carried = port_ur._M_MASK_CACHE.value(outcome="carried")
    dropped = port_ur._M_MASK_CACHE.value(outcome="dropped")
    new = ur.ur_model_from_state(old.__getstate__(), device="cpu")
    new.adopt_rule_caches(old, carry=True)
    assert new.rule_mask_cache("host") is old.rule_mask_cache("host")
    assert new.rule_mask_cache("device") is old.rule_mask_cache("device")
    assert "_rule_mask_device" in new.__dict__["_staged"]
    assert port_ur._M_MASK_CACHE.value(outcome="carried") == carried + 2
    fresh = ur.ur_model_from_state(old.__getstate__(), device="cpu")
    fresh.adopt_rule_caches(old, carry=False)
    assert len(fresh.rule_mask_cache("host")) == 0
    assert port_ur._M_MASK_CACHE.value(outcome="dropped") == dropped + 2


def test_pad_batch_rows_matches_jax():
    x = np.arange(15, dtype=np.int32).reshape(5, 3)
    for rows in (x[:1], x[:4], x):
        got = port_common.pad_batch_rows(rows)
        np.testing.assert_array_equal(got, jax_common.pad_batch_rows(rows))
    assert port_common.pad_batch_rows(x[:4]) is not None and len(port_common.pad_batch_rows(x)) == 8
