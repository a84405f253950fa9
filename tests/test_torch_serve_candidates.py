"""The port's candidate-pruned host tail: the cases of
tests/test_serve_candidates.py, each held against the port's dense host
tail (candidates off) exactly and against the JAX package's answer on the
same model (a fabricated JAX ``URModel`` carried to the port).

The pruned tail must equal the dense tail — the same items, the same f32
scores, the same tie order — on the shapes that break naive pruning:
duplicate score vectors, constant popularity, rules selecting outside the
candidate set, a boost with a backfill shortfall (falls back), a
rare-match rule past the scan budget (falls back), empty postings (falls
back when every type is blank), a blacklist over the popularity head and
every candidate, all masked and num 0.  Also the sliced rule mask against
the full one, the cached full mask gathered, the ``auto`` resolution on the
model's device, the inversion gauges and the threaded ``warm``.
"""

import threading

import numpy as np
import pytest

from predictionio_tpu.models.universal_recommender import engine as jax_ur
from predictionio_tpu_torch.models import universal_recommender as ur
from predictionio_tpu_torch.models.universal_recommender import engine as port_ur
from predictionio_tpu_torch.storage import set_storage as port_set_storage

from _torch_serve_cases import (Served, algos, canon, env, fresh_caches,  # noqa: F401
                                hist_for, jax_oracles, make_models, random_bodies)


def run_both(pair, models, query, hist):
    """(pruned, dense) port answers of one query under the host halves,
    each equal to the JAX answer."""
    jax_algo, algo = pair
    jax_model, model = models
    with env(PIO_UR_SERVE_SCORER="host", PIO_UR_SERVE_TAIL="host",
             PIO_UR_SERVE_CANDIDATES="on"):
        pruned = canon(algo.predict(model, ur.URQuery.from_json(query), hist_override=hist))
    with env(PIO_UR_SERVE_SCORER="host", PIO_UR_SERVE_TAIL="host",
             PIO_UR_SERVE_CANDIDATES="off"):
        dense = canon(algo.predict(model, ur.URQuery.from_json(query), hist_override=hist))
    with jax_oracles():
        want = canon(jax_algo.predict(jax_model, jax_ur.URQuery.from_json(query),
                                      hist_override=hist))
    assert pruned == want and dense == want, query
    return pruned, dense


def test_seeded_corpus_pruned_equals_dense_and_jax(mem_storage, fresh_caches):  # noqa: F811
    """A trained seeded corpus: every query of the random mix answers the
    same pruned, dense, batched and in JAX."""
    s = Served(mem_storage, 0)
    try:
        rng = np.random.default_rng(77)
        bodies = random_bodies(rng, s.users(), s.model.item_dict.strings(), 60)
        queries = [ur.URQuery.from_json(b) for b in bodies]
        pruned = [canon(s.algo.predict(s.model, q)) for q in queries]
        with env(PIO_UR_SERVE_CANDIDATES="off"):
            dense = [canon(s.algo.predict(s.model, q)) for q in queries]
        batched = [canon(r) for r in s.algo.serve_batch_predict(s.model, queries)]
        want = [canon(s.jax_answer(b)) for b in bodies]
        assert pruned == dense == batched == want
        assert sum(bool(w) for w in want) > 30
    finally:
        port_set_storage(None)


@pytest.mark.parametrize("num", [5, 40, 120])
def test_duplicate_score_ties_exact_order(num):
    """Counts scoring gives integer, duplicate-heavy scores: the pruned
    tail keeps the dense boundary ties deep into the list."""
    models = make_models(const_llr=True)
    pruned, _ = run_both(algos(), models, {"user": "u1", "num": num},
                         hist_for(range(0, 60)))
    assert len(pruned) == num


def test_duplicate_llr_weights_exact():
    models = make_models(const_llr=True)
    run_both(algos(use_llr_weights=True), models, {"user": "u1", "num": 30},
             hist_for(range(10, 50)))


def test_random_llr_weights_and_type_weights():
    models = make_models(seed=4)
    pair = algos(use_llr_weights=True, indicator_weights={"ev1": 0.5})
    run_both(pair, models, {"user": "u1", "num": 25}, hist_for(range(3, 40, 3)))


def test_constant_popularity_backfill_tie_order():
    """All-equal popularity: the backfill walk is pure tie order."""
    models = make_models(popularity=np.full(400, 0.5, np.float32))
    pruned, _ = run_both(algos(), models, {"user": "u1", "num": 50},
                         hist_for([3], types=("ev0",)))
    assert len(pruned) == 50


def test_rules_selecting_outside_candidate_set():
    """A hard filter disjoint from the candidates: every result comes
    from the backfill walk restricted to the rule's items."""
    models = make_models(n_items=300)
    pruned, _ = run_both(algos(), models, {
        "user": "u1", "num": 8,
        "fields": [{"name": "category", "values": ["c4"], "bias": -1}]},
        hist_for(range(0, 20)))
    assert pruned


def test_boost_with_backfill_shortfall_falls_back():
    models = make_models(n_items=300)
    before = port_ur._M_CAND.value(outcome="fallback_backfill_reorder")
    run_both(algos(), models, {
        "user": "u1", "num": 40,
        "fields": [{"name": "category", "values": ["c1"], "bias": 2.5}]},
        hist_for([1], types=("ev0",)))
    assert port_ur._M_CAND.value(outcome="fallback_backfill_reorder") > before


def test_rare_match_backfill_scan_budget_falls_back(monkeypatch):
    models = make_models(n_items=3000)
    monkeypatch.setattr(ur.URAlgorithm, "_BACKFILL_SCAN_BUDGET", 8)
    monkeypatch.setattr(jax_ur.URAlgorithm, "_BACKFILL_SCAN_BUDGET", 8)
    before = port_ur._M_CAND.value(outcome="fallback_backfill_scan")
    pruned, _ = run_both(algos(), models, {
        "user": "u1", "num": 40,
        "fields": [{"name": "category", "values": ["c1"], "bias": -1}]},
        hist_for([1], types=("ev0",)))
    assert pruned
    assert port_ur._M_CAND.value(outcome="fallback_backfill_scan") > before


def test_empty_postings_event_type():
    pair = algos()
    q = {"user": "u1", "num": 10}
    hist = hist_for(range(0, 30))
    pruned, _ = run_both(pair, make_models(blank_type="ev1"), q, hist)
    assert pruned
    jax_model, model = make_models(blank_type="ev1")
    for m in (jax_model, model):
        m.indicator_idx["ev0"] = np.full_like(m.indicator_idx["ev0"], -1)
    before = port_ur._M_CAND.value(outcome="fallback_no_candidates")
    run_both(pair, (jax_model, model), q, hist)
    assert port_ur._M_CAND.value(outcome="fallback_no_candidates") > before


def test_blacklist_covering_popularity_head_and_candidates():
    jax_model, model = make_models(n_items=300)
    _, algo = pair = algos()
    hist = hist_for([5], types=("ev0",))
    sparse = algo._score_history_host(model, hist)
    cand_items = [f"i{int(j)}" for j in sparse[0]]
    head = [f"i{int(j)}" for j in model.host_pop_order()[:80]]
    pruned, _ = run_both(pair, (jax_model, model), {
        "user": "u1", "num": 10, "blacklistItems": sorted(set(cand_items + head))}, hist)
    assert pruned


def test_all_masked_and_num0():
    models = make_models()
    hist = hist_for(range(0, 10))
    for q in ({"user": "u1", "num": 6,
               "fields": [{"name": "category", "values": ["nope"], "bias": -1}]},
              {"user": "u1", "num": 0}):
        assert run_both(algos(), models, q, hist) == ([], [])


def test_candidate_metrics_observed():
    _, model = make_models()
    _, algo = algos()
    hist = hist_for(range(0, 8))
    sparse = algo._score_history_host(model, hist)
    frac = len(sparse[0]) / len(model.item_dict)
    port_ur._M_CAND_FRAC.clear_series()
    before = port_ur._M_CAND.value(outcome="pruned")
    algo.predict(model, ur.URQuery(user="u1", num=5), hist_override=hist)
    assert port_ur._M_CAND.value(outcome="pruned") == before + 1
    snap = port_ur._M_CAND_FRAC._snapshot_series()
    assert snap and abs(next(iter(snap.values()))["sum"] - frac) < 1e-9


def test_sparse_scorer_matches_jax_native_and_oracle():
    """``_score_history_host``: the native serve core and the numpy oracle
    return the JAX scorer's candidates and f32 scores bit for bit."""
    jax_model, model = make_models(seed=9)
    for llr in (False, True):
        jax_algo, algo = algos(use_llr_weights=llr, indicator_weights={"ev0": 1.5})
        hist = hist_for(range(2, 90, 7))
        with jax_oracles():
            wc, ws = jax_algo._score_history_host(jax_model, hist)
        for native in ("on", "off"):
            with env(PIO_NATIVE=native):
                gc, gs = algo._score_history_host(model, hist)
            np.testing.assert_array_equal(gc, wc)
            assert gs.dtype == ws.dtype == np.float32
            np.testing.assert_array_equal(gs.view(np.int32), ws.view(np.int32))


def test_sliced_mask_equals_full_mask_gather(mem_storage, fresh_caches):  # noqa: F811
    """``_mask_from_key_host_sliced(ids)`` is ``_mask_from_key_host()[ids]``
    for every rule shape of the random mix, and the full host mask is the
    device mask and the JAX host mask bit for bit."""
    s = Served(mem_storage, 1)
    try:
        rng = np.random.default_rng(5)
        ids = np.unique(rng.integers(0, len(s.model.item_dict), 12)).astype(np.int32)
        n = 0
        for body in random_bodies(rng, s.users(), s.model.item_dict.strings(), 60):
            key = s.algo._mask_rule_key(ur.URQuery.from_json(body))
            if key is None:
                continue
            full = s.algo._mask_from_key(s.model, key, host=True)
            np.testing.assert_array_equal(
                full[ids], s.algo._mask_from_key_host_sliced(s.model, key, ids))
            dev = s.algo._mask_from_key(s.model, key).numpy()
            want = s.jax_algo._mask_from_key(s.jax_model, key, True)
            np.testing.assert_array_equal(full.view(np.int32), dev.view(np.int32))
            np.testing.assert_array_equal(full.view(np.int32), want.view(np.int32))
            n += 1
        assert n >= 20
    finally:
        port_set_storage(None)


def test_cached_full_mask_is_gathered(mem_storage, fresh_caches, monkeypatch):  # noqa: F811
    """Once a dense query composed and cached the full mask, the pruned
    path gathers from it instead of re-evaluating the rule."""
    s = Served(mem_storage, 2)
    try:
        body = {"user": s.users()[0], "num": 5,
                "fields": [{"name": "category", "values": ["c1"], "bias": -1}]}
        with env(PIO_UR_SERVE_CANDIDATES="off"):
            dense = canon(s.answer(body))
        assert len(s.model.rule_mask_cache("host")) == 1
        calls = []
        orig = s.algo._mask_from_key_host_sliced
        monkeypatch.setattr(s.algo, "_mask_from_key_host_sliced",
                            lambda *a, **kw: calls.append(1) or orig(*a, **kw))
        assert canon(s.answer(body)) == dense
        assert calls == [], "the cached full mask was not gathered"
    finally:
        port_set_storage(None)


def test_auto_resolves_on_the_models_device(monkeypatch):
    """``auto`` picks the host halves for a CPU model and the device halves
    for a CUDA one; the knobs force either; candidates only on host/host."""
    _, model = make_models(n_items=20)
    for k in ("PIO_UR_SERVE_SCORER", "PIO_UR_SERVE_TAIL", "PIO_UR_SERVE_CANDIDATES"):
        monkeypatch.delenv(k, raising=False)
    assert port_ur._serve_scorer(model) == port_ur._serve_tail(model) == "host"
    assert port_ur._serve_candidates(model) == "on"

    class OnCard:
        device = __import__("torch").device("cuda")

    assert port_ur._serve_scorer(OnCard) == port_ur._serve_tail(OnCard) == "device"
    assert port_ur._serve_candidates(OnCard) == "off"
    monkeypatch.setenv("PIO_UR_SERVE_CANDIDATES", "off")
    assert port_ur._serve_candidates(model) == "off"
    monkeypatch.setenv("PIO_UR_SERVE_CANDIDATES", "on")
    monkeypatch.setenv("PIO_UR_SERVE_TAIL", "device")
    assert port_ur._serve_candidates(model) == "off"
    monkeypatch.setenv("PIO_UR_SERVE_TAIL", "host")
    monkeypatch.setenv("PIO_UR_SERVE_SCORER", "device")
    assert port_ur._serve_candidates(model) == "off"
    monkeypatch.setenv("PIO_UR_SERVE_SCORER", "host")
    assert port_ur._serve_scorer(OnCard) == "host"


def test_warm_propagates_parallel_build_failure(monkeypatch):
    _, model = make_models()
    monkeypatch.setenv("PIO_UR_SERVE_SCORER", "host")
    monkeypatch.setenv("PIO_UR_SERVE_TAIL", "host")
    model.indicator_idx["ev1"] = None   # unbuildable second type
    with pytest.raises(AttributeError):
        model.warm()


def test_warm_builds_all_types_in_parallel(monkeypatch):
    """warm() under the host halves builds every type's inversion once
    (concurrent warms share them) and the popularity order, which is
    ``host_topk_desc``'s order of the JAX model's."""
    jax_model, model = make_models()
    for k in ("PIO_UR_SERVE_SCORER", "PIO_UR_SERVE_TAIL", "PIO_UR_SERVE_CANDIDATES"):
        monkeypatch.delenv(k, raising=False)
    results = []
    barrier = threading.Barrier(4)

    def warm():
        barrier.wait()
        model.warm()
        results.append({n: model.host_inverted(n)[0] for n in model.indicator_idx})

    threads = [threading.Thread(target=warm) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(results) == 4
    for name in model.indicator_idx:
        assert all(r[name] is results[0][name] for r in results), f"{name} built twice"
        assert port_ur._M_INV_BYTES.value(event=name) == sum(
            a.nbytes for a in model.host_inverted(name))
    assert "_dev_indicators" not in model.__dict__
    np.testing.assert_array_equal(model.host_pop_order(), jax_model.host_pop_order())


@pytest.mark.parametrize("scorer", ["device", "host"])
def test_warm_scores_one_history_with_the_device_scorer(monkeypatch, scorer):
    """Under the device scorer the algorithm's warm scores one history alone
    and as a micro-batch row, so the scorer's first launches (which load
    its kernels on the card) come before the first query (ROADMAP §C.11);
    under the host scorer it launches neither."""
    _, model = make_models()
    monkeypatch.setenv("PIO_UR_SERVE_SCORER", scorer)
    calls = []
    for fn in ("_indicator_score_ids", "_indicator_score_ids_batch"):
        real = getattr(port_ur, fn)
        monkeypatch.setattr(port_ur, fn,
                            lambda *a, _fn=fn, _real=real: calls.append(_fn) or _real(*a))
    algos()[1].warm(model)
    want = ["_indicator_score_ids", "_indicator_score_ids_batch"] if scorer == "device" else []
    assert calls == want
