"""The port's basket rules and complementary-purchase template against the
JAX package.

``basket_rules`` through the dense strategy and, with both packages'
``_BASKET_RULES_DENSE_MAX_ITEMS`` lowered, through the item-tiled one (the
JAX side with its ``PIO_CCO_TOPK`` default; the port through K3's carry
form, its plain version on the CPU): complement ids and lifts bit-equal,
ties included (corpora with many equal pair counts), confidences within
rtol 1e-6.  The template from each package's memory store: the
sessionized baskets identical, the rule tables as above, and every cart's
answer equal item for item with scores within rtol 1e-5, through
``predict`` and ``serve_batch_predict``; a JAX-pickled model serves in the
port.
"""

import pickle

import numpy as np
import pytest

from predictionio_tpu.controller.engine import EngineParams as JaxEngineParams
from predictionio_tpu.models.complementary_purchase import engine as jax_cp
from predictionio_tpu.ops import cco as jax_cco
from predictionio_tpu_torch.controller import EngineParams
from predictionio_tpu_torch.models.complementary_purchase import engine as port_cp
from predictionio_tpu_torch.ops import cco
from predictionio_tpu_torch.storage import set_storage as port_set_storage
from predictionio_tpu_torch.workflow import persistence

from _torch_event_cases import T0, fill_both, fill_jax, port_localfs_storage, port_memory_storage

LIFT_RTOL = 1e-6
SCORE_RTOL = 1e-5
APP = "cpapp"


def _baskets(seed, n_items, n_events, n_baskets, zipf=1.5):
    rng = np.random.default_rng(seed)
    b = np.sort(rng.integers(0, n_baskets, n_events)).astype(np.int32)
    i = (rng.zipf(zipf, n_events) % n_items).astype(np.int32)
    return b, i, int(b.max()) + 1


CASES = {"zipf": (1, 300, 5000, 2000, 1.5), "flat_ties": (2, 40, 600, 300, 1.01),
         "few_baskets": (3, 150, 400, 60, 1.2)}
CUTS = [(0.0, 0.0), (0.002, 0.1), (0.01, 0.5)]


def _same_rules(got, want):
    gl, gi, gc = got
    wl, wi, wc = want
    np.testing.assert_array_equal(gi, wi)
    assert gl.dtype == wl.dtype == np.float32
    np.testing.assert_array_equal(np.isfinite(gl), np.isfinite(wl))
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_allclose(gc, wc, rtol=LIFT_RTOL, atol=0)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("cuts", CUTS)
def test_dense_strategy(case, cuts):
    b, i, nb = _baskets(*CASES[case])
    n_items = CASES[case][1]
    got = cco.basket_rules(b, i, nb, n_items, top_k=12, min_support=cuts[0],
                           min_confidence=cuts[1], device="cpu")
    want = jax_cco.basket_rules(b, i, nb, n_items, top_k=12, min_support=cuts[0],
                                min_confidence=cuts[1])
    _same_rules(got, want)
    if cuts == (0.0, 0.0):
        assert (got[1] >= 0).sum() > 0


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("tile", [32, 100])
def test_tiled_strategy(case, tile, monkeypatch):
    monkeypatch.delenv("PIO_CCO_TOPK", raising=False)
    monkeypatch.setattr(cco, "_BASKET_RULES_DENSE_MAX_ITEMS", 16)
    monkeypatch.setattr(jax_cco, "_BASKET_RULES_DENSE_MAX_ITEMS", 16)
    b, i, nb = _baskets(*CASES[case])
    n_items = CASES[case][1]
    for k in (5, 20):
        got = cco.basket_rules(b, i, nb, n_items, top_k=k, item_tile=tile, device="cpu")
        want = jax_cco.basket_rules(b, i, nb, n_items, top_k=k, item_tile=tile)
        _same_rules(got, want)


def test_tiled_equals_dense_and_launches_a_tile_each(monkeypatch):
    from predictionio_tpu_torch.ops import hopper_kernels as hk

    b, i, nb = _baskets(*CASES["zipf"])
    dense = cco.basket_rules(b, i, nb, 300, top_k=10, device="cpu")
    monkeypatch.setattr(cco, "_BASKET_RULES_DENSE_MAX_ITEMS", 16)
    calls = []
    real = cco.tile_topk_desc

    def spy(scores, b_, id_offset=0, carry=None):
        calls.append((scores.shape, id_offset, carry is not None))
        return real(scores, b_, id_offset=id_offset, carry=carry)

    monkeypatch.setattr(cco, "tile_topk_desc", spy)
    tiled = cco.basket_rules(b, i, nb, 300, top_k=10, item_tile=64, device="cpu")
    for g, w in zip(tiled, dense):
        np.testing.assert_array_equal(g, w)
    assert [c[1:] for c in calls] == [(t0, True) for t0 in range(0, 300, 64)]
    assert hk.tile_topk_desc is real


def test_single_item_baskets_leave_counts_exact():
    # every basket a singleton but one: only that basket's pair forms rules
    b = np.array([0, 1, 2, 3, 3, 4, 4], np.int32)
    i = np.array([0, 1, 2, 1, 2, 3, 3], np.int32)
    lift, idx, conf = cco.basket_rules(b, i, 5, 4, top_k=3, device="cpu")
    want = jax_cco.basket_rules(b, i, 5, 4, top_k=3)
    _same_rules((lift, idx, conf), want)
    assert idx[1, 0] == 2 and idx[2, 0] == 1 and (idx[[0, 3]] == -1).all()


def test_basket_count_guard():
    with pytest.raises(ValueError, match="2\\^31"):
        cco.basket_rules(np.zeros(1, np.int32), np.zeros(1, np.int32), 1 << 31, 1,
                         device="cpu")


# -- the template ---------------------------------------------------------------------


def _corpus(n_users=30, n_items=25, n_events=600, seed=13):
    rng = np.random.default_rng(seed)
    specs = []
    t = np.sort(rng.integers(0, 40 * 3600, n_events)).astype(float)
    for k in range(n_events):
        u = int(rng.integers(n_users))
        specs.append(("buy", "user", f"u{u}", "item", f"i{int(rng.zipf(1.3)) % n_items}",
                      {}, T0 + t[k], T0 + t[k]))
    specs.append(("view", "user", "u0", "item", "i1", {}, T0, T0))
    return specs


@pytest.fixture()
def stores(mem_storage):
    port_store = port_memory_storage()
    port_set_storage(port_store)
    fill_both(mem_storage, port_store, APP, _corpus())
    yield
    port_set_storage(None)


def _ep(mod, ep_cls, **algo):
    return ep_cls(data_source_params=mod.CPDataSourceParams(app_name=APP,
                                                            basket_window="2 hours"),
                  algorithm_params_list=[("rules", mod.CPAlgorithmParams(**algo))])


CARTS = [{"items": ["i1"], "num": 3}, {"items": ["i0", "i2"], "num": 10},
         {"items": ["i5", "nope", "i7", "i1"]}, {"items": ["nope"]}, {"items": []},
         {"items": ["i3"], "num": 1}, {"items": [f"i{k}" for k in range(20)], "num": 50}]


def test_baskets_from_a_jax_written_localfs_store(fs_storage, tmp_path):
    """The JAX package writes the buys into its localfs store; the port
    sessionizes the same directory's events into the same baskets."""
    fill_jax(fs_storage, APP, _corpus())
    port_set_storage(port_localfs_storage(tmp_path / "store"))
    try:
        _assert_same_baskets()
    finally:
        port_set_storage(None)


def test_baskets_are_the_jax_baskets(stores):
    _assert_same_baskets()


def _assert_same_baskets():
    got = port_cp.CPDataSource(port_cp.CPDataSourceParams(app_name=APP)).read_training()
    want = jax_cp.CPDataSource(jax_cp.CPDataSourceParams(app_name=APP)).read_training()
    np.testing.assert_array_equal(got.basket_idx, want.basket_idx)
    np.testing.assert_array_equal(got.item_idx, want.item_idx)
    assert got.n_baskets == want.n_baskets and got.item_dict.to_state() == \
        want.item_dict.to_state()


@pytest.mark.parametrize("algo", [{}, {"min_support": 0.002, "min_confidence": 0.05,
                                       "max_rules_per_item": 5}])
def test_template_answers_as_the_jax_one(stores, algo):
    engine, ep = port_cp.ComplementaryPurchaseEngine.apply(), _ep(port_cp, EngineParams, **algo)
    jax_engine = jax_cp.ComplementaryPurchaseEngine.apply()
    jax_ep = _ep(jax_cp, JaxEngineParams, **algo)
    (model,), (jax_model,) = engine.train(ep, device="cpu"), jax_engine.train(jax_ep)
    np.testing.assert_array_equal(model.comp_idx, jax_model.comp_idx)
    f = np.isfinite(jax_model.comp_lift)
    np.testing.assert_allclose(model.comp_lift[f], jax_model.comp_lift[f], rtol=LIFT_RTOL)
    predict, predict_batch = engine.serving_bundle(ep, [model])
    jax_predict = jax_engine.predictor(jax_ep, [jax_model])
    queries = [port_cp.CPQuery.from_json(c) for c in CARTS]
    for q, b in zip(queries, predict_batch(queries)):
        want = jax_predict(jax_cp.CPQuery(q.items, q.num)).to_json()["itemScores"]
        for got in (predict(q).to_json()["itemScores"], b.to_json()["itemScores"]):
            assert [s["item"] for s in got] == [s["item"] for s in want]
            np.testing.assert_allclose([s["score"] for s in got], [s["score"] for s in want],
                                       rtol=SCORE_RTOL)
    assert predict(queries[0]).item_scores


def test_jax_pickled_model_serves(stores):
    jax_engine, jax_ep = jax_cp.ComplementaryPurchaseEngine.apply(), _ep(jax_cp, JaxEngineParams)
    (jax_model,) = jax_engine.train(jax_ep)
    model = persistence.loads(pickle.dumps(jax_model))
    model.to_device("cpu")
    predict = port_cp.ComplementaryPurchaseEngine.apply().predictor(
        _ep(port_cp, EngineParams), [model])
    jax_predict = jax_engine.predictor(jax_ep, [jax_model])
    for c in CARTS:
        got = predict(port_cp.CPQuery.from_json(c)).to_json()["itemScores"]
        want = jax_predict(jax_cp.CPQuery.from_json(c)).to_json()["itemScores"]
        assert [s["item"] for s in got] == [s["item"] for s in want]
        np.testing.assert_allclose([s["score"] for s in got], [s["score"] for s in want],
                                   rtol=SCORE_RTOL)
