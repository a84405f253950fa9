"""The port's lead-scoring template and its gather logistic regression
against the JAX package.

``logreg_gather_train`` (Adam over embedding gathers, the sigmoid
cross-entropy) from the same categorical ids: weight tables and bias
within 1e-5 (absolute) of the JAX op.  The template from each package's
memory store of the same sessions (``view`` events carrying a sessionId
and first-view attributes, ``buy`` events converting them): the
sessionized training data identical, and every query's score within 1e-5
of the JAX answer, the unseen-attribute fallback to the base rate
included; a JAX-pickled model serves in the port.
"""

import pickle

import numpy as np
import pytest

from predictionio_tpu.controller.engine import EngineParams as JaxEngineParams
from predictionio_tpu.models.lead_scoring import engine as jax_ls
from predictionio_tpu.ops import logreg as jax_lr
from predictionio_tpu_torch.controller import EngineParams
from predictionio_tpu_torch.models.lead_scoring import engine as port_ls
from predictionio_tpu_torch.ops import logreg as lr
from predictionio_tpu_torch.storage import set_storage as port_set_storage
from predictionio_tpu_torch.workflow import persistence

from _torch_event_cases import T0, fill_both, port_memory_storage

ATOL = 1e-5
APP = "leadapp"
PAGES, REFS, BROWSERS = ["/", "/sale", "/blog", "/pricing"], ["google", "direct", "ads"], \
    ["Chrome", "Safari"]


@pytest.mark.parametrize("iterations", [1, 25, 200])
def test_gather_logreg_matches_jax(iterations):
    rng = np.random.default_rng(iterations)
    dims = [5, 3, 4]
    idx = np.stack([rng.integers(-1, d, 300) for d in dims]).astype(np.int32)
    y = (rng.random(300) < 0.3 + 0.1 * (idx[0] == 1)).astype(np.float32)
    got_w, got_b = lr.logreg_gather_train(idx, dims, y, l2=1e-3, iterations=iterations,
                                          device="cpu")
    want_w, want_b = jax_lr.logreg_gather_train(idx, dims, y, l2=1e-3, iterations=iterations)
    for g, w in zip(got_w, want_w, strict=True):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
    assert abs(got_b - want_b) <= ATOL


def _corpus(n_sessions=150, seed=10):
    rng = np.random.default_rng(seed)
    specs = []
    for s in range(n_sessions):
        page, ref = PAGES[s % 4], REFS[int(rng.integers(3))]
        t = T0 + 10 * s
        props = {"sessionId": f"s{s}", "landingPageId": page, "referrerId": ref,
                 "browser": BROWSERS[int(rng.integers(2))]}
        specs.append(("view", "user", f"u{s % 40}", "item", page, props, t, t))
        # a later view of the same session: the first view's attributes win
        specs.append(("view", "user", f"u{s % 40}", "item", "/x",
                      {**props, "landingPageId": "/late"}, t + 1, t + 1))
        if rng.random() < (0.6 if page == "/sale" else 0.15):
            specs.append(("buy", "user", f"u{s % 40}", "item", "p1",
                          {"sessionId": f"s{s}"}, t + 2, t + 2))
    specs.append(("view", "user", "u0", "item", "/", {"landingPageId": "/"}, T0, T0))
    return specs


QUERIES = [{"landingPageId": p, "referrerId": r, "browser": b}
           for p in PAGES for r in REFS for b in BROWSERS] + [
    {"landingPageId": "/unknown"}, {}, {"referrerId": "ads"}]


@pytest.fixture()
def stores(mem_storage):
    port_store = port_memory_storage()
    port_set_storage(port_store)
    fill_both(mem_storage, port_store, APP, _corpus())
    yield
    port_set_storage(None)


def _ep(mod, ep_cls):
    return ep_cls(data_source_params=mod.LSDataSourceParams(app_name=APP),
                  algorithm_params_list=[("logreg", mod.LSAlgorithmParams(iterations=120))])


def test_sessions_are_the_jax_sessions(stores):
    got = port_ls.LSDataSource(port_ls.LSDataSourceParams(app_name=APP)).read_training()
    want = jax_ls.LSDataSource(jax_ls.LSDataSourceParams(app_name=APP)).read_training()
    np.testing.assert_array_equal(got.attr_idx, want.attr_idx)
    np.testing.assert_array_equal(got.converted, want.converted)
    assert [d.to_state() for d in got.attr_dicts] == [d.to_state() for d in want.attr_dicts]
    assert got.attr_idx.shape == (3, 150) and "/late" not in got.attr_dicts[0].to_state()


def test_scores_are_the_jax_scores(stores):
    engine, ep = port_ls.LeadScoringEngine.apply(), _ep(port_ls, EngineParams)
    jax_engine, jax_ep = jax_ls.LeadScoringEngine.apply(), _ep(jax_ls, JaxEngineParams)
    models, jax_models = engine.train(ep, device="cpu"), jax_engine.train(jax_ep)
    predict = engine.predictor(ep, models)
    jax_predict = jax_engine.predictor(jax_ep, jax_models)
    scores = []
    for q in QUERIES:
        got = predict(port_ls.LSQuery.from_json(q)).score
        want = jax_predict(jax_ls.LSQuery.from_json(q)).score
        assert abs(got - want) <= ATOL, (q, got, want)
        scores.append(got)
    assert scores[-2] == models[0].base_rate
    assert max(scores) > 0.4 > min(scores)
    assert engine.batch_predictor(ep, models) is None   # host-only serving


def test_jax_pickled_model_serves(stores):
    jax_engine, jax_ep = jax_ls.LeadScoringEngine.apply(), _ep(jax_ls, JaxEngineParams)
    (jax_model,) = jax_engine.train(jax_ep)
    model = persistence.loads(pickle.dumps(jax_model))
    predict = port_ls.LeadScoringEngine.apply().predictor(_ep(port_ls, EngineParams), [model])
    jax_predict = jax_engine.predictor(jax_ep, [jax_model])
    for q in QUERIES:
        assert predict(port_ls.LSQuery.from_json(q)).to_json() == \
            jax_predict(jax_ls.LSQuery.from_json(q)).to_json()
