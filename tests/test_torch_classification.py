"""The port's logistic regression, naive Bayes and classification template
against the JAX package.

- Adam (``optax.adam``): the loss before each of 20 steps and the weights
  after 1, 5 and 20 steps within 1e-5 (absolute) of the JAX run from the
  same zeros.
- L-BFGS (``optax.lbfgs()`` with its zoom line search): the weights after
  each of the first 5 iterations within 1e-5; at 100 iterations the
  predicted labels equal and the final loss within 1e-4 relative.
- Gaussian and multinomial naive Bayes: fitted tables within 1e-5
  (relative 1e-5 on the log terms), predictions equal.
- The template: ``read_training`` of ``$set`` attributes and ``read_eval``'s
  folds identical; both algorithms (logistic regression by either
  optimizer, naive Bayes of either kind) trained by each package from its
  own memory store answer every query alike, through ``predict`` and the
  serving batch; a JAX-pickled model serves in the port.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.controller.engine import EngineParams as JaxEngineParams
from predictionio_tpu.models.classification import engine as jax_cls
from predictionio_tpu.ops import logreg as jax_lr
from predictionio_tpu.ops import naive_bayes as jax_nb
from predictionio_tpu_torch.controller import EngineParams
from predictionio_tpu_torch.models.classification import engine as port_cls
from predictionio_tpu_torch.ops import logreg as lr
from predictionio_tpu_torch.ops import naive_bayes as nb
from predictionio_tpu_torch.storage import set_storage as port_set_storage
from predictionio_tpu_torch.workflow import persistence

from _torch_event_cases import T0, fill_both, fill_jax, port_localfs_storage, port_memory_storage

ATOL = 1e-5
LOSS_RTOL = 1e-4
APP = "clsapp"


def _data(seed, n=300, d=5, c=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d, c)).astype(np.float32)
    y = np.argmax(x @ w + 0.5 * rng.normal(size=(n, c)), 1).astype(np.int32)
    return x, y, c


def _runs(x, y, c, optimizer, iterations, l2=1e-3):
    n, d = x.shape
    mask = np.ones(n, np.float32)
    (jw, jb), jl = jax_lr._logreg_run(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask), jnp.zeros((d, c)), jnp.zeros(c),
        jnp.float32(l2), optimizer=optimizer, learning_rate=0.1, iterations=iterations)
    (tw, tb), tl = lr._logreg_run(
        torch.tensor(x), torch.tensor(y, dtype=torch.int64), torch.tensor(mask),
        torch.zeros(d, c), torch.zeros(c), np.float32(l2), optimizer=optimizer,
        learning_rate=0.1, iterations=iterations)
    return (np.asarray(jw), np.asarray(jb), np.asarray(jl)), (tw.numpy(), tb.numpy(), tl.numpy())


@pytest.mark.parametrize("steps", [1, 5, 20])
@pytest.mark.parametrize("seed", [0, 1])
def test_adam_follows_optax_step_by_step(seed, steps):
    x, y, c = _data(seed)
    (jw, jb, jl), (tw, tb, tl) = _runs(x, y, c, "adam", steps)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=ATOL)
    np.testing.assert_allclose(tw, jw, rtol=0, atol=ATOL)
    np.testing.assert_allclose(tb, jb, rtol=0, atol=ATOL)


@pytest.mark.parametrize("iterations", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("seed", [0, 2])
def test_lbfgs_follows_optax_for_five_iterations(seed, iterations):
    x, y, c = _data(seed)
    (jw, jb, jl), (tw, tb, tl) = _runs(x, y, c, "lbfgs", iterations)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=ATOL)
    np.testing.assert_allclose(tw, jw, rtol=0, atol=ATOL)
    np.testing.assert_allclose(tb, jb, rtol=0, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 3])
def test_lbfgs_after_100_iterations(seed):
    x, y, c = _data(seed, n=500, d=8, c=4)
    (jw, jb, jl), (tw, tb, tl) = _runs(x, y, c, "lbfgs", 100)
    np.testing.assert_array_equal(np.argmax(x @ tw + tb, 1), np.argmax(x @ jw + jb, 1))
    assert abs(tl[-1] - jl[-1]) <= LOSS_RTOL * abs(jl[-1])


def test_logreg_train_matches_and_refuses_a_mesh():
    x, y, c = _data(4)
    jw, jb = jax_lr.logreg_train(x, y, c, l2=1e-3, iterations=30)
    tw, tb = lr.logreg_train(x, y, c, l2=1e-3, iterations=30, device="cpu")
    np.testing.assert_allclose(tw, jw, rtol=0, atol=ATOL)
    np.testing.assert_allclose(tb, jb, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(
        lr.logreg_predict(torch.tensor(tw), torch.tensor(tb), torch.tensor(x)),
        jax_lr.logreg_predict(jw, jb, x))
    with pytest.raises(NotImplementedError, match="parallel"):
        lr.logreg_train(x, y, c, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="optimizer"):
        lr.logreg_train(x, y, c, optimizer="sgd", device="cpu")


def test_gaussian_naive_bayes():
    x, y, c = _data(5)
    got = nb.gaussian_nb_train(x, y, c, device="cpu")
    want = jax_nb.gaussian_nb_train(x, y, c)
    for f in ("class_log_prior", "mean", "var"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=ATOL, atol=ATOL)
    q = np.random.default_rng(6).normal(size=(64, x.shape[1])).astype(np.float32)
    np.testing.assert_array_equal(nb.gaussian_nb_predict(got, q, device="cpu"),
                                  jax_nb.gaussian_nb_predict(want, q))


def test_multinomial_naive_bayes():
    rng = np.random.default_rng(7)
    x = rng.poisson(1.5, size=(200, 12)).astype(np.float32)
    y = (x[:, :4].sum(1) > x[:, 4:8].sum(1)).astype(np.int32)
    got = nb.multinomial_nb_train(x, y, 2, alpha=0.5, device="cpu")
    want = jax_nb.multinomial_nb_train(x, y, 2, alpha=0.5)
    for f in ("class_log_prior", "feature_log_prob"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=ATOL, atol=ATOL)
    q = rng.poisson(1.5, size=(64, 12)).astype(np.float32)
    np.testing.assert_array_equal(nb.multinomial_nb_predict(got, q, device="cpu"),
                                  jax_nb.multinomial_nb_predict(want, q))


# -- the template ---------------------------------------------------------------------


def _corpus(n_users=120, seed=8):
    rng = np.random.default_rng(seed)
    specs = []
    for u in range(n_users):
        a = rng.integers(0, 4, 3).astype(float)
        label = "yes" if a[0] + 0.5 * a[1] - a[2] + rng.normal(0, 0.7) > 1.0 else "no"
        t = T0 + u
        specs.append(("$set", "user", f"u{u}", None, None,
                      {"attr0": a[0], "attr1": a[1], "attr2": a[2]}, t, t))
        specs.append(("$set", "user", f"u{u}", None, None, {"label": label}, t + 1, t + 1))
    specs.append(("$set", "user", "nolabel", None, None, {"attr0": 1.0}, T0, T0))
    return specs


QUERIES = [{"attr0": float(a), "attr1": float(b), "attr2": float(c)}
           for a in range(4) for b in range(0, 4, 2) for c in range(4)] + [{"attr0": 3.0}]

ALGOS = [("logreg", {"optimizer": "lbfgs", "iterations": 60, "l2": 0.01}),
         ("logreg", {"optimizer": "adam", "iterations": 60, "l2": 0.01,
                     "learning_rate": 0.1}),
         ("naivebayes", {"model_type": "gaussian"}),
         ("naivebayes", {"model_type": "multinomial", "alpha": 1.0})]


@pytest.fixture()
def stores(mem_storage):
    port_store = port_memory_storage()
    port_set_storage(port_store)
    fill_both(mem_storage, port_store, APP, _corpus())
    yield mem_storage, port_store
    port_set_storage(None)


def _engine_params(mod, ep_cls, name, params, **ds):
    algo_cls = {"logreg": mod.LogRegParams, "naivebayes": mod.NaiveBayesParams}[name]
    extra = {"mesh_dp": 1} if name == "logreg" else {}
    return ep_cls(data_source_params=mod.ClassificationDSParams(app_name=APP, **ds),
                  algorithm_params_list=[(name, algo_cls(**params, **extra))])


def test_read_training_from_a_jax_written_localfs_store(fs_storage, tmp_path):
    """The JAX package writes the ``$set`` events into its localfs store;
    the port's training read of the same directory (its native fold)
    equals the JAX one."""
    fill_jax(fs_storage, APP, _corpus())
    port_set_storage(port_localfs_storage(tmp_path / "store"))
    try:
        got = port_cls.ClassificationDataSource(
            port_cls.ClassificationDSParams(app_name=APP)).read_training()
        want = jax_cls.ClassificationDataSource(
            jax_cls.ClassificationDSParams(app_name=APP)).read_training()
        np.testing.assert_array_equal(got.x, want.x)
        np.testing.assert_array_equal(got.y, want.y)
        assert got.labels == want.labels and len(got.y) == 120
    finally:
        port_set_storage(None)


def test_read_training_and_folds(stores):
    got = port_cls.ClassificationDataSource(port_cls.ClassificationDSParams(app_name=APP))
    want = jax_cls.ClassificationDataSource(jax_cls.ClassificationDSParams(app_name=APP))
    g, w = got.read_training(), want.read_training()
    np.testing.assert_array_equal(g.x, w.x)
    np.testing.assert_array_equal(g.y, w.y)
    assert g.labels == w.labels and len(g.y) == 120
    gf = port_cls.ClassificationDataSource(
        port_cls.ClassificationDSParams(app_name=APP, eval_k=4)).read_eval()
    wf = jax_cls.ClassificationDataSource(
        jax_cls.ClassificationDSParams(app_name=APP, eval_k=4)).read_eval()
    assert len(gf) == len(wf) == 4
    for (gtd, gi, gqa), (wtd, wi, wqa) in zip(gf, wf):
        assert gi == wi
        np.testing.assert_array_equal(gtd.x, wtd.x)
        assert [(q.features, a) for q, a in gqa] == [(q.features, a) for q, a in wqa]


@pytest.mark.parametrize("name, params", ALGOS)
def test_template_answers_as_the_jax_one(stores, name, params):
    engine = port_cls.ClassificationEngine.apply()
    ep = _engine_params(port_cls, EngineParams, name, params)
    jax_engine = jax_cls.ClassificationEngine.apply()
    jax_ep = _engine_params(jax_cls, JaxEngineParams, name, params)
    models = engine.train(ep, device="cpu")
    jax_models = jax_engine.train(jax_ep)
    predict, predict_batch = engine.serving_bundle(ep, models)
    jax_predict = jax_engine.predictor(jax_ep, jax_models)
    queries = [port_cls.ClassificationQuery.from_json(q) for q in QUERIES]
    want = [jax_predict(jax_cls.ClassificationQuery.from_json(q)).to_json() for q in QUERIES]
    assert [predict(q).to_json() for q in queries] == want
    assert [r.to_json() for r in predict_batch(queries)] == want
    assert len({w["label"] for w in want}) == 2


@pytest.mark.parametrize("name, params", [ALGOS[0], ALGOS[2]])
def test_jax_pickled_model_serves_in_the_port(stores, name, params):
    jax_engine = jax_cls.ClassificationEngine.apply()
    jax_ep = _engine_params(jax_cls, JaxEngineParams, name, params)
    (jax_model,) = jax_engine.train(jax_ep)
    model = persistence.loads(pickle.dumps(jax_model))
    model.to_device("cpu")
    engine = port_cls.ClassificationEngine.apply()
    predict = engine.predictor(_engine_params(port_cls, EngineParams, name, params), [model])
    jax_predict = jax_engine.predictor(jax_ep, [jax_model])
    for q in QUERIES:
        assert predict(port_cls.ClassificationQuery.from_json(q)).to_json() == \
            jax_predict(jax_cls.ClassificationQuery.from_json(q)).to_json()
    assert set(pickle.loads(pickle.dumps(model)).__dict__) == set(jax_model.__dict__)


def test_mesh_dp_raises(stores):
    engine = port_cls.ClassificationEngine.apply()
    ep = _engine_params(port_cls, EngineParams, "logreg", {})
    ep.algorithm_params_list[0][1].mesh_dp = 2
    with pytest.raises(NotImplementedError, match="parallel"):
        engine.train(ep, device="cpu")
