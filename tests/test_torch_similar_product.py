"""The port's similar-product template against the JAX package.

A seeded corpus of three co-view clusters (``view`` events, a little
cross-cluster noise, ``$set`` categories) goes into each package's memory
store.  Each package trains from its own store through ``Engine.train``
(the port on CPU tensors; the JAX side at ``meshDp`` 1): the cooccurrence
tables agree within the CCO bar (LLR rtol/atol 1e-4, ids equal away from
ties), and ALS from the same initial factors within the ALS bar.  Then a
JAX-trained model of each algorithm is carried across
(``sp_model_from_state``) and the port's ``predict`` and
``serve_batch_predict`` answer every query as the JAX engine does on the
same model: items in the same order away from ties, scores within rtol
1e-5, atol 1e-6 (f32 sums in another order).  The JAX tests' own
assertions (clusters, rules, the batch against the serial path) hold for
the port.  A JAX-pickled ``SPModel`` serves through the port's model store,
and ``pio app new`` → ``import`` → ``train`` → ``deploy`` of
``examples/similar_product/engine.json`` serves on the CPU.
"""

import json
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from predictionio_tpu.controller.engine import EngineParams as JaxEngineParams
from predictionio_tpu.models.similar_product import engine as jax_sp
from predictionio_tpu.ops import als as jax_als
from predictionio_tpu_torch.cli import main as cli
from predictionio_tpu_torch.controller import EngineParams
from predictionio_tpu_torch.models import similar_product as sp
from predictionio_tpu_torch.ops import als
from predictionio_tpu_torch.storage import set_storage as port_set_storage
from predictionio_tpu_torch.workflow import persistence

from _torch_event_cases import T0, fill_both, port_events, port_memory_storage

REPO = Path(__file__).resolve().parents[1]
APP = "spapp"
RTOL, ATOL = 1e-5, 1e-6
CLUSTERS = "amz"
CATS = {"a": ["alpha"], "m": ["mid"], "z": ["zeta"]}


def sp_corpus():
    """Three clusters of 8 items each viewed by a third of 60 users, a
    cross-cluster view now and then, and ``$set`` categories (the ``m``
    items also in ``alpha`` on even ids)."""
    rng = np.random.default_rng(4)
    specs = []
    for u in range(60):
        c = CLUSTERS[u % 3]
        for i in range(8):
            if rng.random() < 0.7:
                t = T0 + len(specs)
                specs.append(("view", "user", f"u{u}", "item", f"{c}{i}", {}, t, t))
        if rng.random() < 0.3:
            t = T0 + len(specs)
            other = f"{CLUSTERS[int(rng.integers(3))]}{int(rng.integers(8))}"
            specs.append(("view", "user", f"u{u}", "item", other, {}, t, t))
    for c in CLUSTERS:
        for i in range(8):
            t = T0 + 10_000 + i
            cats = CATS[c] + (["alpha"] if c == "m" and i % 2 == 0 else [])
            specs.append(("$set", "item", f"{c}{i}", None, None, {"categories": cats}, t, t))
    return specs


QUERIES = [
    dict(items=["a1"], num=3),
    dict(items=["a1"], num=10),
    dict(items=["a0", "a2"], num=4, black_list=["a3"]),
    dict(items=["z1", "m2"], num=6),
    dict(items=["m1"], num=5, categories=["alpha"]),
    dict(items=["a0"], num=5, categories=["zeta"]),
    dict(items=["a0"], num=4, white_list=["a3", "z2", "ghost"]),
    dict(items=["a0"], num=4, white_list=[]),
    dict(items=["nope"], num=4),
    dict(items=["a1"], num=4, categories=["ghost"]),
    dict(items=["a1", "nope", "z5"], num=1),
    dict(items=["m0", "m1", "m2", "m3", "m4"], num=50, black_list=["m5"]),
]

PARAMS = {
    "als": (jax_sp.SPALSParams, sp.SPALSParams,
            dict(rank=3, num_iterations=10, mesh_dp=1)),
    "cooccurrence": (jax_sp.SPCooccurrenceParams, sp.SPCooccurrenceParams,
                     dict(min_llr=0.5, mesh_dp=1, max_correlators_per_item=6)),
}


@pytest.fixture()
def jax_init_in_port(monkeypatch):
    def init(data, k, seed):
        x0, y0 = jax_als._als_init(data, k, seed)
        return torch.as_tensor(np.array(x0)), torch.as_tensor(np.array(y0))

    monkeypatch.setattr(als, "_als_init", init)


class Both:
    """One algorithm trained from events by each package."""

    def __init__(self, jax_store, port_store, algo):
        fill_both(jax_store, port_store, APP, sp_corpus())
        jax_cls, port_cls, params = PARAMS[algo]
        self.algo = algo
        self.jax_engine = jax_sp.SimilarProductEngine.apply()
        self.jax_ep = JaxEngineParams(
            data_source_params=jax_sp.SPDataSourceParams(app_name=APP),
            algorithm_params_list=[(algo, jax_cls(**params))])
        self.engine = sp.SimilarProductEngine.apply()
        self.ep = EngineParams(
            data_source_params=sp.SPDataSourceParams(app_name=APP),
            algorithm_params_list=[(algo, port_cls(**params))])
        self.jax_models = self.jax_engine.train(self.jax_ep)
        self.models = self.engine.train(self.ep, device="cpu")
        # the JAX model carried across: both engines serve the same numbers
        self.carried = [sp.sp_model_from_state(self.jax_models[0].__getstate__(),
                                               device="cpu")]
        self.jax_algo = self.jax_engine.algorithm_classes[algo](self.jax_ep.algorithm_params_list[0][1])
        self.port_algo = self.engine.algorithm_classes[algo](self.ep.algorithm_params_list[0][1])


@pytest.fixture(params=sorted(PARAMS))
def both(request, mem_storage, jax_init_in_port):
    port_store = port_memory_storage()
    port_set_storage(port_store)
    yield Both(mem_storage, port_store, request.param)
    port_set_storage(None)


def assert_same(got, want, rtol=RTOL, atol=ATOL):
    """Answers equal: the same length, scores within the bar, items in the
    same order except swaps between scores that tie within it."""
    g = [(s["item"], s["score"]) for s in got["itemScores"]]
    w = [(s["item"], s["score"]) for s in want["itemScores"]]
    assert len(g) == len(w), (g, w)
    np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=rtol, atol=atol)
    for (gi, gs), (wi, ws) in zip(g, w):
        if gi != wi:
            assert gi in dict(w) and abs(dict(w)[gi] - ws) <= atol + rtol * abs(ws), (g, w)


def items_of(res):
    return [s.item for s in res.item_scores]


def test_trained_models_match_jax(both):
    got, want = both.models[0], both.jax_models[0]
    assert got.kind == want.kind == both.algo
    assert got.item_dict.strings() == want.item_dict.strings()
    assert got.cat_dict.strings() == want.cat_dict.strings()
    np.testing.assert_array_equal(got.cat_masks, want.cat_masks)
    if both.algo == "als":
        np.testing.assert_allclose(got.item_factors, want.item_factors, rtol=1e-4, atol=2e-4)
        return
    np.testing.assert_allclose(got.indicator_llr, want.indicator_llr, rtol=1e-4, atol=1e-4)
    for r in range(len(got.indicator_idx)):   # ids equal away from ties and the cut
        s = want.indicator_llr[r]
        for j in range(len(s) - 1):
            if (np.abs(s - s[j]) <= 1e-4 + 1e-4 * abs(s[j])).sum() == 1:
                assert got.indicator_idx[r, j] == want.indicator_idx[r, j], r


def test_predict_matches_jax_on_a_carried_across_model(both):
    predict = both.engine.predictor(both.ep, both.carried)
    jax_predict = both.jax_engine.predictor(both.jax_ep, both.jax_models)
    for q in QUERIES:
        got = predict(sp.SimilarProductQuery(**q)).to_json()
        assert_same(got, jax_predict(jax_sp.SimilarProductQuery(**q)).to_json())


def test_serve_batch_matches_jax_and_the_serial_path(both):
    queries = [sp.SimilarProductQuery(**q) for q in QUERIES]
    model = both.carried[0]
    serial = [both.port_algo.predict(model, q) for q in queries]
    batched = both.port_algo.serve_batch_predict(model, queries)
    jax_batched = both.jax_algo.serve_batch_predict(
        both.jax_models[0], [jax_sp.SimilarProductQuery(**q) for q in QUERIES])
    assert len(batched) == len(queries)
    for q, s, b, jb in zip(queries, serial, batched, jax_batched):
        assert [(r.item, round(r.score, 4)) for r in s.item_scores] == \
            [(r.item, round(r.score, 4)) for r in b.item_scores], q
        assert_same(b.to_json(), jb.to_json())


def test_clusters_and_rules_hold_in_the_port(both):
    """tests/test_similar_product.py's assertions on the port's own train."""
    predict = both.engine.predictor(both.ep, both.models)

    def ask(**q):
        return items_of(predict(sp.SimilarProductQuery(**q)))

    res = ask(items=["a1"], num=3)
    assert res and all(i.startswith("a") for i in res) and "a1" not in res, res
    res = ask(items=["a0", "a1"], num=4, black_list=["a2"])
    assert not {"a0", "a1", "a2"} & set(res)
    assert all(i.startswith("z") for i in ask(items=["a0"], num=5, categories=["zeta"]))
    assert ask(items=["a0"], num=5, white_list=["a3"]) in ([], ["a3"])
    assert ask(items=["a0"], num=5, white_list=[]) == []
    assert ask(items=["nope"], num=5) == []


def test_query_json_and_model_roundtrip(both):
    q = sp.SimilarProductQuery.from_json(
        {"items": ["i1"], "num": 2, "whiteList": ["i2"], "blackList": ["i3"],
         "categories": ["c"]})
    assert q.items == ["i1"] and q.white_list == ["i2"] and q.categories == ["c"]
    assert sp.SimilarProductQuery.from_json({"items": ["a"]}).white_list is None
    restored = [pickle.loads(pickle.dumps(m)) for m in both.models]
    restored[0].to_device("cpu")
    q = sp.SimilarProductQuery(items=["m1"], num=5, categories=["alpha"])
    assert (both.engine.predictor(both.ep, both.models)(q).to_json()
            == both.engine.predictor(both.ep, restored)(q).to_json())


def test_mesh_dp_above_one_names_the_roadmap(both):
    td = both.engine.make_components(both.ep)[0].read_training()
    _, cls, params = PARAMS[both.algo]
    algo_cls = both.engine.algorithm_classes[both.algo]
    # a dp above the ranks (one here) raises MeshSpec.resolve's error, as JAX
    with pytest.raises(ValueError, match=r"mesh 2x1 != 1 devices"):
        algo_cls(cls(**{**params, "mesh_dp": 2}), device="cpu").train(td)


def test_jax_pickled_model_serves_in_the_port(fs_storage):
    """The JAX package trains the cooccurrence model from its localfs store
    through ``run_train``; the port loads that blob and serves as the JAX
    model loaded back from it does."""
    from predictionio_tpu.workflow import core_workflow as jax_workflow

    port_store = port_memory_storage()
    fill_both(fs_storage, port_store, APP, sp_corpus())
    jax_cls, port_cls, params = PARAMS["cooccurrence"]
    jax_engine = jax_sp.SimilarProductEngine.apply()
    jax_ep = JaxEngineParams(data_source_params=jax_sp.SPDataSourceParams(app_name=APP),
                             algorithm_params_list=[("cooccurrence", jax_cls(**params))])
    instance = jax_workflow.run_train(jax_engine, jax_ep, engine_id="sp-jax",
                                      storage=fs_storage)
    _, (jax_model,) = jax_workflow.load_latest_models("sp-jax", storage=fs_storage)
    (model,) = persistence.deserialize_models(fs_storage.models.get(instance.id),
                                              device="cpu")
    assert type(model) is sp.SPModel
    np.testing.assert_array_equal(model.indicator_idx, jax_model.indicator_idx)
    engine = sp.SimilarProductEngine.apply()
    ep = EngineParams(data_source_params=sp.SPDataSourceParams(app_name=APP),
                      algorithm_params_list=[("cooccurrence", port_cls(**params))])
    predict = engine.predictor(ep, [model])
    jax_predict = jax_engine.predictor(jax_ep, [jax_model])
    for q in QUERIES:
        assert_same(predict(sp.SimilarProductQuery(**q)).to_json(),
                    jax_predict(jax_sp.SimilarProductQuery(**q)).to_json())


def test_pio_train_and_deploy_the_example(tmp_path, monkeypatch):
    """``examples/similar_product/engine.json`` (its app renamed) through
    the port's ``pio`` on a localfs store: app new, import and train in
    this process, ``pio deploy`` as a subprocess; the served answers equal
    the port's predictor on the stored model."""
    from predictionio_tpu_torch.storage import get_storage
    from predictionio_tpu_torch.workflow.core_workflow import load_latest_models
    from predictionio_tpu_torch.workflow.create_workflow import engine_from_variant
    from test_torch_cli import _served

    variant = json.loads((REPO / "examples/similar_product/engine.json").read_text())
    variant["datasource"]["params"]["appName"] = APP
    (tmp_path / "engine.json").write_text(json.dumps(variant))
    (tmp_path / "events.jsonl").write_text("".join(
        json.dumps(e.to_json()) + "\n" for e in port_events(sp_corpus())))
    for k in list(__import__("os").environ):
        if k.startswith("PIO_"):
            monkeypatch.delenv(k)
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "store"))
    monkeypatch.setenv("PIO_TORCH_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)
    port_set_storage(None)
    try:
        for argv in (["app", "new", APP],
                     ["import", "--app-name", APP, "--input", "events.jsonl"],
                     ["build"], ["train"]):
            assert cli.main(argv) == 0, argv
        factory, engine, ep = engine_from_variant(variant)
        _, models = load_latest_models(variant["id"], storage=get_storage(), device="cpu")
    finally:
        port_set_storage(None)
    assert type(models[0]) is sp.SPModel and models[0].kind == "cooccurrence"
    bodies = [{"items": ["a1"], "num": 4}, {"items": ["z0", "z1"], "num": 3},
              {"items": ["m1"], "num": 5, "categories": ["alpha"]},
              {"items": ["a0"], "whiteList": ["a2"]}, {"items": ["ghost"]}]
    predict = engine.predictor(ep, models)
    want = [predict(factory.query_class.from_json(b)).to_json() for b in bodies]
    served = _served(tmp_path, bodies)
    assert served["info"]["devices"] == ["cpu"]
    assert served["deploy_rc"] == 0, served["deploy_out"]
    assert served["answers"] == want
    assert want[0]["itemScores"] and want[-1] == {"itemScores": []}
