"""The port's evaluation workflow against the JAX package.

- The metric classes and ``MetricEvaluator`` score the same (query,
  prediction, actual) triples to the same numbers, and pick the same best
  candidate (exact: the same float64 means over the same values).
- ``Engine.eval`` of the recommendation template, each package training
  from its own memory store of the same rating events (the port's
  ``_als_init`` monkeypatched to the JAX arrays, JAX at ``meshDp`` 1): the
  k-fold split (``np.random.default_rng(seed)``) gives identical folds and
  (query, actual) pairs, and precision@10 agrees within 1e-6 absolute.
- The UR's leave-one-out fold is identical in both packages, and the four
  rank metrics are equal on a model the JAX package trains on the fold and
  the port carries across.
- ``FastEvalEngine`` reuses folds, prepared data and models as the JAX one
  does (the same cache statistics), and its scores equal ``Engine.eval``'s.
- ``run_eval`` records the EvaluationInstance (EVALCOMPLETED with the
  results as text, JSON and HTML; EVALFAILED and the error re-raised) and
  counts ``pio_eval_runs_total``.
- The port's examples (``predictionio_tpu_torch/examples/*/evaluation.py``)
  are the JAX package's ``examples/*/evaluation.py`` byte for byte but for
  the import prefix.  ``pio eval`` of them exits 0 and prints the JAX
  console's lines; a module that imports the JAX package is refused,
  naming it; in a fresh interpreter, from a working directory outside the
  repo, ``pio eval`` of the port's example by package path never puts
  ``predictionio_tpu`` into ``sys.modules``.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from predictionio_tpu.controller import evaluation as jax_evaluation
from predictionio_tpu.controller.engine import EngineParams as JaxEngineParams
from predictionio_tpu.models.recommendation import engine as jax_reco
from predictionio_tpu.models.universal_recommender import engine as jax_ur
from predictionio_tpu.ops import als as jax_als
from predictionio_tpu.workflow.fast_eval import FastEvalEngine as JaxFastEvalEngine
from predictionio_tpu_torch.cli import main as cli
from predictionio_tpu_torch.controller import EngineParams
from predictionio_tpu_torch.controller import evaluation
from predictionio_tpu_torch.models import universal_recommender as ur
from predictionio_tpu_torch.models.universal_recommender import engine as port_ur
from predictionio_tpu_torch.models.recommendation import engine as reco
from predictionio_tpu_torch.ops import als
from predictionio_tpu_torch.storage import set_storage as port_set_storage
from predictionio_tpu_torch.workflow import core_workflow
from predictionio_tpu_torch.workflow.fast_eval import FastEvalEngine

from _torch_event_cases import (
    fill_both,
    fill_jax,
    port_localfs_storage,
    port_memory_storage,
    rating_corpus,
    seeded_corpus,
)

APP = "evalapp"
REPO = Path(__file__).resolve().parents[1]
PRECISION_ATOL = 1e-6


@pytest.fixture()
def jax_init_in_port(monkeypatch):
    def init(data, k, seed):
        x0, y0 = jax_als._als_init(data, k, seed)
        return torch.as_tensor(np.array(x0)), torch.as_tensor(np.array(y0))

    monkeypatch.setattr(als, "_als_init", init)


@pytest.fixture()
def stores(mem_storage):
    port_store = port_memory_storage()
    port_set_storage(port_store)
    yield mem_storage, port_store
    port_set_storage(None)


EXAMPLES = ["recommendation", "universal_recommender"]


def port_copy(example: str, replace=()) -> str:
    """The port's ``predictionio_tpu_torch/examples/<example>/evaluation.py``
    with each (old, new) of ``replace`` applied, for a test to write as a
    module of its own."""
    src = (REPO / "predictionio_tpu_torch" / "examples" / example / "evaluation.py").read_text()
    for old, new in replace:
        src = src.replace(old, new)
    assert "predictionio_tpu." not in src
    return src


def write_module(directory: Path, name: str, source: str) -> str:
    """Write ``<name>.py`` into ``directory``, put the directory on
    ``sys.path``; returns the module name."""
    directory.mkdir(parents=True, exist_ok=True)
    (directory / f"{name}.py").write_text(source)
    if str(directory) not in sys.path:
        sys.path.insert(0, str(directory))
    return name


# -- metrics and the evaluator ---------------------------------------------------


def _metric_classes(mod):
    class Hit(mod.AverageMetric):
        def score_one(self, q, p, a):
            return float(a in p)

    class HitOrSkip(mod.OptionAverageMetric):
        def score_one(self, q, p, a):
            return None if a < 0 else float(a in p)

    class Sum(mod.SumMetric):
        def score_one(self, q, p, a):
            return len(p) + 0.25 * a

    class Loss(mod.AverageMetric):
        higher_is_better = False

        def score_one(self, q, p, a):
            return abs(a - len(p)) / 3.0

    return {"hit": Hit, "option": HitOrSkip, "sum": Sum, "loss": Loss, "zero": mod.ZeroMetric}


def _eval_data(seed):
    rng = np.random.default_rng(seed)
    return [({"fold": f}, [(int(q), [int(x) for x in rng.integers(0, 9, rng.integers(0, 5))],
                            int(rng.integers(-2, 9))) for q in range(30)])
            for f in range(3)]


@pytest.mark.parametrize("kind", ["hit", "option", "sum", "loss", "zero"])
def test_metrics_score_as_the_jax_ones(kind):
    data = _eval_data(1)
    got = _metric_classes(evaluation)[kind]()
    want = _metric_classes(jax_evaluation)[kind]()
    assert got.calculate(data) == want.calculate(data)
    assert got.header() == want.header()
    assert got.compare(0.25, 0.5) == want.compare(0.25, 0.5)


def test_option_metric_with_nothing_scored_is_worst():
    class Never(evaluation.OptionAverageMetric):
        def score_one(self, q, p, a):
            return None

    assert Never().calculate(_eval_data(2)) == -math.inf


@pytest.mark.parametrize("kind", ["hit", "loss"])
def test_metric_evaluator_picks_the_jax_best(kind):
    datasets = [_eval_data(s) for s in (3, 4, 5, 6)]
    candidates = [EngineParams(data_source_params=reco.DataSourceParams(seed=s))
                  for s in range(4)]
    jax_candidates = [JaxEngineParams(data_source_params=jax_reco.DataSourceParams(seed=s))
                      for s in range(4)]
    others = [_metric_classes(evaluation)["sum"]()]
    got = evaluation.MetricEvaluator(_metric_classes(evaluation)[kind](), others).evaluate(
        None, candidates, eval_runner=lambda eng, ep: datasets[ep.data_source_params.seed])
    want = jax_evaluation.MetricEvaluator(
        _metric_classes(jax_evaluation)[kind](), [_metric_classes(jax_evaluation)["sum"]()]
    ).evaluate(None, jax_candidates,
               eval_runner=lambda eng, ep: datasets[ep.data_source_params.seed])
    assert got.to_json() == want.to_json()


def test_params_grid_matches_jax():
    base = EngineParams(algorithm_params_list=[("als", reco.ALSAlgorithmParams(rank=4))])
    jax_base = JaxEngineParams(
        algorithm_params_list=[("als", jax_reco.ALSAlgorithmParams(rank=4))])
    grid = {"rank": [4, 8], "lambda_": [0.01, 0.1]}
    got = [ep.to_json() for ep in evaluation.params_grid(base, "als", grid)]
    want = [ep.to_json() for ep in jax_evaluation.params_grid(jax_base, "als", grid)]
    # the port's ALS params hold its checkpoint options besides the JAX ones
    for g, w in zip(got, want, strict=True):
        for gp, wp in zip(g["algorithmParamsList"], w["algorithmParamsList"], strict=True):
            assert {k: v for k, v in gp["params"].items() if k in wp["params"]} == wp["params"]


# -- Engine.eval of the recommendation template ----------------------------------------


def _reco_params(mod, rank, **ds):
    return (mod.DataSourceParams(app_name=APP, eval_k=3, **ds),
            mod.ALSAlgorithmParams(rank=rank, num_iterations=4, mesh_dp=1))


def _ep(mod, ep_cls, rank, **ds):
    dsp, ap = _reco_params(mod, rank, **ds)
    return ep_cls(data_source_params=dsp, algorithm_params_list=[("als", ap)])


def _precision(mod):
    class PrecisionAt10(mod.OptionAverageMetric):
        def score_one(self, q, p, a):
            actual_item, rating = a
            if rating < 4.0:
                return None
            return 1.0 if actual_item in [s.item for s in p.item_scores] else 0.0

    return PrecisionAt10()


def test_reco_folds_are_the_jax_folds(stores):
    fill_both(*stores, APP, rating_corpus())
    _assert_same_reco_folds()


def test_reco_folds_from_a_jax_written_localfs_store(fs_storage, tmp_path):
    """The JAX package writes the events into its localfs store; the port
    reads the same directory."""
    fill_jax(fs_storage, APP, rating_corpus())
    port_set_storage(port_localfs_storage(tmp_path / "store"))
    try:
        _assert_same_reco_folds()
    finally:
        port_set_storage(None)


def _assert_same_reco_folds():
    dsp, _ = _reco_params(reco, 4)
    jdsp, _ = _reco_params(jax_reco, 4)
    got = reco.RecoDataSource(dsp).read_eval()
    want = jax_reco.RecoDataSource(jdsp).read_eval()
    assert len(got) == len(want) == 3
    for (gtd, ginfo, gqa), (wtd, winfo, wqa) in zip(got, want):
        assert ginfo == winfo
        assert [(q.user, q.num, a) for q, a in gqa] == [(q.user, q.num, a) for q, a in wqa]
        for col in ("entity_ids", "target_ids", "times_us", "ratings"):
            np.testing.assert_array_equal(getattr(gtd, col), getattr(wtd, col))


@pytest.mark.parametrize("rank", [4, 8])
def test_engine_eval_of_the_recommendation_template(stores, jax_init_in_port, rank):
    fill_both(*stores, APP, rating_corpus())
    got = reco.RecommendationEngine.apply().eval(_ep(reco, EngineParams, rank), device="cpu")
    want = jax_reco.RecommendationEngine.apply().eval(_ep(jax_reco, JaxEngineParams, rank))
    assert [info for info, _ in got] == [info for info, _ in want]
    for (_, gqpa), (_, wqpa) in zip(got, want):
        assert [(q.user, a) for q, _, a in gqpa] == [(q.user, a) for q, _, a in wqpa]
    g, w = _precision(evaluation).calculate(got), _precision(jax_evaluation).calculate(want)
    assert abs(g - w) <= PRECISION_ATOL, (g, w)


def test_fast_eval_reuses_stages_as_the_jax_one(stores, jax_init_in_port):
    fill_both(*stores, APP, rating_corpus())
    cands = [_ep(reco, EngineParams, r) for r in (4, 8, 4)]
    jax_cands = [_ep(jax_reco, JaxEngineParams, r) for r in (4, 8, 4)]
    fast = FastEvalEngine(reco.RecommendationEngine.apply(), device="cpu")
    jax_fast = JaxFastEvalEngine(jax_reco.RecommendationEngine.apply())
    got = evaluation.MetricEvaluator(_precision(evaluation)).evaluate(
        fast.engine, cands, eval_runner=fast.eval)
    want = jax_evaluation.MetricEvaluator(_precision(jax_evaluation)).evaluate(
        jax_fast.engine, jax_cands, eval_runner=jax_fast.eval)
    assert fast.stats == jax_fast.stats == {
        "folds": 1, "prepared": 1, "models": 2,
        "folds_hit": 2, "prepared_hit": 2, "models_hit": 1}
    assert got.best_index == want.best_index
    for (_, gs, _), (_, ws, _) in zip(got.engine_params_scores, want.engine_params_scores):
        assert abs(gs - ws) <= PRECISION_ATOL
    plain = evaluation.MetricEvaluator(_precision(evaluation)).evaluate(
        fast.engine, cands, device="cpu")
    assert [s for _, s, _ in plain.engine_params_scores] == \
        [s for _, s, _ in got.engine_params_scores]


# -- the UR's leave-one-out fold and its rank metrics ------------------------------------


def _ur_params(mod):
    return (mod.URDataSourceParams(app_name=APP, event_names=["purchase", "view"],
                                   eval_users=12, eval_num=10, eval_seed=4),
            mod.URAlgorithmParams(app_name=APP, mesh_dp=1, max_correlators_per_item=8))


def _rank_metrics(mod):
    return [mod.HitRateMetric(), mod.NDCGMetric(), mod.PrecisionAtKMetric(5), mod.MRRMetric()]


def test_ur_leave_one_out_fold_and_rank_metrics(stores):
    fill_both(*stores, APP, seeded_corpus(7, n_users=40, n_items=25, n_inter=700))
    dsp, ap = _ur_params(port_ur)
    jdsp, jap = _ur_params(jax_ur)
    (gtd, ginfo, gqa), = ur.URDataSource(dsp).read_eval()
    (wtd, winfo, wqa), = jax_ur.URDataSource(jdsp).read_eval()
    assert ginfo == winfo and len(gqa) == 12
    assert [(q.user, q.num, a) for q, a in gqa] == [(q.user, q.num, a) for q, a in wqa]
    for name in wtd.event_names:
        for g, w in zip(gtd.interactions[name], wtd.interactions[name]):
            if isinstance(w, np.ndarray):
                np.testing.assert_array_equal(g, w)
            else:
                assert list(g.to_state()) == list(w.to_state())
    jax_model = jax_ur.URAlgorithm(jap).train(wtd)
    port_model = ur.ur_model_from_state(jax_model.__getstate__(), device="cpu")
    got = ur.URAlgorithm(ap, device="cpu").batch_predict(port_model, [q for q, _ in gqa])
    want = jax_ur.URAlgorithm(jap).batch_predict(jax_model, [q for q, _ in wqa])
    g_data = [(ginfo, [(q, p, a) for (q, a), p in zip(gqa, got)])]
    w_data = [(winfo, [(q, p, a) for (q, a), p in zip(wqa, want)])]
    for gm, wm in zip(_rank_metrics(port_ur), _rank_metrics(jax_ur)):
        assert gm.header() == wm.header()
        assert gm.calculate(g_data) == wm.calculate(w_data)
    assert _rank_metrics(port_ur)[0].calculate(g_data) > 0.0


def test_ur_read_eval_is_empty_without_eval_users(stores):
    fill_both(*stores, APP, seeded_corpus(7))
    dsp, _ = _ur_params(port_ur)
    assert ur.URDataSource(port_ur.URDataSourceParams(app_name=APP)).read_eval() == []
    assert len(ur.URDataSource(dsp).read_eval()) == 1


# -- run_eval and pio eval --------------------------------------------------------------


def _evaluation(metric=None):
    return evaluation.Evaluation(
        engine=reco.RecommendationEngine.apply(), metric=metric or _precision(evaluation),
        engine_params_list=[_ep(reco, EngineParams, r) for r in (4, 8)])


def test_run_eval_records_the_instance(stores):
    _, port_store = stores
    fill_both(*stores, APP, rating_corpus())
    before = core_workflow._M_EVALS.value(status="EVALCOMPLETED")
    result = core_workflow.run_eval(_evaluation(), evaluation_class="x.RecoEval",
                                    storage=port_store, device="cpu")
    (inst,) = port_store.evaluation_instances.get_completed()
    assert inst.status == "EVALCOMPLETED" and inst.evaluation_class == "x.RecoEval"
    assert inst.end_time is not None
    assert json.loads(inst.evaluator_results_json) == json.loads(json.dumps(result.to_json()))
    assert inst.evaluator_results.startswith(f"PrecisionAt10: best={result.best_score:.6f}")
    assert "<table>" in inst.evaluator_results_html
    assert core_workflow._M_EVALS.value(status="EVALCOMPLETED") == before + 1


def test_run_eval_records_a_failure_and_reraises(stores):
    _, port_store = stores
    fill_both(*stores, APP, rating_corpus())

    class Broken(evaluation.OptionAverageMetric):
        def score_one(self, q, p, a):
            raise RuntimeError("metric broke")

    before = core_workflow._M_EVALS.value(status="EVALFAILED")
    with pytest.raises(RuntimeError, match="metric broke"):
        core_workflow.run_eval(_evaluation(Broken()), storage=port_store, device="cpu")
    assert port_store.evaluation_instances.get_completed() == []
    assert core_workflow._M_EVALS.value(status="EVALFAILED") == before + 1


def test_run_eval_through_fast_eval(stores):
    _, port_store = stores
    fill_both(*stores, APP, rating_corpus())
    ev = _evaluation()
    fast = FastEvalEngine(ev.engine, device="cpu")
    result = core_workflow.run_eval(ev, storage=port_store, device="cpu",
                                    eval_runner=fast.eval)
    assert fast.stats["folds"] == 1 and fast.stats["folds_hit"] == 1
    assert result.best_score == ev.run(device="cpu").best_score


def test_pio_eval_of_the_port_copy(stores, tmp_path, monkeypatch, capsys):
    fill_both(*stores, "MyApp", rating_corpus())
    monkeypatch.setenv("PIO_TORCH_DEVICE", "cpu")
    mod = write_module(tmp_path / "mods", "port_reco_evaluation",
                       port_copy("recommendation"))
    assert cli.main(["eval", f"{mod}.RecommendationEvaluation"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("Evaluation completed: PrecisionAt10 best=")
    assert sum(line.startswith("  * candidate") for line in out) == 1
    assert json.loads("\n".join(out[out.index("Best engine params:") + 1:]))[
        "algorithmParamsList"][0]["name"] == "als"


def test_pio_eval_with_a_params_generator(stores, tmp_path, monkeypatch, capsys):
    fill_both(*stores, "MyShop", seeded_corpus(3, n_users=30, n_items=20, n_inter=500))
    monkeypatch.setenv("PIO_TORCH_DEVICE", "cpu")
    mod = write_module(tmp_path / "mods", "port_ur_evaluation", port_copy(
        "universal_recommender", [("eval_users=500", "eval_users=10")]))
    assert cli.main(["eval", f"{mod}.UREvaluation", f"{mod}.MinLlrGrid"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("Evaluation completed: HitRate best=")
    assert [line[4:15] for line in out[1:4]] == [f"candidate {i}" for i in range(3)]
    assert sum(line.startswith("  * ") for line in out[1:4]) == 1
    assert "NDCG=" in out[1] and "Precision@10=" in out[1] and "MRR=" in out[1]


@pytest.mark.parametrize("path", [
    "examples.recommendation.evaluation.RecommendationEvaluation",
    "predictionio_tpu.controller.evaluation.Evaluation"])
def test_pio_eval_refuses_a_module_that_imports_the_jax_package(stores, monkeypatch, capsys,
                                                                path):
    monkeypatch.setenv("PIO_TORCH_DEVICE", "cpu")
    monkeypatch.chdir(REPO)
    assert cli.main(["eval", path]) == 1
    err = capsys.readouterr().err
    assert repr(path.rpartition(".")[0]) in err and "imports the JAX package" in err


@pytest.mark.parametrize("example", EXAMPLES)
def test_port_example_is_the_jax_one_on_the_ports_imports(example):
    """Each of the port's examples is the JAX example with every ``from
    predictionio_tpu.`` on the port's path, and nothing else changed."""
    jax_src = (REPO / "examples" / example / "evaluation.py").read_bytes()
    port_src = (REPO / "predictionio_tpu_torch" / "examples" / example /
                "evaluation.py").read_bytes()
    assert b"from predictionio_tpu." in jax_src
    assert port_src == jax_src.replace(b"from predictionio_tpu.", b"from predictionio_tpu_torch.")
    assert b"predictionio_tpu." not in port_src


_FRESH = r"""
import json, os, sys
sys.path.insert(0, sys.argv[1])
os.environ["PIO_TORCH_DEVICE"] = "cpu"
from predictionio_tpu_torch.cli.main import main
from predictionio_tpu_torch.events.event import Event
from predictionio_tpu_torch.storage import App, Storage, StorageConfig, set_storage
store = Storage(StorageConfig.memory())
set_storage(store)
app = store.apps.insert(App(0, "MyApp"))
store.l_events.insert_batch([Event("rate", "user", f"u{u}", "item", f"i{i}",
                                   properties={"rating": 5.0 if (u + i) % 2 else 1.0},
                                   event_time=1.7e9 + 40 * u + i, creation_time=1.7e9)
                             for u in range(20) for i in range(30) if (u * 7 + i) % 3], app)
assert os.getcwd() == sys.argv[1] and "" in sys.path
assert main(["eval", "predictionio_tpu_torch.examples.recommendation.evaluation."
                     "RecommendationEvaluation"]) == 0
assert main(["eval", "port_reco_evaluation.RecommendationEvaluation"]) == 0
os.chdir(sys.argv[2])
assert main(["eval", "examples.recommendation.evaluation.RecommendationEvaluation"]) == 1
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "predictionio_tpu" or m.startswith("predictionio_tpu."))
print(json.dumps(bad))
"""


def test_pio_eval_never_loads_the_jax_package(tmp_path):
    """From a working directory outside the repo, with the repo alone on
    ``PYTHONPATH``: the port's example by package path and a copy of it in
    the working directory evaluate; the JAX example is refused."""
    write_module(tmp_path, "port_reco_evaluation", port_copy("recommendation"))
    out = subprocess.run([sys.executable, "-c", _FRESH, str(tmp_path), str(REPO)],
                         cwd=tmp_path, env={**os.environ, "PYTHONPATH": str(REPO)},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "imports the JAX package" in out.stderr
    lines = out.stdout.strip().splitlines()
    assert sum(line.startswith("Evaluation completed: PrecisionAt10 best=")
               for line in lines) == 2
    assert lines[-1] == "[]"
