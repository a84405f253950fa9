"""FastEval — memoized evaluation across engine-params candidates.

Counterpart of ``predictionio_tpu/workflow/fast_eval.py``; its models train
on the ``device`` given at construction.  Reference: FastEvalEngine (core/.../workflow/; SURVEY.md §3 'pio eval' note):
when evaluating a grid of EngineParams, candidates that share a DASE prefix
(same dataSourceParams → same folds; + same preparatorParams → same prepared
data; + same algorithmParams → same trained models) reuse the earlier stage's
result instead of recomputing it.  Worth reproducing because hyperparameter
grids usually vary only the algorithm block.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Tuple

from predictionio_tpu_torch.controller.engine import Engine, EngineParams, _unpack_fold


def _key(params) -> str:
    return json.dumps(params.to_json(), sort_keys=True)


class FastEvalEngine:
    """Wraps an Engine with stage-level memoization for eval runs.

    Usage: ``MetricEvaluator(...).evaluate(engine, candidates,
    eval_runner=FastEvalEngine(engine).eval)``
    or pass to ``Evaluation.run(eval_runner=...)``.  ``device`` is where
    the candidates' models train (None: the algorithms' default, ``"cuda"``).
    """

    def __init__(self, engine: Engine, device=None):
        self.engine = engine
        self.device = device
        self._folds: Dict[str, List[Tuple[Any, Any, list]]] = {}
        self._prepared: Dict[str, List[Any]] = {}
        self._models: Dict[str, List[List[Any]]] = {}
        self.stats = {"folds": 0, "prepared": 0, "models": 0,
                      "folds_hit": 0, "prepared_hit": 0, "models_hit": 0}

    def _get_folds(self, engine_params: EngineParams):
        key = _key(engine_params.data_source_params)
        if key not in self._folds:
            data_source = self.engine.data_source_class(engine_params.data_source_params)
            self._folds[key] = [_unpack_fold(f) for f in data_source.read_eval()]
            self.stats["folds"] += 1
        else:
            self.stats["folds_hit"] += 1
        return key, self._folds[key]

    def _get_prepared(self, engine_params: EngineParams):
        folds_key, folds = self._get_folds(engine_params)
        key = folds_key + "|" + _key(engine_params.preparator_params)
        if key not in self._prepared:
            preparator = self.engine.preparator_class(engine_params.preparator_params)
            self._prepared[key] = [preparator.prepare(td) for td, _, _ in folds]
            self.stats["prepared"] += 1
        else:
            self.stats["prepared_hit"] += 1
        return key, folds, self._prepared[key]

    def _get_models(self, engine_params: EngineParams):
        prep_key, folds, prepared = self._get_prepared(engine_params)
        algo_key = json.dumps(
            [[name, p.to_json()] for name, p in engine_params.algorithm_params_list],
            sort_keys=True,
        )
        key = prep_key + "|" + algo_key
        if key not in self._models:
            per_fold = []
            for pd in prepared:
                algorithms = self._algorithms(engine_params)
                per_fold.append([algo.train(pd) for algo in algorithms])
            self._models[key] = per_fold
            self.stats["models"] += 1
        else:
            self.stats["models_hit"] += 1
        return folds, self._models[key]

    def _algorithms(self, engine_params: EngineParams):
        _, _, algorithms, _ = self.engine.make_components(engine_params,
                                                          device=self.device)
        return algorithms

    def eval(self, engine: Engine, engine_params: EngineParams):
        """Signature-compatible with MetricEvaluator's eval_runner."""
        folds, per_fold_models = self._get_models(engine_params)
        algorithms = self._algorithms(engine_params)
        serving = self.engine.serving_class(engine_params.serving_params)
        results = []
        for (td, info, qa_pairs), models in zip(folds, per_fold_models):
            queries = [q for q, _ in qa_pairs]
            per_algo = [
                algo.batch_predict(model, queries)
                for algo, model in zip(algorithms, models)
            ]
            qpa = []
            for i, (q, a) in enumerate(qa_pairs):
                preds = [per_algo[j][i] for j in range(len(algorithms))]
                qpa.append((q, serving.serve(q, preds), a))
            results.append((info, qpa))
        return results
