"""Evaluation API (reference: core/.../controller/{Evaluation,Metric,
MetricEvaluator}.scala + e2/.../evaluation/CrossValidation).

Counterpart of ``predictionio_tpu/controller/evaluation.py`` (a copy with
the port's imports).  ``Evaluation`` pairs an Engine with a Metric and
candidate EngineParams; ``MetricEvaluator.evaluate`` scores every candidate
over the engine's eval folds and picks the best — the reference's
hyperparameter-tuning loop (`pio eval`).  Both take the ``device`` the
candidates' models train on (None: the algorithms' default, ``"cuda"``).
"""

from __future__ import annotations

import abc
import dataclasses
import math
import statistics
from typing import Any, Callable, Dict, Generic, List, Optional, Sequence, Tuple, TypeVar

from predictionio_tpu_torch.controller.engine import Engine, EngineParams

Q = TypeVar("Q")
P = TypeVar("P")
A = TypeVar("A")


class Metric(abc.ABC, Generic[Q, P, A]):
    """Scores a set of (query, prediction, actual) triples.

    Reference: Metric.scala — ``calculate(sc, evalDataSet)``; subclasses
    AverageMetric / OptionAverageMetric / SumMetric / ZeroMetric map to
    overriding ``score_one`` or all of ``calculate``.
    """

    #: larger is better (reference: Metric's Ordering)
    higher_is_better: bool = True

    def header(self) -> str:
        return type(self).__name__

    def score_one(self, query: Q, prediction: P, actual: A) -> Optional[float]:
        raise NotImplementedError

    def calculate(self, eval_data: Sequence[Tuple[Any, Sequence[Tuple[Q, P, A]]]]) -> float:
        """Default: mean of per-triple scores over all folds, ignoring None
        (reference: OptionAverageMetric semantics)."""
        scores: List[float] = []
        for _info, qpa in eval_data:
            for q, p, a in qpa:
                s = self.score_one(q, p, a)
                if s is not None:
                    scores.append(float(s))
        if not scores:
            return -math.inf if self.higher_is_better else math.inf
        return statistics.fmean(scores)

    def compare(self, a: float, b: float) -> int:
        if a == b:
            return 0
        better = a > b if self.higher_is_better else a < b
        return 1 if better else -1


class AverageMetric(Metric[Q, P, A]):
    """score_one must return a float for every triple."""


class OptionAverageMetric(Metric[Q, P, A]):
    """score_one may return None to skip a triple."""


class SumMetric(Metric[Q, P, A]):
    def calculate(self, eval_data):
        total = 0.0
        for _info, qpa in eval_data:
            for q, p, a in qpa:
                s = self.score_one(q, p, a)
                if s is not None:
                    total += float(s)
        return total


class ZeroMetric(Metric[Q, P, A]):
    """Reference: ZeroMetric — always 0; used when only side metrics matter."""

    def calculate(self, eval_data):
        return 0.0


@dataclasses.dataclass
class MetricEvaluatorResult:
    best_score: float
    best_engine_params: EngineParams
    best_index: int
    metric_header: str
    other_metric_headers: List[str]
    engine_params_scores: List[Tuple[EngineParams, float, List[float]]]

    def to_json(self) -> Dict[str, Any]:
        return {
            "bestScore": self.best_score,
            "bestIndex": self.best_index,
            "bestEngineParams": self.engine_params_scores[self.best_index][0].to_json(),
            "metricHeader": self.metric_header,
            "otherMetricHeaders": self.other_metric_headers,
            "engineParamsScores": [
                {"engineParams": ep.to_json(), "score": s, "otherScores": o}
                for ep, s, o in self.engine_params_scores
            ],
        }


class MetricEvaluator:
    """Reference: MetricEvaluator.scala — evaluates each EngineParams candidate
    with the primary metric (+ optional side metrics), returns the best."""

    def __init__(self, metric: Metric, other_metrics: Sequence[Metric] = ()):
        self.metric = metric
        self.other_metrics = list(other_metrics)

    def evaluate(
        self,
        engine: Engine,
        engine_params_list: Sequence[EngineParams],
        eval_runner: Optional[Callable[[Engine, EngineParams], Any]] = None,
        device=None,
    ) -> MetricEvaluatorResult:
        """``eval_runner`` (e.g. ``FastEvalEngine(engine).eval``) replaces
        ``engine.eval(ep, device=device)``; it brings its own device."""
        if not engine_params_list:
            raise ValueError("engine_params_list must be non-empty")
        run = eval_runner or (lambda eng, ep: eng.eval(ep, device=device))
        scored: List[Tuple[EngineParams, float, List[float]]] = []
        for ep in engine_params_list:
            eval_data = run(engine, ep)
            score = self.metric.calculate(eval_data)
            others = [m.calculate(eval_data) for m in self.other_metrics]
            scored.append((ep, score, others))
        best_index = 0
        for i in range(1, len(scored)):
            if self.metric.compare(scored[i][1], scored[best_index][1]) > 0:
                best_index = i
        return MetricEvaluatorResult(
            best_score=scored[best_index][1],
            best_engine_params=scored[best_index][0],
            best_index=best_index,
            metric_header=self.metric.header(),
            other_metric_headers=[m.header() for m in self.other_metrics],
            engine_params_scores=scored,
        )


class Evaluation:
    """Binds an engine + metric + candidate params (reference: Evaluation.scala).

    Subclass and set ``engine``, ``metric`` (and optionally ``other_metrics``,
    ``engine_params_list``) as class attributes, or pass to __init__.
    """

    engine: Optional[Engine] = None
    metric: Optional[Metric] = None
    other_metrics: Sequence[Metric] = ()
    engine_params_list: Sequence[EngineParams] = ()

    def __init__(
        self,
        engine: Optional[Engine] = None,
        metric: Optional[Metric] = None,
        engine_params_list: Optional[Sequence[EngineParams]] = None,
        other_metrics: Optional[Sequence[Metric]] = None,
    ):
        if engine is not None:
            self.engine = engine
        if metric is not None:
            self.metric = metric
        if engine_params_list is not None:
            self.engine_params_list = engine_params_list
        if other_metrics is not None:
            self.other_metrics = other_metrics

    def run(self, eval_runner=None, device=None) -> MetricEvaluatorResult:
        if self.engine is None or self.metric is None:
            raise ValueError("Evaluation requires both an engine and a metric")
        evaluator = MetricEvaluator(self.metric, self.other_metrics)
        params = list(self.engine_params_list) or [EngineParams()]
        return evaluator.evaluate(self.engine, params, eval_runner, device=device)


class EngineParamsGenerator:
    """Supplies the candidate EngineParams for an Evaluation (reference:
    EngineParamsGenerator.scala, passed to `pio eval` alongside the
    Evaluation).  Subclass and set ``engine_params_list`` — usually via
    ``params_grid`` — or pass it to __init__."""

    engine_params_list: Sequence[EngineParams] = ()

    def __init__(self, engine_params_list: Optional[Sequence[EngineParams]] = None):
        if engine_params_list is not None:
            self.engine_params_list = engine_params_list


def params_grid(
    base: EngineParams,
    algorithm: str,
    grid: Dict[str, Sequence[Any]],
) -> List[EngineParams]:
    """Cartesian hyperparameter grid over one algorithm's params.

    The reference's engine-params-list workflows build candidate lists by
    hand (e.g. copying a baseParams and varying appId/rank per candidate);
    this is the generator for the common case: every combination of
    ``grid`` values overlaid on ``algorithm``'s params in ``base``.

        params_grid(ep, "als", {"rank": [8, 16], "reg": [0.01, 0.1]})
        → 4 EngineParams candidates
    """
    import itertools

    if not grid:
        return [base]
    names = [n for n, _ in base.algorithm_params_list]
    if algorithm not in names:
        raise ValueError(f"algorithm {algorithm!r} not in {names}")
    keys = list(grid)
    out: List[EngineParams] = []
    for combo in itertools.product(*(grid[k] for k in keys)):
        override = dict(zip(keys, combo))
        apl = []
        for name, p in base.algorithm_params_list:
            if name == algorithm:
                if dataclasses.is_dataclass(p):
                    p = dataclasses.replace(p, **override)
                elif isinstance(p, dict):
                    p = {**p, **override}
                else:
                    raise TypeError(
                        f"cannot overlay grid on params of type {type(p).__name__}")
            apl.append((name, p))
        out.append(dataclasses.replace(base, algorithm_params_list=apl))
    return out
