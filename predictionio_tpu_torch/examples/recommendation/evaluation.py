"""Example evaluation for `pio eval` (reference analogue: a template's
Evaluation.scala): precision@10 over a 3-fold split, tuning ALS rank."""

from predictionio_tpu_torch.controller import EngineParams, Evaluation, OptionAverageMetric
from predictionio_tpu_torch.models.recommendation import RecommendationEngine
from predictionio_tpu_torch.models.recommendation.engine import (
    ALSAlgorithmParams,
    DataSourceParams,
)


class PrecisionAt10(OptionAverageMetric):
    def score_one(self, q, p, a):
        actual_item, rating = a
        if rating < 4.0:
            return None
        return 1.0 if actual_item in [s.item for s in p.item_scores] else 0.0


class RecommendationEvaluation(Evaluation):
    engine = RecommendationEngine.apply()
    metric = PrecisionAt10()
    engine_params_list = [
        EngineParams(
            data_source_params=DataSourceParams(app_name="MyApp", eval_k=3),
            algorithm_params_list=[("als", ALSAlgorithmParams(rank=r, num_iterations=6, mesh_dp=1))],
        )
        for r in (4, 8)
    ]
