"""Example `pio eval` setup for the Universal Recommender: leave-one-out
hit@10 with a minLLR grid supplied by an EngineParamsGenerator.

    pio eval examples.universal_recommender.evaluation.UREvaluation \
             examples.universal_recommender.evaluation.MinLlrGrid
"""

from predictionio_tpu_torch.controller import EngineParams, Evaluation
from predictionio_tpu_torch.controller.evaluation import EngineParamsGenerator, params_grid
from predictionio_tpu_torch.models.universal_recommender import UniversalRecommenderEngine
from predictionio_tpu_torch.models.universal_recommender.engine import (
    HitRateMetric,
    MRRMetric,
    NDCGMetric,
    PrecisionAtKMetric,
    URAlgorithmParams,
    URDataSourceParams,
)

_BASE = EngineParams(
    data_source_params=URDataSourceParams(
        app_name="MyShop", event_names=["purchase", "view"],
        eval_users=500, eval_num=10),
    algorithm_params_list=[("ur", URAlgorithmParams(app_name="MyShop"))],
)


class UREvaluation(Evaluation):
    engine = UniversalRecommenderEngine.apply()
    metric = HitRateMetric()
    # side metrics reported per candidate alongside the selection metric
    other_metrics = (NDCGMetric(), PrecisionAtKMetric(10), MRRMetric())


class MinLlrGrid(EngineParamsGenerator):
    engine_params_list = params_grid(_BASE, "ur", {"min_llr": [0.0, 2.0, 5.0]})
