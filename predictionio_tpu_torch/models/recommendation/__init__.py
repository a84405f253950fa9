from predictionio_tpu_torch.models.recommendation.convert import (  # noqa: F401
    als_model_from_state,
)
from predictionio_tpu_torch.models.recommendation.engine import (  # noqa: F401
    ALSAlgorithm,
    ALSAlgorithmParams,
    ALSModel,
    ItemScore,
    PredictedResult,
    RecommendationEngine,
    RecoDataSource,
    RecoPreparator,
    RecoQuery,
    RecoServing,
)
