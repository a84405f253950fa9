from predictionio_tpu_torch.models.universal_recommender.convert import (  # noqa: F401
    ur_model_from_state,
    ur_training_data_from_arrays,
)
from predictionio_tpu_torch.models.universal_recommender.engine import (  # noqa: F401
    URAlgorithm,
    URAlgorithmParams,
    URDataSource,
    URModel,
    URPreparator,
    URQuery,
    URResult,
    URTrainingData,
    UniversalRecommenderEngine,
)
