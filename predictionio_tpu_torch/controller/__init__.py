from predictionio_tpu_torch.controller.dase import (  # noqa: F401
    Algorithm,
    AverageServing,
    DataSource,
    FirstServing,
    IdentityPreparator,
    LAlgorithm,
    LDataSource,
    LPreparator,
    LServing,
    P2LAlgorithm,
    PAlgorithm,
    PDataSource,
    PersistentModel,
    PPreparator,
    Preparator,
    Serving,
)
from predictionio_tpu_torch.controller.engine import (  # noqa: F401
    Engine,
    EngineFactory,
    EngineParams,
)
from predictionio_tpu_torch.controller.evaluation import (  # noqa: F401
    AverageMetric,
    Evaluation,
    Metric,
    MetricEvaluator,
    MetricEvaluatorResult,
    OptionAverageMetric,
    SumMetric,
    ZeroMetric,
)
from predictionio_tpu_torch.controller.params import EmptyParams, Params  # noqa: F401
