from predictionio_tpu_torch.controller.dase import (  # noqa: F401
    Algorithm,
    DataSource,
    FirstServing,
    PersistentModel,
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
    EngineParamsGenerator,
    Evaluation,
    Metric,
    MetricEvaluator,
    MetricEvaluatorResult,
    OptionAverageMetric,
    SumMetric,
    ZeroMetric,
    params_grid,
)
from predictionio_tpu_torch.controller.params import EmptyParams, Params  # noqa: F401
