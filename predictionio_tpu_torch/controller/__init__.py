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
from predictionio_tpu_torch.controller.params import EmptyParams, Params  # noqa: F401
