from predictionio_tpu_torch.sdk.client import (  # noqa: F401
    AsyncResult,
    EngineClient,
    EventClient,
    EventPipeline,
    PIOError,
    QueryPipeline,
)
