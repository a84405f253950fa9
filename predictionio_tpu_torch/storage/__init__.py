from predictionio_tpu_torch.storage.base import (  # noqa: F401
    AccessKey,
    AccessKeys,
    App,
    Apps,
    Channel,
    Channels,
    EngineInstance,
    EngineInstances,
    EngineManifest,
    EngineManifests,
    EvaluationInstance,
    EvaluationInstances,
    LEvents,
    Models,
    PEvents,
)
from predictionio_tpu_torch.storage.locator import (  # noqa: F401
    Storage,
    StorageConfig,
    get_storage,
    set_storage,
)
