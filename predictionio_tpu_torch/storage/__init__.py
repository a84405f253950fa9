from predictionio_tpu_torch.storage.memory import (  # noqa: F401
    App,
    Event,
    MemStorage,
    get_storage,
    set_storage,
)
