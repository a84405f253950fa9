from predictionio_tpu_torch.models.text.engine import (  # noqa: F401
    TextClassificationEngine,
    TextQuery,
)
