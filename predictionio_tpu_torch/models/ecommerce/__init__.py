from predictionio_tpu_torch.models.ecommerce.engine import (  # noqa: F401
    ECommAlgorithm,
    ECommAlgorithmParams,
    ECommerceEngine,
    ECommModel,
    ECommQuery,
)
