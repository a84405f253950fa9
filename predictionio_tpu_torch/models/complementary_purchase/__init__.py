from predictionio_tpu_torch.models.complementary_purchase.engine import (  # noqa: F401
    ComplementaryPurchaseEngine,
    CPQuery,
)
