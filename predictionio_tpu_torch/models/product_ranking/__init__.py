from predictionio_tpu_torch.models.product_ranking.engine import (  # noqa: F401
    PRQuery,
    ProductRankingEngine,
)
