from predictionio_tpu_torch.models.similar_product.convert import (  # noqa: F401
    sp_model_from_state,
)
from predictionio_tpu_torch.models.similar_product.engine import (  # noqa: F401
    SimilarProductEngine,
    SimilarProductQuery,
    SPALSAlgorithm,
    SPALSParams,
    SPCooccurrenceAlgorithm,
    SPCooccurrenceParams,
    SPDataSourceParams,
    SPModel,
)
