from predictionio_tpu_torch.models.classification.engine import (  # noqa: F401
    ClassificationEngine,
    ClassificationQuery,
    ClassifiedResult,
    LogisticRegressionAlgorithm,
    NaiveBayesAlgorithm,
)
