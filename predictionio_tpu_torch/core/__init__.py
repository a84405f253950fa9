"""Core base types (counterpart of ``predictionio_tpu/core``)."""

from predictionio_tpu_torch.core.base import (  # noqa: F401
    BaseAlgorithm,
    BaseDataSource,
    BaseEngine,
    BaseEvaluator,
    BasePreparator,
    BaseServing,
    Doer,
)
