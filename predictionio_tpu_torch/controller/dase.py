"""User-facing DASE component classes (reference: core/.../controller/).

Counterpart of ``predictionio_tpu/controller/dase.py``: the classes engine
templates subclass.  The evaluation-only classes and the P/L naming
aliases wait for the slices that use them.
"""

from __future__ import annotations

import pickle
from typing import Any, Sequence

from predictionio_tpu_torch.core.base import (
    BaseAlgorithm,
    BaseDataSource,
    BasePreparator,
    BaseServing,
)


class DataSource(BaseDataSource):
    """Reads training data from the event store."""


class Preparator(BasePreparator):
    """Transforms TrainingData into the algorithm-ready PreparedData."""


class Algorithm(BaseAlgorithm):
    """train(prepared_data) -> model; predict(model, query) -> prediction."""


class Serving(BaseServing):
    """Combines/post-processes algorithm predictions for a query."""


class FirstServing(Serving):
    """Reference: FirstServing — returns the first algorithm's prediction."""

    def serve(self, query: Any, predictions: Sequence[Any]) -> Any:
        return predictions[0]


class PersistentModel:
    """Models that manage their own persistence
    (reference: PersistentModel / PersistentModelLoader).

    The default pickles the whole object.  Device tensors cached on a model
    are not part of its pickled state (see ``models.common``).
    """

    def save(self) -> bytes:
        return pickle.dumps(self)

    @classmethod
    def load(cls, blob: bytes) -> "PersistentModel":
        obj = pickle.loads(blob)
        if not isinstance(obj, cls):
            raise TypeError(f"model blob holds {type(obj).__name__}, expected {cls.__name__}")
        return obj
