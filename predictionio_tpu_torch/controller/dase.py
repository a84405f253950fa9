"""User-facing DASE component classes (reference: core/.../controller/).

Counterpart of ``predictionio_tpu/controller/dase.py``: the classes engine
templates subclass, ``IdentityPreparator``, ``AverageServing`` and the
reference's P/L naming aliases (``PAlgorithm``, ``LDataSource``, ...), so
a reference template maps onto this API name for name.
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
    """Reads training (and, through ``read_eval``, evaluation) data from the
    event store."""


class Preparator(BasePreparator):
    """Transforms TrainingData into the algorithm-ready PreparedData."""


class IdentityPreparator(Preparator):
    """Reference: IdentityPreparator / PIdentityPreparator."""

    def prepare(self, training_data):
        return training_data


class Algorithm(BaseAlgorithm):
    """train(prepared_data) -> model; predict(model, query) -> prediction."""


class Serving(BaseServing):
    """Combines/post-processes algorithm predictions for a query."""


class FirstServing(Serving):
    """Reference: FirstServing — returns the first algorithm's prediction."""

    def serve(self, query: Any, predictions: Sequence[Any]) -> Any:
        return predictions[0]


class AverageServing(Serving):
    """Reference: AverageServing — averages numeric predictions."""

    def serve(self, query: Any, predictions: Sequence[Any]) -> Any:
        return sum(predictions) / len(predictions)


class PersistentModel:
    """Models that manage their own persistence
    (reference: PersistentModel / PersistentModelLoader).

    The default pickles the whole object.  Device tensors cached on a model
    are not part of its pickled state (see ``models.common``).  ``load``
    reads the JAX package's pickles too (``workflow.persistence.loads``).
    """

    def save(self) -> bytes:
        return pickle.dumps(self)

    @classmethod
    def load(cls, blob: bytes) -> "PersistentModel":
        from predictionio_tpu_torch.workflow.persistence import loads

        obj = loads(blob)
        if not isinstance(obj, cls):
            raise TypeError(f"model blob holds {type(obj).__name__}, expected {cls.__name__}")
        return obj


# -- naming-parity aliases ---------------------------------------------------

PDataSource = DataSource
LDataSource = DataSource
PPreparator = Preparator
LPreparator = Preparator
PAlgorithm = Algorithm
LAlgorithm = Algorithm
P2LAlgorithm = Algorithm
LServing = Serving
