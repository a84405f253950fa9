"""Core base types (reference: core/src/main/scala/io/prediction/core/).

Counterpart of ``predictionio_tpu/core/base.py``.  The ``Base*`` abstract
classes carry the type plumbing between the workflow and the user-facing
controller API; ``Doer`` instantiates a component class with its
``Params``.  As in the JAX package there is one execution model, so the
reference's P/L component split collapses to a single variant.
"""

from __future__ import annotations

import abc
import inspect
from typing import Any, Generic, List, Optional, Sequence, Type, TypeVar

from predictionio_tpu_torch.controller.params import EmptyParams, Params

P = TypeVar("P", bound=Params)
TD = TypeVar("TD")   # training data
PD = TypeVar("PD")   # prepared data
M = TypeVar("M")     # model
Q = TypeVar("Q")     # query
PR = TypeVar("PR")   # prediction


class Doer(Generic[P]):
    """A component instantiated with its Params (reference: Doer.scala)."""

    params_class: Type[Params] = EmptyParams

    def __init__(self, params: Optional[Params] = None):
        if params is None or (
            type(params) is EmptyParams and self.params_class is not EmptyParams
        ):
            # EmptyParams stands for "use this component's defaults" — the
            # reference's EngineParams defaults every block to EmptyParams.
            params = self.params_class()
        self.params = params


class BaseDataSource(Doer[P], Generic[P, TD], abc.ABC):
    @abc.abstractmethod
    def read_training(self) -> TD: ...


class BasePreparator(Doer[P], Generic[P, TD, PD], abc.ABC):
    @abc.abstractmethod
    def prepare(self, training_data: TD) -> PD: ...


class BaseAlgorithm(Doer[P], Generic[P, PD, M, Q, PR], abc.ABC):
    @abc.abstractmethod
    def train(self, prepared_data: PD) -> M: ...

    @abc.abstractmethod
    def predict(self, model: M, query: Q) -> PR: ...

    #: True when batch_predict is safe to use for DEPLOY-TIME serving —
    #: i.e. it reads exactly the same state per query as predict().
    #: ``Engine.batch_predictor`` engages only when every algorithm sets it.
    serving_batchable: bool = False

    def batch_predict(self, model: M, queries: Sequence[Q]) -> List[PR]:
        """Vectorized predict (reference: PAlgorithm.batchPredict).
        Override for a one-launch batch path."""
        return [self.predict(model, q) for q in queries]


class BaseServing(Doer[P], Generic[P, Q, PR], abc.ABC):
    @abc.abstractmethod
    def serve(self, query: Q, predictions: Sequence[PR]) -> PR: ...


class BaseEngine(abc.ABC):
    @abc.abstractmethod
    def train(self, engine_params) -> Any: ...


def doer_name(obj: Any) -> str:
    cls = obj if inspect.isclass(obj) else type(obj)
    return f"{cls.__module__}.{cls.__qualname__}"
