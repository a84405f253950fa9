"""Engine abstraction (reference: core/.../controller/Engine.scala).

Counterpart of ``predictionio_tpu/controller/engine.py``.  An ``Engine``
wires one DataSource, one Preparator, a named set of Algorithms, and one
Serving class.  ``EngineParams`` carries the per-component params (bound
from engine.json); ``EngineFactory`` is the user entry point named in
engine.json's ``engineFactory`` key.  Evaluation (``Engine.eval``) waits
for the slice that ports the evaluation workflow.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Type

from predictionio_tpu_torch.controller.params import EmptyParams, Params
from predictionio_tpu_torch.core.base import (
    BaseAlgorithm,
    BaseDataSource,
    BaseEngine,
    BasePreparator,
    BaseServing,
    doer_name,
)

#: fleet default for serving micro-batch size; engines tighten it via a
#: ``serve_batch_max`` class attribute
DEFAULT_SERVE_BATCH = 64


@dataclasses.dataclass
class EngineParams:
    """Per-component parameter bundle (reference: EngineParams in Engine.scala)."""

    data_source_params: Params = dataclasses.field(default_factory=EmptyParams)
    preparator_params: Params = dataclasses.field(default_factory=EmptyParams)
    algorithm_params_list: List[Tuple[str, Params]] = dataclasses.field(default_factory=list)
    serving_params: Params = dataclasses.field(default_factory=EmptyParams)


class Engine(BaseEngine):
    """DASE engine (reference: Engine.scala).

    ``algorithm_classes`` maps algorithm names (referenced from engine.json's
    ``algorithms[].name``) to BaseAlgorithm subclasses.
    """

    def __init__(
        self,
        data_source_class: Type[BaseDataSource],
        preparator_class: Type[BasePreparator],
        algorithm_classes: Dict[str, Type[BaseAlgorithm]],
        serving_class: Type[BaseServing],
    ):
        self.data_source_class = data_source_class
        self.preparator_class = preparator_class
        self.algorithm_classes = dict(algorithm_classes)
        self.serving_class = serving_class

    # -- component instantiation --------------------------------------------

    def make_components(
        self, engine_params: EngineParams
    ) -> Tuple[BaseDataSource, BasePreparator, List[BaseAlgorithm], BaseServing]:
        data_source = self.data_source_class(engine_params.data_source_params)
        preparator = self.preparator_class(engine_params.preparator_params)
        algorithms: List[BaseAlgorithm] = []
        for name, params in engine_params.algorithm_params_list or self._default_algo_list():
            if name not in self.algorithm_classes:
                raise ValueError(
                    f"unknown algorithm {name!r}; engine defines {sorted(self.algorithm_classes)}"
                )
            algorithms.append(self.algorithm_classes[name](params))
        serving = self.serving_class(engine_params.serving_params)
        return data_source, preparator, algorithms, serving

    def _default_algo_list(self) -> List[Tuple[str, Params]]:
        return [
            (name, cls.params_class())
            for name, cls in list(self.algorithm_classes.items())[:1]
        ]

    # -- train ---------------------------------------------------------------

    def train(self, engine_params: EngineParams) -> List[Any]:
        """Run D→P→A over all algorithms; returns the list of trained models
        (reference: Engine.train)."""
        data_source, preparator, algorithms, _ = self.make_components(engine_params)
        td = data_source.read_training()
        pd = preparator.prepare(td)
        return [algo.train(pd) for algo in algorithms]

    # -- serving -------------------------------------------------------------

    def predictor(
        self, engine_params: EngineParams, models: Sequence[Any]
    ) -> Callable[[Any], Any]:
        """The deploy-time query→prediction function (reference:
        CreateServer's ServerActor closing over (engine, models))."""
        return self.serving_bundle(engine_params, models)[0]

    def _serving_components(self, engine_params: EngineParams,
                            models: Sequence[Any]):
        """Shared deploy prologue: build components, validate the model
        count, and pre-stage serving state to the device (warm) so the
        first query never pays the host→device model transfer."""
        _, _, algorithms, serving = self.make_components(engine_params)
        if len(models) != len(algorithms):
            raise ValueError(
                f"{len(models)} model(s) for {len(algorithms)} algorithm(s)"
            )
        for algo, model in zip(algorithms, models):
            warm = getattr(algo, "warm", None)
            if warm is not None:
                warm(model)
        return algorithms, serving

    def batch_predictor(
        self, engine_params: EngineParams, models: Sequence[Any]
    ) -> Optional[Callable[[Sequence[Any]], List[Any]]]:
        """A queries→predictions function that scores a whole batch in one
        device launch per slice, or None when an algorithm has no
        serving-correct batch path (``serve_batch_predict`` or
        ``serving_batchable``)."""
        return self.serving_bundle(engine_params, models)[1]

    def serving_bundle(
        self, engine_params: EngineParams, models: Sequence[Any]
    ) -> Tuple[Callable[[Any], Any],
               Optional[Callable[[Sequence[Any]], List[Any]]]]:
        """(predict, predict_batch-or-None) built from ONE component
        construction + warm pass."""
        algorithms, serving = self._serving_components(engine_params, models)

        def predict(query: Any) -> Any:
            preds = [algo.predict(model, query)
                     for algo, model in zip(algorithms, models)]
            return serving.serve(query, preds)

        def batch_fn(algo):
            fn = getattr(algo, "serve_batch_predict", None)
            if fn is not None:
                return fn
            if getattr(algo, "serving_batchable", False):
                return algo.batch_predict
            return None

        fns = [batch_fn(a) for a in algorithms]
        if any(f is None for f in fns):
            return predict, None

        max_batch = min(
            (getattr(a, "serve_batch_max", DEFAULT_SERVE_BATCH)
             for a in algorithms), default=DEFAULT_SERVE_BATCH)

        def _run_slice(queries: Sequence[Any]) -> List[Any]:
            per_algo = []
            for fn, algo, model in zip(fns, algorithms, models):
                col = fn(model, queries)
                if len(col) != len(queries):
                    raise RuntimeError(
                        f"{type(algo).__name__}'s serving batch path "
                        f"returned {len(col)} results for {len(queries)} "
                        "queries — it must be 1:1")
                per_algo.append(col)
            return [serving.serve(q, [col[i] for col in per_algo])
                    for i, q in enumerate(queries)]

        def predict_batch(queries: Sequence[Any]) -> List[Any]:
            # the cap is enforced here, so any caller stays inside the
            # per-slice memory bound the engines declared
            out: List[Any] = []
            for s in range(0, len(queries), max_batch):
                out.extend(_run_slice(queries[s: s + max_batch]))
            return out

        predict_batch.max_batch = max_batch
        return predict, predict_batch

    # -- params binding (engine.json) ----------------------------------------

    def engine_params_from_variant(self, variant: Dict[str, Any]) -> EngineParams:
        """Bind an engine.json document to typed EngineParams (reference:
        WorkflowUtils/JsonExtractor)."""
        dsp = self.data_source_class.params_class.from_json(
            _params_block(variant.get("datasource"))
        )
        pp = self.preparator_class.params_class.from_json(
            _params_block(variant.get("preparator"))
        )
        algo_list: List[Tuple[str, Params]] = []
        for entry in variant.get("algorithms", []):
            name = entry.get("name")
            if name not in self.algorithm_classes:
                raise ValueError(
                    f"engine.json names unknown algorithm {name!r}; "
                    f"engine defines {sorted(self.algorithm_classes)}"
                )
            algo_list.append(
                (name, self.algorithm_classes[name].params_class.from_json(entry.get("params", {})))
            )
        sp = self.serving_class.params_class.from_json(_params_block(variant.get("serving")))
        return EngineParams(dsp, pp, algo_list, sp)


def _params_block(block: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    if block is None:
        return {}
    # engine.json wraps component params as {"params": {...}}; tolerate bare maps.
    if "params" in block and isinstance(block["params"], dict):
        return block["params"]
    return block


class EngineFactory:
    """User entry point named by engine.json's ``engineFactory``
    (reference: EngineFactory trait). Subclass and override ``apply``."""

    @classmethod
    def apply(cls) -> Engine:
        raise NotImplementedError

    @classmethod
    def engine_id(cls) -> str:
        return doer_name(cls)
