"""Classification engine template.

Counterpart of ``predictionio_tpu/models/classification/engine.py`` (the
reference Classification template: the data source reads per-entity
``$set`` properties "attr0..attrN" + "label" through
``PEventStore.aggregate_properties``; algorithms: MLlib
LogisticRegressionWithLBFGS and NaiveBayes).  Logistic regression trains
on the model's device with ``ops.logreg`` (L-BFGS by default, optax's
algorithm step for step, or Adam); naive Bayes fits by segment sums
(``ops.naive_bayes``).  A model's weights are staged to its device once
and a query or a micro-batch is one product and one readback.  The models'
pickled state is the JAX package's.

Wire format (reference template):
  query    {"attr0": 2.0, "attr1": 0.0, "attr2": 1.0}   (by attribute name)
  response {"label": "spam"}
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from predictionio_tpu_torch.controller import (
    Algorithm,
    DataSource,
    Engine,
    EngineFactory,
    FirstServing,
    Params,
    Preparator,
)
from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.models.common import DeviceCacheMixin
from predictionio_tpu_torch.models.common import pad_batch_rows as _pad_batch
from predictionio_tpu_torch.ops import logreg as lr_ops
from predictionio_tpu_torch.ops import naive_bayes as nb_ops
from predictionio_tpu_torch.ops.cco import ROADMAP_MESH
from predictionio_tpu_torch.store.event_store import PEventStore


@dataclasses.dataclass
class ClassificationQuery:
    features: Dict[str, float]

    @classmethod
    def from_json(cls, d: Dict) -> "ClassificationQuery":
        return cls(features={k: float(v) for k, v in d.items()})


@dataclasses.dataclass
class ClassifiedResult:
    label: str

    def to_json(self) -> Dict:
        return {"label": self.label}


@dataclasses.dataclass
class ClassificationDSParams(Params):
    app_name: str = "default"
    entity_type: str = "user"
    attributes: List[str] = dataclasses.field(
        default_factory=lambda: ["attr0", "attr1", "attr2"]
    )
    label: str = "label"
    eval_k: int = 0
    seed: int = 3


@dataclasses.dataclass
class LabeledData:
    x: np.ndarray              # [n, d] float32
    y: np.ndarray              # [n] int32
    labels: List[str]          # class id -> label string
    attributes: List[str]


class ClassificationDataSource(DataSource):
    params_class = ClassificationDSParams

    def read_training(self) -> LabeledData:
        props = PEventStore.aggregate_properties(
            self.params.app_name, self.params.entity_type
        )
        attrs = list(self.params.attributes)
        labels: List[str] = []
        label_of: Dict[str, int] = {}
        rows, ys = [], []
        for _entity, pm in sorted(props.items()):
            if self.params.label not in pm:
                continue
            try:
                row = [float(pm.get_as(a, float)) for a in attrs]
            except (KeyError, TypeError):
                continue
            lab = str(pm[self.params.label])
            if lab not in label_of:
                label_of[lab] = len(labels)
                labels.append(lab)
            rows.append(row)
            ys.append(label_of[lab])
        if not rows:
            raise ValueError(
                f"no labeled '{self.params.entity_type}' entities with attributes "
                f"{attrs} + '{self.params.label}' in app {self.params.app_name!r}"
            )
        return LabeledData(
            x=np.asarray(rows, np.float32),
            y=np.asarray(ys, np.int32),
            labels=labels,
            attributes=attrs,
        )

    def read_eval(self):
        data = self.read_training()
        k = self.params.eval_k
        if k <= 1:
            return []
        rng = np.random.default_rng(self.params.seed)
        fold_of = rng.integers(0, k, size=len(data.y))
        folds = []
        for f in range(k):
            tr, te = fold_of != f, fold_of == f
            td = LabeledData(data.x[tr], data.y[tr], data.labels, data.attributes)
            qa = [
                (
                    ClassificationQuery(dict(zip(data.attributes, data.x[i].tolist()))),
                    data.labels[int(data.y[i])],
                )
                for i in np.nonzero(te)[0]
            ]
            folds.append((td, {"fold": f}, qa))
        return folds


class ClassificationPreparator(Preparator):
    def prepare(self, td: LabeledData) -> LabeledData:
        return td


class _ClassifierModelBase(DeviceCacheMixin):
    """Labels and attribute names; the pickled state is the public
    attributes (the JAX model's ``__dict__``), never a staged tensor."""

    def __init__(self, labels: List[str], attributes: List[str], device=None):
        self.labels = labels
        self.attributes = attributes
        self.to_device(device)

    def __getstate__(self):
        return {k: v for k, v in self.__dict__.items() if not k.startswith("_")}

    def __setstate__(self, state):
        self.__dict__.update(state)

    def featurize(self, query: ClassificationQuery) -> np.ndarray:
        return np.asarray(
            [[float(query.features.get(a, 0.0)) for a in self.attributes]], np.float32
        )

    def _stage(self, attr: str, host) -> torch.Tensor:
        return self._device(attr, lambda: torch.tensor(
            np.asarray(host, np.float32), device=self.device))

    def features_device(self, queries: Sequence[ClassificationQuery]) -> torch.Tensor:
        """The queries' feature rows, the batch padded to a power of two."""
        x = _pad_batch(np.concatenate([self.featurize(q) for q in queries]))
        return torch.as_tensor(x).to(self.device)


class LogRegModel(_ClassifierModelBase):
    def __init__(self, w, b, labels, attributes, device=None):
        super().__init__(labels, attributes, device)
        self.w = w
        self.b = b

    def weights_device(self):
        return self._stage("_w_dev", self.w), self._stage("_b_dev", self.b)

    def warm(self) -> None:
        self.weights_device()


@dataclasses.dataclass
class LogRegParams(Params):
    iterations: int = 100
    l2: float = 1e-4
    optimizer: str = "lbfgs"
    learning_rate: float = 0.1
    mesh_dp: int = 0        # 0 or 1: the one card; above 1 is not ported


class LogisticRegressionAlgorithm(Algorithm):
    params_class = LogRegParams
    serving_batchable = True   # batch_predict reads only model state

    def train(self, td: LabeledData) -> LogRegModel:
        device = resolve_device(self.device)
        if self.params.mesh_dp > 1:
            raise NotImplementedError(f"mesh_dp={self.params.mesh_dp}: {ROADMAP_MESH}")
        w, b = lr_ops.logreg_train(
            td.x, td.y, n_classes=len(td.labels),
            l2=self.params.l2, iterations=self.params.iterations,
            optimizer=self.params.optimizer, learning_rate=self.params.learning_rate,
            device=device,
        )
        return LogRegModel(w, b, td.labels, td.attributes, device=device)

    def warm(self, model: LogRegModel) -> None:
        model.warm()

    def predict(self, model: LogRegModel, query: ClassificationQuery) -> ClassifiedResult:
        return self.batch_predict(model, [query])[0]

    def batch_predict(self, model: LogRegModel, queries: Sequence[ClassificationQuery]):
        if not queries:
            return []
        preds = lr_ops.logreg_predict(*model.weights_device(), model.features_device(queries))
        return [ClassifiedResult(label=model.labels[int(p)])
                for p in preds[:len(queries)]]


class NBModel(_ClassifierModelBase):
    def __init__(self, inner, labels, attributes, device=None):
        super().__init__(labels, attributes, device)
        self.inner = inner

    def scores(self, x: torch.Tensor) -> torch.Tensor:
        """[n, C] class scores of feature rows on the model's device."""
        m = self.inner
        if isinstance(m, nb_ops.GaussianNBModel):
            return nb_ops.gaussian_nb_scores(
                self._stage("_prior_dev", m.class_log_prior), self._stage("_mean_dev", m.mean),
                self._stage("_var_dev", m.var), x)
        return nb_ops.multinomial_nb_scores(
            self._stage("_prior_dev", m.class_log_prior),
            self._stage("_logp_dev", m.feature_log_prob), x)


@dataclasses.dataclass
class NaiveBayesParams(Params):
    model_type: str = "gaussian"  # gaussian | multinomial
    alpha: float = 1.0            # multinomial smoothing (reference: lambda)


class NaiveBayesAlgorithm(Algorithm):
    params_class = NaiveBayesParams
    serving_batchable = True   # batch_predict reads only model state

    def train(self, td: LabeledData) -> NBModel:
        device = resolve_device(self.device)
        if self.params.model_type == "gaussian":
            inner = nb_ops.gaussian_nb_train(td.x, td.y, len(td.labels), device=device)
        elif self.params.model_type == "multinomial":
            inner = nb_ops.multinomial_nb_train(td.x, td.y, len(td.labels), self.params.alpha,
                                                device=device)
        else:
            raise ValueError(f"unknown model_type {self.params.model_type!r}")
        return NBModel(inner, td.labels, td.attributes, device=device)

    def predict(self, model: NBModel, query: ClassificationQuery) -> ClassifiedResult:
        return self.batch_predict(model, [query])[0]

    def batch_predict(self, model: NBModel, queries: Sequence[ClassificationQuery]):
        if not queries:
            return []
        preds = torch.argmax(model.scores(model.features_device(queries)), dim=-1).cpu().numpy()
        return [ClassifiedResult(label=model.labels[int(p)])
                for p in preds[:len(queries)]]


class ClassificationEngine(EngineFactory):
    @classmethod
    def apply(cls) -> Engine:
        return Engine(
            data_source_class=ClassificationDataSource,
            preparator_class=ClassificationPreparator,
            algorithm_classes={
                "logreg": LogisticRegressionAlgorithm,
                "naivebayes": NaiveBayesAlgorithm,
            },
            serving_class=FirstServing,
        )

    query_class = ClassificationQuery
