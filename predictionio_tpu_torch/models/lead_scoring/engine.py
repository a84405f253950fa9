"""Lead Scoring engine template.

Counterpart of ``predictionio_tpu/models/lead_scoring/engine.py`` (the
reference Lead Scoring template, PredictionIO 0.9.x gallery: how likely a
visit session converts to a purchase, from its first view's landing page,
referrer and browser; ``view`` events sessionized by sessionId, a session
converted when a ``buy`` shares it).

The attributes are dictionary-encoded and train the gather-based binary
logistic regression on the device (``ops.logreg.logreg_gather_train``:
Adam, the one-hot design matrix never built).  Serving is host-only, as in
the reference: a 3-element gather from the weight tables, which are the
model.

Wire format (reference template):
  query    {"landingPageId": "/sale", "referrerId": "google", "browser": "Chrome"}
  response {"score": 0.72}
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from predictionio_tpu_torch.controller import (
    Algorithm,
    DataSource,
    Engine,
    EngineFactory,
    FirstServing,
    Params,
    PersistentModel,
    Preparator,
)
from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.ops import logreg as logreg_ops
from predictionio_tpu_torch.store.columnar import IdDict
from predictionio_tpu_torch.store.event_store import PEventStore

ATTRS = ("landingPageId", "referrerId", "browser")


@dataclasses.dataclass
class LSQuery:
    landing_page_id: str
    referrer_id: str
    browser: str

    @classmethod
    def from_json(cls, d: Dict) -> "LSQuery":
        return cls(
            landing_page_id=str(d.get("landingPageId", "")),
            referrer_id=str(d.get("referrerId", "")),
            browser=str(d.get("browser", "")),
        )

    def values(self) -> List[str]:
        return [self.landing_page_id, self.referrer_id, self.browser]


@dataclasses.dataclass
class LSResult:
    score: float

    def to_json(self) -> Dict:
        return {"score": self.score}


@dataclasses.dataclass
class LSDataSourceParams(Params):
    app_name: str = "default"
    view_event: str = "view"
    buy_event: str = "buy"
    session_property: str = "sessionId"


@dataclasses.dataclass
class LSTrainingData:
    # attr_idx[a][s] = dictionary id of attribute a for session s (-1 none)
    attr_idx: np.ndarray      # int32 [n_attrs, n_sessions]
    converted: np.ndarray     # bool [n_sessions]
    attr_dicts: List[IdDict]


class LSDataSource(DataSource):
    """Sessionizes view events by the sessionId property (FIRST view of a
    session defines its attributes, reference semantics) and labels
    sessions converted when any buy event shares the sessionId.

    Reads Event objects (properties needed per event); session datasets
    are orders of magnitude smaller than interaction logs, so the
    columnar fast path is not required here."""

    params_class = LSDataSourceParams

    def read_training(self) -> LSTrainingData:
        events = sorted(
            PEventStore.find(
                self.params.app_name,
                event_names=[self.params.view_event, self.params.buy_event]),
            key=lambda e: e.event_time)   # first view wins, deterministically
        sessions: Dict[str, int] = {}
        first_attrs: List[List[str]] = []
        converted_set = set()
        for e in events:
            sid = e.properties.get(self.params.session_property)
            if sid is None:
                continue
            sid = str(sid)
            if e.event == self.params.view_event:
                if sid not in sessions:
                    sessions[sid] = len(first_attrs)
                    first_attrs.append(
                        [str(e.properties.get(a) or "") for a in ATTRS])
            else:
                converted_set.add(sid)
        n_sessions = len(first_attrs)
        attr_dicts = [IdDict() for _ in ATTRS]
        attr_idx = np.full((len(ATTRS), n_sessions), -1, np.int32)
        for s, vals in enumerate(first_attrs):
            for a, v in enumerate(vals):
                if v:
                    attr_idx[a, s] = attr_dicts[a].add(v)
        converted = np.zeros(n_sessions, bool)
        for sid, s in sessions.items():
            if sid in converted_set:
                converted[s] = True
        return LSTrainingData(attr_idx, converted, attr_dicts)


class LSPreparator(Preparator):
    def prepare(self, td: LSTrainingData) -> LSTrainingData:
        return td


@dataclasses.dataclass
class LSAlgorithmParams(Params):
    iterations: int = 200
    l2: float = 1e-3


class LSModel(PersistentModel):
    """Per-attribute weight tables + bias: score = σ(Σ_a w_a[id_a] + b).
    Serving is a 3-element gather on host arrays, no device."""

    def __init__(self, attr_weights: List[np.ndarray], bias: float,
                 attr_dicts: List[IdDict], base_rate: float):
        self.attr_weights = attr_weights
        self.bias = bias
        self.attr_dicts = attr_dicts
        self.base_rate = base_rate

    def __getstate__(self):
        return {"w": self.attr_weights, "b": self.bias,
                "dicts": [d.to_state() for d in self.attr_dicts],
                "base": self.base_rate}

    def __setstate__(self, s):
        self.attr_weights = s["w"]
        self.bias = s["b"]
        self.attr_dicts = [IdDict.from_state(d) for d in s["dicts"]]
        self.base_rate = s["base"]


class LSAlgorithm(Algorithm):
    params_class = LSAlgorithmParams
    # not serving_batchable: predict is a handful of host scalar lookups
    # (no device launch or readback to amortize)

    def train(self, td: LSTrainingData) -> LSModel:
        n_sessions = td.attr_idx.shape[1]
        dims = [max(len(d), 1) for d in td.attr_dicts]
        if n_sessions == 0:
            return LSModel([np.zeros(d, np.float32) for d in dims], 0.0,
                           td.attr_dicts, 0.0)
        y = td.converted.astype(np.float32)
        # embedding-gather logreg: never materializes the one-hot design
        # matrix (attribute cardinality × sessions would blow host memory)
        attr_weights, bias = logreg_ops.logreg_gather_train(
            td.attr_idx, dims, y, l2=self.params.l2,
            iterations=self.params.iterations, device=resolve_device(self.device))
        return LSModel(attr_weights, bias, td.attr_dicts, float(y.mean()))

    def predict(self, model: LSModel, query: LSQuery) -> LSResult:
        z = model.bias
        known_any = False
        for a, v in enumerate(query.values()):
            if a >= len(model.attr_dicts) or not v:
                continue
            i = model.attr_dicts[a].id(v)
            if i is not None and i < len(model.attr_weights[a]):
                z += float(model.attr_weights[a][i])
                known_any = True
        if not known_any:
            # reference: unseen attribute combos fall back to the overall
            # conversion rate rather than a half-trained logit
            return LSResult(model.base_rate)
        return LSResult(float(1.0 / (1.0 + np.exp(-z))))


class LeadScoringEngine(EngineFactory):
    @classmethod
    def apply(cls) -> Engine:
        return Engine(
            data_source_class=LSDataSource,
            preparator_class=LSPreparator,
            algorithm_classes={"logreg": LSAlgorithm},
            serving_class=FirstServing,
        )

    query_class = LSQuery
