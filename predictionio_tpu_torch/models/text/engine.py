"""Text-classification engine template.

Counterpart of ``predictionio_tpu/models/text/engine.py`` (the reference
text classification template, tf-idf features + an MLlib classifier, plus
BASELINE.json config 5's embedding + MLP variant).

Training events (reference template's convention): one event per document —
  {"event": "train", "entityType": "content", "entityId": "...",
   "properties": {"text": "...", "label": "spam"}}

Wire format:
  query    {"text": "free pills now"}
  response {"label": "spam", "confidence": 0.93}

Algorithms: "nb" (hashed counts → multinomial NB; it serves on the host,
as the JAX one does), "logreg" (hashed tf-idf → L-BFGS logistic
regression) and "mlp" (embedding-bag MLP; its initial weights come from a
``torch.Generator``, see ``ops.text``), trained on the model's device; the
logreg and MLP models stage their weights to it once and serve a batch in
one pass.  The models' pickled state is the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

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
from predictionio_tpu_torch.models.common import DeviceCacheMixin, pad_batch_rows
from predictionio_tpu_torch.ops import logreg as lr_ops
from predictionio_tpu_torch.ops import naive_bayes as nb_ops
from predictionio_tpu_torch.ops import text as text_ops
from predictionio_tpu_torch.store.event_store import PEventStore


@dataclasses.dataclass
class TextQuery:
    text: str

    @classmethod
    def from_json(cls, d: Dict) -> "TextQuery":
        return cls(text=str(d["text"]))


@dataclasses.dataclass
class TextPrediction:
    label: str
    confidence: float

    def to_json(self) -> Dict:
        return {"label": self.label, "confidence": self.confidence}


@dataclasses.dataclass
class TextDSParams(Params):
    app_name: str = "default"
    event_name: str = "train"
    entity_type: str = "content"
    text_field: str = "text"
    label_field: str = "label"
    eval_k: int = 0
    seed: int = 3


@dataclasses.dataclass
class TextTrainingData:
    texts: List[str]
    y: np.ndarray
    labels: List[str]


class TextDataSource(DataSource):
    params_class = TextDSParams

    def read_training(self) -> TextTrainingData:
        texts: List[str] = []
        ys: List[int] = []
        labels: List[str] = []
        label_of: Dict[str, int] = {}

        def add(text, label) -> None:
            if text is None or label is None:
                return
            label = str(label)
            if label not in label_of:
                label_of[label] = len(labels)
                labels.append(label)
            texts.append(str(text))
            ys.append(label_of[label])

        batch = PEventStore.native_batch(
            self.params.app_name,
            event_names=[self.params.event_name],
            entity_type=self.params.entity_type,
        )
        pc = batch.prop_columns if batch is not None else None
        if pc is not None:
            # native-scan path: both feature columns straight off the C++
            # parser, aligned on rows that carry both properties
            tcol = pc.get(self.params.text_field)
            lcol = pc.get(self.params.label_field)
            if tcol is not None and lcol is not None:
                _, ti, li = np.intersect1d(
                    tcol.rows, lcol.rows, return_indices=True)
                for tj, lj in zip(ti, li):
                    add(tcol.value_at(int(tj)), lcol.value_at(int(lj)))
        else:
            # row-object fallback (memory/SQL backends) — the ONLY read
            for e in PEventStore.find(
                self.params.app_name,
                event_names=[self.params.event_name],
                entity_type=self.params.entity_type,
            ):
                add(e.properties.get(self.params.text_field),
                    e.properties.get(self.params.label_field))
        if not texts:
            raise ValueError(
                f"no {self.params.event_name!r} events with "
                f"'{self.params.text_field}'/'{self.params.label_field}' properties"
            )
        return TextTrainingData(texts=texts, y=np.asarray(ys, np.int32), labels=labels)

    def read_eval(self):
        data = self.read_training()
        k = self.params.eval_k
        if k <= 1:
            return []
        rng = np.random.default_rng(self.params.seed)
        fold_of = rng.integers(0, k, size=len(data.y))
        folds = []
        for f in range(k):
            tr = fold_of != f
            td = TextTrainingData(
                [t for t, m in zip(data.texts, tr) if m], data.y[tr], data.labels
            )
            qa = [
                (TextQuery(data.texts[i]), data.labels[int(data.y[i])])
                for i in np.nonzero(~tr)[0]
            ]
            folds.append((td, {"fold": f}, qa))
        return folds


class TextPreparator(Preparator):
    def prepare(self, td: TextTrainingData) -> TextTrainingData:
        return td


class TextModel(DeviceCacheMixin, PersistentModel):
    def __init__(self, kind: str, labels: List[str], dim: int, payload: dict, device=None):
        self.kind = kind
        self.labels = labels
        self.dim = dim
        self.payload = payload
        self.to_device(device)

    def __getstate__(self):
        return {k: v for k, v in self.__dict__.items() if not k.startswith("_")}

    def __setstate__(self, state):
        self.__dict__.update(state)

    def tensors_device(self, key: str) -> Tuple[torch.Tensor, ...]:
        """``payload[key]`` (one array or a tuple of them) on the model's
        device, staged once."""
        def build():
            v = self.payload[key]
            items = v if isinstance(v, (tuple, list)) else (v,)
            return tuple(torch.tensor(np.asarray(a), device=self.device) for a in items)

        return self._device(f"_{key}_dev", build)


@dataclasses.dataclass
class TextNBParams(Params):
    dim: int = 4096
    alpha: float = 1.0


class TextNBAlgorithm(Algorithm):
    params_class = TextNBParams
    # not serving_batchable: batch_predict is a per-query loop, so the
    # micro-batcher would add coordination overhead with no amortization

    def train(self, td: TextTrainingData) -> TextModel:
        device = resolve_device(self.device)
        counts = text_ops.hashing_vectorize(td.texts, self.params.dim)
        inner = nb_ops.multinomial_nb_train(counts, td.y, len(td.labels), self.params.alpha,
                                            device=device)
        return TextModel("nb", td.labels, self.params.dim, {"inner": inner}, device=device)

    def predict(self, model: TextModel, query: TextQuery) -> TextPrediction:
        counts = text_ops.hashing_vectorize([query.text], model.dim)
        inner = model.payload["inner"]
        scores = model.payload["inner"].class_log_prior + counts @ inner.feature_log_prob.T
        probs = _softmax(scores[0])
        j = int(np.argmax(probs))
        return TextPrediction(model.labels[j], float(probs[j]))

    def batch_predict(self, model: TextModel, queries: Sequence[TextQuery]):
        return [self.predict(model, q) for q in queries]


@dataclasses.dataclass
class TextLogRegParams(Params):
    dim: int = 4096
    iterations: int = 60
    l2: float = 1e-5


class TextLogRegAlgorithm(Algorithm):
    params_class = TextLogRegParams
    serving_batchable = True   # batch_predict reads only model state

    def train(self, td: TextTrainingData) -> TextModel:
        device = resolve_device(self.device)
        counts = text_ops.hashing_vectorize(td.texts, self.params.dim)
        x, idf = text_ops.tfidf_transform(counts, device=device)
        w, b = lr_ops.logreg_train(
            x, td.y, n_classes=len(td.labels),
            l2=self.params.l2, iterations=self.params.iterations, device=device,
        )
        return TextModel("logreg", td.labels, self.params.dim, {"w": w, "b": b, "idf": idf},
                         device=device)

    def predict(self, model: TextModel, query: TextQuery) -> TextPrediction:
        return self.batch_predict(model, [query])[0]

    def batch_predict(self, model: TextModel, queries: Sequence[TextQuery]):
        if not queries:
            return []
        counts = text_ops.hashing_vectorize([q.text for q in queries], model.dim)
        counts = pad_batch_rows(counts)   # pow2-bucket the batch dim
        (w,), (b,), (idf,) = (model.tensors_device(k) for k in ("w", "b", "idf"))
        x, _ = text_ops.tfidf_transform_tensor(torch.as_tensor(counts).to(model.device), idf)
        probs = lr_ops.logreg_predict_proba(w, b, x)[:len(queries)].cpu().numpy()
        out = []
        for row in probs:
            j = int(np.argmax(row))
            out.append(TextPrediction(model.labels[j], float(row[j])))
        return out


@dataclasses.dataclass
class TextMLPParams(Params):
    vocab_size: int = 8192
    max_len: int = 64
    embed_dim: int = 32
    hidden_dim: int = 64
    iterations: int = 150
    learning_rate: float = 0.02
    seed: int = 0


class TextMLPAlgorithm(Algorithm):
    params_class = TextMLPParams
    serving_batchable = True   # batch_predict reads only model state

    def train(self, td: TextTrainingData) -> TextModel:
        device = resolve_device(self.device)
        p = self.params
        ids, mask = text_ops.tokens_to_ids(td.texts, p.vocab_size, p.max_len)
        params = text_ops.mlp_train(
            ids, mask, td.y, n_classes=len(td.labels), vocab_size=p.vocab_size,
            embed_dim=p.embed_dim, hidden_dim=p.hidden_dim,
            iterations=p.iterations, learning_rate=p.learning_rate, seed=p.seed,
            device=device,
        )
        return TextModel("mlp", td.labels, p.vocab_size,
                         {"params": params, "max_len": p.max_len}, device=device)

    def predict(self, model: TextModel, query: TextQuery) -> TextPrediction:
        return self.batch_predict(model, [query])[0]

    def batch_predict(self, model: TextModel, queries: Sequence[TextQuery]):
        if not queries:
            return []
        ids, mask = text_ops.tokens_to_ids(
            [q.text for q in queries], model.dim, model.payload["max_len"]
        )
        dev = model.device
        ids = torch.as_tensor(pad_batch_rows(ids)).to(dev)    # pow2-bucket the batch dim
        mask = torch.as_tensor(pad_batch_rows(mask)).to(dev)
        logits = text_ops.mlp_predict_logits(
            model.tensors_device("params"), ids, mask)[:len(queries)].cpu().numpy()
        out = []
        for row in logits:
            probs = _softmax(row)
            j = int(np.argmax(probs))
            out.append(TextPrediction(model.labels[j], float(probs[j])))
        return out


def _softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - np.max(x))
    return e / e.sum()


class TextClassificationEngine(EngineFactory):
    @classmethod
    def apply(cls) -> Engine:
        return Engine(
            data_source_class=TextDataSource,
            preparator_class=TextPreparator,
            algorithm_classes={
                "nb": TextNBAlgorithm,
                "logreg": TextLogRegAlgorithm,
                "mlp": TextMLPAlgorithm,
            },
            serving_class=FirstServing,
        )

    query_class = TextQuery
