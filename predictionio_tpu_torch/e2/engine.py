"""Reusable engine helpers (reference: e2/src/main/scala/io/prediction/e2/engine/
— CategoricalNaiveBayes.scala, MarkovChain.scala, BinaryVectorizer.scala).

Counterpart of ``predictionio_tpu/e2/engine.py``: host-side count
aggregations in numpy, the JAX package's line for line; the Markov chain's
per-state top-k keeps ``lax.top_k``'s order (probability descending, the
lower state first among ties) through ``ops.topk.topk_desc``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.ops.topk import topk_desc


class BinaryVectorizer:
    """Maps (field, value) pairs to a fixed-width binary feature vector
    (reference: BinaryVectorizer.fromPropertyAndAttributeNames)."""

    def __init__(self, index: Dict[Tuple[str, str], int]):
        self.index = dict(index)

    @classmethod
    def fit(cls, rows: Sequence[Dict[str, str]], fields: Sequence[str]) -> "BinaryVectorizer":
        index: Dict[Tuple[str, str], int] = {}
        for row in rows:
            for f in fields:
                if f in row:
                    key = (f, str(row[f]))
                    if key not in index:
                        index[key] = len(index)
        return cls(index)

    @property
    def width(self) -> int:
        return len(self.index)

    def transform(self, row: Dict[str, str]) -> np.ndarray:
        v = np.zeros(self.width, np.float32)
        for f, val in row.items():
            j = self.index.get((f, str(val)))
            if j is not None:
                v[j] = 1.0
        return v

    def transform_many(self, rows: Sequence[Dict[str, str]]) -> np.ndarray:
        return np.stack([self.transform(r) for r in rows]) if rows else np.zeros((0, self.width), np.float32)


@dataclasses.dataclass
class CategoricalNBModel:
    labels: List[str]
    prior: np.ndarray                     # [C] log prior
    log_likelihood: List[np.ndarray]      # per feature: [C, cardinality_f]
    feature_values: List[Dict[str, int]]  # per feature: value -> column


class CategoricalNaiveBayes:
    """Naive Bayes over categorical string features (reference:
    CategoricalNaiveBayes.train on LabeledPoints of string features)."""

    @staticmethod
    def train(
        points: Sequence[Tuple[str, Sequence[str]]], alpha: float = 1.0
    ) -> CategoricalNBModel:
        if not points:
            raise ValueError("no labeled points")
        n_features = len(points[0][1])
        labels: List[str] = []
        label_of: Dict[str, int] = {}
        feature_values: List[Dict[str, int]] = [dict() for _ in range(n_features)]
        for label, feats in points:
            if len(feats) != n_features:
                raise ValueError("inconsistent feature arity")
            if label not in label_of:
                label_of[label] = len(labels)
                labels.append(label)
            for f, v in enumerate(feats):
                fv = feature_values[f]
                if str(v) not in fv:
                    fv[str(v)] = len(fv)
        y = np.asarray([label_of[l] for l, _ in points], np.int32)
        C = len(labels)
        counts = np.bincount(y, minlength=C).astype(np.float32)
        prior = np.log(counts / counts.sum())
        log_likelihood = []
        for f in range(n_features):
            card = len(feature_values[f])
            x = np.asarray([feature_values[f][str(feats[f])] for _, feats in points], np.int32)
            tab = np.zeros((C, card), np.float32)
            np.add.at(tab, (y, x), 1.0)
            tab += alpha
            log_likelihood.append(np.log(tab / tab.sum(axis=1, keepdims=True)))
        return CategoricalNBModel(labels, prior, log_likelihood, feature_values)

    @staticmethod
    def log_score(
        model: CategoricalNBModel,
        features: Sequence[str],
        default_likelihood=lambda ll: -math.inf,
    ) -> Optional[np.ndarray]:
        """Per-class log score; unseen feature values use default_likelihood
        (reference: logScore with defaultLikelihood)."""
        score = model.prior.copy()
        for f, v in enumerate(features):
            col = model.feature_values[f].get(str(v))
            if col is None:
                score += np.asarray([default_likelihood(model.log_likelihood[f][c])
                                     for c in range(len(model.labels))])
            else:
                score += model.log_likelihood[f][:, col]
        return score

    @staticmethod
    def predict(model: CategoricalNBModel, features: Sequence[str]) -> str:
        scores = CategoricalNaiveBayes.log_score(
            model, features, default_likelihood=lambda ll: float(ll.min()) - 1.0
        )
        return model.labels[int(np.argmax(scores))]


class MarkovChain:
    """First-order Markov chain over state transitions (reference:
    MarkovChain.train on a transition-count matrix, keeping top-K next
    states per state)."""

    def __init__(self, transition_prob: np.ndarray, top_k_idx: np.ndarray, top_k_prob: np.ndarray):
        self.transition_prob = transition_prob
        self.top_k_idx = top_k_idx
        self.top_k_prob = top_k_prob

    @classmethod
    def train(cls, transitions: Sequence[Tuple[int, int]], n_states: int, top_k: int = 10) -> "MarkovChain":
        counts = np.zeros((n_states, n_states), np.float32)
        for a, b in transitions:
            counts[a, b] += 1.0
        row = counts.sum(axis=1, keepdims=True)
        prob = counts / np.maximum(row, 1.0)
        k = min(top_k, n_states)
        p, i = topk_desc(torch.from_numpy(prob), k)
        return cls(prob, i.to(torch.int32).numpy(), p.numpy())

    def next_states(self, state: int) -> List[Tuple[int, float]]:
        return [
            (int(j), float(p))
            for j, p in zip(self.top_k_idx[state], self.top_k_prob[state])
            if p > 0
        ]
