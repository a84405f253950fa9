"""Product Ranking engine template.

Counterpart of ``predictionio_tpu/models/product_ranking/engine.py`` (the
reference Product Ranking template, PredictionIO 0.9.x gallery: rank a
query-provided item list for a user with ALS scores; when the user or
every item is unknown the original order comes back with ``isOriginal:
true``).

Training is implicit-feedback ALS (``ops.als.als_train`` with
``implicit=True``; interaction counts are the confidences) on the model's
device.  Serving gathers only the queried items' factors on the device:
score = x_u · Y[ids] for the handful of queried ids, one [W] readback a
query (``serve_batch_predict``: one [B, W] readback a micro-batch), never
an [n_items] pass.  The model's state dict is the JAX package's.

Wire format (reference template):
  query    {"user": "u1", "items": ["i3", "i1", "i9"]}
  response {"itemScores": [...], "isOriginal": false}
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

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
from predictionio_tpu_torch.models.common import DeviceCacheMixin, reindex_interactions
from predictionio_tpu_torch.models.recommendation.engine import ItemScore
from predictionio_tpu_torch.ops import als as als_ops
from predictionio_tpu_torch.parallel.distributed import process_count
from predictionio_tpu_torch.parallel.mesh import MeshSpec, create_mesh
from predictionio_tpu_torch.store.columnar import IdDict
from predictionio_tpu_torch.store.event_store import PEventStore


@dataclasses.dataclass
class PRQuery:
    user: str
    items: List[str]

    @classmethod
    def from_json(cls, d: Dict) -> "PRQuery":
        return cls(user=str(d["user"]), items=[str(i) for i in d["items"]])


@dataclasses.dataclass
class PRResult:
    item_scores: List[ItemScore]
    is_original: bool

    def to_json(self) -> Dict:
        return {"itemScores": [s.to_json() for s in self.item_scores],
                "isOriginal": self.is_original}


@dataclasses.dataclass
class PRDataSourceParams(Params):
    app_name: str = "default"
    event_names: List[str] = dataclasses.field(default_factory=lambda: ["view", "buy"])


@dataclasses.dataclass
class PRTrainingData:
    user_idx: np.ndarray
    item_idx: np.ndarray
    user_dict: IdDict
    item_dict: IdDict


class PRDataSource(DataSource):
    params_class = PRDataSourceParams

    def read_training(self) -> PRTrainingData:
        batch = PEventStore.batch(
            self.params.app_name, event_names=list(self.params.event_names))
        user_idx, item_idx, user_dict, item_dict = reindex_interactions(batch)
        return PRTrainingData(user_idx=user_idx, item_idx=item_idx,
                              user_dict=user_dict, item_dict=item_dict)


class PRPreparator(Preparator):
    def prepare(self, td: PRTrainingData) -> PRTrainingData:
        return td


@dataclasses.dataclass
class PRAlgorithmParams(Params):
    rank: int = 10
    num_iterations: int = 10
    lambda_: float = 0.01
    alpha: float = 1.0
    seed: int = 7
    mesh_dp: int = 0        # 0 = one shard a rank


class PRModel(DeviceCacheMixin, PersistentModel):
    """User and item factors + id dictionaries; the factors are staged to
    the model's device once (``warm``)."""

    def __init__(self, user_factors, item_factors, user_dict, item_dict, device=None):
        self.user_factors = user_factors
        self.item_factors = item_factors
        self.user_dict = user_dict
        self.item_dict = item_dict
        self.to_device(device)

    def __getstate__(self):
        return {"X": self.user_factors, "Y": self.item_factors,
                "users": self.user_dict.to_state(),
                "items": self.item_dict.to_state()}

    def __setstate__(self, s):
        self.user_factors = s["X"]
        self.item_factors = s["Y"]
        self.user_dict = IdDict.from_state(s["users"])
        self.item_dict = IdDict.from_state(s["items"])

    def _stage(self, attr: str, host) -> torch.Tensor:
        return self._device(attr, lambda: torch.tensor(
            np.asarray(host, np.float32), device=self.device))

    def item_factors_device(self) -> torch.Tensor:
        return self._stage("_y_dev", self.item_factors)

    def user_factors_device(self) -> torch.Tensor:
        return self._stage("_x_dev", self.user_factors)

    def warm(self) -> None:
        if len(self.item_factors):
            self.item_factors_device()
            self.user_factors_device()


def _rank_scores(user_vec: torch.Tensor, item_factors: torch.Tensor,
                 ids: torch.Tensor) -> torch.Tensor:
    """Scores of ONLY the queried ids (a gather of a few factor rows);
    -1 padding scores -inf."""
    valid = ids >= 0
    y = item_factors[torch.where(valid, ids, 0)]
    return torch.where(valid, y @ user_vec, float("-inf"))


def _rank_scores_batch(user_vecs: torch.Tensor, item_factors: torch.Tensor,
                       ids: torch.Tensor) -> torch.Tensor:
    """Batched ``_rank_scores``: [B, W] id rows x [B, K] user vectors ->
    [B, W] scores in one gather and one batched product."""
    valid = ids >= 0
    y = item_factors[torch.where(valid, ids, 0)]           # [B, W, K]
    s = torch.bmm(y, user_vecs[:, :, None])[:, :, 0]
    return torch.where(valid, s, float("-inf"))


def _unrankable(model: PRModel, uid, known) -> bool:
    return (uid is None or len(model.item_factors) == 0
            or all(iid is None for _, iid in known))


def _ranked(known, scores) -> PRResult:
    """Known items by score, descending (stable: ties keep the query's
    order); unknown items sink to the bottom with score 0, as the
    reference ranks only known items and appends the rest."""
    ranked = sorted(
        ((name, float(s) if np.isfinite(s) else None)
         for (name, _), s in zip(known, scores)),
        key=lambda t: (t[1] is None, -(t[1] or 0.0)))
    return PRResult([ItemScore(n, s if s is not None else 0.0) for n, s in ranked],
                    is_original=False)


class PRAlgorithm(Algorithm):
    params_class = PRAlgorithmParams

    def train(self, td: PRTrainingData) -> PRModel:
        device = resolve_device(self.device)
        n_users, n_items = len(td.user_dict), len(td.item_dict)
        rank = self.params.rank
        if n_users == 0 or n_items == 0:
            return PRModel(np.zeros((0, rank), np.float32), np.zeros((0, rank), np.float32),
                           td.user_dict, td.item_dict, device=device)
        # implicit: interaction counts as confidences (trainImplicit)
        cell = td.user_idx.astype(np.int64) * n_items + td.item_idx
        uniq, counts = np.unique(cell, return_counts=True)
        users = (uniq // n_items).astype(np.int32)
        items = (uniq % n_items).astype(np.int32)
        dp = self.params.mesh_dp or process_count()
        mesh = create_mesh(MeshSpec(dp=dp, mp=1)) if dp > 1 else None
        data = als_ops.prepare_als_data(
            users, items, counts.astype(np.float32), n_users, n_items, dp=dp)
        X, Y = als_ops.als_train(
            data, k=rank, reg=self.params.lambda_, iterations=self.params.num_iterations,
            mesh=mesh, seed=self.params.seed, implicit=True, alpha=self.params.alpha, device=device)
        return PRModel(X, Y, td.user_dict, td.item_dict, device=device)

    def warm(self, model: PRModel) -> None:
        model.warm()

    def predict(self, model: PRModel, query: PRQuery) -> PRResult:
        uid = model.user_dict.id(query.user)
        known = [(i, model.item_dict.id(i)) for i in query.items]
        if _unrankable(model, uid, known):
            # reference semantics: cannot rank -> original order, marked
            return PRResult([ItemScore(i, 0.0) for i in query.items], is_original=True)
        ids = als_ops.pad_ids([iid if iid is not None else -1 for _, iid in known])
        dev = model.device
        scores = _rank_scores(model.user_factors_device()[uid], model.item_factors_device(),
                              torch.as_tensor(ids, dtype=torch.int64).to(dev))
        return _ranked(known, scores.cpu().numpy()[: len(known)])

    def serve_batch_predict(self, model: PRModel, queries) -> List[PRResult]:
        """Micro-batch serving: every rankable query's gathered scores in
        one device program and one [B, W] readback; unrankable queries
        answer on the host in original order, as ``predict`` does."""
        results: List[Optional[PRResult]] = [None] * len(queries)
        live, knowns, uids = [], [], []
        for qi, query in enumerate(queries):
            uid = model.user_dict.id(query.user)
            known = [(i, model.item_dict.id(i)) for i in query.items]
            if _unrankable(model, uid, known):
                results[qi] = PRResult([ItemScore(i, 0.0) for i in query.items],
                                       is_original=True)
            else:
                live.append(qi)
                knowns.append(known)
                uids.append(uid)
        if not live:
            return results
        bp = als_ops.bucket_width(len(live), min_width=1)
        ids = als_ops.pad_id_rows(
            [[iid if iid is not None else -1 for _, iid in known] for known in knowns]
            + [[]] * (bp - len(live)))
        dev = model.device
        rows = torch.as_tensor(uids + [uids[-1]] * (bp - len(live)), dtype=torch.int64).to(dev)
        out = _rank_scores_batch(model.user_factors_device()[rows], model.item_factors_device(),
                                 torch.as_tensor(ids, dtype=torch.int64).to(dev)).cpu().numpy()
        for r, qi in enumerate(live):
            results[qi] = _ranked(knowns[r], out[r, : len(knowns[r])])
        return results


class ProductRankingEngine(EngineFactory):
    @classmethod
    def apply(cls) -> Engine:
        return Engine(
            data_source_class=PRDataSource,
            preparator_class=PRPreparator,
            algorithm_classes={"als": PRAlgorithm},
            serving_class=FirstServing,
        )

    query_class = PRQuery
