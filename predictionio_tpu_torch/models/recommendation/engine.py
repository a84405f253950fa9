"""Recommendation engine template (ALS matrix factorization): serving.

Counterpart of ``predictionio_tpu/models/recommendation/engine.py``.
predict = user-factor · item-factors top-K, scored on the device by the
fused masked-score kernel (``ops.als``).  The model's state dict is the JAX
package's, so a JAX-trained model carries across with
``convert.als_model_from_state``.  Training and the event-store data source
wait for later slices (ROADMAP.md, queue A: "ALS training" and "Storage and
event store").

Query/response wire format matches the reference template:
  query    {"user": "u1", "num": 4, "unseenOnly": false, "blackList": []}
  response {"itemScores": [{"item": "i3", "score": 1.2}, ...]}
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

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
from predictionio_tpu_torch.models.common import DeviceCacheMixin
from predictionio_tpu_torch.ops import als as als_ops
from predictionio_tpu_torch.store.columnar import CSRLookup, IdDict


# -- query / result types (wire-compatible with the reference template) ------


@dataclasses.dataclass
class RecoQuery:
    user: str
    num: int = 10
    # exclude the user's own rated items (reference e-commerce template's
    # unseenOnly) and/or an explicit item blacklist
    unseen_only: bool = False
    blacklist: List[str] = dataclasses.field(default_factory=list)

    @classmethod
    def from_json(cls, d: Dict) -> "RecoQuery":
        return cls(
            user=str(d["user"]),
            num=int(d.get("num", 10)),
            unseen_only=bool(d.get("unseenOnly", False)),
            blacklist=[str(b) for b in d.get("blackList", [])],
        )


@dataclasses.dataclass
class ItemScore:
    item: str
    score: float

    def to_json(self) -> Dict:
        return {"item": self.item, "score": self.score}


@dataclasses.dataclass
class PredictedResult:
    item_scores: List[ItemScore]

    def to_json(self) -> Dict:
        return {"itemScores": [s.to_json() for s in self.item_scores]}


# -- DASE components ---------------------------------------------------------


@dataclasses.dataclass
class DataSourceParams(Params):
    app_name: str = "default"
    event_names: List[str] = dataclasses.field(default_factory=lambda: ["rate", "buy"])
    eval_k: int = 0          # >0 enables k-fold eval folds
    seed: int = 3


class RecoDataSource(DataSource):
    """Reads rating events ("rate"/"buy") from the event store."""

    params_class = DataSourceParams

    def read_training(self):
        raise NotImplementedError(
            "the port has no event store yet: it comes with the storage "
            "slice (ROADMAP.md, queue A, 'Storage and event store')")


@dataclasses.dataclass
class PreparedRatings:
    user_idx: np.ndarray
    item_idx: np.ndarray
    rating: np.ndarray
    user_dict: IdDict
    item_dict: IdDict


class RecoPreparator(Preparator):
    """Dedupes (user, item) pairs keeping the latest rating — the reference
    DataSource does this with an RDD reduceByKey on latest eventTime.  Takes
    any columnar batch with the JAX ``EventBatch``'s columns."""

    IMPLICIT_RATING = 4.0

    def prepare(self, batch) -> PreparedRatings:
        valid = batch.target_ids >= 0
        users = batch.entity_ids[valid]
        items = batch.target_ids[valid]
        times = batch.times_us[valid]
        ratings = np.nan_to_num(batch.ratings[valid], nan=self.IMPLICIT_RATING)
        # keep latest event per (user, item)
        order = np.lexsort((times, items, users))
        users, items, ratings = users[order], items[order], ratings[order]
        if len(users):
            last = np.ones(len(users), bool)
            last[:-1] = (users[:-1] != users[1:]) | (items[:-1] != items[1:])
            users, items, ratings = users[last], items[last], ratings[last]
        return PreparedRatings(
            user_idx=users.astype(np.int32),
            item_idx=items.astype(np.int32),
            rating=ratings.astype(np.float32),
            user_dict=batch.entity_dict,
            item_dict=batch.target_dict,
        )


@dataclasses.dataclass
class ALSAlgorithmParams(Params):
    rank: int = 10
    num_iterations: int = 10
    lambda_: float = 0.01
    seed: int = 7
    mesh_dp: int = 0        # 0 = use all devices
    checkpoint_every: int = 0
    checkpoint_dir: str = ""


class ALSModel(DeviceCacheMixin, PersistentModel):
    """Factor matrices + id dictionaries (+ per-user seen items as a CSR
    lookup for unseen-only serving).

    ``device`` is fixed here, where the model is built (default ``"cuda"``;
    ``resolve_device`` raises when it is absent).  The pickled state is the
    JAX ``ALSModel``'s dict and holds no device: a model restored with
    ``__setstate__`` serves on the default device."""

    def __init__(
        self,
        user_factors: np.ndarray,
        item_factors: np.ndarray,
        user_dict: IdDict,
        item_dict: IdDict,
        seen: Optional[CSRLookup] = None,
        device=None,
    ):
        self.user_factors = user_factors
        self.item_factors = item_factors
        self.user_dict = user_dict
        self.item_dict = item_dict
        self.seen = seen if seen is not None else CSRLookup.empty()
        self.device = resolve_device(device)

    def __getstate__(self):
        return {
            "X": self.user_factors, "Y": self.item_factors,
            "users": self.user_dict.to_state(), "items": self.item_dict.to_state(),
            "seen": self.seen.to_state(),
        }

    def __setstate__(self, state):
        self.__init__(state["X"], state["Y"], IdDict.from_state(state["users"]),
                      IdDict.from_state(state["items"]),
                      CSRLookup.from_state(state["seen"]))

    def _stage(self, attr: str, host: np.ndarray) -> torch.Tensor:
        # a copy: the host array may be read-only (a JAX model's factors)
        return self._device(attr, lambda: torch.tensor(
            np.asarray(host, np.float32), device=self.device))

    def item_factors_device(self) -> torch.Tensor:
        """Item factors [I, K] staged to the device ONCE (never per query)."""
        return self._stage("_item_factors_dev", self.item_factors)

    def user_factors_device(self) -> torch.Tensor:
        """User factors [U, K] on the device, so a query sends its row index
        rather than its vector."""
        return self._stage("_user_factors_dev", self.user_factors)

    def warm(self) -> None:
        """Pre-stage serving state to the device and score one query
        (called at deploy), so the first user pays neither the transfer nor
        the kernel's first-use build and module load."""
        if len(self.item_factors) and len(self.user_factors):
            items = self.item_factors_device()
            als_ops.recommend_scores_excl(
                self.user_factors_device()[0], items, als_ops.pad_ids([]),
                min(als_ops.bucket_width(1), len(items))).cpu()


class ALSAlgorithm(Algorithm):
    params_class = ALSAlgorithmParams
    serving_batchable = True   # batch_predict reads only model state

    def train(self, pd: PreparedRatings) -> ALSModel:
        raise NotImplementedError(
            "ALS training is not ported yet (ROADMAP.md, queue A, 'ALS "
            "training'); train with the JAX package and carry the model "
            "across with models.recommendation.convert.als_model_from_state")

    def warm(self, model: ALSModel) -> None:
        model.warm()

    def _exclusions(self, model: ALSModel, query: RecoQuery,
                    uid: Optional[int]) -> np.ndarray:
        """Item ids excluded from this query's results (unpadded)."""
        parts = []
        if query.unseen_only and uid is not None:
            parts.append(model.seen.row(uid))
        for b in query.blacklist:
            bid = model.item_dict.id(b)
            if bid is not None:
                parts.append(np.asarray([bid], np.int32))
        return np.concatenate(parts) if parts else np.empty(0, np.int32)

    @staticmethod
    def _k_bucket(num: int, n_items: int) -> int:
        """Serve top-k from a power-of-two bucket so distinct ``num`` values
        share shapes (the JAX package's shape-bucketing rule)."""
        return min(als_ops.bucket_width(num), n_items)

    def predict(self, model: ALSModel, query: RecoQuery) -> PredictedResult:
        uid = model.user_dict.id(query.user)
        if uid is None or len(model.item_factors) == 0:
            return PredictedResult([])
        num = min(query.num, len(model.item_factors))
        k = self._k_bucket(num, len(model.item_factors))
        excl = als_ops.pad_ids(self._exclusions(model, query, uid))
        # ONE stacked [2, k] device→host copy per query
        out = als_ops.recommend_scores_excl(
            model.user_factors_device()[uid], model.item_factors_device(),
            excl, k).cpu().numpy()
        scores, idx = out[0], out[1].astype(np.int32)
        return PredictedResult(
            [
                ItemScore(model.item_dict.str(int(i)), float(s))
                for s, i in zip(scores[:num], idx[:num])
                if np.isfinite(s)
            ]
        )

    def batch_predict(self, model: ALSModel, queries: Sequence[RecoQuery]) -> List[PredictedResult]:
        if not queries or len(model.item_factors) == 0:
            return [PredictedResult([]) for _ in queries]
        k = self._k_bucket(
            min(max(q.num for q in queries), len(model.item_factors)),
            len(model.item_factors),
        )
        uids = np.array(
            [model.user_dict.id(q.user) if model.user_dict.id(q.user) is not None else -1
             for q in queries], np.int32,
        )
        safe = np.maximum(uids, 0)
        excl_rows = [self._exclusions(model, q, int(u) if u >= 0 else None)
                     for q, u in zip(queries, uids)]
        width = als_ops.bucket_width(max(len(e) for e in excl_rows))
        # bucket the BATCH dim too (edge-padded rows repeat the last query),
        # so serving batch sizes collapse to a few shapes
        bp = als_ops.bucket_width(len(queries), min_width=1)
        rows = torch.as_tensor(np.pad(safe, (0, bp - len(queries)), mode="edge"),
                               dtype=torch.int64).to(model.device)
        excl = np.full((bp, width), -1, np.int32)
        for j, e in enumerate(excl_rows):
            excl[j, :len(e)] = e
        out = als_ops.recommend_batch_excl(
            model.user_factors_device()[rows], model.item_factors_device(),
            excl, k).cpu().numpy()
        scores, idx = out[:, 0], out[:, 1].astype(np.int32)
        out = []
        for j, q in enumerate(queries):
            if uids[j] < 0:
                out.append(PredictedResult([]))
                continue
            n = min(q.num, k)
            out.append(
                PredictedResult(
                    [ItemScore(model.item_dict.str(int(i)), float(s))
                     for s, i in zip(scores[j, :n], idx[j, :n]) if np.isfinite(s)]
                )
            )
        return out


class RecoServing(FirstServing):
    """Reference template uses the first (only) algorithm's prediction."""


class RecommendationEngine(EngineFactory):
    @classmethod
    def apply(cls) -> Engine:
        return Engine(
            data_source_class=RecoDataSource,
            preparator_class=RecoPreparator,
            algorithm_classes={"als": ALSAlgorithm},
            serving_class=RecoServing,
        )

    # serving-layer JSON adapter used by the query server
    query_class = RecoQuery
