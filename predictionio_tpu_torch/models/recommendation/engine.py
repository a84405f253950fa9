"""Recommendation engine template (ALS matrix factorization): serving.

Counterpart of ``predictionio_tpu/models/recommendation/engine.py``.
train = ALS on the model's device (``ops.als.als_train``: batched normal
equations and Cholesky solves, optionally checkpointed); predict =
user-factor · item-factors top-K, scored on the device by the fused
masked-score kernel (``ops.als``).  The model's state dict is the JAX
package's, so a JAX-trained model carries across with
``convert.als_model_from_state`` (or the model store's blob).  The data
source reads its rating events from the event store.

Query/response wire format matches the reference template:
  query    {"user": "u1", "num": 4, "unseenOnly": false, "blackList": []}
  response {"itemScores": [{"item": "i3", "score": 1.2}, ...]}
"""

from __future__ import annotations

import dataclasses
import math
import os
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
from predictionio_tpu_torch.ops.cco import ROADMAP_MESH
from predictionio_tpu_torch.store.columnar import CSRLookup, EventBatch, IdDict
from predictionio_tpu_torch.store.event_store import PEventStore


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

    IMPLICIT_RATING = 4.0

    def read_training(self) -> EventBatch:
        return PEventStore.batch(
            self.params.app_name, event_names=list(self.params.event_names)
        )

    def read_eval(self):
        """``eval_k`` folds of the rating events, each event's fold drawn
        from ``np.random.default_rng(seed)`` (the JAX package's split, draw
        for draw); a fold's queries are its held-out events' users, their
        actuals (item, rating)."""
        batch = self.read_training()
        k = self.params.eval_k
        if k <= 1:
            return []
        rng = np.random.default_rng(self.params.seed)
        fold_of = rng.integers(0, k, size=len(batch))
        users, items = batch.entity_dict.strings(), batch.target_dict.strings()
        ratings = np.nan_to_num(batch.ratings, nan=self.IMPLICIT_RATING)
        folds = []
        for f in range(k):
            train_idx = np.nonzero(fold_of != f)[0]
            test_idx = np.nonzero(fold_of == f)[0]
            td = _subset(batch, train_idx)
            qa = [(RecoQuery(user=users[u], num=10), (items[t], r))
                  for u, t, r in zip(batch.entity_ids[test_idx].tolist(),
                                     batch.target_ids[test_idx].tolist(),
                                     ratings[test_idx].tolist())]
            folds.append((td, {"fold": f}, qa))
        return folds


def _subset(batch: EventBatch, idx: np.ndarray) -> EventBatch:
    """The rows ``idx`` of a batch, sharing its dictionaries (the property
    columns are dropped: the rating column carries what training reads)."""
    return EventBatch(
        batch.event_codes[idx], batch.entity_type_codes[idx], batch.entity_ids[idx],
        batch.target_ids[idx], batch.times_us[idx], batch.ratings[idx],
        batch.event_dict, batch.entity_type_dict, batch.entity_dict, batch.target_dict,
    )


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
    mesh_dp: int = 0        # 0 or 1: the one card; above 1 is not ported
    checkpoint_every: int = 0
    checkpoint_dir: str = ""


class ALSModel(DeviceCacheMixin, PersistentModel):
    """Factor matrices + id dictionaries (+ per-user seen items as a CSR
    lookup for unseen-only serving).

    ``device`` is resolved here, where the model is built (default
    ``"cuda"``; ``resolve_device`` raises when it is absent).  The pickled
    state is the JAX ``ALSModel``'s dict and holds no device: a model
    restored with ``__setstate__`` resolves its device at first staging
    (``to_device``, else the default)."""

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
        self.to_device(device)

    def __getstate__(self):
        return {
            "X": self.user_factors, "Y": self.item_factors,
            "users": self.user_dict.to_state(), "items": self.item_dict.to_state(),
            "seen": self.seen.to_state(),
        }

    def __setstate__(self, state):
        # no device here: unpickling never touches one (see to_device)
        self.user_factors = state["X"]
        self.item_factors = state["Y"]
        self.user_dict = IdDict.from_state(state["users"])
        self.item_dict = IdDict.from_state(state["items"])
        self.seen = CSRLookup.from_state(state["seen"])

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
        device = resolve_device(self.device)
        n_users, n_items = len(pd.user_dict), len(pd.item_dict)
        if n_users == 0 or n_items == 0:
            return ALSModel(
                np.zeros((0, self.params.rank), np.float32),
                np.zeros((0, self.params.rank), np.float32),
                pd.user_dict, pd.item_dict, device=device,
            )
        if self.params.mesh_dp > 1:
            raise NotImplementedError(
                f"mesh_dp={self.params.mesh_dp}: {ROADMAP_MESH}")
        data = als_ops.prepare_als_data(
            pd.user_idx, pd.item_idx, pd.rating, n_users, n_items, dp=1
        )
        checkpoint = None
        if self.params.checkpoint_every > 0:
            from predictionio_tpu_torch.utils.checkpoint import (
                CheckpointStore,
                prune_stale_runs,
            )

            base_dir = self.params.checkpoint_dir or os.path.join(
                os.environ.get("PIO_CHECKPOINT_DIR", ".pio_checkpoints"), "als"
            )
            # keyed by run fingerprint: trainings of other data or params
            # never share a snapshot dir; dirs of crashed runs whose
            # fingerprint never recurs age out (TTL)
            prune_stale_runs(base_dir)
            fp = als_ops.als_fingerprint(
                data, self.params.rank, self.params.lambda_, self.params.seed
            )
            checkpoint = CheckpointStore(os.path.join(base_dir, fp))
        X, Y = als_ops.als_train(
            data,
            k=self.params.rank,
            reg=self.params.lambda_,
            iterations=self.params.num_iterations,
            seed=self.params.seed,
            checkpoint=checkpoint,
            checkpoint_every=self.params.checkpoint_every,
            device=device,
        )
        if checkpoint is not None:
            # completed: remove this run's snapshot dir entirely
            checkpoint.clear(remove_dir=True)
        seen = CSRLookup.from_pairs(pd.user_idx, pd.item_idx, n_users)
        return ALSModel(X, Y, pd.user_dict, pd.item_dict, seen, device=device)

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
        uids = np.array([-1 if u is None else u
                         for u in (model.user_dict.id(q.user) for q in queries)], np.int32)
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
            if len(e):
                excl[j, :len(e)] = e
        out = als_ops.recommend_batch_excl(
            model.user_factors_device()[rows], model.item_factors_device(),
            excl, k).cpu().numpy()
        scores, idx = out[:, 0].tolist(), out[:, 1].astype(np.int32).tolist()
        names = model.item_dict.to_state()   # the live list, not a copy
        out = []
        for j, q in enumerate(queries):
            if uids[j] < 0:
                out.append(PredictedResult([]))
                continue
            n = min(q.num, k)
            out.append(PredictedResult([ItemScore(names[i], s)
                                        for s, i in zip(scores[j][:n], idx[j][:n])
                                        if math.isfinite(s)]))
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
