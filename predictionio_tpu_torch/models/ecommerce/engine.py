"""E-Commerce Recommendation engine template.

Counterpart of ``predictionio_tpu/models/ecommerce/engine.py`` (the
reference's E-Commerce Recommendation template: implicit ALS on view and
buy events, a three-tier predict — known user → recent-similar →
popular default — live "seen" and "unavailableItems" constraint reads
from ``LEventStore``, and category/whiteList/blackList business rules).

- Training is ``ops.als.als_train`` with ``implicit=True`` on the model's
  device: event-weighted strengths, duplicate (user, item) cells summed,
  confidences c = 1 + alpha·r.
- Serving is device-final: item factors and the per-category item bitmasks
  are staged to the device once (``warm``); a query ships three small
  padded id lists (categories, whiteList, exclusions) and one [2, k]
  tensor crosses back (``ops.als.recommend_scores_rules``).  The rare
  popularity tier ranks on the host.
- The real-time constraints keep the reference's semantics: seen events
  and the latest ``unavailableItems`` ``$set`` are read from the event
  store at predict time, so a constraint update takes effect without a
  retrain.

The model's state dict is the JAX package's (both revisions load), so a
JAX-pickled ``ECommModel`` serves here through ``persistence.port_class``.

Wire format (reference template):
  query    {"user": "u1", "num": 4, "categories": ["c"],
            "whiteList": [...], "blackList": [...]}
  response {"itemScores": [{"item": "i3", "score": 1.2}, ...]}
"""

from __future__ import annotations

import dataclasses
import logging
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
from predictionio_tpu_torch.models.common import (
    CategoryRulesMixin,
    opt_str_list,
    reindex_interactions,
)
from predictionio_tpu_torch.models.recommendation.engine import ItemScore, PredictedResult
from predictionio_tpu_torch.ops import als as als_ops
from predictionio_tpu_torch.ops.cco import ROADMAP_MESH
from predictionio_tpu_torch.store.columnar import IdDict, category_masks
from predictionio_tpu_torch.store.event_store import LEventStore, PEventStore

log = logging.getLogger("pio.ecommerce")


@dataclasses.dataclass
class ECommQuery:
    user: str
    num: int = 10
    categories: Optional[List[str]] = None
    white_list: Optional[List[str]] = None
    black_list: Optional[List[str]] = None

    @classmethod
    def from_json(cls, d: Dict) -> "ECommQuery":
        # empty-vs-absent semantics: see models.common.opt_str_list
        return cls(
            user=str(d["user"]),
            num=int(d.get("num", 10)),
            categories=opt_str_list(d, "categories"),
            white_list=opt_str_list(d, "whiteList"),
            black_list=opt_str_list(d, "blackList"),
        )


@dataclasses.dataclass
class ECommDataSourceParams(Params):
    app_name: str = "default"
    # interaction events read for training (the reference reads viewEvents
    # and buyEvents separately; both feed the implicit matrix)
    event_names: List[str] = dataclasses.field(default_factory=lambda: ["view", "buy"])
    item_entity_type: str = "item"


@dataclasses.dataclass
class ECommTrainingData:
    user_idx: np.ndarray      # per event
    item_idx: np.ndarray
    event_codes: np.ndarray   # index into event_names
    event_names: List[str]
    user_dict: IdDict
    item_dict: IdDict
    item_categories: Dict[str, List[str]]


class ECommDataSource(DataSource):
    """Columnar read of the interaction events + the items' ``$set``
    ``categories``."""

    params_class = ECommDataSourceParams

    def read_training(self) -> ECommTrainingData:
        batch = PEventStore.batch(
            self.params.app_name, event_names=list(self.params.event_names))
        user_idx, item_idx, user_dict, item_dict, rows = reindex_interactions(
            batch, return_rows=True)
        ev_codes = batch.event_codes[rows]
        # event name -> position in self.params.event_names (event_dict codes
        # are storage-order, not config-order)
        name_of_code = {c: batch.event_dict.str(c) for c in np.unique(ev_codes)}
        code_map = np.full(max(len(batch.event_dict), 1), -1, np.int32)
        for c, nm in name_of_code.items():
            if nm in self.params.event_names:
                code_map[c] = self.params.event_names.index(nm)
        props = PEventStore.aggregate_properties(
            self.params.app_name, self.params.item_entity_type)
        cats: Dict[str, List[str]] = {}
        for item, pm in props.items():
            v = pm.get("categories")
            if v is not None:
                cats[item] = [str(c) for c in (v if isinstance(v, list) else [v])]
        return ECommTrainingData(
            user_idx=user_idx,
            item_idx=item_idx,
            event_codes=code_map[ev_codes].astype(np.int32),
            event_names=list(self.params.event_names),
            user_dict=user_dict,
            item_dict=item_dict,
            item_categories=cats,
        )


class ECommPreparator(Preparator):
    def prepare(self, td: ECommTrainingData) -> ECommTrainingData:
        return td


@dataclasses.dataclass
class ECommAlgorithmParams(Params):
    app_name: str = "default"   # for real-time LEventStore reads at predict
    rank: int = 10
    num_iterations: int = 10
    lambda_: float = 0.01
    alpha: float = 1.0          # implicit-feedback confidence slope
    seed: int = 7
    mesh_dp: int = 0            # 0 or 1: the one card; above 1 is not ported
    # event-strength weights by training event name; unlisted events weigh 1
    event_weights: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"buy": 4.0})
    # reference ECommAlgorithmParams: unseenOnly + seenEvents read live
    unseen_only: bool = False
    seen_events: List[str] = dataclasses.field(default_factory=lambda: ["view", "buy"])
    # events whose recent targets seed the unknown-user fallback
    similar_events: List[str] = dataclasses.field(default_factory=lambda: ["view"])
    recent_events_limit: int = 10
    # constraint entity carrying the live unavailable-items list
    unavailable_constraint: str = "unavailableItems"


class ECommModel(CategoryRulesMixin, PersistentModel):
    """Factors + device-resident business-rule state.

    ``cat_masks`` ([C, n_items] bool, category → items) is derived from
    the sparse per-item category dict (the persisted form) and staged to
    the device once per load (``warm``) with the item factors.
    ``popular`` is the weighted interaction count per item — the
    predictDefault tier for users with no factor and no recent history.
    ``device`` is resolved where the model is built (default ``"cuda"``);
    the pickled state holds none (see ``DeviceCacheMixin``)."""

    def __init__(self, user_factors, item_factors, user_dict, item_dict,
                 item_categories: Dict[str, List[str]], popular: np.ndarray,
                 device=None):
        self.user_factors = user_factors
        self.item_factors = item_factors
        self.user_dict = user_dict
        self.item_dict = item_dict
        self.item_categories = item_categories
        self.cat_dict, self.cat_masks = category_masks(item_categories, item_dict)
        self.popular = popular
        self.to_device(device)

    def __getstate__(self):
        return {
            "X": self.user_factors, "Y": self.item_factors,
            "users": self.user_dict.to_state(), "items": self.item_dict.to_state(),
            "cats": self.item_categories, "popular": self.popular,
        }

    def __setstate__(self, s):
        self.user_factors = s["X"]
        self.item_factors = s["Y"]
        self.user_dict = IdDict.from_state(s["users"])
        self.item_dict = IdDict.from_state(s["items"])
        if "cat_masks" in s:
            # migrate the first-revision format (dense masks + cat-name
            # dict) back to the sparse per-item category lists
            names = IdDict.from_state(s["cats"])
            masks = s["cat_masks"]
            self.item_categories = {}
            for c in range(masks.shape[0]):
                for i in np.flatnonzero(masks[c]):
                    self.item_categories.setdefault(
                        self.item_dict.str(int(i)), []).append(names.str(c))
        else:
            self.item_categories = s["cats"]
        self.cat_dict, self.cat_masks = category_masks(
            self.item_categories, self.item_dict)
        self.popular = s["popular"]

    def item_factors_device(self) -> torch.Tensor:
        """Item factors [I, K] staged to the device once (a copy: the host
        array may be read-only)."""
        return self._device("_y_dev", lambda: torch.tensor(
            np.asarray(self.item_factors, np.float32), device=self.device))

    def warm(self) -> None:
        """Pre-stage the serving state and score one rule query, so the
        first user pays neither the transfer nor a first-use setup."""
        if len(self.item_factors):
            items = self.item_factors_device()
            empty = als_ops.pad_ids([])
            als_ops.recommend_scores_rules(
                items[0], items, self.cat_masks_device(), empty, empty, empty,
                min(als_ops.bucket_width(1), len(items))).cpu()


class ECommAlgorithm(Algorithm):
    params_class = ECommAlgorithmParams

    def train(self, td: ECommTrainingData) -> ECommModel:
        device = resolve_device(self.device)
        n_users, n_items = len(td.user_dict), len(td.item_dict)
        rank = self.params.rank
        if n_users == 0 or n_items == 0:
            return ECommModel(
                np.zeros((0, rank), np.float32), np.zeros((0, rank), np.float32),
                td.user_dict, td.item_dict, td.item_categories,
                np.zeros(n_items, np.float32), device=device)
        if self.params.mesh_dp > 1:
            raise NotImplementedError(
                f"mesh_dp={self.params.mesh_dp}: {ROADMAP_MESH}")
        # event-weighted strengths, duplicates summed into one (u, i) cell —
        # the confidence input r of trainImplicit (the reference sums views)
        w = np.ones(len(td.event_names), np.float32)
        for name, weight in (self.params.event_weights or {}).items():
            if name in td.event_names:
                w[td.event_names.index(name)] = float(weight)
        strength = w[np.maximum(td.event_codes, 0)]
        cell = td.user_idx.astype(np.int64) * n_items + td.item_idx
        uniq, inv = np.unique(cell, return_inverse=True)
        r = np.zeros(len(uniq), np.float32)
        np.add.at(r, inv, strength)
        users = (uniq // n_items).astype(np.int32)
        items = (uniq % n_items).astype(np.int32)
        popular = np.zeros(n_items, np.float32)
        np.add.at(popular, items, r)
        data = als_ops.prepare_als_data(users, items, r, n_users, n_items, dp=1)
        X, Y = als_ops.als_train(
            data, k=rank, reg=self.params.lambda_,
            iterations=self.params.num_iterations,
            seed=self.params.seed, implicit=True, alpha=self.params.alpha,
            device=device)
        return ECommModel(X, Y, td.user_dict, td.item_dict, td.item_categories,
                          popular, device=device)

    def warm(self, model: ECommModel) -> None:
        model.warm()

    # -- predict tiers (reference ECommAlgorithm.predict) --------------------

    def _query_vector(self, model: ECommModel, user: str):
        """(vector [K] on the host, items to exclude) of the first two tiers,
        or None for the popularity tier: the user's factor row, else the
        mean of the recently viewed items' factors (predictSimilar)."""
        uid = model.user_dict.id(user)
        if uid is not None and np.any(model.user_factors[uid]):
            return np.asarray(model.user_factors[uid], np.float32), ()
        recent = self._recent_item_ids(model, user)
        if len(recent):
            # cosine-free: the factors share one training scale
            return np.asarray(model.item_factors[recent].mean(axis=0), np.float32), recent
        return None

    def predict(self, model: ECommModel, query: ECommQuery) -> PredictedResult:
        if len(model.item_factors) == 0:
            return PredictedResult([])
        tier = self._query_vector(model, query.user)
        if tier is None:
            return self._popular(model, query)
        return self._scored(model, query, *tier)

    def serve_batch_predict(self, model: ECommModel,
                            queries) -> List[PredictedResult]:
        """Micro-batch serving: tiers 1 and 2 share one batched rules+top-k
        pass and ONE [B, 2, k] readback; the popularity tier and infeasible
        queries answer on the host exactly as predict does."""
        results: List[Optional[PredictedResult]] = [None] * len(queries)
        if len(model.item_factors) == 0:
            return [PredictedResult([]) for _ in queries]
        n_items = len(model.item_factors)
        # query-independent live read: once per batch, not per query
        unavailable = self._unavailable_ids(model)
        live, vecs, rules, nums = [], [], [], []
        for qi, query in enumerate(queries):
            tier = self._query_vector(model, query.user)
            if tier is None:
                results[qi] = self._popular(model, query)
                continue
            vec, exclude = tier
            cat_ids, white, excl, feasible = self._rule_ids(
                model, query, extra_excl=exclude, unavailable=unavailable)
            if not feasible:
                results[qi] = PredictedResult([])
                continue
            live.append(qi)
            vecs.append(vec)
            rules.append((cat_ids, white, excl))
            nums.append(min(query.num, n_items))
        if not live:
            return results
        bp = als_ops.bucket_width(len(live), min_width=1)
        pad_tail = [[]] * (bp - len(live))
        v = np.zeros((bp, vecs[0].shape[0]), np.float32)
        v[: len(live)] = np.stack(vecs)
        k = min(als_ops.bucket_width(max(nums)), n_items)
        out = als_ops.recommend_batch_rules(
            torch.as_tensor(v).to(model.device), model.item_factors_device(),
            model.cat_masks_device(),
            als_ops.pad_id_rows([r[0] for r in rules] + pad_tail),
            als_ops.pad_id_rows([r[1] for r in rules] + pad_tail),
            als_ops.pad_id_rows([r[2] for r in rules] + pad_tail), k).cpu().numpy()
        for r, qi in enumerate(live):
            results[qi] = self._result(out[r], nums[r], model)
        return results

    @staticmethod
    def _result(out: np.ndarray, num: int, model: ECommModel) -> PredictedResult:
        scores, idx = out[0], out[1].astype(np.int32)
        return PredictedResult(
            [ItemScore(model.item_dict.str(int(i)), float(s))
             for s, i in zip(scores[:num], idx[:num]) if np.isfinite(s)])

    def _scored(self, model: ECommModel, query: ECommQuery,
                vec: np.ndarray, exclude: Sequence[int] = ()) -> PredictedResult:
        n_items = len(model.item_factors)
        num = min(query.num, n_items)
        k = min(als_ops.bucket_width(num), n_items)
        cat_ids, white, excl, feasible = self._rule_ids(model, query, extra_excl=exclude)
        if not feasible:
            return PredictedResult([])
        out = als_ops.recommend_scores_rules(
            torch.as_tensor(vec).to(model.device), model.item_factors_device(),
            model.cat_masks_device(), als_ops.pad_ids(cat_ids), als_ops.pad_ids(white),
            als_ops.pad_ids(excl), k).cpu().numpy()   # ONE [2, k] copy a query
        return self._result(out, num, model)

    def _popular(self, model: ECommModel, query: ECommQuery) -> PredictedResult:
        """predictDefault: popularity ranking under the same business rules
        (host numpy — no factors involved, and this tier is rare)."""
        scores = model.popular.astype(np.float64).copy()
        cat_ids, white, excl, feasible = self._rule_ids(model, query)
        if not feasible:
            return PredictedResult([])
        if query.categories is not None:
            allow = (model.cat_masks[cat_ids].any(axis=0)
                     if len(cat_ids) else np.zeros(len(scores), bool))
            scores[~allow] = -np.inf
        if query.white_list is not None:
            wmask = np.zeros(len(scores), bool)
            wmask[white] = True
            scores[~wmask] = -np.inf
        scores[excl] = -np.inf
        num = min(query.num, len(scores))
        top = np.argsort(-scores)[:num]
        return PredictedResult(
            [ItemScore(model.item_dict.str(int(i)), float(scores[i]))
             for i in top if np.isfinite(scores[i])])

    def _rule_ids(self, model: ECommModel, query: ECommQuery,
                  extra_excl: Sequence[int] = (),
                  unavailable: Optional[np.ndarray] = None):
        """Translate query rules + live constraints into dense id lists.
        ``unavailable`` lets a batch caller hoist the query-independent
        live unavailableItems read to once per batch."""
        cat_ids = np.asarray(
            [c for c in (model.cat_dict.id(n) for n in query.categories or [])
             if c is not None], np.int32)
        white = np.asarray(
            [i for i in (model.item_dict.id(n) for n in query.white_list or [])
             if i is not None], np.int32)
        excl: List[np.ndarray] = [np.asarray(extra_excl, np.int32)]
        excl.append(np.asarray(
            [i for i in (model.item_dict.id(n) for n in query.black_list or [])
             if i is not None], np.int32))
        excl.append(unavailable if unavailable is not None
                    else self._unavailable_ids(model))
        if self.params.unseen_only:
            excl.append(self._seen_ids(model, query.user))
        merged = np.concatenate(excl)
        # a constraint that resolves to NOTHING means no item can qualify
        # (e.g. an unknown category name) — not "unconstrained"
        feasible = not (
            (query.categories is not None and len(cat_ids) == 0)
            or (query.white_list is not None and len(white) == 0))
        return cat_ids, white, merged, feasible

    # -- live LEventStore reads (the reference reads these per query) --------
    # Only ValueError (app not registered — the offline-eval case) is "no
    # data"; real storage failures propagate rather than silently disabling
    # business constraints.

    def _user_event_item_ids(self, model: ECommModel, user: str,
                             event_names: List[str],
                             limit: Optional[int] = None) -> np.ndarray:
        try:
            events = LEventStore.find_by_entity(
                self.params.app_name, "user", user,
                event_names=list(event_names), limit=limit)
        except ValueError:
            log.debug("app %r not in event store; skipping live read",
                      self.params.app_name)
            return np.empty(0, np.int32)
        ids = [model.item_dict.id(e.target_entity_id) for e in events
               if e.target_entity_id is not None]
        return np.asarray(sorted({i for i in ids if i is not None}), np.int32)

    def _recent_item_ids(self, model: ECommModel, user: str) -> np.ndarray:
        return self._user_event_item_ids(
            model, user, self.params.similar_events,
            limit=self.params.recent_events_limit)

    def _seen_ids(self, model: ECommModel, user: str) -> np.ndarray:
        return self._user_event_item_ids(model, user, self.params.seen_events)

    def _unavailable_ids(self, model: ECommModel) -> np.ndarray:
        """Latest ``$set`` on constraint/unavailableItems (property
        ``items``) — takes effect immediately."""
        try:
            events = LEventStore.find_by_entity(
                self.params.app_name, "constraint",
                self.params.unavailable_constraint,
                event_names=["$set"], limit=1)
        except ValueError:
            return np.empty(0, np.int32)
        if not events:
            return np.empty(0, np.int32)
        items = events[0].properties.get("items") or []
        ids = [model.item_dict.id(str(i)) for i in items]
        return np.asarray([i for i in ids if i is not None], np.int32)


class ECommServing(FirstServing):
    """The reference template serves the single algorithm's prediction."""


class ECommerceEngine(EngineFactory):
    @classmethod
    def apply(cls) -> Engine:
        return Engine(
            data_source_class=ECommDataSource,
            preparator_class=ECommPreparator,
            algorithm_classes={"ecomm": ECommAlgorithm},
            serving_class=ECommServing,
        )

    query_class = ECommQuery
