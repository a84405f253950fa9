"""Complementary Purchase engine template (shopping-basket rules).

Counterpart of ``predictionio_tpu/models/complementary_purchase/engine.py``
(the reference Complementary Purchase template, PredictionIO 0.9.x gallery:
a user's ``buy`` events grouped into baskets by a time window, rules
filtered by minSupport / minConfidence and ranked by lift; query = the
current cart, answer = complementary items).

As in the JAX package, the rules are pairwise: every pair's support,
confidence and lift come from exact basket x item pair counts, and the
per-item top-k by lift is kept (``ops.cco.basket_rules``: the dense
strategy up to 16,384 items, item tiles through the K3 tile top-k kernel's
carry form past it).  A cart of several items aggregates its items' rules
on the device (``ops.als.indicator_scatter_scores``) and the top-k runs
through the business-rules scorer (``ops.als.scores_rules_topk``) with the
cart excluded; the template has no category rules on its wire, so the
scorer takes the model's empty category set.  Training and serving run on
the model's device; the model's state dict is the JAX package's.

Wire format (reference template):
  query    {"items": ["i1", "i2"], "num": 3}
  response {"itemScores": [{"item": "i9", "score": 1.7}, ...]}
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

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
from predictionio_tpu_torch.models.common import CategoryRulesMixin
from predictionio_tpu_torch.models.recommendation.engine import ItemScore, PredictedResult
from predictionio_tpu_torch.models.universal_recommender.popmodel import parse_duration
from predictionio_tpu_torch.ops import als as als_ops
from predictionio_tpu_torch.ops import cco as cco_ops
from predictionio_tpu_torch.store.columnar import IdDict
from predictionio_tpu_torch.store.event_store import PEventStore


@dataclasses.dataclass
class CPQuery:
    items: List[str]
    num: int = 10

    @classmethod
    def from_json(cls, d: Dict) -> "CPQuery":
        return cls(items=[str(i) for i in d["items"]],
                   num=int(d.get("num", 10)))


@dataclasses.dataclass
class CPDataSourceParams(Params):
    app_name: str = "default"
    event_name: str = "buy"
    # events of one user closer together than this belong to one basket
    # (reference DataSource basketWindow)
    basket_window: str = "1 hour"


@dataclasses.dataclass
class CPTrainingData:
    basket_idx: np.ndarray    # int32 per event
    item_idx: np.ndarray
    n_baskets: int
    item_dict: IdDict


class CPDataSource(DataSource):
    """Reads buy events and sessionizes them into baskets: one columnar
    read, then a vectorized (user, time)-sort with baskets split on user
    change or a time gap beyond basket_window."""

    params_class = CPDataSourceParams

    def read_training(self) -> CPTrainingData:
        batch = PEventStore.batch(
            self.params.app_name, event_names=[self.params.event_name])
        has_t = batch.target_ids >= 0
        users = batch.entity_ids[has_t]
        t_codes = batch.target_ids[has_t]
        times = batch.times_us[has_t].astype(np.int64)
        uniq = np.unique(t_codes)
        item_dict = IdDict([batch.target_dict.str(int(c)) for c in uniq])
        t_map = np.full(max(len(batch.target_dict), 1), -1, np.int32)
        t_map[uniq] = np.arange(len(uniq), dtype=np.int32)
        items = t_map[t_codes]
        if len(users) == 0:
            return CPTrainingData(np.empty(0, np.int32), np.empty(0, np.int32),
                                  0, item_dict)
        order = np.lexsort((times, users))
        users, items, times = users[order], items[order], times[order]
        window_us = int(parse_duration(self.params.basket_window) * 1e6)
        new_basket = np.ones(len(users), bool)
        new_basket[1:] = (users[1:] != users[:-1]) | (
            (times[1:] - times[:-1]) > window_us)
        basket_idx = (np.cumsum(new_basket) - 1).astype(np.int32)
        return CPTrainingData(
            basket_idx=basket_idx,
            item_idx=items.astype(np.int32),
            n_baskets=int(basket_idx[-1]) + 1,
            item_dict=item_dict,
        )


class CPPreparator(Preparator):
    def prepare(self, td: CPTrainingData) -> CPTrainingData:
        return td


@dataclasses.dataclass
class CPAlgorithmParams(Params):
    # reference Complementary Purchase: minSupport / minConfidence cuts,
    # rules ranked by lift
    min_support: float = 0.0
    min_confidence: float = 0.0
    max_rules_per_item: int = 20


class CPModel(CategoryRulesMixin, PersistentModel):
    """Per-item complement lists: ids + lift scores.  Staged to the device
    at warm(); a query ships only the padded cart ids and one stacked
    [2, k] array returns.  (Rule confidences are an op-level output —
    ops.cco.basket_rules — not serving state.)"""

    def __init__(self, item_dict: IdDict, comp_idx: np.ndarray,
                 comp_lift: np.ndarray, device=None):
        self.item_dict = item_dict
        self.comp_idx = comp_idx
        self.comp_lift = comp_lift
        # no category rules in this template: empty mask set (the shared
        # rules scorer still wants its device-resident dummy)
        self.cat_masks = np.zeros((0, max(len(item_dict), 1)), bool)
        self.to_device(device)

    def __getstate__(self):
        return {"items": self.item_dict.to_state(), "idx": self.comp_idx,
                "lift": self.comp_lift}

    def __setstate__(self, s):
        self.item_dict = IdDict.from_state(s["items"])
        self.comp_idx = s["idx"]
        self.comp_lift = s["lift"]
        self.cat_masks = np.zeros((0, max(len(self.item_dict), 1)), bool)

    def tables_device(self):
        return self._device("_tab_dev", lambda: (
            torch.tensor(np.asarray(self.comp_idx, np.int32), device=self.device),
            torch.tensor(np.where(np.isfinite(self.comp_lift), self.comp_lift, 0.0)
                         .astype(np.float32), device=self.device)))

    def warm(self) -> None:
        if len(self.item_dict):
            self.tables_device()
            self.cat_masks_device()


class CPAlgorithm(Algorithm):
    params_class = CPAlgorithmParams

    def train(self, td: CPTrainingData) -> CPModel:
        device = resolve_device(self.device)
        n_items = len(td.item_dict)
        if n_items == 0 or td.n_baskets == 0:
            k = max(self.params.max_rules_per_item, 1)
            return CPModel(td.item_dict,
                           np.full((n_items, k), -1, np.int32),
                           np.full((n_items, k), -np.inf, np.float32), device=device)
        lift, idx, _conf = cco_ops.basket_rules(
            td.basket_idx, td.item_idx, td.n_baskets, n_items,
            top_k=self.params.max_rules_per_item,
            min_support=self.params.min_support,
            min_confidence=self.params.min_confidence, device=device)
        return CPModel(td.item_dict, idx, lift, device=device)

    def warm(self, model: CPModel) -> None:
        model.warm()

    def predict(self, model: CPModel, query: CPQuery) -> PredictedResult:
        n_items = len(model.item_dict)
        if n_items == 0:
            return PredictedResult([])
        cart = [model.item_dict.id(i) for i in query.items]
        cart = [c for c in cart if c is not None]
        if not cart:
            return PredictedResult([])
        idx_dev, lift_dev = model.tables_device()
        q_pad = als_ops.pad_ids(cart)
        # aggregate lift over the cart items (device gather+scatter), then
        # top-k excluding the cart itself — ONE stacked readback
        scores = als_ops.indicator_scatter_scores(idx_dev, lift_dev, q_pad)
        num = min(query.num, n_items)
        k = min(als_ops.bucket_width(num), n_items)
        out = als_ops.scores_rules_topk(
            scores, model.cat_masks_device(), als_ops.pad_ids([]),
            als_ops.pad_ids([]), als_ops.pad_ids(np.asarray(cart, np.int32)), k
        ).cpu().numpy()
        st, si = out[0], out[1].astype(np.int32)
        return PredictedResult(
            [ItemScore(model.item_dict.str(int(j)), float(s))
             for s, j in zip(st[:num], si[:num])
             if np.isfinite(s) and s > 0])

    def serve_batch_predict(self, model: CPModel, queries):
        """Micro-batch serving: every cart's rule aggregation + top-k in
        one device pass and one [B, 2, k] readback; empty/unresolvable
        carts answer on the host like predict."""
        n_items = len(model.item_dict)
        results = [None] * len(queries)
        live, carts = [], []
        for qi, query in enumerate(queries):
            cart = [model.item_dict.id(i) for i in query.items]
            cart = [c for c in cart if c is not None]
            if n_items == 0 or not cart:
                results[qi] = PredictedResult([])
            else:
                live.append(qi)
                carts.append(cart)
        if not live:
            return results
        bp = als_ops.bucket_width(len(live), min_width=1)
        qm = als_ops.pad_id_rows(carts + [[]] * (bp - len(live)))
        idx_dev, lift_dev = model.tables_device()
        scores = als_ops.indicator_scatter_scores_batch(idx_dev, lift_dev, qm)
        nums = [min(queries[i].num, n_items) for i in live]
        k = min(als_ops.bucket_width(max(nums)), n_items)
        none = np.full((bp, 16), -1, np.int32)
        out = als_ops.scores_rules_topk_batch(
            scores, model.cat_masks_device(), none, none, qm, k).cpu().numpy()
        for r, qi in enumerate(live):
            st = out[r, 0]
            si = out[r, 1].astype(np.int32)
            n = nums[r]
            results[qi] = PredictedResult(
                [ItemScore(model.item_dict.str(int(j)), float(s))
                 for s, j in zip(st[:n], si[:n])
                 if np.isfinite(s) and s > 0])
        return results


class ComplementaryPurchaseEngine(EngineFactory):
    @classmethod
    def apply(cls) -> Engine:
        return Engine(
            data_source_class=CPDataSource,
            preparator_class=CPPreparator,
            algorithm_classes={"rules": CPAlgorithm},
            serving_class=FirstServing,
        )

    query_class = CPQuery
