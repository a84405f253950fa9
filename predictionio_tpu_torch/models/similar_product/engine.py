"""Similar-Product engine template.

Counterpart of ``predictionio_tpu/models/similar_product/engine.py`` (the
reference's Similar Product template: item-item similarity from view
events, with category, whiteList and blackList rules) and its cooccurrence
variant.

Wire format (reference template):
  query    {"items": ["i1", "i2"], "num": 4,
            "categories": ["c"], "whiteList": [...], "blackList": [...]}
  response {"itemScores": [{"item": "i5", "score": 0.9}, ...]}

Algorithms:
- "als": implicit-feedback ALS (``ops.als.als_train``) on the view counts
  of each (user, item); similarity is the cosine over item factors, the
  query's mean factor against the row-normalized item factors.
- "cooccurrence": LLR item-item cooccurrence, ``ops.cco.cco_indicators_coo``
  of the views against themselves with the self-pair masked: K2 and K3 on
  the card, through whichever CCO strategy the catalog's size picks.

Serving is device-final, as in the reference: the row-normalized factors or
the indicator table and the [C, n_items] category masks are staged on the
model's device once (``warm``); a query ships small padded id lists and one
[2, k] tensor crosses back.  The cooccurrence score of an item is the sum
of the LLR weights of the query items' indicators that name it (a gather
and a scatter-add, ``ops.als.indicator_scatter_scores``); on the card that
float sum has no fixed order, so scores agree with the CPU's within f32
rounding and ranks may swap only between near-equal scores.

The model's state dict is the JAX package's, so a JAX-pickled ``SPModel``
serves here through ``persistence.port_class``, and ``sp_model_from_state``
carries a JAX model's state across.
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
from predictionio_tpu_torch.models.common import (
    CategoryRulesMixin,
    opt_str_list,
    reindex_interactions,
)
from predictionio_tpu_torch.models.recommendation.engine import ItemScore, PredictedResult
from predictionio_tpu_torch.ops import als as als_ops
from predictionio_tpu_torch.ops import cco as cco_ops
from predictionio_tpu_torch.parallel.distributed import process_count
from predictionio_tpu_torch.parallel.mesh import MeshSpec, create_mesh
from predictionio_tpu_torch.store.columnar import IdDict, category_masks
from predictionio_tpu_torch.store.event_store import PEventStore


@dataclasses.dataclass
class SimilarProductQuery:
    items: List[str]
    num: int = 10
    categories: Optional[List[str]] = None
    white_list: Optional[List[str]] = None
    black_list: Optional[List[str]] = None

    @classmethod
    def from_json(cls, d: Dict) -> "SimilarProductQuery":
        # empty-vs-absent semantics: see models.common.opt_str_list
        return cls(
            items=[str(i) for i in d["items"]],
            num=int(d.get("num", 10)),
            categories=opt_str_list(d, "categories"),
            white_list=opt_str_list(d, "whiteList"),
            black_list=opt_str_list(d, "blackList"),
        )


@dataclasses.dataclass
class SPDataSourceParams(Params):
    app_name: str = "default"
    event_names: List[str] = dataclasses.field(default_factory=lambda: ["view"])
    item_entity_type: str = "item"


@dataclasses.dataclass
class SPTrainingData:
    user_idx: np.ndarray
    item_idx: np.ndarray
    user_dict: IdDict
    item_dict: IdDict
    item_categories: Dict[str, List[str]]


class SPDataSource(DataSource):
    """Columnar read of the view events and the items' ``$set``
    ``categories``."""

    params_class = SPDataSourceParams

    def read_training(self) -> SPTrainingData:
        batch = PEventStore.batch(
            self.params.app_name, event_names=list(self.params.event_names))
        users, items, user_dict, item_dict = reindex_interactions(batch)
        props = PEventStore.aggregate_properties(
            self.params.app_name, self.params.item_entity_type)
        cats = {}
        for item, pm in props.items():
            v = pm.get("categories")
            if v is not None:
                cats[item] = [str(c) for c in (v if isinstance(v, list) else [v])]
        return SPTrainingData(
            user_idx=users,
            item_idx=items,
            user_dict=user_dict,
            item_dict=item_dict,
            item_categories=cats,
        )


class SPPreparator(Preparator):
    def prepare(self, td: SPTrainingData) -> SPTrainingData:
        return td


class SPModel(CategoryRulesMixin, PersistentModel):
    """Either item factors (als) or an indicator table (cooccurrence), and
    the per-item categories.  ``device`` is resolved where the model is
    built (default ``"cuda"``); the pickled state holds none."""

    def __init__(self, kind, item_dict, item_categories,
                 item_factors=None, indicator_idx=None, indicator_llr=None,
                 device=None):
        self.kind = kind
        self.item_dict = item_dict
        self.item_categories = item_categories
        self.item_factors = item_factors
        self.indicator_idx = indicator_idx
        self.indicator_llr = indicator_llr
        self.cat_dict, self.cat_masks = category_masks(item_categories, item_dict)
        self.to_device(device)

    def __getstate__(self):
        return {
            "kind": self.kind, "items": self.item_dict.to_state(),
            "cats": self.item_categories, "factors": self.item_factors,
            "idx": self.indicator_idx, "llr": self.indicator_llr,
        }

    def __setstate__(self, s):
        self.kind = s["kind"]
        self.item_dict = IdDict.from_state(s["items"])
        self.item_categories = s["cats"]
        self.item_factors = s["factors"]
        self.indicator_idx = s["idx"]
        self.indicator_llr = s["llr"]
        self.cat_dict, self.cat_masks = category_masks(
            self.item_categories, self.item_dict)

    def factors_norm_device(self) -> torch.Tensor:
        """Row-normalized factors, so ``Yn @ q`` is cosine · |q|; the |q|
        rescale happens on the host on k scores."""
        def build():
            f = np.asarray(self.item_factors, np.float32)
            norms = np.maximum(np.linalg.norm(f, axis=1, keepdims=True), 1e-8)
            return torch.tensor(f / norms, device=self.device)

        return self._device("_fn_dev", build)

    def indicators_device(self):
        """(ids [n_items, C] int32, LLR weights [n_items, C] f32)."""
        return self._device("_ind_dev", lambda: (
            torch.tensor(np.asarray(self.indicator_idx, np.int32), device=self.device),
            torch.tensor(np.asarray(self.indicator_llr, np.float32), device=self.device)))

    def warm(self) -> None:
        """Stage the serving state and answer one query, so the first user
        pays neither the transfer nor a first-use setup."""
        if len(self.item_dict) == 0:
            return
        if self.kind == "als" and self.item_factors is not None and len(self.item_factors):
            self.factors_norm_device()
        if self.kind == "cooccurrence" and self.indicator_idx is not None \
                and len(self.indicator_idx):
            self.indicators_device()
        self.cat_masks_device()
        _sp_predict(self, SimilarProductQuery(items=[self.item_dict.str(0)], num=1))


@dataclasses.dataclass
class SPALSParams(Params):
    rank: int = 10
    num_iterations: int = 10
    lambda_: float = 0.01
    alpha: float = 1.0      # implicit-feedback confidence slope
    seed: int = 7
    mesh_dp: int = 0        # 0 = every rank


class SPALSAlgorithm(Algorithm):
    params_class = SPALSParams

    def train(self, td: SPTrainingData) -> SPModel:
        device = resolve_device(self.device)
        n_users, n_items = len(td.user_dict), len(td.item_dict)
        if n_items == 0:
            return SPModel("als", td.item_dict, td.item_categories,
                           item_factors=np.zeros((0, self.params.rank), np.float32),
                           device=device)
        # implicit feedback (MLlib ALS.trainImplicit, as the reference
        # template calls it): view counts become confidences c = 1 + alpha·r
        cell = td.user_idx.astype(np.int64) * n_items + td.item_idx
        uniq, counts = np.unique(cell, return_counts=True)
        users = (uniq // n_items).astype(np.int32)
        items = (uniq % n_items).astype(np.int32)
        dp = self.params.mesh_dp or process_count()
        mesh = create_mesh(MeshSpec(dp=dp, mp=1)) if dp > 1 else None
        data = als_ops.prepare_als_data(
            users, items, counts.astype(np.float32), n_users, n_items, dp=dp)
        _, Y = als_ops.als_train(
            data, k=self.params.rank, reg=self.params.lambda_,
            iterations=self.params.num_iterations, mesh=mesh, seed=self.params.seed,
            implicit=True, alpha=self.params.alpha, device=device)
        return SPModel("als", td.item_dict, td.item_categories, item_factors=Y,
                       device=device)

    def warm(self, model: SPModel) -> None:
        model.warm()

    def predict(self, model: SPModel, query: SimilarProductQuery) -> PredictedResult:
        return _sp_predict(model, query)

    def serve_batch_predict(self, model: SPModel, queries):
        return _sp_predict_batch(model, queries)


@dataclasses.dataclass
class SPCooccurrenceParams(Params):
    max_correlators_per_item: int = 50
    min_llr: float = 0.0
    user_block: int = 1024
    item_tile: int = 4096
    mesh_dp: int = 0        # 0 = every rank


class SPCooccurrenceAlgorithm(Algorithm):
    params_class = SPCooccurrenceParams

    def train(self, td: SPTrainingData) -> SPModel:
        device = resolve_device(self.device)
        n_users, n_items = len(td.user_dict), len(td.item_dict)
        if n_items == 0:
            return SPModel("cooccurrence", td.item_dict, td.item_categories,
                           indicator_idx=np.zeros((0, 1), np.int32),
                           indicator_llr=np.zeros((0, 1), np.float32), device=device)
        dp = self.params.mesh_dp or process_count()
        mesh = create_mesh(MeshSpec(dp=dp, mp=1)) if dp > 1 else None
        scores, idx = cco_ops.cco_indicators_coo(
            td.user_idx, td.item_idx, td.user_idx, td.item_idx,
            n_users, n_items, n_items,
            top_k=self.params.max_correlators_per_item,
            llr_threshold=self.params.min_llr,
            user_block=self.params.user_block,
            item_tile=self.params.item_tile,
            mesh=mesh, exclude_self=True, device=device,
        )
        return SPModel(
            "cooccurrence", td.item_dict, td.item_categories,
            indicator_idx=idx.astype(np.int32),
            indicator_llr=np.where(np.isfinite(scores), scores, 0.0).astype(np.float32),
            device=device)

    def warm(self, model: SPModel) -> None:
        model.warm()

    def predict(self, model: SPModel, query: SimilarProductQuery) -> PredictedResult:
        return _sp_predict(model, query)

    def serve_batch_predict(self, model: SPModel, queries):
        return _sp_predict_batch(model, queries)


def _result(model: SPModel, scores: np.ndarray, ids: np.ndarray, num: int) -> PredictedResult:
    return PredictedResult(
        [ItemScore(model.item_dict.str(int(j)), float(s))
         for s, j in zip(scores[:num], ids[:num]) if np.isfinite(s) and s > 0])


def _sp_predict(model: SPModel, query: SimilarProductQuery) -> PredictedResult:
    """One query, device-final: the rules mask and the top-k on the model's
    device, one [2, k] copy back."""
    n_items = len(model.item_dict)
    if n_items == 0:
        return PredictedResult([])
    prepped = _sp_rule_ids(model, query)
    if prepped is None:   # no resolvable items, or an unresolvable constraint
        return PredictedResult([])
    qids, cat_ids, white, excl = prepped
    num = min(query.num, n_items)
    k = min(als_ops.bucket_width(num), n_items)
    cat_pad = als_ops.pad_ids(np.asarray(cat_ids, np.int32))
    white_pad = als_ops.pad_ids(np.asarray(white, np.int32))
    excl_pad = als_ops.pad_ids(np.asarray(excl, np.int32))
    scale = 1.0
    if model.kind == "als":
        qvec = np.asarray(model.item_factors, np.float32)[np.asarray(qids)].mean(axis=0)
        scale = 1.0 / max(float(np.linalg.norm(qvec)), 1e-8)   # Yn @ q = cosine · |q|
        out = als_ops.recommend_scores_rules(
            torch.as_tensor(qvec).to(model.device), model.factors_norm_device(),
            model.cat_masks_device(), cat_pad, white_pad, excl_pad, k)
    else:
        idx_dev, llr_dev = model.indicators_device()
        scores = als_ops.indicator_scatter_scores(idx_dev, llr_dev, als_ops.pad_ids(qids))
        out = als_ops.scores_rules_topk(scores, model.cat_masks_device(), cat_pad,
                                        white_pad, excl_pad, k)
    out = out.cpu().numpy()                # the one copy back a query
    return _result(model, out[0] * scale, out[1].astype(np.int32), num)


def _sp_rule_ids(model: SPModel, query: SimilarProductQuery):
    """(qids, cat_ids, white, excl) of one query, or None when it answers
    nothing without the device: no resolvable query item, or a category or
    whiteList constraint present but resolving to nothing."""
    qids = [model.item_dict.id(i) for i in query.items]
    qids = [q for q in qids if q is not None]
    if not qids:
        return None
    cat_ids = [c for c in (model.cat_dict.id(n) for n in query.categories or [])
               if c is not None]
    if query.categories is not None and len(cat_ids) == 0:
        return None
    white = [i for i in (model.item_dict.id(n) for n in query.white_list or [])
             if i is not None]
    if query.white_list is not None and len(white) == 0:
        return None
    excl = list(qids)
    for bl in query.black_list or []:
        bid = model.item_dict.id(bl)
        if bid is not None:
            excl.append(bid)
    return qids, cat_ids, white, excl


def _sp_predict_batch(model: SPModel, queries) -> List[PredictedResult]:
    """Micro-batch serving: every query's rules and top-k in one pass and
    one [B, 2, k] copy back; the host short-circuits answer as
    ``_sp_predict`` does."""
    n_items = len(model.item_dict)
    results: List[Optional[PredictedResult]] = [None] * len(queries)
    live: List[int] = []
    prepped = []
    for i, q in enumerate(queries):
        p = _sp_rule_ids(model, q) if n_items else None
        if p is None:
            results[i] = PredictedResult([])
        else:
            live.append(i)
            prepped.append(p)
    if not live:
        return results
    bp = als_ops.bucket_width(len(live), min_width=1)
    pad = [[]] * (bp - len(live))
    cm = als_ops.pad_id_rows([p[1] for p in prepped] + pad)
    wm = als_ops.pad_id_rows([p[2] for p in prepped] + pad)
    em = als_ops.pad_id_rows([p[3] for p in prepped] + pad)
    nums = [min(queries[i].num, n_items) for i in live]
    k = min(als_ops.bucket_width(max(nums)), n_items)
    scales = np.ones(len(live), np.float64)
    if model.kind == "als":
        f = np.asarray(model.item_factors, np.float32)
        vecs = np.zeros((bp, f.shape[1]), np.float32)
        for r, p in enumerate(prepped):
            v = f[np.asarray(p[0])].mean(axis=0)
            vecs[r] = v
            scales[r] = 1.0 / max(float(np.linalg.norm(v)), 1e-8)
        out = als_ops.recommend_batch_rules(
            torch.as_tensor(vecs).to(model.device), model.factors_norm_device(),
            model.cat_masks_device(), cm, wm, em, k)
    else:
        idx_dev, llr_dev = model.indicators_device()
        qm = als_ops.pad_id_rows([p[0] for p in prepped] + pad)
        scores = als_ops.indicator_scatter_scores_batch(idx_dev, llr_dev, qm)
        out = als_ops.scores_rules_topk_batch(scores, model.cat_masks_device(), cm, wm, em, k)
    out = out.cpu().numpy()                # one copy back for the batch
    for r, i in enumerate(live):
        results[i] = _result(model, out[r, 0] * scales[r], out[r, 1].astype(np.int32),
                             nums[r])
    return results


class SimilarProductEngine(EngineFactory):
    @classmethod
    def apply(cls) -> Engine:
        return Engine(
            data_source_class=SPDataSource,
            preparator_class=SPPreparator,
            algorithm_classes={
                "als": SPALSAlgorithm,
                "cooccurrence": SPCooccurrenceAlgorithm,
            },
            serving_class=FirstServing,
        )

    query_class = SimilarProductQuery
