"""Universal Recommender engine template (CCO): training and serving.

Counterpart of ``predictionio_tpu/models/universal_recommender/engine.py``.
Training runs ``ops.cco.cco_train_indicators`` on the device (the count
product, the K2 LLR kernel and the K3 top-k kernel) and builds a ``URModel``
whose state dict is the JAX package's, so models carry across both ways
(``convert.ur_model_from_state``).  Serving is the reference's device
scorer and device tail: the user's recent history (read from the event
store) becomes a multi-hot vector per event type, scored by one gather +
reduce over the resident [n_items, top_k] indicator table; the blacklist,
both top-ks (signal and popularity backfill) and one stacked [4, k]
readback follow on the device, and the host assembles the answer.

Not ported yet, each named in ROADMAP.md: business rules (a query with
``fields``, ``dateRange`` or a live ``currentDate`` raises ``ValueError``,
which the query server answers with 400 — never with an unfiltered
answer); the host scorer and tail, candidate pruning, the response and
rule-mask caches and spans; the micro-batched serving path; checkpointed
and multi-device training; ``read_training`` from the event store; eval.

Wire format (UR):
  query    {"user": "u1", "num": 10}
           {"item": "i1"}                              (item-similarity)
           {"itemSet": ["i1", "i2"]}                   (cart)
           {"user": "u1", "blacklistItems": ["i3"]}
  response {"itemScores": [{"item": "i5", "score": 2.1}, ...]}
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

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
from predictionio_tpu_torch.models.universal_recommender.popmodel import (
    backfill_scores,
    parse_duration,
)
from predictionio_tpu_torch.ops import cco as cco_ops
from predictionio_tpu_torch.ops.als import bucket_width, check_f32_id_range, pad_ids
from predictionio_tpu_torch.ops.topk import topk_desc
from predictionio_tpu_torch.storage.memory import parse_time
from predictionio_tpu_torch.store.columnar import CSRLookup, IdDict
from predictionio_tpu_torch.store.event_store import LEventStore

ROADMAP_RULES = "ROADMAP.md, queue A, 'UR business rules'"
ROADMAP_STORAGE = "ROADMAP.md, queue A, 'Storage and event store'"


# -- query / result ----------------------------------------------------------


@dataclasses.dataclass
class FieldRule:
    name: str
    values: List[str]
    bias: float  # -1 => hard filter; >0 => multiplicative boost

    @classmethod
    def from_json(cls, d: Dict) -> "FieldRule":
        return cls(name=str(d["name"]), values=[str(v) for v in d["values"]],
                   bias=float(d.get("bias", 1.0)))


@dataclasses.dataclass
class DateRange:
    """Hard filter on an item date property (reference UR: query dateRange
    with name/before/after ISO-8601 bounds)."""

    name: str
    after: Optional[str] = None    # keep items with prop >= after
    before: Optional[str] = None   # keep items with prop <= before

    @classmethod
    def from_json(cls, d: Dict) -> "DateRange":
        return cls(name=str(d["name"]),
                   after=d.get("after"), before=d.get("before"))


@dataclasses.dataclass
class URQuery:
    user: Optional[str] = None
    item: Optional[str] = None
    # shopping-cart style: recommend for a SET of items (reference UR
    # itemSet queries — wishlist/cart complements)
    item_set: List[str] = dataclasses.field(default_factory=list)
    num: int = 20
    fields: List[FieldRule] = dataclasses.field(default_factory=list)
    blacklist_items: List[str] = dataclasses.field(default_factory=list)
    return_self: bool = False
    date_range: Optional[DateRange] = None
    # "now" for availableDateName/expireDateName checks; ISO-8601
    current_date: Optional[str] = None

    def __post_init__(self):
        self.fields = [
            f if isinstance(f, FieldRule) else FieldRule.from_json(f) for f in self.fields
        ]
        if self.date_range is not None and not isinstance(self.date_range, DateRange):
            self.date_range = DateRange.from_json(self.date_range)

    @classmethod
    def from_json(cls, d: Dict) -> "URQuery":
        return cls(
            user=str(d["user"]) if d.get("user") is not None else None,
            item=str(d["item"]) if d.get("item") is not None else None,
            item_set=[str(i) for i in d.get("itemSet", [])],
            num=int(d.get("num", 20)),
            fields=[FieldRule.from_json(f) for f in d.get("fields", [])],
            blacklist_items=[str(b) for b in d.get("blacklistItems", [])],
            return_self=bool(d.get("returnSelf", False)),
            date_range=DateRange.from_json(d["dateRange"]) if d.get("dateRange") else None,
            current_date=d.get("currentDate"),
        )


@dataclasses.dataclass
class ItemScore:
    item: str
    score: float

    def to_json(self) -> Dict:
        return {"item": self.item, "score": self.score}


@dataclasses.dataclass
class URResult:
    item_scores: List[ItemScore]

    def to_json(self) -> Dict:
        return {"itemScores": [s.to_json() for s in self.item_scores]}


# -- DASE: data source and preparator ------------------------------------------


@dataclasses.dataclass
class URDataSourceParams(Params):
    app_name: str = "default"
    event_names: List[str] = dataclasses.field(default_factory=lambda: ["purchase", "view"])
    item_entity_type: str = "item"
    eval_users: int = 0
    eval_num: int = 10
    eval_seed: int = 0


@dataclasses.dataclass
class URTrainingData:
    """Per-event-type COO with a shared user dictionary.

    interactions[event_name] = (user_idx, item_idx, item_dict, times); the
    primary event is event_names[0] and defines the recommendable item
    space; ``times`` is epoch seconds per event (feeds the PopModel
    backfill windows)."""

    event_names: List[str]
    user_dict: IdDict
    interactions: Dict[str, Tuple[np.ndarray, np.ndarray, IdDict, np.ndarray]]
    item_properties: Dict[str, Dict[str, Any]]  # item id -> property map


class URDataSource(DataSource):
    params_class = URDataSourceParams

    def read_training(self) -> URTrainingData:
        raise NotImplementedError(
            f"the port has no bulk event read yet ({ROADMAP_STORAGE}); build "
            "URTrainingData from arrays with models.universal_recommender."
            "convert.ur_training_data_from_arrays")


class URPreparator(Preparator):
    """Identity (reference URPreparator builds Mahout IndexedDatasets)."""

    def prepare(self, td: URTrainingData) -> URTrainingData:
        return td


# -- model -------------------------------------------------------------------


class URModel(DeviceCacheMixin, PersistentModel):
    """Indicator tables per event type + popularity + item properties.

    For event type t: ``indicator_idx[t]`` [I_p, K] holds correlated item ids
    in t's item space (-1 padding), ``indicator_llr[t]`` the LLR strengths.
    ``user_seen`` is a CSR lookup (user → primary items).  The pickled
    state is the JAX ``URModel``'s dict and holds no device: a restored
    model serves on the default device (``"cuda"``)."""

    def __init__(
        self,
        primary_event: str,
        item_dict: IdDict,
        user_dict: IdDict,
        indicator_idx: Dict[str, np.ndarray],
        indicator_llr: Dict[str, np.ndarray],
        event_item_dicts: Dict[str, IdDict],
        popularity: np.ndarray,
        item_properties: Dict[str, Dict[str, Any]],
        user_seen: CSRLookup,
        user_seen_by_event: Optional[Dict[str, CSRLookup]] = None,
        device=None,
    ):
        self.primary_event = primary_event
        self.item_dict = item_dict
        self.user_dict = user_dict
        self.indicator_idx = indicator_idx
        self.indicator_llr = indicator_llr
        self.event_item_dicts = event_item_dicts
        self.popularity = popularity
        self.item_properties = item_properties
        self.user_seen = user_seen
        # non-primary blacklist_events: user → seen items mapped into the
        # PRIMARY item space
        self.user_seen_by_event = user_seen_by_event or {}
        self.device = resolve_device(device)

    def __getstate__(self):
        return {
            "primary_event": self.primary_event,
            "items": self.item_dict.to_state(),
            "users": self.user_dict.to_state(),
            "indicator_idx": self.indicator_idx,
            "indicator_llr": self.indicator_llr,
            "event_items": {k: d.to_state() for k, d in self.event_item_dicts.items()},
            "popularity": self.popularity,
            "item_properties": self.item_properties,
            "user_seen": self.user_seen.to_state(),
            "user_seen_by_event": {
                k: c.to_state() for k, c in self.user_seen_by_event.items()},
        }

    def __setstate__(self, s):
        self.__init__(
            s["primary_event"], IdDict.from_state(s["items"]),
            IdDict.from_state(s["users"]), s["indicator_idx"], s["indicator_llr"],
            {k: IdDict.from_state(v) for k, v in s["event_items"].items()},
            s["popularity"], s["item_properties"],
            CSRLookup.from_state(s["user_seen"]),
            {k: CSRLookup.from_state(v)
             for k, v in s.get("user_seen_by_event", {}).items()})

    # -- device-resident serving state (staged once, never pickled) ---------

    def device_indicators(self) -> Dict[str, Tuple[torch.Tensor, torch.Tensor,
                                                   torch.Tensor]]:
        """Per event type, the indicator table staged to the device ONCE:
        (ids [I_p, K] int64 with -1 padding sent to a sink id n_t, the 0/1
        validity weights, the LLR weights with 0 at padding)."""
        def stage():
            out = {}
            for name, idx in self.indicator_idx.items():
                n_t = max(len(self.event_item_dicts[name]), 1)
                idx = torch.as_tensor(np.asarray(idx, np.int64), device=self.device)
                llr = torch.as_tensor(np.asarray(self.indicator_llr[name], np.float32),
                                      device=self.device)
                valid = idx >= 0
                out[name] = (torch.where(valid, idx, n_t), valid.to(torch.float32),
                             torch.where(valid, llr, 0.0))
            return out
        return self._device("_dev_indicators", stage)

    def device_popularity(self) -> torch.Tensor:
        return self._device("_dev_pop", lambda: torch.tensor(
            np.asarray(self.popularity, np.float32), device=self.device))

    def device_ones(self) -> torch.Tensor:
        return self._device("_dev_ones", lambda: torch.ones(
            len(self.item_dict), dtype=torch.float32, device=self.device))

    def device_zeros(self) -> torch.Tensor:
        return self._device("_dev_zeros", lambda: torch.zeros(
            len(self.item_dict), dtype=torch.float32, device=self.device))

    def pop_norm(self) -> float:
        return self._device("_pop_norm", lambda: max(
            float(np.abs(self.popularity).max()), 1.0)
            if len(self.popularity) else 1.0)

    def warm(self) -> None:
        """Stage the serving state and run one backfill query's device tail
        (called at deploy), so the first user pays neither the transfer nor
        the first use of the device ops."""
        self.device_indicators()
        self.pop_norm()
        n = len(self.item_dict)
        if n:
            _serve_topk(self.device_zeros(), self.device_ones(),
                        self.device_popularity(), pad_ids([]),
                        min(bucket_width(1), n)).cpu()


# -- device serving ops --------------------------------------------------------


def _indicator_score_ids(
    idx: torch.Tensor,       # [I_p, K] int64, padding = n_items_t
    weight: torch.Tensor,    # [I_p, K] f32: validity or LLR weights
    hist_ids,                # [W] history item ids in t-space, -1 padding
    n_items_t: int,
) -> torch.Tensor:
    """score[i] = Σ_k 1[idx[i,k] ∈ hist] · w[i,k].  The history multi-hot
    is built on the device from the small padded id list; padding and
    unknown ids land in a sink entry past the last item, which stays 0."""
    ids = torch.as_tensor(hist_ids).to(device=idx.device, dtype=torch.int64)
    ids = torch.where((ids >= 0) & (ids < n_items_t), ids, n_items_t)
    hvec = torch.zeros(n_items_t + 1, dtype=torch.float32, device=idx.device)
    hvec.index_fill_(0, ids, 1.0)
    hvec[n_items_t] = 0.0
    return (hvec[idx] * weight).sum(-1)


def _serve_topk(signal, mask, bf, black_ids, k: int) -> torch.Tensor:
    """The device tail: apply the rule mask and the blacklist, take the
    top-k of the signal and the top-k of the backfill eligibility, and
    stack both as one [4, k] f32 tensor, so one copy crosses back to the
    host (item ids are exact in f32 below 2**24)."""
    n = signal.shape[0]
    check_f32_id_range(n)
    ids = torch.as_tensor(black_ids).to(device=signal.device, dtype=torch.int64)
    ids = torch.where((ids >= 0) & (ids < n), ids, n)
    excl = torch.zeros(n + 1, dtype=torch.bool, device=signal.device)
    excl[ids] = True
    excl = excl[:n]
    neg_inf = torch.tensor(float("-inf"), device=signal.device)
    st, si = topk_desc(torch.where(excl, neg_inf, signal * mask), k)
    # backfill ranks by bf * mask; mask > 0 is the eligibility cut
    bt, bi = topk_desc(torch.where((mask > 0) & ~excl, bf * mask, neg_inf), k)
    return torch.stack([st, si.to(torch.float32), bt, bi.to(torch.float32)])


# -- algorithm ---------------------------------------------------------------


@dataclasses.dataclass
class URAlgorithmParams(Params):
    app_name: str = "default"
    event_names: List[str] = dataclasses.field(default_factory=list)  # default: data source's
    max_correlators_per_item: int = 50
    min_llr: float = 0.0
    max_query_events: int = 100
    num: int = 20
    user_block: int = 1024
    item_tile: int = 4096
    mesh_dp: int = 0
    use_llr_weights: bool = False
    blacklist_events: List[str] = dataclasses.field(default_factory=list)  # default: primary
    # per-event-type tuning overrides (reference UR: indicators config),
    # e.g. {"view": {"maxCorrelatorsPerItem": 25, "minLLR": 4.0}}
    indicator_params: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
    backfill_type: str = "popular"  # popular | trending | hot | none
    backfill_duration: str = "3650 days"
    backfill_event_names: List[str] = dataclasses.field(default_factory=list)
    checkpoint: bool = False
    checkpoint_dir: str = ""
    indicator_weights: Dict[str, float] = dataclasses.field(default_factory=dict)
    available_date_name: str = ""
    expire_date_name: str = ""


class URAlgorithm(Algorithm):
    """CCO training and serving.  ``device`` is where ``train`` builds the
    model (default ``"cuda"``; it raises without a card unless ``"cpu"``
    is asked for); ``predict`` follows the model's own device."""

    params_class = URAlgorithmParams

    def __init__(self, params: Optional[Params] = None, device=None):
        super().__init__(params)
        self.device = device

    @staticmethod
    def per_type_tuning(params: URAlgorithmParams,
                        event_names: Sequence[str],
                        ) -> Dict[str, Tuple[int, float]]:
        """Per-event-type (max_correlators, min_llr) overrides parsed from
        ``indicator_params``."""
        per_type: Dict[str, Tuple[int, float]] = {}
        for name, over in (params.indicator_params or {}).items():
            if name not in event_names:
                raise ValueError(
                    f"indicator_params names unknown event type {name!r}; "
                    f"configured event_names: {list(event_names)}")
            t_k = params.max_correlators_per_item
            t_llr = params.min_llr
            for key, val in over.items():
                norm = key.replace("_", "").lower()   # minLLR/minLlr/min_llr
                if norm == "maxcorrelatorsperitem":
                    t_k = int(val)
                elif norm == "minllr":
                    t_llr = float(val)
                else:
                    raise ValueError(
                        f"indicator_params[{name!r}]: unknown key {key!r} "
                        "(expected maxCorrelatorsPerItem / minLLR)")
            per_type[name] = (t_k, t_llr)
        return per_type

    def train(self, td: URTrainingData) -> URModel:
        device = resolve_device(self.device)
        primary = td.event_names[0]
        p_user, p_item, p_item_dict, p_times = td.interactions[primary]
        n_users = len(td.user_dict)
        n_items = len(p_item_dict)
        if n_items == 0:
            raise ValueError(f"no {primary!r} events to train on")
        blacklist_events = self.params.blacklist_events or [primary]
        unknown = [b for b in blacklist_events if b not in td.event_names]
        if unknown:
            raise ValueError(
                f"blacklist_events {unknown} not in event_names {td.event_names}")
        if self.params.mesh_dp > 1:
            raise NotImplementedError(
                f"mesh_dp={self.params.mesh_dp}: {cco_ops.ROADMAP_MESH}")
        if self.params.checkpoint:
            raise NotImplementedError(
                "checkpointed UR training is not ported yet (ROADMAP.md, "
                "queue A, 'the host tail, pruning and caches')")
        others = []
        event_item_dicts: Dict[str, IdDict] = {}
        for name in td.event_names:
            u, i, item_dict, _ = td.interactions[name]
            if name != primary and len(item_dict) == 0:
                continue
            if name == primary:
                u, i = p_user, p_item  # identity → the self-indicator reuses P
            others.append((name, u, i, len(item_dict)))
            event_item_dicts[name] = item_dict
        results = cco_ops.cco_train_indicators(
            p_user, p_item, others, n_users, n_items,
            top_k=self.params.max_correlators_per_item,
            llr_threshold=self.params.min_llr,
            exclude_self_for=primary,
            user_block=self.params.user_block,
            item_tile=self.params.item_tile,
            per_type=self.per_type_tuning(self.params, td.event_names),
            device=device)
        indicator_idx: Dict[str, np.ndarray] = {}
        indicator_llr: Dict[str, np.ndarray] = {}
        for name, (scores, idx) in results.items():
            indicator_idx[name] = idx.astype(np.int32)
            indicator_llr[name] = np.where(np.isfinite(scores), scores, 0.0).astype(np.float32)
        user_seen = CSRLookup.from_pairs(p_user, p_item, n_users)
        # PopModel backfill over the event-time window (raw events: volume)
        bf_names = self.params.backfill_event_names or [primary]
        unknown_bf = [b for b in bf_names if b not in td.event_names]
        if unknown_bf:
            raise ValueError(
                f"backfill_event_names {unknown_bf} not in event_names "
                f"{td.event_names}")
        bf_items, bf_times = [], []
        for name in bf_names:
            u, i, item_dict_t, times = td.interactions[name]
            if name == primary:
                bf_items.append(p_item)
                bf_times.append(p_times)
            else:
                mapped = p_item_dict.lookup_many(item_dict_t.strings())[i]
                keep = mapped >= 0
                bf_items.append(mapped[keep])
                bf_times.append(times[keep])
        popularity = backfill_scores(
            self.params.backfill_type, np.concatenate(bf_items),
            np.concatenate(bf_times), n_items,
            parse_duration(self.params.backfill_duration))
        # per-event seen CSRs for non-primary blacklist_events, in the
        # primary item space
        user_seen_by_event: Dict[str, CSRLookup] = {}
        for name in blacklist_events:
            if name == primary or name not in event_item_dicts:
                continue
            u, i, item_dict, _ = td.interactions[name]
            mapped = p_item_dict.lookup_many(item_dict.strings())[i]
            keep = mapped >= 0
            user_seen_by_event[name] = CSRLookup.from_pairs(
                u[keep], mapped[keep], n_users)
        return URModel(
            primary_event=primary,
            item_dict=p_item_dict,
            user_dict=td.user_dict,
            indicator_idx=indicator_idx,
            indicator_llr=indicator_llr,
            event_item_dicts=event_item_dicts,
            popularity=popularity,
            item_properties=td.item_properties,
            user_seen=user_seen,
            user_seen_by_event=user_seen_by_event,
            device=device,
        )

    def warm(self, model: URModel) -> None:
        model.warm()

    # -- serving -------------------------------------------------------------

    def _user_history(self, model: URModel, user: str) -> Dict[str, np.ndarray]:
        """Recent item ids per event type, from the live event store
        (reference: URAlgorithm.predict reading LEventStore)."""
        hist: Dict[str, np.ndarray] = {}
        for name, item_dict in model.event_item_dicts.items():
            try:
                events = LEventStore.find_by_entity(
                    self.params.app_name, "user", user, event_names=[name],
                    limit=self.params.max_query_events)
            except ValueError:   # the app does not exist: no history
                events = []
            ids = {item_dict.id(e.target_entity_id) for e in events
                   if e.target_entity_id is not None}
            ids.discard(None)
            hist[name] = np.asarray(sorted(ids), np.int32)
        return hist

    def _score_history(self, model: URModel, hist: Dict[str, np.ndarray]
                       ) -> Optional[torch.Tensor]:
        """The device scorer over every event type's history: a query ships
        a few hundred bytes of ids and the [I_p] signal stays on the
        device.  None when no event type carries history."""
        total = None
        for name, (idx, valid, llr) in model.device_indicators().items():
            h_ids = hist.get(name)
            if h_ids is None or len(h_ids) == 0:
                continue
            n_t = max(len(model.event_item_dicts[name]), 1)
            s = _indicator_score_ids(idx, llr if self.params.use_llr_weights
                                     else valid, pad_ids(h_ids), n_t)
            weight = float(self.params.indicator_weights.get(name, 1.0))
            s = s * weight if weight != 1.0 else s
            total = s if total is None else total + s
        return total

    def _check_rules(self, query: URQuery) -> None:
        """Business rules are not ported: a query that carries one is
        refused (400), never answered unfiltered.  A ``currentDate`` is a
        rule only when the engine names an available/expire date property;
        otherwise it is inert, but must still parse, as in the reference."""
        current = query.current_date
        live_date = bool(current) and bool(
            self.params.available_date_name or self.params.expire_date_name)
        if query.fields or query.date_range is not None or live_date:
            raise ValueError(
                "business rules (fields, dateRange, currentDate) are not "
                f"ported yet ({ROADMAP_RULES})")
        if current:
            try:
                parse_time(current)
            except (ValueError, TypeError) as e:
                raise ValueError(f"currentDate: {current!r} is not an "
                                 "ISO-8601 date") from e

    def batch_predict(self, model: URModel, queries) -> List[URResult]:
        """Eval-time predictions: user history comes from the MODEL's
        training interactions (user_seen), never the live event store."""
        out = []
        for q in queries:
            hist: Dict[str, np.ndarray] = {}
            if q.user is not None:
                uid = model.user_dict.id(q.user)
                if uid is not None:
                    row = model.user_seen.row(uid)
                    if len(row):
                        hist[model.primary_event] = row.astype(np.int32)
            out.append(self.predict(model, q, hist_override=hist))
        return out

    def predict(self, model: URModel, query: URQuery,
                hist_override: Optional[Dict[str, np.ndarray]] = None) -> URResult:
        """Serve one query: history → device scorer → device tail (mask,
        blacklist, both top-ks, one [4, k] readback) → host assembly."""
        n_items = len(model.item_dict)
        if n_items == 0:
            return URResult([])
        self._check_rules(query)
        hist = self._query_hist(model, query, hist_override)
        signal = self._score_history(model, hist) if hist is not None else None
        return self._device_tail(model, query, signal, min(query.num, n_items))

    def _device_tail(self, model: URModel, query: URQuery,
                     signal: Optional[torch.Tensor], num: int) -> URResult:
        black_ids = self._blacklist_ids(model, query)
        sig = model.device_zeros() if signal is None else signal
        # k covers the worst case: every signal pick also occupying a
        # backfill slot; bucketed so distinct nums share shapes
        k = min(bucket_width(2 * num, 16), len(model.item_dict))
        out = _serve_topk(sig, model.device_ones(), model.device_popularity(),
                          pad_ids(black_ids), k).cpu().numpy()
        return self._assemble(model, num, signal is not None,
                              out[0], out[1].astype(np.int32),
                              out[2], out[3].astype(np.int32))

    def _query_hist(self, model: URModel, query: URQuery,
                    hist_override: Optional[Dict[str, np.ndarray]] = None,
                    ) -> Optional[Dict[str, np.ndarray]]:
        """Per-event-type history ids driving the signal, or None when the
        query carries no personalization handle (pure backfill)."""
        set_ids = [model.item_dict.id(i) for i in query.item_set]
        set_ids = [i for i in set_ids if i is not None]
        if query.item is not None or set_ids:
            # item-similarity / itemSet: the query items' OWN indicator
            # lists act as a virtual history on each event type's field
            if query.item is not None:
                iid = model.item_dict.id(query.item)
                if iid is not None:
                    set_ids.append(iid)
            if not set_ids:
                return None
            hist: Dict[str, np.ndarray] = {}
            for name, idx in model.indicator_idx.items():
                rows = idx[np.asarray(set_ids, np.int32)]
                ids = np.unique(rows[rows >= 0])
                if len(ids):
                    hist[name] = ids.astype(np.int32)
            return hist
        if query.user is not None:
            return (hist_override if hist_override is not None
                    else self._user_history(model, query.user))
        return None

    def _assemble(self, model: URModel, num: int, have_signal: bool,
                  st, si, bt, bi) -> URResult:
        """Signal picks first, then popularity backfill pads short lists up
        to num (reference UR appends popRank-ordered items)."""
        results: List[ItemScore] = []
        chosen = set()
        if have_signal:
            for s, j in zip(st, si):
                if np.isfinite(s) and s > 0 and len(results) < num:
                    results.append(ItemScore(model.item_dict.str(int(j)), float(s)))
                    chosen.add(int(j))
        if len(results) < num and self.params.backfill_type != "none":
            norm = model.pop_norm()
            for s, j in zip(bt, bi):
                if len(results) >= num:
                    break
                if int(j) in chosen or not np.isfinite(s):
                    continue
                results.append(ItemScore(model.item_dict.str(int(j)), float(s) / norm))
        return URResult(results)

    def _blacklist_ids(self, model: URModel, query: URQuery) -> List[int]:
        """Item ids to exclude: the user's seen items under every configured
        blacklist event type, query blacklistItems, and self for item
        queries."""
        ids: List[int] = []
        if query.user is not None:
            uid = model.user_dict.id(query.user)
            if uid is not None:
                for name in self.params.blacklist_events or [model.primary_event]:
                    if name == model.primary_event:
                        ids.extend(model.user_seen.row(uid).tolist())
                    else:
                        csr = model.user_seen_by_event.get(name)
                        if csr is not None:
                            ids.extend(csr.row(uid).tolist())
        black = set(query.blacklist_items)
        if not query.return_self:
            if query.item is not None:
                black.add(query.item)
            black.update(query.item_set)
        for b in black:
            bid = model.item_dict.id(b)
            if bid is not None:
                ids.append(bid)
        return ids


class UniversalRecommenderEngine(EngineFactory):
    @classmethod
    def apply(cls) -> Engine:
        return Engine(
            data_source_class=URDataSource,
            preparator_class=URPreparator,
            algorithm_classes={"ur": URAlgorithm},
            serving_class=FirstServing,
        )

    query_class = URQuery
