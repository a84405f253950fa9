"""Universal Recommender engine template (CCO): training and serving.

Counterpart of ``predictionio_tpu/models/universal_recommender/engine.py``.
Training runs ``ops.cco.cco_train_indicators`` on the device (the count
product, the K2 LLR kernel and the K3 top-k kernel) and builds a ``URModel``
whose state dict is the JAX package's, so models carry across both ways
(``convert.ur_model_from_state``).  Training data comes
from the event store (``URDataSource.read_training``: one ``PEventStore``
batch of the interactions, item properties folded from ``$set`` events).
Serving is the reference's device scorer and device tail: the user's
recent history (read from the event store) becomes a multi-hot vector per
event type, scored by one gather + reduce over the resident
[n_items, top_k] indicator table; the business-rule mask (field filters
and boosts, ``dateRange``, ``currentDate`` against the available/expire
dates), the blacklist, both top-ks (signal and popularity backfill) and
one stacked [4, k] readback follow on the device, and the host assembles
the answer.

The query server's micro-batcher serves through ``serve_batch_predict``:
a batch's histories score against the resident tables in one gather a
event type, and both top-ks for the whole batch come back in one
[B, 4, k] readback.

Not ported yet, each named in ROADMAP.md: the host scorer and tail,
candidate pruning, the response, composed rule-mask and history caches and
spans (the composed mask is built from its rule key on every query);
checkpointed and multi-device training; eval.

Wire format (UR):
  query    {"user": "u1", "num": 10}
           {"item": "i1"}                              (item-similarity)
           {"itemSet": ["i1", "i2"]}                   (cart)
           {"user": "u1", "fields": [{"name": "category",
             "values": ["phones"], "bias": -1}],        (-1 filter, >0 boost)
            "blacklistItems": ["i3"]}
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
from predictionio_tpu_torch.events.event import parse_time
from predictionio_tpu_torch.models.common import DeviceCacheMixin, LRUCache
from predictionio_tpu_torch.models.universal_recommender.popmodel import (
    backfill_scores,
    parse_duration,
)
from predictionio_tpu_torch.ops import cco as cco_ops
from predictionio_tpu_torch.ops.als import bucket_width, check_f32_id_range, pad_ids
from predictionio_tpu_torch.ops.topk import topk_desc
from predictionio_tpu_torch.store.columnar import CSRLookup, IdDict, fold_properties
from predictionio_tpu_torch.store.event_store import LEventStore, PEventStore


# -- query / result ----------------------------------------------------------


def _iso_ts(v) -> Optional[float]:
    """Date value → epoch seconds via the event pipeline's own coercion
    (events.event.parse_time: ISO-8601 string, numeric epoch, or datetime;
    naive treated as UTC); None if unparseable.

    Unlike raw parse_time, None and booleans return None here — parse_time
    maps None to "now" and bool is an int subclass, either of which would
    turn a malformed query date into a silently wrong hard filter."""
    if v is None or isinstance(v, bool):
        return None
    try:
        return parse_time(v).timestamp()
    except (ValueError, OSError, OverflowError):
        return None


def _query_ts(v, field: str) -> float:
    """Strict variant for query-supplied dates: malformed input rejects the
    query (the server maps ValueError to HTTP 400) instead of silently
    disabling a hard filter."""
    ts = _iso_ts(v)
    if ts is None:
        raise ValueError(f"{field}: {v!r} is not an ISO-8601 date")
    return ts


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
        """One columnar batch read for ALL event types, then vectorized
        per-type dictionary translation.  On a segment backend one native
        scan serves both the interactions and the ``$set``/``$unset``/
        ``$delete`` folds of the item entity type (``fold_properties``);
        elsewhere the rows are read and the properties aggregated from the
        store (the JAX package's two branches)."""
        user_dict = IdDict()
        interactions: Dict[str, Tuple[np.ndarray, np.ndarray, IdDict, np.ndarray]] = {}
        full = PEventStore.native_batch(self.params.app_name)
        if full is not None and full.prop_columns is not None:
            # interactions read no property column: dropping them first
            # keeps select_events from remapping every column
            batch = dataclasses.replace(full, prop_columns=None).select_events(
                list(self.params.event_names))
            props = fold_properties(full, self.params.item_entity_type)
        else:
            batch = dataclasses.replace(PEventStore.batch(
                self.params.app_name, event_names=list(self.params.event_names)),
                prop_columns=None)
            props = PEventStore.aggregate_properties(
                self.params.app_name, self.params.item_entity_type)
        # entity codes → one global user id space.  Only codes REFERENCED by
        # interaction rows enroll (the native scan's entity dictionary also
        # holds $set item ids; enrolling those would inflate n_users and
        # corrupt the LLR population total).
        user_of_code = np.full(max(len(batch.entity_dict), 1), -1, np.int32)
        for name in self.params.event_names:
            sel = batch.select_events([name])
            has_t = sel.target_ids >= 0
            for c in np.unique(sel.entity_ids[has_t]):
                if user_of_code[c] < 0:
                    user_of_code[c] = user_dict.add(batch.entity_dict.str(int(c)))
            t_codes = sel.target_ids[has_t]
            uniq = np.unique(t_codes)
            item_dict = IdDict(
                [batch.target_dict.str(int(c)) for c in uniq])
            local_of_target = np.full(max(len(batch.target_dict), 1), -1, np.int32)
            local_of_target[uniq] = np.arange(len(uniq), dtype=np.int32)
            interactions[name] = (
                user_of_code[sel.entity_ids[has_t]].astype(np.int32),
                local_of_target[t_codes].astype(np.int32),
                item_dict,
                sel.times_us[has_t].astype(np.float64) / 1e6,
            )
        return URTrainingData(
            event_names=list(self.params.event_names),
            user_dict=user_dict,
            interactions=interactions,
            item_properties={k: dict(v) for k, v in props.items()},
        )


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
    model resolves its device at first staging (``to_device``, else the
    default ``"cuda"``)."""

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
        self.to_device(device)

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
        # no device here: unpickling never touches one (see to_device)
        self.primary_event = s["primary_event"]
        self.item_dict = IdDict.from_state(s["items"])
        self.user_dict = IdDict.from_state(s["users"])
        self.indicator_idx = s["indicator_idx"]
        self.indicator_llr = s["indicator_llr"]
        self.event_item_dicts = {k: IdDict.from_state(v) for k, v in s["event_items"].items()}
        self.popularity = s["popularity"]
        self.item_properties = s["item_properties"]
        self.user_seen = CSRLookup.from_state(s["user_seen"])
        self.user_seen_by_event = {
            k: CSRLookup.from_state(v)
            for k, v in s.get("user_seen_by_event", {}).items()}

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

    # -- business-rule state (built lazily, never pickled) ---------------------

    _VALUE_MASK_CACHE_MAX = 512
    _DATE_CACHE_MAX = 512

    def _lru(self, attr: str, max_entries: int, on_device: bool) -> LRUCache:
        """A bounded LRU in ``__dict__``; a cache of device tensors is
        registered as staged, so ``to_device`` drops it."""
        if on_device:
            return self._device(attr, lambda: LRUCache(max_entries))
        cache = self.__dict__.get(attr)
        if cache is None:
            # dict.setdefault is atomic under the GIL: racing creators
            # both construct, one instance wins, both use it
            cache = self.__dict__.setdefault(attr, LRUCache(max_entries))
        return cache

    def known_prop_names(self) -> frozenset:
        """Property names that exist on at least one item — the gate that
        keeps query-supplied field/date names from triggering O(n_items)
        index builds or device-array caching for properties that cannot
        match anything (ES semantics: a filter on a nonexistent field
        matches no documents)."""
        names = self.__dict__.get("_known_prop_names")
        if names is None:
            names = frozenset(
                k for props in self.item_properties.values() for k in props)
            self.__dict__["_known_prop_names"] = names
        return names

    def _value_mask_ids(self, name: str, value: str) -> Optional[np.ndarray]:
        """Item ids holding (name, value); None for unknown names/values
        (the match-nothing case — callers substitute their zero mask
        WITHOUT caching: query fields are user input, caching unknowns
        would let arbitrary queries pin unbounded memory)."""
        if name not in self.known_prop_names():
            return None
        return self.prop_value_index(name).get(value)

    def _ids_to_mask(self, ids: np.ndarray) -> np.ndarray:
        m = np.zeros(len(self.item_dict), np.float32)
        m[ids] = 1.0
        return m

    def device_value_mask(self, name: str, value: str) -> torch.Tensor:
        """0/1 device mask of items whose property ``name`` holds ``value``
        — the Elasticsearch-filter-bitset analogue, cached per (name, value)
        in a bounded thread-safe LRU (touch-on-hit)."""
        ids = self._value_mask_ids(name, value)
        if ids is None:
            return self.device_zeros()
        cache = self._lru("_dev_value_mask", self._VALUE_MASK_CACHE_MAX, True)
        return cache.get_or_build(
            (name, value),
            lambda: torch.as_tensor(self._ids_to_mask(ids), device=self.device))

    def date_offsets(self, name: str) -> Optional[Tuple[float, np.ndarray]]:
        """(base_epoch_s, int32 offsets) for a date property; -1 where
        missing; None when NO item has the property (callers must treat
        that as match-nothing — and it keeps query-supplied names from
        growing the cache).  Integer seconds relative to the earliest
        value keep boundary comparisons EXACT (f32 epoch offsets would
        quantize to ~32 s over decade spans); sub-second precision is
        rounded, matching the second-granularity date semantics of the
        reference's ES range filters.  The device path stages exactly
        these offsets."""
        if name not in self.known_prop_names():
            return None
        cache = self._lru("_date_off", self._DATE_CACHE_MAX, False)

        def build():
            ts = self.prop_date_array(name)
            missing = np.isnan(ts)
            finite = ts[~missing]
            base = float(finite.min()) if len(finite) else 0.0
            off = np.where(missing, -1.0, np.rint(ts - base))
            return base, np.clip(off, -1, 2**31 - 2).astype(np.int32)

        return cache.get_or_build(name, build)

    def device_date(self, name: str) -> Optional[Tuple[float, torch.Tensor]]:
        """Device staging of date_offsets (same base, same int32 array)."""
        d = self.date_offsets(name)
        if d is None:
            return None
        cache = self._lru("_dev_date", self._DATE_CACHE_MAX, True)
        return cache.get_or_build(
            name, lambda: (d[0], torch.as_tensor(d[1], device=self.device)))

    def prop_value_index(self, name: str) -> Dict[str, np.ndarray]:
        """value -> item ids holding it, for one property — lets field rules
        apply as a few array writes instead of a per-item Python loop."""
        cache = self.__dict__.setdefault("_prop_value_index", {})
        if name not in cache:
            idx: Dict[str, list] = {}
            for j in range(len(self.item_dict)):
                v = self.item_properties.get(self.item_dict.str(j), {}).get(name)
                if v is None:
                    continue
                for x in (v if isinstance(v, list) else [v]):
                    idx.setdefault(str(x), []).append(j)
            cache[name] = {k: np.asarray(v, np.int32) for k, v in idx.items()}
        return cache[name]

    def prop_date_array(self, name: str) -> np.ndarray:
        """Per-item epoch seconds of a date property (NaN where missing)."""
        cache = self.__dict__.setdefault("_prop_date_array", {})
        if name not in cache:
            out = np.full(len(self.item_dict), np.nan)
            for j in range(len(self.item_dict)):
                v = self.item_properties.get(self.item_dict.str(j), {}).get(name)
                if v is None:
                    continue
                ts = _iso_ts(v)  # lenient: bad item data skips, query-side is strict
                if ts is not None:
                    out[j] = ts
            cache[name] = out
        return cache[name]

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


# device mask composition: plain elementwise torch ops in the reference's
# order of factors, so the composed f32 mask is the JAX one bit for bit


def _m_or(a, b):
    return torch.maximum(a, b)


def _m_hard(mask, match):
    return mask * match


def _m_boost(mask, match, bias: float):
    return mask * torch.where(match > 0, bias, 1.0)


# date arrays are int32 second-offsets with -1 = property missing; every
# check requires presence (ES range filters match only docs with the field)


def _m_present(mask, ts):
    return mask * (ts >= 0).to(torch.float32)


def _m_ge(mask, ts, bound: int):
    return mask * ((ts >= bound) & (ts >= 0)).to(torch.float32)


def _m_le(mask, ts, bound: int):
    return mask * ((ts <= bound) & (ts >= 0)).to(torch.float32)


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


def _indicator_score_ids_batch(
    idx: torch.Tensor,       # [I_p, K] int64, padding = n_items_t
    weight: torch.Tensor,    # [I_p, K] f32: validity or LLR weights
    hist_ids,                # [B, W] per-query history ids, -1 padding
    n_items_t: int,
) -> torch.Tensor:           # [B, I_p]
    """Batched ``_indicator_score_ids``: one gather scores a whole
    micro-batch's histories against the resident table.  A row whose
    history is all padding scores 0 everywhere, so event types missing for
    some queries need no regrouping on the host.  The [B, I_p, K] gather
    is the transient (multiplied in place): 16 x 100,000 x 50 x 4 B = 320
    MB at the UR's batch cap and the deployed width."""
    ids = torch.as_tensor(hist_ids).to(device=idx.device, dtype=torch.int64)
    ids = torch.where((ids >= 0) & (ids < n_items_t), ids, n_items_t)
    hvec = torch.zeros((ids.shape[0], n_items_t + 1), dtype=torch.float32,
                       device=idx.device)
    hvec.scatter_(1, ids, 1.0)
    hvec[:, n_items_t] = 0.0
    return hvec[:, idx].mul_(weight).sum(-1)


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


def _serve_topk_batch(signal, mask, bf, black_ids, k: int) -> torch.Tensor:
    """Batched ``_serve_topk``: both top-ks of B queries ([B, I] signal and
    mask, [B, W] blacklist ids) as one [B, 4, k] f32 tensor, one copy
    back to the host for the whole micro-batch."""
    b, n = signal.shape
    check_f32_id_range(n)
    ids = torch.as_tensor(black_ids).to(device=signal.device, dtype=torch.int64)
    ids = torch.where((ids >= 0) & (ids < n), ids, n)
    excl = torch.zeros((b, n + 1), dtype=torch.bool, device=signal.device)
    excl.scatter_(1, ids, True)
    excl = excl[:, :n]
    neg_inf = torch.tensor(float("-inf"), device=signal.device)
    st, si = topk_desc(torch.where(excl, neg_inf, signal * mask), k)
    bt, bi = topk_desc(torch.where((mask > 0) & ~excl, bf[None, :] * mask, neg_inf), k)
    return torch.stack([st, si.to(torch.float32), bt, bi.to(torch.float32)], dim=1)


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
    # the serving micro-batch's cap: the batched scorer's [B, I_p, K]
    # gather is the transient (320 MB at 16 x 100k items x 50)
    serve_batch_max = 16

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
        """Serve one query: history → device scorer → device tail (rule
        mask, blacklist, both top-ks, one [4, k] readback) → host assembly."""
        n_items = len(model.item_dict)
        if n_items == 0:
            return URResult([])
        hist = self._query_hist(model, query, hist_override)
        signal = self._score_history(model, hist) if hist is not None else None
        return self._device_tail(model, query, signal, min(query.num, n_items))

    def _device_tail(self, model: URModel, query: URQuery,
                     signal: Optional[torch.Tensor], num: int) -> URResult:
        key = self._mask_rule_key(query)
        mask = (model.device_ones() if key is None
                else self._mask_from_key(model, key))
        black_ids = self._blacklist_ids(model, query)
        sig = model.device_zeros() if signal is None else signal
        # k covers the worst case: every signal pick also occupying a
        # backfill slot; bucketed so distinct nums share shapes
        k = min(bucket_width(2 * num, 16), len(model.item_dict))
        out = _serve_topk(sig, mask, model.device_popularity(),
                          pad_ids(black_ids), k).cpu().numpy()
        return self._assemble(model, num, signal is not None,
                              out[0], out[1].astype(np.int32),
                              out[2], out[3].astype(np.int32))

    def serve_batch_predict(self, model: URModel,
                            queries: Sequence[URQuery]) -> List[URResult]:
        """Deploy-time micro-batch: every query's history (read from the
        live store, as ``predict`` reads it) scores against the resident
        tables in one gather an event type, and the rule masks, the
        blacklists and both top-ks of the batch come back in one [B, 4, k]
        readback.  Answers equal ``predict``'s.  The batch is padded to a
        power of two (zero masks), so batch sizes share shapes."""
        n_items = len(model.item_dict)
        if not queries or n_items == 0:
            return [URResult([]) for _ in queries]
        hists = [self._query_hist(model, q) for q in queries]
        b = len(queries)
        bp = bucket_width(b, min_width=1)
        have_signal = [h is not None and any(len(v) for v in h.values()) for h in hists]
        total = self._score_batch_device(model, hists, bp)
        if total is None:
            total = torch.zeros((bp, n_items), dtype=torch.float32, device=model.device)
        masks = []
        for q in queries:
            key = self._mask_rule_key(q)
            masks.append(model.device_ones() if key is None
                         else self._mask_from_key(model, key))
        masks = torch.stack(masks + [model.device_zeros()] * (bp - b))
        blacks = [self._blacklist_ids(model, q) for q in queries]
        bm = np.full((bp, bucket_width(max((len(x) for x in blacks), default=1))),
                     -1, np.int32)
        for r, ids in enumerate(blacks):
            bm[r, :len(ids)] = ids
        nums = [min(q.num, n_items) for q in queries]
        k = min(bucket_width(2 * max(nums), 16), n_items)
        out = _serve_topk_batch(total, masks, model.device_popularity(), bm, k).cpu().numpy()
        return [self._assemble(model, nums[r], have_signal[r],
                               out[r, 0], out[r, 1].astype(np.int32),
                               out[r, 2], out[r, 3].astype(np.int32))
                for r in range(b)]

    def _score_batch_device(self, model: URModel, hists, bp: int
                            ) -> Optional[torch.Tensor]:
        """The batched device scorer: every event type's histories against
        its resident table in one [B, I_p, K] gather; None when no query
        carries any history."""
        total = None
        for name, (idx, valid, llr) in model.device_indicators().items():
            lens = [len(h[name]) if h and name in h else 0 for h in hists]
            if not any(lens):
                continue
            hm = np.full((bp, bucket_width(max(lens))), -1, np.int32)
            for r, h in enumerate(hists):
                if lens[r]:
                    hm[r, :lens[r]] = h[name]
            n_t = max(len(model.event_item_dicts[name]), 1)
            s = _indicator_score_ids_batch(
                idx, llr if self.params.use_llr_weights else valid, hm, n_t)
            weight = float(self.params.indicator_weights.get(name, 1.0))
            s = s * weight if weight != 1.0 else s
            total = s if total is None else total + s
        return total

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

    # -- business rules ------------------------------------------------------

    def _mask_rule_key(self, query: URQuery) -> Optional[tuple]:
        """Canonical business-rule key, or None when the query carries no
        rules at all (the fast path: no mask work).

        Canonical = field rules sorted (mask composition is a product, so
        order never changes the value) and query dates parsed to epoch
        seconds QUANTIZED to whole seconds — the mask only ever consumes
        second-granularity offsets.  Strict date parsing happens HERE, so
        a malformed date rejects the query with 400."""
        def q_ts(raw, field):
            # falsy (absent/empty) date fields stay unset
            return None if not raw else int(np.rint(_query_ts(raw, field)))

        fields = tuple(sorted(
            (r.name, tuple(r.values), float(r.bias)) for r in query.fields))
        dr = query.date_range
        drk = None
        if dr is not None:
            drk = (dr.name,
                   q_ts(dr.after, "dateRange.after"),
                   q_ts(dr.before, "dateRange.before"))
        # strict-parse currentDate even when no avail/expire property is
        # configured (a malformed date is a 400 regardless), but an INERT
        # currentDate adds no rule
        now = q_ts(query.current_date, "currentDate")
        if not (self.params.available_date_name
                or self.params.expire_date_name):
            now = None
        if not fields and drk is None and now is None:
            return None
        return (fields, drk, now, self.params.available_date_name,
                self.params.expire_date_name)

    def _mask_from_key(self, model: URModel, key: tuple) -> torch.Tensor:
        """Build the mask from the CANONICAL key (not the query object).

        Semantics are the Elasticsearch filter/boost analogue (reference:
        URAlgorithm field biases and date rules as ES bool-query
        filters); items missing a checked date property fail the check,
        like ES range filters."""
        return self._mask_from_key_device(model, *key)

    @staticmethod
    def _date_bound(epoch_s: float, base: float) -> int:
        # same rounding as the item offsets → exact boundary equality
        return int(np.clip(np.rint(epoch_s - base), -1, 2**31 - 2))

    def _mask_from_key_device(self, model, fields, drk, now, avail, expire
                              ) -> torch.Tensor:
        mask = model.device_ones()
        for name, values, bias in fields:
            match = None
            for val in values:
                m = model.device_value_mask(name, val)
                match = m if match is None else _m_or(match, m)
            if match is None:
                match = model.device_zeros()
            if bias < 0:
                mask = _m_hard(mask, match)      # hard filter
            else:
                mask = _m_boost(mask, match, float(bias))
        if drk is not None:
            name, after_s, before_s = drk
            dd = model.device_date(name)
            if dd is None:           # no item has the property: match nothing
                return model.device_zeros()
            base, ts = dd
            mask = _m_present(mask, ts)
            if after_s is not None:
                mask = _m_ge(mask, ts, self._date_bound(after_s, base))
            if before_s is not None:
                mask = _m_le(mask, ts, self._date_bound(before_s, base))
        if now is not None:
            for prop, op in ((avail, _m_le), (expire, _m_ge)):
                # available <= now <= expire; boundary instants still valid
                if not prop:
                    continue
                dd = model.device_date(prop)
                if dd is None:
                    return model.device_zeros()
                base, ts = dd
                mask = op(mask, ts, self._date_bound(now, base))
        return mask


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
