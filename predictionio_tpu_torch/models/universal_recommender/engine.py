"""Universal Recommender engine template (CCO): training and serving.

Counterpart of ``predictionio_tpu/models/universal_recommender/engine.py``.
Training runs ``ops.cco.cco_train_indicators`` on the device (the count
product, the K2 LLR kernel and the K3 top-k kernel) and builds a ``URModel``
whose state dict is the JAX package's, so models carry across both ways
(``convert.ur_model_from_state``).  Training data comes
from the event store (``URDataSource.read_training``: one ``PEventStore``
batch of the interactions, item properties folded from ``$set`` events);
``checkpoint: true`` trains one event type at a time and snapshots each, so
a retried ``pio train`` resumes past the types it finished.

Serving is the reference's two switchable halves.  The scorer turns the
user's recent history (read from the event store through the
append-invalidated history cache, ``serve/history_cache.py``) into a
signal: on the device, a multi-hot vector per event type gathered against
the resident [n_items, top_k] indicator table; on the host, posting-list
slices of the table's inversion (``URModel.host_inverted``) summed over the
compacted candidate union, through the native serve core where it loads.
The tail applies the composed business-rule mask (field filters and
boosts, ``dateRange``, ``currentDate`` against the available/expire dates;
one LRU a model generation and tail kind), the blacklist and both top-ks
(signal and popularity backfill): on the device with one stacked [4, k]
readback, or in numpy (``host_topk_desc`` keeps ``lax.top_k``'s order),
pruned to the candidate rows when both halves are on the host.
``PIO_UR_SERVE_SCORER``, ``PIO_UR_SERVE_TAIL`` and
``PIO_UR_SERVE_CANDIDATES`` force a pick; ``auto`` resolves on the
model's device: the host halves for a model on the CPU (the reference's
pick under ``JAX_PLATFORMS=cpu``), the device halves for one on CUDA.
Before any scoring the response cache (``serve/response_cache.py``,
armed by the query server's install on the served model) answers repeats
whole.

The query server's micro-batcher serves through ``serve_batch_predict``:
cache hits peel off first, then the misses' histories score against the
resident tables in one gather an event type, and both top-ks for the whole
batch come back in one [B, 4, k] readback.

When a span journal is active (eval and batch runs) or a request trace is
live (the flight recorder), each query ``predict`` serves records a
``ur_predict`` span with its tail, candidates and ``<lap>_ms``
attributes; under a trace the laps become child spans (a micro-batched
query, served by ``serve_batch_predict``, records none, as in the JAX
package).  The laps read the host clock: on the card the device's work
lands in the lap that synchronises (the device tail's ``[4, k]``
readback), as JAX's async dispatch does.  Evaluation:
``URDataSource.read_eval``'s leave-one-out fold and the rank metrics
(``HitRateMetric``, ``NDCGMetric``, ``PrecisionAtKMetric``,
``MRRMetric``) over ``batch_predict``'s eval answers.

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
import math
import os as _os
import threading as _threading
import time as _time
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
from predictionio_tpu_torch.models.common import (
    DeviceCacheMixin,
    LRUCache,
    gather_csr_rows,
    host_topk_desc,
)
from predictionio_tpu_torch.models.universal_recommender.popmodel import (
    backfill_scores,
    parse_duration,
)
from predictionio_tpu_torch.native import core as _ncore
from predictionio_tpu_torch.obs import metrics as _obs_metrics
from predictionio_tpu_torch.obs import spans as _spans
from predictionio_tpu_torch.obs import tracing as _tracing
from predictionio_tpu_torch.ops import cco as cco_ops
from predictionio_tpu_torch.ops.als import bucket_width, check_f32_id_range
from predictionio_tpu_torch.ops.als import pad_ids as als_pad_ids
from predictionio_tpu_torch.ops.topk import topk_desc
from predictionio_tpu_torch.parallel.distributed import process_count
from predictionio_tpu_torch.parallel.mesh import MeshSpec, create_mesh
from predictionio_tpu_torch.serve import history_cache as _history_cache
from predictionio_tpu_torch.serve import response_cache as _resp_cache
from predictionio_tpu_torch.store.columnar import CSRLookup, IdDict, fold_properties
from predictionio_tpu_torch.store.event_store import LEventStore, PEventStore  # noqa: F401
from predictionio_tpu_torch.utils.tracing import timed

# -- serving instruments (the JAX package's families) ------------------------

_REG = _obs_metrics.get_registry()
_M_STAGE = _REG.histogram(
    "pio_ur_serve_stage_duration_seconds",
    "UR serve-tail stage wall time by stage (history/cache/score/mask/topk/"
    "assemble), resolved tail (host/device) and candidates (on/off/cache)")
_M_MASK_CACHE = _REG.counter(
    "pio_ur_rule_mask_cache_total",
    "Composed business-rule mask cache lookups by outcome "
    "(hit/miss/evict, carried/dropped at a swap); one entry per (model "
    "generation, canonical rule set, tail)")
_M_SERVE_CACHE = _REG.counter(
    "pio_ur_serve_cache_total",
    "Serving lookup-cache events by cache (value_mask/value_mask_dev/date/"
    "date_dev) and outcome (hit/miss/evict)")
_M_INV_BUILD = _REG.gauge(
    "pio_ur_host_inverted_build_seconds",
    "Wall seconds spent building the host inverted postings index, by "
    "event type (set once per model load)")
_M_INV_BYTES = _REG.gauge(
    "pio_ur_host_inverted_bytes",
    "Resident bytes of the host inverted postings index (CSR indptr + "
    "rows + weights), by event type (set once per build)")
_M_CAND = _REG.counter(
    "pio_ur_serve_candidate_total",
    "Candidate-pruned host-tail decisions by outcome: pruned (served "
    "from the posting-union candidate set), fallback_no_candidates "
    "(cold user / empty postings -> dense tail), "
    "fallback_backfill_reorder (boost mask + backfill shortfall -> "
    "dense tail), fallback_backfill_scan (rare-match rule blew the "
    "backfill scan budget -> dense tail)")
_M_CAND_FRAC = _REG.histogram(
    "pio_ur_serve_candidate_frac",
    "Fraction of the catalog a candidate-pruned query touched "
    "(|candidates| / n_items)",
    buckets=(1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3, 0.01, 0.03,
             0.1, 0.3, 1.0))


def _cache_event(cache: str):
    def on_event(outcome: str) -> None:
        _M_SERVE_CACHE.inc(1, cache=cache, outcome=outcome)
    return on_event


def _mask_cache_event(outcome: str) -> None:
    _M_MASK_CACHE.inc(1, outcome=outcome)


# guards creation of the PER-EVENT-TYPE build locks only (never held
# across a build): inversions of different event types proceed in
# parallel — warm() builds them on one thread each — while two concurrent
# first queries of the SAME type share one argsort
_HOST_INV_LOCK = _threading.Lock()


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

    def read_eval(self):
        """Leave-one-out evaluation folds (the JAX package's split, user for
        user): each qualifying user's LAST primary event (by eventTime) is
        held out, sampled down to ``eval_users`` by
        ``np.random.default_rng(eval_seed)``; training sees the rest.  The
        reference UR ships no evaluation; this is the standard
        implicit-feedback protocol."""
        if self.params.eval_users <= 0:
            return []
        td = self.read_training()
        primary = td.event_names[0]
        u, i, item_dict, times = td.interactions[primary]
        if len(u) == 0:
            return []
        order = np.lexsort((times, u))     # by user, then time
        us, is_, ts_ = u[order], i[order], times[order]
        last_of_user = np.flatnonzero(
            np.concatenate((us[1:] != us[:-1], [True])))
        counts = np.bincount(us, minlength=0)
        holdout_rows = last_of_user[counts[us[last_of_user]] >= 2]
        # sampled, not the first N: stores are often sorted by entity id
        rng = np.random.default_rng(self.params.eval_seed)
        holdout_rows = rng.permutation(holdout_rows)[: self.params.eval_users]
        drop = np.zeros(len(us), bool)
        drop[holdout_rows] = True
        interactions = dict(td.interactions)
        interactions[primary] = (us[~drop], is_[~drop], item_dict, ts_[~drop])
        fold_td = URTrainingData(
            event_names=td.event_names,
            user_dict=td.user_dict,
            interactions=interactions,
            item_properties=td.item_properties,
        )
        qa = [
            (URQuery(user=td.user_dict.str(int(us[r])), num=self.params.eval_num),
             item_dict.str(int(is_[r])))
            for r in holdout_rows
        ]
        return [(fold_td, {"fold": "leave-one-out"}, qa)]


class _RankMetric:
    """Base for rank metrics over URResult predictions with a single
    held-out relevant item (the leave-one-out protocol of read_eval).
    Subclasses score one ranked list by the 0-based rank of the actual
    item, or None when it is absent."""

    higher_is_better = True

    def header(self) -> str:
        raise NotImplementedError   # subclasses name themselves

    def score_rank(self, rank) -> float:
        raise NotImplementedError

    def calculate(self, eval_data) -> float:
        total = 0
        score = 0.0
        for _info, qpa in eval_data:
            for _q, p, actual in qpa:
                total += 1
                rank = next((r for r, s in enumerate(p.item_scores)
                             if s.item == actual), None)
                score += self.score_rank(rank)
        return score / total if total else 0.0

    def compare(self, a: float, b: float) -> int:
        return 0 if a == b else (1 if a > b else -1)


class HitRateMetric(_RankMetric):
    """hit@num: fraction of held-out items anywhere in the result list."""

    def header(self) -> str:
        return "HitRate"

    def score_rank(self, rank) -> float:
        return 1.0 if rank is not None else 0.0


class NDCGMetric(_RankMetric):
    """NDCG@num with one relevant item: 1/log2(rank+2), 0 on a miss —
    the ideal DCG is 1, so no normalization divisor is needed."""

    def header(self) -> str:
        return "NDCG"

    def score_rank(self, rank) -> float:
        return 1.0 / math.log2(rank + 2) if rank is not None else 0.0


class PrecisionAtKMetric(_RankMetric):
    """precision@k with one relevant item: 1/k when the item ranks in the
    top k, else 0 (reference e2 evaluation's precision family)."""

    def __init__(self, k: int = 10):
        self.k = k

    def header(self) -> str:
        return f"Precision@{self.k}"

    def score_rank(self, rank) -> float:
        return 1.0 / self.k if rank is not None and rank < self.k else 0.0


class MRRMetric(_RankMetric):
    """Mean reciprocal rank: 1/(rank+1), 0 on a miss."""

    def header(self) -> str:
        return "MRR"

    def score_rank(self, rank) -> float:
        return 1.0 / (rank + 1) if rank is not None else 0.0


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
                # torch.tensor copies: a model plane's tables are read-only
                # mapped views, which no tensor may alias
                idx = torch.tensor(np.asarray(idx, np.int64), device=self.device)
                llr = torch.tensor(np.asarray(self.indicator_llr[name], np.float32),
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
        norm = self.__dict__.get("_pop_norm")
        if norm is None:
            norm = max(float(np.abs(self.popularity).max()), 1.0) \
                if len(self.popularity) else 1.0
            self.__dict__["_pop_norm"] = norm
        return norm

    # -- host-resident serving state (built lazily, never pickled) -----------

    def host_inverted(self, name: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """CSR inversion of one event type's indicator table, keyed by
        TARGET item id: ``(indptr [n_t+1] int64, rows [nnz] int32, weights
        [nnz] f32)``, where rows are the primary items listing the target as
        a correlator.  Built once under a per-name lock (two concurrent
        first queries of one type share the build; different types build
        concurrently) and cached.  A query then costs |hist| posting-list
        slices instead of a gather at every [I_p, K] table cell."""
        cache = self.__dict__.setdefault("_host_inv", {})
        hit = cache.get(name)
        if hit is not None:
            return hit
        with _HOST_INV_LOCK:
            locks = self.__dict__.setdefault("_host_inv_locks", {})
            lock = locks.get(name)
            if lock is None:
                lock = locks[name] = _threading.Lock()
        with lock:
            hit = cache.get(name)
            if hit is not None:
                return hit
            t0 = _time.perf_counter()
            idx, llr = self.indicator_idx[name], self.indicator_llr[name]
            n_t = max(len(self.event_item_dicts[name]), 1)
            if idx.ndim != 2:
                # no [I_p, K] shape to invert: every posting list empty
                built = (np.zeros(n_t + 1, dtype=np.int64),
                         np.zeros(0, dtype=np.int32),
                         np.zeros(0, dtype=np.float32))
            else:
                i_p, k = idx.shape
                valid = idx >= 0
                rows = np.repeat(np.arange(i_p, dtype=np.int32), k)[valid.ravel()]
                tgt = idx[valid]
                w = llr[valid].astype(np.float32)
                order = np.argsort(tgt, kind="stable")
                tgt, rows, w = tgt[order], rows[order], w[order]
                indptr = np.concatenate(
                    [[0], np.cumsum(np.bincount(tgt, minlength=n_t))]).astype(np.int64)
                built = (indptr, rows, w)
            cache[name] = built
            _M_INV_BUILD.set(_time.perf_counter() - t0, event=name)
            _M_INV_BYTES.set(sum(int(a.nbytes) for a in built), event=name)
            return built

    def host_popularity(self) -> np.ndarray:
        """float32 backfill scores on the host — the values
        device_popularity stages, so both tails rank the fallback alike."""
        pop = self.__dict__.get("_host_pop")
        if pop is None:
            pop = np.asarray(self.popularity, np.float32)
            self.__dict__["_host_pop"] = pop
        return pop

    def host_zeros(self) -> np.ndarray:
        """Shared read-only zero signal (callers never mutate it)."""
        z = self.__dict__.get("_host_zeros")
        if z is None:
            z = np.zeros(len(self.item_dict), np.float32)
            self.__dict__["_host_zeros"] = z
        return z

    def host_pop_order(self) -> np.ndarray:
        """Every item id in the backfill tail's total order — popularity
        descending, id ascending on ties (``host_topk_desc``'s order) —
        computed once a model generation.  The candidate-pruned tail merges
        backfill by walking it, O(num) a query."""
        order = self.__dict__.get("_host_pop_order")
        if order is None:
            _, order = host_topk_desc(self.host_popularity(), len(self.item_dict))
            self.__dict__["_host_pop_order"] = order
        return order

    def warm(self) -> None:
        """Stage only what the resolved scorer AND tail read (called at
        deploy): the device tables for the device scorer, the CSR
        inversions (one thread an event type) for the host scorer; the
        device tail's vectors and one backfill query's device tail, or the
        host tail's popularity, zeros and (with candidates) popularity
        order.  The other halves stay lazy, so a runtime switch still
        works and pays its build on first use."""
        if _serve_scorer(self) == "host":
            names = list(self.indicator_idx)
            errors: List[BaseException] = []

            def build(n: str) -> None:
                try:
                    self.host_inverted(n)
                except BaseException as e:
                    errors.append(e)

            extra = [_threading.Thread(target=build, args=(n,), daemon=True)
                     for n in names[1:]]
            for t in extra:
                t.start()
            # the first build runs here through the same collector, so a
            # failure still joins the siblings before it re-raises
            if names:
                build(names[0])
            for t in extra:
                t.join()
            if errors:
                raise errors[0]
        else:
            self.device_indicators()
        if _serve_tail(self) == "host":
            self.host_popularity()
            self.host_zeros()
            if _serve_candidates(self) == "on":
                self.host_pop_order()
        else:
            n = len(self.item_dict)
            if n:
                _serve_topk(self.device_zeros(), self.device_ones(),
                            self.device_popularity(), als_pad_ids([]),
                            min(bucket_width(1), n)).cpu()
        self.pop_norm()

    def ensure_host_serving_state(self) -> None:
        """Build every host-side derived serving structure — the CSR
        postings inversions, the popularity order, the f32 popularity and
        its norm — however the scorer and tail resolve in this process."""
        for name in self.indicator_idx:
            self.host_inverted(name)
        self.host_popularity()
        self.host_pop_order()
        self.pop_norm()

    # -- business-rule state (built lazily, never pickled) ---------------------

    _VALUE_MASK_CACHE_MAX = 512
    _DATE_CACHE_MAX = 512

    def _lru(self, attr: str, max_entries: int, metric_cache: str,
             on_device: bool = False) -> LRUCache:
        """A bounded LRU in ``__dict__`` counted under ``metric_cache``'s
        label (``rule_mask`` counts into pio_ur_rule_mask_cache_total); a
        cache of device tensors is registered as staged, so ``to_device``
        drops it."""
        cache = self.__dict__.get(attr)
        if cache is None:
            on_event = (_mask_cache_event if metric_cache == "rule_mask"
                        else _cache_event(metric_cache))
            # dict.setdefault is atomic under the GIL: racing creators
            # both construct, one instance wins, both use it
            cache = self.__dict__.setdefault(attr, LRUCache(max_entries, on_event=on_event))
            if on_device:
                self.__dict__.setdefault("_staged", set()).add(attr)
        return cache

    def rule_mask_cache(self, kind: str) -> LRUCache:
        """Composed business-rule masks, one LRU a (model generation, tail
        kind: "host" | "device"), bounded by ``PIO_UR_RULE_MASK_CACHE``.
        Living in ``__dict__`` (never pickled), a reload — a NEW model
        object — starts empty unless ``adopt_rule_caches`` carries it."""
        return self._lru(f"_rule_mask_{kind}", _rule_mask_cache_max(), "rule_mask",
                         on_device=kind == "device")

    # pure functions of (item_dict, item_properties): a swap that proves
    # both unchanged carries the LRU objects to the new generation
    _SWAP_CARRY_ATTRS = ("_rule_mask_host", "_rule_mask_device",
                         "_host_value_mask", "_dev_value_mask",
                         "_date_off", "_dev_date")
    _DEVICE_ATTRS = ("_rule_mask_device", "_dev_value_mask", "_dev_date")

    def adopt_rule_caches(self, prev: "URModel", carry: bool) -> None:
        """Swap survival of the rule caches: composed masks, value-mask
        bitsets and date offsets depend ONLY on the item dictionary and the
        item properties, so a swap whose provenance proves both untouched
        keeps every entry hot.  ``carry=False`` counts the flush; carried
        and dropped entries land in pio_ur_rule_mask_cache_total.  Device
        caches carry only between models on the same device."""
        n_rules = 0
        for attr in ("_rule_mask_host", "_rule_mask_device"):
            c = prev.__dict__.get(attr)
            if c is not None:
                n_rules += len(c)
        if not carry:
            if n_rules:
                _M_MASK_CACHE.inc(n_rules, outcome="dropped")
            return
        same_device = (prev.__dict__.get("_torch_device") is not None
                       and prev.__dict__.get("_torch_device")
                       == self.__dict__.get("_torch_device"))
        for attr in self._SWAP_CARRY_ATTRS:
            on_device = attr in self._DEVICE_ATTRS
            if on_device and not same_device:
                continue
            c = prev.__dict__.get(attr)
            if c is not None:
                self.__dict__.setdefault(attr, c)
                if on_device:
                    self.__dict__.setdefault("_staged", set()).add(attr)
        if n_rules:
            _M_MASK_CACHE.inc(n_rules, outcome="carried")

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
        """Item ids holding (name, value), ascending; None for unknown
        names/values (the match-nothing case — callers substitute their
        zero mask WITHOUT caching: query fields are user input, caching
        unknowns would let arbitrary queries pin unbounded memory)."""
        if name not in self.known_prop_names():
            return None
        return self.prop_value_index(name).get(value)

    def _ids_to_mask(self, ids: np.ndarray) -> np.ndarray:
        m = np.zeros(len(self.item_dict), np.float32)
        m[ids] = 1.0
        return m

    def host_value_mask(self, name: str, value: str) -> np.ndarray:
        """Host twin of device_value_mask; both derive their bitsets from
        the same _ids_to_mask build, so they match bit for bit."""
        ids = self._value_mask_ids(name, value)
        if ids is None:
            return self.host_zeros()
        cache = self._lru("_host_value_mask", self._VALUE_MASK_CACHE_MAX, "value_mask")
        return cache.get_or_build((name, value), lambda: self._ids_to_mask(ids))

    def device_value_mask(self, name: str, value: str) -> torch.Tensor:
        """0/1 device mask of items whose property ``name`` holds ``value``
        — the Elasticsearch-filter-bitset analogue, cached per (name, value)
        in a bounded thread-safe LRU (touch-on-hit)."""
        ids = self._value_mask_ids(name, value)
        if ids is None:
            return self.device_zeros()
        cache = self._lru("_dev_value_mask", self._VALUE_MASK_CACHE_MAX,
                          "value_mask_dev", on_device=True)
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
        reference's ES range filters.  Both tails read exactly these
        offsets."""
        if name not in self.known_prop_names():
            return None
        cache = self._lru("_date_off", self._DATE_CACHE_MAX, "date")

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
        cache = self._lru("_dev_date", self._DATE_CACHE_MAX, "date_dev", on_device=True)
        return cache.get_or_build(
            name, lambda: (d[0], torch.as_tensor(d[1], device=self.device)))

    def prop_value_index(self, name: str) -> Dict[str, np.ndarray]:
        """value -> item ids holding it (ascending), for one property — lets
        field rules apply as a few array writes instead of a per-item
        Python loop."""
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


def _rule_mask_cache_max() -> int:
    """PIO_UR_RULE_MASK_CACHE bounds the composed rule-mask LRU a model
    generation and tail kind (default 128 canonical rule sets; each mask is
    an n_items f32 vector, 400 KB at a 100k catalog)."""
    try:
        return max(int(_os.environ.get("PIO_UR_RULE_MASK_CACHE", "128")), 1)
    except ValueError:
        return 128


def _auto_half(model) -> str:
    """``auto``'s pick for a model: the host halves for a model on the CPU
    (the reference's pick on its CPU backend), the device halves for one
    on CUDA.  Resolving the device raises for an unplaced model without a
    card, as staging would."""
    return "host" if model.device.type == "cpu" else "device"


def _serve_scorer(model) -> str:
    """'device' | 'host' — which history scorer serves ``model``'s queries.
    ``PIO_UR_SERVE_SCORER`` forces (re-read every query), else ``auto``."""
    conf = _os.environ.get("PIO_UR_SERVE_SCORER", "auto").lower()
    if conf in ("host", "device"):
        return conf
    return _auto_half(model)


def _serve_tail(model) -> str:
    """'device' | 'host' — which tail finishes ``model``'s queries (rule
    mask, blacklist, both top-ks, readback).  ``PIO_UR_SERVE_TAIL`` forces,
    else ``auto``.  The tails are twins: the same items, the same tie order
    (``host_topk_desc`` is ``topk_desc``'s order)."""
    conf = _os.environ.get("PIO_UR_SERVE_TAIL", "auto").lower()
    if conf in ("host", "device"):
        return conf
    return _auto_half(model)


def _serve_candidates(model) -> str:
    """'on' | 'off' — whether the host tail serves from the pruned
    posting-union candidate set.  auto and on: candidates whenever BOTH
    halves resolve to host; ``PIO_UR_SERVE_CANDIDATES=off`` forces the
    dense tail.  A query the pruned path cannot answer exactly falls back
    to dense, so the knob never changes answers, only cost."""
    conf = _os.environ.get("PIO_UR_SERVE_CANDIDATES", "auto").lower()
    if conf == "off":
        return "off"
    if _serve_scorer(model) == "host" and _serve_tail(model) == "host":
        return "on"
    return "off"


def _sorted_member(ids: np.ndarray, sorted_ids: Optional[np.ndarray]) -> np.ndarray:
    """Boolean membership of ``ids`` in an ASCENDING id array by
    searchsorted (np.isin re-sorts its second argument every call)."""
    if sorted_ids is None or len(sorted_ids) == 0:
        return np.zeros(len(ids), bool)
    pos = np.searchsorted(sorted_ids, ids)
    np.minimum(pos, len(sorted_ids) - 1, out=pos)
    return sorted_ids[pos] == ids


def _to_host(signal) -> Optional[np.ndarray]:
    """A scorer's signal as a host f32 vector (the device scorer's tensor
    is copied back)."""
    if signal is None or isinstance(signal, np.ndarray):
        return signal
    return signal.cpu().numpy()


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


def _seen_lookup(rows, values, n_rows: int, device: torch.device) -> CSRLookup:
    """``CSRLookup.from_pairs`` with the sort and the dedup of the pairs on
    ``device`` (one copy of them each way): array for array the same, and
    on a card no host sort of the primary's events."""
    rows, values = np.asarray(rows), np.asarray(values)
    if len(rows) == 0:
        return CSRLookup.from_pairs(rows, values, n_rows)
    r = torch.as_tensor(rows, device=device).to(torch.int64)
    v = torch.as_tensor(values, device=device).to(torch.int64)
    n_vals = int(v.max()) + 1
    flat = torch.unique(r * n_vals + v)
    indptr = torch.zeros(n_rows + 1, dtype=torch.int64, device=device)
    torch.cumsum(torch.bincount(flat // n_vals, minlength=n_rows), 0, out=indptr[1:])
    return CSRLookup(indptr.cpu().numpy(), (flat % n_vals).to(torch.int32).cpu().numpy())



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

    @timed("ur.train")
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
        dp = self.params.mesh_dp or process_count()
        mesh = create_mesh(MeshSpec(dp=dp, mp=1)) if dp > 1 else None
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
        common = dict(
            top_k=self.params.max_correlators_per_item,
            llr_threshold=self.params.min_llr,
            mesh=mesh,
            exclude_self_for=primary,
            user_block=self.params.user_block,
            item_tile=self.params.item_tile,
            per_type=self.per_type_tuning(self.params, td.event_names),
            device=device)
        if self.params.checkpoint:
            results = self._train_checkpointed(
                p_user, p_item, others, n_users, n_items, common)
        else:
            results = cco_ops.cco_train_indicators(
                p_user, p_item, others, n_users, n_items, **common)
        indicator_idx: Dict[str, np.ndarray] = {}
        indicator_llr: Dict[str, np.ndarray] = {}
        with timed("ur.train.tables"):
            for name, (scores, idx) in results.items():
                indicator_idx[name] = idx.astype(np.int32)
                indicator_llr[name] = np.where(np.isfinite(scores), scores,
                                               0.0).astype(np.float32)
        with timed("ur.train.seen"):
            user_seen = _seen_lookup(p_user, p_item, n_users, device)
        # PopModel backfill over the event-time window (raw events: volume)
        with timed("ur.train.backfill"):
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
                parse_duration(self.params.backfill_duration), device=device)
        # per-event seen CSRs for non-primary blacklist_events, in the
        # primary item space
        user_seen_by_event: Dict[str, CSRLookup] = {}
        with timed("ur.train.seen_by_event"):
            for name in blacklist_events:
                if name == primary or name not in event_item_dicts:
                    continue
                u, i, item_dict, _ = td.interactions[name]
                mapped = p_item_dict.lookup_many(item_dict.strings())[i]
                keep = mapped >= 0
                user_seen_by_event[name] = _seen_lookup(
                    u[keep], mapped[keep], n_users, device)
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

    def _train_checkpointed(self, p_user, p_item, others, n_users, n_items, common):
        """One ``cco_train_indicators`` call an event type, each type's
        indicators snapshotted: a retried train (``run_train`` with
        ``PIO_TRAIN_RETRIES``) resumes past the types it finished.  The run
        key hashes the sizes, the tuning and every type's full arrays as
        the JAX package does, and the layout is ``utils/checkpoint``'s, so
        either package resumes the other's run
        (``PIO_CHECKPOINT_DIR``/ur/<key>, or ``checkpoint_dir``)."""
        import hashlib

        from predictionio_tpu_torch.utils.checkpoint import (
            CheckpointStore,
            maybe_inject,
            prune_stale_runs,
        )

        h = hashlib.sha1()
        h.update(repr((n_users, n_items, common["top_k"],
                       common["llr_threshold"], common["per_type"])).encode())
        for name, u, i, n_t in others:
            # the FULL arrays: a sample could collide with changed data and
            # resume stale snapshots
            h.update(name.encode())
            h.update(np.asarray([len(u), n_t], np.int64).tobytes())
            h.update(np.ascontiguousarray(u).tobytes())
            h.update(np.ascontiguousarray(i).tobytes())
        base = self.params.checkpoint_dir or _os.path.join(
            _os.environ.get("PIO_CHECKPOINT_DIR", ".pio_checkpoints"), "ur")
        prune_stale_runs(base)
        # keep=0: every type's snapshot lives until the run completes
        store = CheckpointStore(_os.path.join(base, h.hexdigest()[:16]), keep=0)
        done_steps = set(store.steps())
        results = {}
        for step, (name, u, i, n_t) in enumerate(others):
            if step in done_steps:
                state = store.restore(step)
                results[name] = (state["scores"], state["idx"])
                continue
            maybe_inject("ur.indicators")
            out = cco_ops.cco_train_indicators(
                p_user, p_item, [(name, u, i, n_t)], n_users, n_items, **common)
            results[name] = out[name]
            store.save(step, {"scores": results[name][0], "idx": results[name][1]})
        store.clear(remove_dir=True)   # the run is complete; its key never recurs
        return results

    def warm(self, model: URModel) -> None:
        model.warm()
        if _serve_scorer(model) == "device" and len(model.item_dict):
            # one history scored alone and as a micro-batch row: the
            # scorer's first launches load their kernels lazily (tens of ms
            # on the card), which a deploy's first query paid (ROADMAP §C.11)
            for name, (idx, valid, _) in model.device_indicators().items():
                n_t = max(len(model.event_item_dicts[name]), 1)
                hist = als_pad_ids(np.zeros(1, np.int32))
                _indicator_score_ids(idx, valid, hist, n_t)
                _indicator_score_ids_batch(idx, valid, hist[None, :], n_t)
                break

    # -- serving -------------------------------------------------------------

    def _user_history(self, model: URModel, user: str) -> Dict[str, np.ndarray]:
        """Recent item ids per event type, from the live event store
        (reference: URAlgorithm.predict reading LEventStore), through the
        append-invalidated history cache: the cached value is the raw target
        id strings (model-independent, so it survives swaps) and the
        model's ``item_dict`` maps them per query.  ``PIO_HISTORY_CACHE=off``
        reads the store every time."""
        hist: Dict[str, np.ndarray] = {}
        for name, item_dict in model.event_item_dicts.items():
            raw = _history_cache.user_history_targets(
                self.params.app_name, "user", user, name,
                self.params.max_query_events)
            ids = {item_dict.id(t) for t in raw}
            ids.discard(None)
            hist[name] = np.asarray(sorted(ids), np.int32)
        return hist

    def _score_history(self, model: URModel, hist: Dict[str, np.ndarray]):
        """The resolved scorer over every event type's history.  device: the
        resident-table gather, a query ships a few hundred bytes of ids and
        the [I_p] signal stays on the device (a tensor).  host: posting-list
        sums over the inverted index, scattered into a dense f32 numpy
        vector.  None when no event type carries history."""
        if _serve_scorer(model) == "host":
            return self._sparse_signal_dense(
                len(model.item_dict), self._score_history_host(model, hist))
        total = None
        for name, (idx, valid, llr) in model.device_indicators().items():
            h_ids = hist.get(name)
            if h_ids is None or len(h_ids) == 0:
                continue
            n_t = max(len(model.event_item_dicts[name]), 1)
            s = _indicator_score_ids(idx, llr if self.params.use_llr_weights
                                     else valid, als_pad_ids(h_ids), n_t)
            weight = float(self.params.indicator_weights.get(name, 1.0))
            s = s * weight if weight != 1.0 else s
            total = s if total is None else total + s
        return total

    def _score_history_host(self, model: URModel, hist: Dict[str, np.ndarray]
                            ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Inverted-index twin of the device scorer, SPARSE: ``(candidate
        ids, f32 scores)`` — the ascending unique union of posting-list rows
        over every event type's history and the signal at exactly those
        rows (every other row scores 0.0) — or None when no event type
        carries history.  Scores accumulate per type in float64 in posting
        order over the compacted candidates, cast to f32, times the type's
        weight in f32, and add across types in f32: the native serve core
        first, this numpy path its oracle, bit for bit.  Against the device
        scorer, LLR-weighted sums may differ in the last ulp."""
        per_type: List[Tuple[str, np.ndarray, Optional[np.ndarray]]] = []
        for name in model.indicator_idx:
            h_ids = hist.get(name)
            if h_ids is None or len(h_ids) == 0:
                continue
            indptr, rows, w = model.host_inverted(name)
            if self.params.use_llr_weights:
                cat_rows, cat_w = gather_csr_rows(indptr, h_ids, rows, w)
            else:
                (cat_rows,), cat_w = gather_csr_rows(indptr, h_ids, rows), None
            per_type.append((name, cat_rows, cat_w))
        if not per_type:
            return None
        if _ncore.serve_enabled():
            try:
                cand = _ncore.unique_i32(np.concatenate([r for _, r, _ in per_type]))
                scratch = np.empty(len(cand), np.float64)
                ntotal = np.empty(len(cand), np.float32)
                first = True
                for name, cat_rows, cat_w in per_type:
                    weight = float(self.params.indicator_weights.get(name, 1.0))
                    _ncore.score_accum(cand, cat_rows, cat_w, weight, scratch,
                                       ntotal, first)
                    first = False
                _ncore.note_call("serve")
                return cand, ntotal
            except Exception:
                _ncore.note_fallback("error")
        cand = np.unique(np.concatenate([r for _, r, _ in per_type])).astype(np.int32)
        total: Optional[np.ndarray] = None
        for name, cat_rows, cat_w in per_type:
            rel = np.searchsorted(cand, cat_rows)
            if cat_w is not None:
                score = np.bincount(rel, weights=cat_w,
                                    minlength=len(cand)).astype(np.float32)
            else:
                score = np.bincount(rel, minlength=len(cand)).astype(np.float32)
            weight = float(self.params.indicator_weights.get(name, 1.0))
            if weight != 1.0:
                score *= weight
            total = score if total is None else total + score
        return cand, total

    @staticmethod
    def _sparse_signal_dense(n_items: int,
                             sparse: Optional[Tuple[np.ndarray, np.ndarray]]
                             ) -> Optional[np.ndarray]:
        """Dense [n_items] f32 signal from the sparse scorer's result — an
        exact scatter (rows outside the candidates are exactly 0.0)."""
        if sparse is None:
            return None
        ids, sc = sparse
        out = np.zeros(n_items, np.float32)
        out[ids] = sc
        return out

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
        """Serve one query: history → response cache → the resolved scorer
        → the resolved tail (device: rule mask, blacklist, both top-ks, one
        [4, k] readback; host: the same in numpy, candidate-pruned when
        both halves are host) → host assembly.  Stage wall times land in
        pio_ur_serve_stage_duration_seconds and, when a span journal is
        active or a request trace is live, as a per-query ``ur_predict``
        span; under a trace the stage laps also become child spans, so
        /traces/<rid>.json shows the history→score→mask→topk→assemble
        waterfall.  With neither, no span object is built."""
        stages: List[Tuple[str, float]] = []
        meta: Dict[str, str] = {}
        journal = _spans.current_journal()
        trace = _tracing.current_trace() if journal is None else None
        if journal is None and trace is None:
            return self._predict_staged(model, query, hist_override, stages, meta)
        sink = journal if journal is not None else trace
        with sink.span("ur_predict") as rec:
            res = self._predict_staged(model, query, hist_override, stages, meta)
            rec["attrs"] = {"tail": _serve_tail(model),
                            "candidates": meta.get("candidates", "off"),
                            **{f"{n}_ms": round(dt * 1e3, 4) for n, dt in stages}}
        if trace is not None:
            # the laps are strictly sequential, so reconstructed offsets give
            # exact child-span boundaries without a context manager per
            # stage on the serve hot path
            off = rec["start"]
            for n, dt in stages:
                trace.add_span(n, off, dt, parent=rec["id"])
                off += dt
        return res

    def _predict_staged(self, model: URModel, query: URQuery, hist_override,
                        stages: List[Tuple[str, float]],
                        meta: Optional[Dict[str, str]] = None) -> URResult:
        n_items = len(model.item_dict)
        if n_items == 0:
            return URResult([])
        tail = _serve_tail(model)
        t = [_time.perf_counter()]

        def lap(name: str) -> None:
            now = _time.perf_counter()
            stages.append((name, now - t[0]))
            t[0] = now

        hist = self._query_hist(model, query, hist_override)
        lap("history")
        num = min(query.num, n_items)
        cand_label = "off"
        # the response cache, consulted before any scoring: the key covers
        # every input of the answer (k, canonical rules, history ids and
        # blacklist ids, the last two recomputed fresh); hist_override
        # (eval's anti-leakage path) always bypasses
        cache = _resp_cache.get_cache()
        ckey = rkey = cached_items = None
        audit = False
        if cache.armed_for(model):
            if hist_override is not None:
                cache.count_bypass()
            else:
                # strict date parsing (400 on malformed) runs in the key
                # builder, exactly as the uncached mask path would
                rkey = self._mask_rule_key(query)
                ckey = _resp_cache.make_key(
                    num, rkey, hist, self._blacklist_ids(model, query))
                cached_items, audit = cache.lookup(model, ckey)
                lap("cache")
                if cached_items is not None and not audit:
                    if meta is not None:
                        meta["candidates"] = "cache"
                    for name, dt in stages:
                        _M_STAGE.observe(dt, stage=name, tail=tail, candidates="cache")
                    return URResult([ItemScore(n, s) for n, s in cached_items])
        fill: Optional[dict] = {} if ckey is not None else None
        if tail == "host" and _serve_candidates(model) == "on":
            # the candidate-pruned tail; a per-query fallback (None) re-runs
            # the dense tail on the scattered signal with fresh laps
            sparse = (self._score_history_host(model, hist)
                      if hist is not None else None)
            lap("score")
            sub: List[Tuple[str, float]] = []

            def sub_lap(name: str) -> None:
                now = _time.perf_counter()
                sub.append((name, now - t[0]))
                t[0] = now

            res = self._host_tail_pruned(model, query, sparse, num, sub_lap, fill=fill)
            if res is not None:
                stages.extend(sub)
                cand_label = "on"
            else:
                t[0] = _time.perf_counter()   # discard the aborted laps
                res = self._host_tail(model, query,
                                      self._sparse_signal_dense(n_items, sparse),
                                      num, lap, fill=fill)
        else:
            signal = self._score_history(model, hist) if hist is not None else None
            lap("score")
            if tail == "host":
                res = self._host_tail(model, query, _to_host(signal), num, lap, fill=fill)
            else:
                res = self._device_tail(model, query, signal, signal is not None,
                                        num, lap, fill=fill)
        if ckey is not None:
            self._cache_settle(cache, model, ckey, rkey, res, cached_items, hist,
                               fill, num)
        if meta is not None:
            meta["candidates"] = cand_label
        for name, dt in stages:
            _M_STAGE.observe(dt, stage=name, tail=tail, candidates=cand_label)
        return res

    def _cache_settle(self, cache, model: URModel, ckey: tuple,
                      rkey: Optional[tuple], res: URResult, cached_items, hist,
                      fill: Optional[dict], num: int) -> None:
        """Response-cache bookkeeping after the tail: fill after a miss, or
        — on an audited hit — compare the fresh answer bit for bit with the
        cached one (a mismatch is counted and full-flushes; the caller
        serves the FRESH result)."""
        items = tuple((r.item, float(r.score)) for r in res.item_scores)
        if cached_items is not None:
            if items != cached_items:
                cache.audit_mismatch(ckey)
            return
        used_backfill = bool((fill or {}).get("backfill")) or (
            len(items) < num and self.params.backfill_type != "none")
        cache.put(model, ckey, items, hist, (fill or {}).get("ids", ()),
                  used_backfill, rkey is not None, bool(self.params.use_llr_weights))

    def _device_tail(self, model: URModel, query: URQuery, signal,
                     have_signal: bool, num: int, lap=None,
                     fill: Optional[dict] = None) -> URResult:
        mask = self._mask_for(model, query, host=False)
        black_ids = self._blacklist_ids(model, query)
        if lap is not None:
            lap("mask")
        if signal is None:
            sig = model.device_zeros()
        else:
            sig = torch.as_tensor(signal, device=model.device)
        # k covers the worst case: every signal pick also occupying a
        # backfill slot; bucketed so distinct nums share shapes
        k = min(bucket_width(2 * num, 16), len(model.item_dict))
        out = _serve_topk(sig, mask if mask is not None else model.device_ones(),
                          model.device_popularity(), als_pad_ids(black_ids),
                          k).cpu().numpy()     # ONE [4, k] readback
        if lap is not None:
            lap("topk")
        res = self._assemble(model, num, have_signal, out[0], out[1].astype(np.int32),
                             out[2], out[3].astype(np.int32), fill=fill)
        if lap is not None:
            lap("assemble")
        return res

    def _host_tail(self, model: URModel, query: URQuery,
                   signal: Optional[np.ndarray], num: int,
                   lap=None, fill: Optional[dict] = None) -> URResult:
        """The zero-dispatch tail: the device tail's math in numpy, with the
        composed rule mask cached per canonical rule set.  Elementwise f32
        products are the device's bit for bit and host_topk_desc keeps its
        tie order, so the answers are the device tail's."""
        n_items = len(model.item_dict)
        mask = self._mask_for(model, query, host=True)
        black = self._blacklist_ids(model, query)
        if lap is not None:
            lap("mask")
        k = min(bucket_width(2 * num, 16), n_items)
        bidx = np.asarray(black, np.int32) if black else None
        # signal top-k over the POSITIVE entries only (_assemble takes a
        # signal pick only when finite and > 0); the subset keeps index
        # order, so its (value desc, index asc) order is the device's
        st = si = None
        if signal is not None:
            s = signal * mask if mask is not None else signal
            pos = np.flatnonzero(s > 0)
            if bidx is not None and len(pos):
                pos = pos[np.isin(pos, bidx, invert=True)]
            if len(pos):
                vals, oi = host_topk_desc(s[pos], min(k, len(pos)))
                st, si = vals, pos[oi].astype(np.int32)
        n_signal = min(len(st) if st is not None else 0, num)
        # the backfill ranking matters only when the signal leaves slots
        bt = bi = None
        if n_signal < num and self.params.backfill_type != "none":
            bf = model.host_popularity()
            bfm = bf * mask if mask is not None else bf.copy()
            if mask is not None:
                bfm[mask <= 0] = -np.inf
            if bidx is not None:
                bfm[bidx] = -np.inf
            bt, bi = host_topk_desc(bfm, k)
        if lap is not None:
            lap("topk")
        empty_f = np.zeros(0, np.float32)
        empty_i = np.zeros(0, np.int32)
        res = self._assemble(
            model, num, st is not None,
            st if st is not None else empty_f, si if si is not None else empty_i,
            bt if bt is not None else empty_f, bi if bi is not None else empty_i,
            fill=fill)
        if lap is not None:
            lap("assemble")
        return res

    def _host_tail_pruned(self, model: URModel, query: URQuery,
                          sparse: Optional[Tuple[np.ndarray, np.ndarray]],
                          num: int, lap=None, fill: Optional[dict] = None
                          ) -> Optional[URResult]:
        """Candidate-pruned host tail: the mask, the blacklist and the
        signal top-k touch ONLY the sparse scorer's candidate rows, and the
        popularity backfill walks the precomputed popularity order — no
        [I_p] temporary, so a query's cost is flat in the catalog's size.

        The answers are _host_tail's by construction: the dense positive
        set lies in the candidates; the sliced mask is the full mask
        gathered (elementwise factors commute with the gather); candidates
        ascend, so the subset top-k keeps the dense tie order; and the
        backfill walk IS the dense ``host_topk_desc(bf * mask)`` order
        whenever the mask is binary.

        None when the query must fall back to the dense tail: no candidates
        (cold user or empty postings), a boosted (non-binary) mask with a
        backfill shortfall, or a backfill walk past its scan budget.  Each
        outcome counts in pio_ur_serve_candidate_total."""
        if sparse is None or len(sparse[0]) == 0:
            _M_CAND.inc(1, outcome="fallback_no_candidates")
            return None
        cand, sc = sparse
        n_items = len(model.item_dict)
        # strict date parsing in the key builder: malformed dates 400
        # exactly as the dense tail's
        key = self._mask_rule_key(query)
        mask_at = None
        mask_c = None
        if key is not None:
            # peek, not get: this probe never fills, so counting it would
            # flatline the dense cache's hit ratio under pruned traffic
            full = model.rule_mask_cache("host").peek(key)
            if full is not None:
                def mask_at(ids, _full=full):
                    return _full[ids]
            else:
                def mask_at(ids):
                    return self._mask_from_key_host_sliced(model, key, ids)
            mask_c = mask_at(cand)
        black = self._blacklist_ids(model, query)
        if lap is not None:
            lap("mask")
        k = min(bucket_width(2 * num, 16), n_items)
        s = sc * mask_c if mask_c is not None else sc
        pos = np.flatnonzero(s > 0)
        # the blacklist sorted ONCE: the signal filter and the backfill
        # walk both probe it through _sorted_member
        sb = np.sort(np.asarray(black, np.int32)) if black else None
        if sb is not None and len(pos):
            pos = pos[~_sorted_member(cand[pos], sb)]
        st = si = None
        if len(pos):
            vals, oi = host_topk_desc(s[pos], min(k, len(pos)))
            st, si = vals, cand[pos][oi].astype(np.int32)
        n_signal = min(len(st) if st is not None else 0, num)
        bt = bi = None
        if n_signal < num and self.params.backfill_type != "none":
            if key is not None and not self._mask_key_is_binary(key):
                # a boost scales backfill scores, so eligible-item order is
                # no longer the popularity order: only the dense top-k ranks
                _M_CAND.inc(1, outcome="fallback_backfill_reorder")
                return None
            merged = self._backfill_merge(model, mask_at, sb, k)
            if merged is None:
                _M_CAND.inc(1, outcome="fallback_backfill_scan")
                return None
            bt, bi = merged
        if lap is not None:
            lap("topk")
        _M_CAND.inc(1, outcome="pruned")
        _M_CAND_FRAC.observe(len(cand) / max(n_items, 1))
        empty_f = np.zeros(0, np.float32)
        empty_i = np.zeros(0, np.int32)
        res = self._assemble(
            model, num, st is not None,
            st if st is not None else empty_f, si if si is not None else empty_i,
            bt if bt is not None else empty_f, bi if bi is not None else empty_i,
            fill=fill)
        if lap is not None:
            lap("assemble")
        return res

    @staticmethod
    def _mask_key_is_binary(key: tuple) -> bool:
        """True when the composed mask only takes values in {0, 1}: every
        field bias a hard filter (< 0), 0.0 or 1.0; date factors are
        always 0/1.  A binary mask never REORDERS backfill scores."""
        return all(bias < 0.0 or bias in (0.0, 1.0) for _name, _values, bias in key[0])

    # ids a pruned-tail backfill walk may scan before it gives up and the
    # query serves dense: a catalog-independent bound on the sliced rule
    # work for a rule that matches almost nothing
    _BACKFILL_SCAN_BUDGET = 1 << 16

    def _backfill_merge(self, model: URModel, mask_at, sb, k: int
                        ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Backfill picks of the pruned tail: walk the precomputed
        (popularity desc, id asc) order in doubling chunks, dropping
        blacklisted (``sb``: a sorted id array or None) and masked-out ids,
        until k survive.  Called only under a binary mask, where the
        survivors' order IS the dense ``host_topk_desc(bf * mask)`` order
        and their scores are exactly ``bf``.  None when the walk passes
        _BACKFILL_SCAN_BUDGET ids still owing survivors."""
        order = model.host_pop_order()
        bf = model.host_popularity()
        n = len(order)
        picks: List[np.ndarray] = []
        taken = 0
        start, chunk = 0, max(4 * k, 64)
        while taken < k and start < n:
            if start >= self._BACKFILL_SCAN_BUDGET:
                return None
            ids = order[start:start + chunk]
            start += len(ids)
            chunk = min(chunk * 2, 1 << 16)
            keep = np.ones(len(ids), bool)
            if sb is not None:
                keep &= ~_sorted_member(ids, sb)
            if mask_at is not None:
                keep &= mask_at(ids) > 0
            sel = ids[keep]
            if len(sel):
                picks.append(sel[: k - taken])
                taken += len(picks[-1])
        if not picks:
            return np.zeros(0, np.float32), np.zeros(0, np.int32)
        bi = np.concatenate(picks).astype(np.int32)
        return bf[bi], bi

    def _mask_from_key_host_sliced(self, model: URModel, key: tuple,
                                   ids: np.ndarray) -> np.ndarray:
        """The canonical rule key's mask at ``ids`` only — exactly
        ``_mask_from_key_host(...)[ids]`` without the [I_p] build and
        without a cache entry.  The same factor composition
        (_compose_mask_host) with other accessors: a sorted-membership
        probe for a value match, a gather of the date offsets."""
        zeros = np.zeros(len(ids), np.float32)
        return self._compose_mask_host(
            model, key,
            value_match=lambda name, val: _sorted_member(
                ids, model._value_mask_ids(name, val)).astype(np.float32),
            date_ts=lambda ts: ts[ids],
            zeros=lambda: zeros,
            n=len(ids))

    def serve_batch_predict(self, model: URModel,
                            queries: Sequence[URQuery]) -> List[URResult]:
        """Deploy-time micro-batch, with the serial path's response cache:
        cached rows peel off before any device work, only the misses run
        the batched tail, and the misses fill the same cache ``predict``
        consults.  Answers equal ``predict``'s."""
        n_items = len(model.item_dict)
        if not queries or n_items == 0:
            return [URResult([]) for _ in queries]
        hists = [self._query_hist(model, q) for q in queries]
        cache = _resp_cache.get_cache()
        if not cache.armed_for(model):
            return self._serve_batch_uncached(model, queries, hists)
        keys: List[Tuple[tuple, Optional[tuple], int]] = []
        out: List[Optional[URResult]] = [None] * len(queries)
        misses: List[int] = []
        audited: Dict[int, tuple] = {}
        for r, q in enumerate(queries):
            num = min(q.num, n_items)
            rkey = self._mask_rule_key(q)
            ckey = _resp_cache.make_key(num, rkey, hists[r], self._blacklist_ids(model, q))
            keys.append((ckey, rkey, num))
            items, audit = cache.lookup(model, ckey)
            if items is not None and not audit:
                out[r] = URResult([ItemScore(n, s) for n, s in items])
            else:
                misses.append(r)
                if items is not None:
                    audited[r] = items
        if misses:
            fills: List[dict] = [{} for _ in misses]
            fresh = self._serve_batch_uncached(
                model, [queries[r] for r in misses], [hists[r] for r in misses], fills)
            for i, r in enumerate(misses):
                out[r] = fresh[i]
                ckey, rkey, num = keys[r]
                self._cache_settle(cache, model, ckey, rkey, fresh[i],
                                   audited.get(r), hists[r], fills[i], num)
        return out

    def _serve_batch_uncached(self, model: URModel, queries: Sequence[URQuery],
                              hists, fills: Optional[List[dict]] = None
                              ) -> List[URResult]:
        """The batched tail itself (histories already read): one gather an
        event type and one [B, 4, k] readback on the device tail; the host
        tail runs per query (off one batched device gather when the scorer
        is the device's)."""
        n_items = len(model.item_dict)
        b = len(queries)
        bp = bucket_width(b, min_width=1)
        have_signal = [h is not None and any(len(v) for v in h.values()) for h in hists]
        scorer = _serve_scorer(model)
        if _serve_tail(model) == "host":
            if scorer == "host":
                sparses = [self._score_history_host(model, h) if h else None
                           for h in hists]
                if _serve_candidates(model) == "on":
                    out = []
                    for r, q in enumerate(queries):
                        nm = min(q.num, n_items)
                        f = fills[r] if fills is not None else None
                        res = self._host_tail_pruned(model, q, sparses[r], nm, fill=f)
                        if res is None:
                            res = self._host_tail(
                                model, q, self._sparse_signal_dense(n_items, sparses[r]),
                                nm, fill=f)
                        out.append(res)
                    return out
                rows = [self._sparse_signal_dense(n_items, s) for s in sparses]
            else:
                total = self._score_batch_device(model, hists, bp)
                rows_all = None if total is None else total[:b].cpu().numpy()
                rows = [rows_all[r] if rows_all is not None and have_signal[r]
                        else None for r in range(b)]
            return [self._host_tail(model, q, rows[r], min(q.num, n_items),
                                    fill=fills[r] if fills is not None else None)
                    for r, q in enumerate(queries)]
        total = None
        if scorer == "host":
            rows_np = [self._sparse_signal_dense(n_items, self._score_history_host(model, h))
                       if h else None for h in hists]
            if any(r is not None for r in rows_np):
                total = torch.as_tensor(np.stack(
                    [r if r is not None else np.zeros(n_items, np.float32) for r in rows_np]
                    + [np.zeros(n_items, np.float32)] * (bp - b)), device=model.device)
        else:
            total = self._score_batch_device(model, hists, bp)
        if total is None:
            total = torch.zeros((bp, n_items), dtype=torch.float32, device=model.device)
        masks = torch.stack(
            [m if (m := self._mask_for(model, q, host=False)) is not None
             else model.device_ones() for q in queries]
            + [model.device_zeros()] * (bp - b))
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
                               out[r, 2], out[r, 3].astype(np.int32),
                               fill=fills[r] if fills is not None else None)
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
                  st, si, bt, bi, fill: Optional[dict] = None) -> URResult:
        """Signal picks first, then popularity backfill pads short lists up
        to num (reference UR appends popRank-ordered items).  ``fill``, when
        given, receives the response cache's entry facts: the picked item
        ids and how many came from backfill."""
        results: List[ItemScore] = []
        chosen = set()
        bf_ids: List[int] = []
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
                bf_ids.append(int(j))
        if fill is not None:
            fill["ids"] = list(chosen) + bf_ids
            fill["backfill"] = len(bf_ids)
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

    def _mask_for(self, model: URModel, query: URQuery, host: bool):
        """The composed business-rule mask for one query, memoized per
        (model generation, canonical rule set, tail kind) in a bounded LRU
        (hit/miss/evict in pio_ur_rule_mask_cache_total): repeated rule
        sets skip the composition.  None = no rules (all ones)."""
        key = self._mask_rule_key(query)
        if key is None:
            return None
        cache = model.rule_mask_cache("host" if host else "device")
        return cache.get_or_build(key, lambda: self._mask_from_key(model, key, host))

    def _mask_from_key(self, model: URModel, key: tuple, host: bool = False):
        """Build the mask from the CANONICAL key (not the query object): a
        host f32 array with ``host``, else a tensor on the model's device.
        Both compose the identical f32 factors in the identical order, each
        a separate elementwise op (no fused multiply-add), so they agree
        bit for bit, float biases included.

        Semantics are the Elasticsearch filter/boost analogue (reference:
        URAlgorithm field biases and date rules as ES bool-query
        filters); items missing a checked date property fail the check,
        like ES range filters."""
        if host:
            return self._mask_from_key_host(model, *key)
        return self._mask_from_key_device(model, *key)

    @staticmethod
    def _date_bound(epoch_s: float, base: float) -> int:
        # same rounding as the item offsets → exact boundary equality
        return int(np.clip(np.rint(epoch_s - base), -1, 2**31 - 2))

    def _mask_from_key_host(self, model, fields, drk, now, avail, expire
                            ) -> np.ndarray:
        return self._compose_mask_host(
            model, (fields, drk, now, avail, expire),
            value_match=model.host_value_mask,   # cached full f32 bitsets
            date_ts=lambda ts: ts,
            zeros=model.host_zeros,
            n=len(model.item_dict))

    def _compose_mask_host(self, model, key: tuple, value_match, date_ts,
                           zeros, n: int) -> np.ndarray:
        """The ONE host factor composition behind both the full mask and
        the candidate slice: pruned-equals-dense depends on both multiplying
        the identical elementwise factors in the identical order, so the
        callers only swap accessors: ``value_match(name, val)`` → f32 0/1
        match over the domain, ``date_ts(full_ts)`` → the domain's slice of
        a date-offset array, ``zeros()`` → the match-nothing result, ``n``
        = the domain's length."""
        fields, drk, now, avail, expire = key
        one = np.float32(1.0)
        mask = np.ones(n, np.float32)
        for name, values, bias in fields:
            match = None
            for val in values:
                m = value_match(name, val)
                match = m if match is None else np.maximum(match, m)
            if match is None:
                match = zeros()
            if bias < 0:
                mask = mask * match              # hard filter
            else:
                mask = mask * np.where(match > 0, np.float32(bias), one)
        if drk is not None:
            name, after_s, before_s = drk
            d = model.date_offsets(name)
            if d is None:            # no item has the property: match nothing
                return zeros()
            base, ts = d
            ts = date_ts(ts)
            present = (ts >= 0)
            mask = mask * present.astype(np.float32)
            if after_s is not None:
                mask = mask * ((ts >= self._date_bound(after_s, base))
                               & present).astype(np.float32)
            if before_s is not None:
                mask = mask * ((ts <= self._date_bound(before_s, base))
                               & present).astype(np.float32)
        if now is not None:
            for prop, op in ((avail, np.less_equal), (expire, np.greater_equal)):
                # available <= now <= expire; boundary instants still valid
                if not prop:
                    continue
                d = model.date_offsets(prop)
                if d is None:
                    return zeros()
                base, ts = d
                ts = date_ts(ts)
                b = self._date_bound(now, base)
                mask = mask * (op(ts, b) & (ts >= 0)).astype(np.float32)
        return mask

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
