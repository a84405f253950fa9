"""Provenance-invalidated top-k response cache for the serve hot path.

Counterpart of ``predictionio_tpu/serve/response_cache.py``.  Whole
answers are memoized per installed model generation; a swap keeps the
entries its provenance proves unchanged and drops the rest, so
Zipf-shaped traffic becomes a dict hit plus response re-assembly.

Exactness contract (zero staleness, bit-identical to the uncached tail):

- The KEY covers every query-side input of the answer: the effective k
  (``min(query.num, n_items)``), the canonical business-rule key
  (``_mask_rule_key`` — sorted fields, quantized dates), the per-event-
  type history id fingerprint, and the blacklist id set.  History and
  blacklist are recomputed from the live store / current model on every
  lookup, so an event append reroutes to a new key immediately — user
  drift never needs invalidation, only model drift does.
- A LOOKUP only serves an entry created against the IDENTICAL model
  object (in-flight queries on a superseded generation bypass; a put
  from a superseded generation is refused).
- A SWAP (``QueryServerState._install`` → :meth:`ResponseCache.on_swap`)
  intersects the new generation's provenance against each entry:

  * per event type, a changed primary row ``r`` can only move the signal
    score of histories that hit a target in ``old_idx[r] ∪ new_idx[r]``
    (posting membership of ``r`` changes exactly at those target ids) —
    entries whose recorded history intersects those *affected targets*
    drop, everything else provably scores bit-identically;
  * entries whose RESULT ids intersect the changed rows or the
    popularity-moved ids drop (belt over the same suspenders);
  * any popularity movement drops entries that used (or fell short of)
    backfill — ``pop_norm`` and the backfill order may shift;
  * a properties change drops entries that carried business rules;
  * ``use_llr_weights`` deployments drop signal entries on every swap (a
    single N bump moves every LLR weight, so scores drift globally —
    counts-based scoring, the default, is swap-stable).

  A model arriving WITHOUT provenance (retrain, restage, plane keyframe
  after a rebuild, missing/mismatched prev token) flushes everything.
- Online self-check: every ``PIO_SERVE_CACHE_AUDIT_N``-th hit recomputes
  the tail and compares bit-exactly; a mismatch increments
  ``pio_serve_cache_audit_mismatch_total`` (alert on nonzero), logs, and
  full-flushes.  ``PIO_SERVE_CACHE=off`` is the kill-switch oracle.

Provenance sources, normalized by :func:`_swap_provenance` exactly as the
reference reads them:

- in-process swaps (embedded follower): ``model._plane_prov`` — the fold
  engine's emit stash, valid iff its ``prev`` weakref is the cached
  generation;
- plane workers: ``model._serve_prov`` — the publisher's changed sets,
  valid iff its ``prevGeneration`` equals the cached generation's plane
  generation.

The fold (``streaming/fold.py``) stamps ``_plane_prov`` on every model it
emits, so an embedded follower's swap sweeps only the affected entries;
the model plane (``streaming/plane.py``) writes the same sets beside each
generation and its readers stamp ``_serve_prov``.  A retrain or a reload
carries no provenance and flushes everything, as in the reference.

Knobs: ``PIO_SERVE_CACHE`` (on|off, default on), ``PIO_SERVE_CACHE_MAX``
(entries, default 4096), ``PIO_SERVE_CACHE_TTL_S`` (0 = no TTL),
``PIO_SERVE_CACHE_AUDIT_N`` (default 1000, 0 = off).
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import time as _time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from predictionio_tpu_torch.obs import metrics as _obs_metrics

log = logging.getLogger("pio.serve.response_cache")

_REG = _obs_metrics.get_registry()
_M_CACHE = _REG.counter(
    "pio_serve_cache_total",
    "Response-cache lookups by outcome: hit (answer served from cache), "
    "miss (computed and filled), bypass (cache on but this query/model "
    "not cacheable — superseded generation, eval hist_override)")
_M_INVAL = _REG.counter(
    "pio_serve_cache_invalidations_total",
    "Response-cache entries dropped, by reason: no_provenance (swap "
    "without a usable changed-set — full flush), intersect (entry's "
    "history/result ids meet the swap's changed sets), backfill "
    "(popularity moved under a backfill-using entry), props (business-"
    "rule entry under a properties change), llr (use_llr_weights drifts "
    "scores every tick), audit (online self-check mismatch — full "
    "flush), disabled (engine without response-cache support installed), "
    "ttl, evict")
_M_ENTRIES = _REG.gauge(
    "pio_serve_cache_entries",
    "Live response-cache entries (one per distinct (history fingerprint, "
    "rule set, k, blacklist) answer)")
_M_AUDIT = _REG.counter(
    "pio_serve_cache_audit_mismatch_total",
    "Online response-cache self-check failures: a cached answer differed "
    "from the recomputed tail.  MUST stay 0 — nonzero means the "
    "invalidation proof was violated; the cache full-flushes and should "
    "be killed with PIO_SERVE_CACHE=off while the bug is found")

_EMPTY64 = np.zeros(0, np.int64)


def cache_enabled() -> bool:
    """The PIO_SERVE_CACHE kill switch (default on)."""
    return os.environ.get("PIO_SERVE_CACHE", "on").lower() not in (
        "off", "0", "false", "no")


def _cache_max() -> int:
    try:
        return max(int(os.environ.get("PIO_SERVE_CACHE_MAX", "4096")), 1)
    except ValueError:
        return 4096


def _cache_ttl_s() -> float:
    try:
        return max(float(os.environ.get("PIO_SERVE_CACHE_TTL_S", "0")), 0.0)
    except ValueError:
        return 0.0


def _audit_n() -> int:
    try:
        return max(int(os.environ.get("PIO_SERVE_CACHE_AUDIT_N", "1000")), 0)
    except ValueError:
        return 1000


def make_key(num: int, rule_key, hist: Optional[Dict[str, np.ndarray]],
             black_ids: Sequence[int]) -> tuple:
    """The full response key.  ``hist`` arrays are the per-event-type
    sorted-unique id lists the scorer consumes (raw bytes — exact, no
    hash collisions); the blacklist canonicalizes to its sorted-unique
    id SET (duplicates/order can't change masking)."""
    hk = (tuple(sorted((n, h.tobytes()) for n, h in hist.items()
                       if len(h)))
          if hist else ())
    bk = (np.unique(np.asarray(black_ids, np.int64)).tobytes()
          if black_ids else b"")
    return (int(num), rule_key, hk, bk)


def warm() -> None:
    """Build one key before a model serves: the first call of the key
    builder's numpy functions may import a module (``numpy.ma``, in newer
    numpy releases: 120-150 ms under the GIL), which a plane subscriber's
    first query paid (ROADMAP §C.11)."""
    make_key(1, None, {"warm": np.zeros(1, np.int64)}, [1, 0])


class _Entry:
    __slots__ = ("items", "hist", "result_ids", "used_backfill",
                 "has_rules", "llr_sensitive", "ts")

    def __init__(self, items, hist, result_ids, used_backfill,
                 has_rules, llr_sensitive, ts):
        self.items = items                  # tuple[(item_str, score), ...]
        self.hist = hist                    # {name: sorted int64 ids}
        self.result_ids = result_ids        # sorted int64 primary ids
        self.used_backfill = used_backfill
        self.has_rules = has_rules
        self.llr_sensitive = llr_sensitive
        self.ts = ts


def _intersects(a: np.ndarray, b: np.ndarray) -> bool:
    """Nonempty intersection of two ASCENDING id arrays (searchsorted —
    both sides are pre-sorted, np.isin would re-sort per call)."""
    if not len(a) or not len(b):
        return False
    if len(b) < len(a):
        a, b = b, a
    pos = np.searchsorted(b, a)
    np.minimum(pos, len(b) - 1, out=pos)
    return bool((b[pos] == a).any())


def _is_ur_model(model) -> bool:
    """Duck check for the one model family the cache understands (the
    install path is engine-agnostic)."""
    return (hasattr(model, "indicator_idx") and hasattr(model, "item_dict")
            and hasattr(model, "popularity"))


def _swap_provenance(new, cur) -> Optional[dict]:
    """Normalize the new generation's provenance RELATIVE TO ``cur`` into
    ``{"inv": {name: changed primary rows}, "pop": changed ids,
    "props_changed": bool}`` — or None when any piece is unknown (the
    caller full-flushes).  Absence of a type in the fold stash means
    either carried-identical (provable by object identity) or rebuilt
    (unknown rows → None)."""
    if cur is None:
        return None
    sp = new.__dict__.get("_serve_prov")
    if sp is not None:
        # plane-composed generation: validity keyed to the PLANE
        # generation the publisher diffed against
        if int(sp.get("prev_gen") or -1) != int(
                cur.__dict__.get("_plane_generation") or -2):
            return None
        if set(new.indicator_idx) != set(cur.indicator_idx):
            return None
        inv = {}
        for name in new.indicator_idx:
            rows = sp["inv"].get(name)
            if rows is None:
                return None
            inv[name] = np.asarray(rows, np.int64)
        pop = sp.get("pop")
        if pop is None:
            return None
        return {"inv": inv, "pop": np.asarray(pop, np.int64),
                "props_changed": bool(sp.get("props_changed"))}
    prov = new.__dict__.get("_plane_prov")
    if not prov:
        return None
    ref = prov.get("prev")
    if ref is None or ref() is not cur:
        return None
    serve = prov.get("serve")
    if serve is None:
        return None     # fold couldn't prove the changed sets this tick
    if set(serve["inv"]) != set(new.indicator_idx) \
            or set(new.indicator_idx) != set(cur.indicator_idx):
        return None
    return {"inv": {n: np.asarray(v, np.int64)
                    for n, v in serve["inv"].items()},
            "pop": np.asarray(serve["pop"], np.int64),
            "props_changed":
                new.item_properties is not cur.item_properties}


def _affected_targets(prov: dict, new, cur) -> Dict[str, np.ndarray]:
    """Per event type, the target-space ids whose posting lists could
    have changed: ``unique(valid(old_idx[changed] ∪ new_idx[changed]))``.
    A history that avoids all of them gathers the identical posting rows
    (and, counts-based, the identical scores) from both generations."""
    aff: Dict[str, np.ndarray] = {}
    for name, rows in prov["inv"].items():
        parts: List[np.ndarray] = []
        if len(rows):
            for m in (cur, new):
                idx = np.asarray(m.indicator_idx[name])
                r = rows[rows < idx.shape[0]]
                if len(r):
                    vals = idx[r].ravel()
                    vals = vals[vals >= 0]
                    if len(vals):
                        parts.append(vals.astype(np.int64))
        aff[name] = (np.unique(np.concatenate(parts)) if parts
                     else _EMPTY64)
    return aff


class ResponseCache:
    """Bounded thread-safe LRU of whole top-k answers, armed on the model
    object the query server currently serves.  One instance per process
    (module singleton); prefork siblings each run their own, invalidated
    through the plane-carried provenance."""

    def __init__(self):
        self._lock = threading.Lock()
        self._data: "collections.OrderedDict[tuple, _Entry]" = \
            collections.OrderedDict()
        self._model = None
        self._hits = 0
        # introspection for tests/bench: totals since process start
        self.hit_count = 0
        self.miss_count = 0
        self.last_swap_invalidated = 0
        self.last_swap_reason = ""

    # -- serving side --------------------------------------------------------

    def armed_for(self, model) -> bool:
        """Fast gate for the predict hot path: cache globally on AND this
        exact model object is the installed generation."""
        return (self._model is model and model is not None
                and cache_enabled())

    def lookup(self, model, key: tuple) -> Tuple[Optional[tuple], bool]:
        """(cached items | None, audit_due).  Counts hit/miss/bypass."""
        now = _time.monotonic()
        ttl = _cache_ttl_s()
        audit = False
        with self._lock:
            if self._model is not model:
                outcome = "bypass"
                entry = None
            else:
                entry = self._data.get(key)
                if entry is not None and ttl and now - entry.ts > ttl:
                    del self._data[key]
                    _M_INVAL.inc(1, reason="ttl")
                    entry = None
                if entry is not None:
                    self._data.move_to_end(key)
                    outcome = "hit"
                    self._hits += 1
                    self.hit_count += 1
                    n = _audit_n()
                    audit = bool(n) and self._hits % n == 0
                else:
                    outcome = "miss"
                    self.miss_count += 1
            n_live = len(self._data)
        _M_CACHE.inc(1, outcome=outcome)
        _M_ENTRIES.set(n_live)
        return (entry.items if entry is not None else None), audit

    def count_bypass(self, n: int = 1) -> None:
        """Per-row bypass accounting for batch callers that skip lookup
        wholesale (e.g. hist_override)."""
        if n > 0:
            _M_CACHE.inc(n, outcome="bypass")

    def put(self, model, key: tuple, items, hist, result_ids,
            used_backfill: bool, has_rules: bool,
            llr_sensitive: bool) -> None:
        """Fill after a miss.  Refused when the generation moved under
        the in-flight query (the swap's invalidation sweep must stay
        authoritative) or the switch flipped off."""
        if not cache_enabled():
            return
        hist64 = {n: np.asarray(h, np.int64) for n, h in (hist or {}).items()
                  if len(h)}
        rids = np.unique(np.asarray(result_ids, np.int64))
        entry = _Entry(tuple(items), hist64, rids, bool(used_backfill),
                       bool(has_rules), bool(llr_sensitive),
                       _time.monotonic())
        evicted = 0
        with self._lock:
            if self._model is not model:
                return
            self._data[key] = entry
            self._data.move_to_end(key)
            cap = _cache_max()
            while len(self._data) > cap:
                self._data.popitem(last=False)
                evicted += 1
            n_live = len(self._data)
        if evicted:
            _M_INVAL.inc(evicted, reason="evict")
        _M_ENTRIES.set(n_live)

    def audit_mismatch(self, key: tuple) -> None:
        """An audited hit diverged from the recomputed tail: record it
        loudly and drop EVERYTHING — correctness over hit rate."""
        _M_AUDIT.inc(1)
        log.error("response cache: online audit mismatch (key drop + "
                  "full flush) — cached answer differed from the "
                  "recomputed tail; run with PIO_SERVE_CACHE=off and "
                  "report")
        with self._lock:
            n = len(self._data)
            self._data.clear()
        if n:
            _M_INVAL.inc(n, reason="audit")
        _M_ENTRIES.set(0)

    # -- install side --------------------------------------------------------

    def on_swap(self, models) -> None:
        """QueryServerState._install hook, called UNDER the install lock
        just before the new predictor goes live: re-arm on the new
        generation, dropping exactly the entries its provenance cannot
        prove unchanged."""
        model = (models[0] if isinstance(models, (list, tuple))
                 and len(models) == 1 else None)
        if model is None or not _is_ur_model(model):
            self.disarm()
            return
        with self._lock:
            cur = self._model
            self._model = model
            if cur is model or not self._data:
                self.last_swap_invalidated = 0
                self.last_swap_reason = "noop"
                n_live = len(self._data)
                dropped: Dict[str, int] = {}
            else:
                dropped = self._invalidate_locked(model, cur)
                n_live = len(self._data)
        for reason, n in dropped.items():
            _M_INVAL.inc(n, reason=reason)
        _M_ENTRIES.set(n_live)

    def _invalidate_locked(self, new, cur) -> Dict[str, int]:
        prov = _swap_provenance(new, cur)
        if prov is None:
            n = len(self._data)
            self._data.clear()
            self.last_swap_invalidated = n
            self.last_swap_reason = "no_provenance"
            return {"no_provenance": n} if n else {}
        aff = _affected_targets(prov, new, cur)
        # primary-space union for the result-id intersection check
        parts = [r for r in prov["inv"].values() if len(r)]
        if len(prov["pop"]):
            parts.append(prov["pop"])
        changed_union = (np.unique(np.concatenate(parts)) if parts
                         else _EMPTY64)
        pop_any = bool(len(prov["pop"]))
        dropped: Dict[str, int] = {}
        doomed: List[tuple] = []
        for key, e in self._data.items():
            reason = None
            if e.llr_sensitive:
                reason = "llr"
            elif prov["props_changed"] and e.has_rules:
                reason = "props"
            elif pop_any and e.used_backfill:
                reason = "backfill"
            elif _intersects(e.result_ids, changed_union) or any(
                    _intersects(h, aff.get(n, _EMPTY64))
                    for n, h in e.hist.items()):
                reason = "intersect"
            if reason is not None:
                doomed.append(key)
                dropped[reason] = dropped.get(reason, 0) + 1
        for key in doomed:
            del self._data[key]
        self.last_swap_invalidated = len(doomed)
        self.last_swap_reason = "selective"
        return dropped

    def disarm(self) -> None:
        """Installed models the cache can't reason about (non-UR engines,
        multi-model bundles): serve uncached."""
        with self._lock:
            n = len(self._data)
            self._data.clear()
            self._model = None
        if n:
            _M_INVAL.inc(n, reason="disabled")
        _M_ENTRIES.set(0)

    def clear(self) -> None:
        """Test/bench helper: drop entries AND the armed model."""
        self.disarm()

    def reset_for_tests(self) -> None:
        """Disarm, drop every entry and zero the instance's counters, so
        one test's serving cannot leak into the next in one process."""
        self.disarm()
        with self._lock:
            self._hits = 0
            self.hit_count = 0
            self.miss_count = 0
            self.last_swap_invalidated = 0
            self.last_swap_reason = ""

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)


_CACHE = ResponseCache()


def get_cache() -> ResponseCache:
    return _CACHE
