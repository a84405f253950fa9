"""The one event generator: every configuration's events from its seed.

A configuration gives the users, the catalog's items and, per event type,
the number of events and the rank exponent ``zipf_s`` of item popularity;
a traffic mix gives the batch the draws are made in and, where the entry
needs event times, the span they fall in.  Item popularity is a Zipf law
truncated to the catalog: the item of popularity rank r (1 ≤ r ≤ items) is
drawn with weight r^-s.  One permutation of the catalog, drawn from the
seed, maps ranks to item ids, so every event type shares its popular items
and ids carry no order of popularity.  Each event's user is uniform.  For
each event type, in order, one generator seeded by (seed, type index)
draws each batch's users and then its items.  The same seed gives the same
arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

#: event times start here (2026-01-01T00:00:00Z) and fall within the span
EPOCH_BASE_S = 1_767_225_600.0
#: the stream of the catalog's rank → item permutation
CATALOG_STREAM = 999


@dataclasses.dataclass
class Events:
    user: np.ndarray                 # int32 [E]
    item: np.ndarray                 # int32 [E]
    time: Optional[np.ndarray]       # float64 [E] epoch seconds, or None


def rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of one stream of a run: any whole seed, negative or
    past 64 bits, maps to one of 2**64 seeds."""
    return np.random.default_rng([seed % (1 << 64), stream])


def zipf_cdf(items: int, s: float) -> np.ndarray:
    """float64 [items]: the cumulative shares of ranks 1..items under
    weights r^-s, the last exactly 1."""
    cdf = np.cumsum(np.arange(1, items + 1, dtype=np.float64) ** -s)
    cdf /= cdf[-1]
    cdf[-1] = 1.0
    return cdf


def make_events(cfg: Dict, traffic: Dict, seed: int) -> Dict[str, Events]:
    users, items = int(cfg["users"]), int(cfg["items"])
    span = traffic.get("time_span_s")
    catalog = rng(seed, CATALOG_STREAM).permutation(items).astype(np.int32)
    out: Dict[str, Events] = {}
    for index, et in enumerate(cfg["event_types"]):
        n = int(et["events"])
        cdf = zipf_cdf(items, float(et["zipf_s"]))
        batch = int(traffic.get("batch") or n)
        g = rng(seed, index)
        user = np.empty(n, np.int32)
        item = np.empty(n, np.int32)
        for lo in range(0, n, batch):
            hi = min(lo + batch, n)
            user[lo:hi] = g.integers(0, users, hi - lo, dtype=np.int32)
            item[lo:hi] = catalog[np.searchsorted(cdf, g.random(hi - lo), side="right")]
        time = None
        if span:
            time = EPOCH_BASE_S + g.uniform(0.0, float(span), n)
        out[et["name"]] = Events(user, item, time)
    return out
