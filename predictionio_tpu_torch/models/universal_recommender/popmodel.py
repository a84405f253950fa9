"""Popularity backfill family of the Universal Recommender.

Counterpart of ``predictionio_tpu/models/universal_recommender/popmodel.py``
(a copy: the port imports nothing of the JAX package).  Parity with the
reference UR's PopModel (actionml/universal-recommender PopModel.scala):
event-time-windowed ranking selectable as ``backfill_type``:

- ``popular``  — event count inside the window
- ``trending`` — velocity: count in the window's recent half minus the
  older half
- ``hot``      — acceleration: the change in velocity across three equal
  thirds of the window

The reference computes these as Spark RDD countByKey passes over time
ranges; here they are up to three ``bincount`` sweeps over the columnar
event arrays, on the host, or with ``device`` on that device after one
copy of the items and times each (the counts are exact either way, so the
scores are the same).

Raw event streams (with duplicates) are the correct input: popularity ranks
by event *volume*, unlike the CCO marginals which count distinct users.
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np
import torch

BACKFILL_TYPES = ("popular", "trending", "hot", "none")

_DURATION_RE = re.compile(
    r"^\s*(\d+(?:\.\d+)?)\s*(seconds?|secs?|s|minutes?|mins?|m|hours?|hrs?|h|days?|d|weeks?|w)?\s*$",
    re.IGNORECASE,
)
_UNIT_SECONDS = {
    "s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0, "w": 604800.0,
}


def parse_duration(text: str) -> float:
    """'90 days' / '12 hours' / '3600' (seconds) → seconds.

    Mirrors the reference's duration params (e.g. backfillField.duration
    \"3650 days\"); raises ValueError on anything unparseable so a typo'd
    engine.json fails at train time, not silently."""
    m = _DURATION_RE.match(text or "")
    if not m:
        raise ValueError(f"unparseable duration: {text!r}")
    value = float(m.group(1))
    unit = (m.group(2) or "s").lower()[0]
    return value * _UNIT_SECONDS[unit]


def _window_counts(
    items: np.ndarray, times: np.ndarray, n_items: int,
    start: float, end: float,
) -> np.ndarray:
    sel = (times >= start) & (times < end)
    if torch.is_tensor(items):
        return torch.bincount(items[sel], minlength=n_items).to(torch.float32).cpu().numpy()
    if not sel.any():
        return np.zeros(n_items, np.float32)
    return np.bincount(items[sel], minlength=n_items).astype(np.float32)


def backfill_scores(
    backfill_type: str,
    items: np.ndarray,          # int32 [E] primary-event item ids (raw, with dups)
    times: np.ndarray,          # f64   [E] epoch seconds per event
    n_items: int,
    duration_s: float,
    end_ts: Optional[float] = None,
    device: Optional[torch.device] = None,
) -> np.ndarray:
    """Per-item backfill score; higher = ranked earlier.  ``end_ts`` defaults
    to the newest event (training-time \"now\").  With ``device`` the
    sweeps run there."""
    if backfill_type not in BACKFILL_TYPES:
        raise ValueError(
            f"backfill_type must be one of {BACKFILL_TYPES}, got {backfill_type!r}")
    if backfill_type == "none" or n_items == 0:
        return np.zeros(n_items, np.float32)
    if device is None:
        items = np.asarray(items, np.int64)
        times = np.asarray(times, np.float64)
    else:
        items = torch.as_tensor(np.asarray(items), device=device).to(torch.int64)
        times = torch.as_tensor(np.asarray(times, np.float64), device=device)
    if len(items) == 0:
        return np.zeros(n_items, np.float32)
    end = float(end_ts) if end_ts is not None else float(times.max()) + 1e-6
    start = end - float(duration_s)
    if backfill_type == "popular":
        return _window_counts(items, times, n_items, start, end)
    if backfill_type == "trending":
        mid = end - duration_s / 2.0
        older = _window_counts(items, times, n_items, start, mid)
        newer = _window_counts(items, times, n_items, mid, end)
        return newer - older
    # hot: growth-rate acceleration across three equal thirds.  The raw
    # second difference c3 - 2·c2 + c1 would rank an item that was huge
    # long ago and then died (+c1, zero c2/c3) as "hot"; the smoothed
    # ratio form rewards items whose RATE of growth is increasing and
    # penalizes decay regardless of absolute volume.
    t1 = end - duration_s * 2.0 / 3.0
    t2 = end - duration_s / 3.0
    c1 = _window_counts(items, times, n_items, start, t1)
    c2 = _window_counts(items, times, n_items, t1, t2)
    c3 = _window_counts(items, times, n_items, t2, end)
    return c3 / (c2 + 1.0) - c2 / (c1 + 1.0)
