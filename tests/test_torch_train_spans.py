"""The spans inside the UR/CCO train (``utils/tracing.timed``): each lands
as a ``torch.profiler`` range, in an active span journal with its parent,
and in ``recent_spans``, on one clock.

- A tiny ``URAlgorithm.train`` on the resident tile loop opens every
  engine and driver span the stated number of times a train, ``cco.*``
  inside ``cco.train`` inside ``ur.train``;
- under an active ``SpanJournal`` the same names land with their parent
  links;
- a range's ``start_ns`` and the journal's ``start`` of one span agree;
- ``cco_indicators`` on a blocked layout opens ``cco.flatten`` and
  ``cco.stage``, on the resident and on the chunked strategy.
"""

import collections
import time

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from predictionio_tpu_torch.models.universal_recommender.engine import (
    URAlgorithm,
    URAlgorithmParams,
    URTrainingData,
)
from predictionio_tpu_torch.obs import spans as obs_spans
from predictionio_tpu_torch.ops import cco
from predictionio_tpu_torch.store.columnar import IdDict
from predictionio_tpu_torch.utils import tracing

PREFIXES = ("ur.", "cco.")

#: each span's count in one train of ``ur_data`` on the resident strategy:
#: the primary's and each type's id checks, the resident primary and the
#: view's staging, one tile loop and one readback a type
PER_TRAIN = {
    "ur.train": 1, "ur.train.tables": 1, "ur.train.seen": 1,
    "ur.train.backfill": 1, "ur.train.seen_by_event": 1,
    "cco.train": 1, "cco.check_ids": 3, "cco.stage": 2, "cco.tiles": 2,
    "cco.finalize": 2,
}


@pytest.fixture()
def tiled(monkeypatch):
    """The tiled strategies on the CPU: neither the dense strategy nor the
    host sparse runner."""
    monkeypatch.setenv("PIO_CCO_DENSE", "off")
    monkeypatch.setenv("PIO_CCO_SPARSE", "off")


def ur_data(seed=0, n_users=40, n_items=60):
    g = np.random.default_rng(seed)
    users = IdDict([f"u{u}" for u in range(n_users)])
    catalog = IdDict([f"i{i}" for i in range(n_items)])
    inter = {}
    for name, n in (("purchase", 200), ("view", 500)):
        inter[name] = (g.integers(0, n_users, n).astype(np.int32),
                       g.integers(0, n_items, n).astype(np.int32), catalog,
                       1.7e9 + g.uniform(0, 86400.0, n))
    return URTrainingData(event_names=["purchase", "view"], user_dict=users,
                          interactions=inter, item_properties={})


def ur_algo():
    return URAlgorithm(URAlgorithmParams(
        app_name="spans", event_names=["purchase", "view"], max_correlators_per_item=5,
        item_tile=16, blacklist_events=["purchase", "view"]), device="cpu")


def ranges(prof):
    """The program's ranges in a stopped profiler: (start ns, end ns, name)."""
    return sorted((e.start_ns(), e.end_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CPU and e.is_user_annotation()
                  and e.name().startswith(PREFIXES))


def inside(inner, outers):
    return any(s <= inner[0] and inner[1] <= e for s, e, _ in outers)


def test_every_span_of_a_train_is_a_range_nested_in_its_parent(tiled):
    algo, td = ur_algo(), ur_data()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        algo.train(td)
        algo.train(td)
    got = ranges(prof)
    counts = collections.Counter(name for _, _, name in got)
    assert counts == {name: 2 * n for name, n in PER_TRAIN.items()}
    by = collections.defaultdict(list)
    for r in got:
        by[r[2]].append(r)
    for r in got:
        if r[2].startswith("cco.") and r[2] != "cco.train":
            assert inside(r, by["cco.train"]), r
        elif r[2] != "ur.train":
            assert inside(r, by["ur.train"]), r


def test_a_journal_holds_the_same_spans_with_their_parents(tiled, tmp_path):
    journal = obs_spans.SpanJournal(tmp_path / "train.jsonl")
    with journal.activate():
        ur_algo().train(ur_data(seed=1))
    recs = obs_spans.read_journal(tmp_path / "train.jsonl")
    assert collections.Counter(r["name"] for r in recs) == PER_TRAIN
    name_of = {r["id"]: r["name"] for r in recs}
    for r in recs:
        parent = name_of.get(r["parent"])
        if r["name"] == "ur.train":
            assert parent is None
        elif r["name"].startswith("ur.train.") or r["name"] == "cco.train":
            assert parent == "ur.train", r
        else:
            assert parent == "cco.train", r


def test_a_range_the_journal_and_recent_spans_agree_on_one_clock(tmp_path):
    journal = obs_spans.SpanJournal(tmp_path / "clock.jsonl")
    with journal.activate(), profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.timed("cco.probe"):
            time.sleep(0.02)
    [(r0, r1, _)] = [r for r in ranges(prof) if r[2] == "cco.probe"]
    [rec] = [r for r in obs_spans.read_journal(tmp_path / "clock.jsonl")
             if r["name"] == "cco.probe"]
    assert abs(rec["start"] - r0 / 1e9) < 0.05
    [(s, e, _)] = [r for r in tracing.recent_spans() if r[2] == "cco.probe"][-1:]
    assert abs(s - r0) < 50_000_000 and abs(e - r1) < 50_000_000
    assert e - s >= 20_000_000


def test_recent_spans_are_bounded_and_in_closing_order():
    for k in range(tracing._RECENT.maxlen + 3):
        with tracing.timed("probe.recent"):
            pass
    got = tracing.recent_spans()
    assert len(got) == tracing._RECENT.maxlen
    assert all(a[1] <= b[1] for a, b in zip(got, got[1:]))


@pytest.mark.parametrize("strategy", ["resident", "chunked"])
def test_cco_indicators_spans_the_flatten_and_the_staging(tiled, monkeypatch, strategy):
    if strategy == "chunked":
        monkeypatch.setattr(cco, "_resident_budget", lambda device: 0)
    g = np.random.default_rng(3)
    n_users, n_items = 50, 40
    blocked = cco.block_interactions(g.integers(0, n_users, 400), g.integers(0, n_items, 400),
                                     n_users, n_items, user_block=16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        scores, ids = cco.cco_indicators(blocked, blocked, n_total_users=n_users, top_k=4,
                                         item_tile=16, exclude_self=True, device="cpu")
    assert ids.shape == (n_items, 4)
    counts = collections.Counter(name for _, _, name in ranges(prof))
    assert counts == {"cco.train": 1, "cco.flatten": 1, "cco.stage": 1, "cco.tiles": 1,
                      "cco.finalize": 1}
