"""The Universal Recommender's train on the dense CCO strategy, as a card
takes it for a catalog whose whole count matrix fits
(``ops/cco.py:_dense_path_ok``), with four event types.

- With ``PIO_CCO_DENSE`` on ``auto`` every type takes the dense route, and
  every row of every indicator table matches the benchmark's plain
  reference (``pio_bench/reference.py``, G² in float64) row by row;
- ``PIO_CCO_DENSE=off`` moves every type to the resident tile loop, and the
  tables stay the same bit for bit;
- each type's dense run is one ``cco.dense`` span inside ``cco.train``;
- ``strategy_by_type`` counts one event type a train by the strategy that
  trained it, and ``dense_chunks`` the dense route's user-chunk passes,
  from 0 after ``reset_strategy_counts()``;
- the dense route checks each type's ids as it stages them, with no host
  pass (only the primary's ``cco.check_ids`` runs), and an id out of range
  raises the host check's error;
- the engine's seen lookup, sorted and deduplicated on the training's
  device, is ``CSRLookup.from_pairs`` array for array, and on the card the
  backfill's sweeps give the host's scores, and the dense counts are the
  CPU's.

On the CPU the host sparse runner comes before the dense strategy
(``PIO_CCO_SPARSE`` on ``auto``); on the card it never does, so these tests
turn it off to choose as the card chooses.  The file imports no JAX.
"""

import collections

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from pio_bench import check, reference
from predictionio_tpu_torch.models.universal_recommender import engine
from predictionio_tpu_torch.models.universal_recommender.engine import (
    URAlgorithm,
    URAlgorithmParams,
    URTrainingData,
)
from predictionio_tpu_torch.ops import cco
from predictionio_tpu_torch.store.columnar import CSRLookup, IdDict

N_USERS, N_ITEMS, TOP_K = 700, 200, 8
#: (event type, events, its catalog's items): the log's four behaviours in
#: the benchmark configuration's order; ``fav`` on a smaller catalog, so
#: one type's padded width differs from the primary's
TYPES = (("purchase", 1500, N_ITEMS), ("view", 9000, N_ITEMS),
         ("cart", 3000, N_ITEMS), ("fav", 2000, 150))
#: the dense chunk budget that splits 700 users into 3 chunks of 256:
#: (I_p + the widest padded I_t) cells of 2 bytes, 256 users
CHUNK_BYTES = (N_ITEMS + 256) * 2 * 256
N_CHUNKS = 3


@pytest.fixture()
def card_choice(monkeypatch):
    """The strategy choice of the card on the CPU: no host sparse runner,
    the dense switch on ``auto``, and a chunk budget that makes several
    user chunks of this small train."""
    monkeypatch.setenv("PIO_CCO_SPARSE", "off")
    monkeypatch.delenv("PIO_CCO_DENSE", raising=False)
    monkeypatch.setattr(cco, "_DENSE_CHUNK_BYTES", CHUNK_BYTES)
    return monkeypatch


def events(seed):
    """Each type's (user, item) arrays: items skewed to a few popular ones,
    as the benchmark's generator draws them, so rows have many co-occurring
    items and ties in their scores."""
    g = np.random.default_rng(seed)
    out = {}
    for name, n, items in TYPES:
        w = 1.0 / np.arange(1, items + 1) ** 0.871
        out[name] = (g.integers(0, N_USERS, n).astype(np.int32),
                     g.choice(items, n, p=w / w.sum()).astype(np.int32))
    return out


def train(seed=0):
    ev = events(seed)
    users = IdDict([f"u{u}" for u in range(N_USERS)])
    inter = {}
    for name, _, items in TYPES:
        u, i = ev[name]
        catalog = IdDict([f"i{k}" for k in range(items)])
        inter[name] = (u, i, catalog, 1.7e9 + np.arange(len(u), dtype=np.float64))
    names = [t[0] for t in TYPES]
    td = URTrainingData(event_names=names, user_dict=users, interactions=inter,
                        item_properties={})
    algo = URAlgorithm(URAlgorithmParams(
        app_name="dense", event_names=names, max_correlators_per_item=TOP_K,
        item_tile=64), device="cpu")
    return ev, algo.train(td)


def test_auto_takes_the_dense_route_and_matches_the_reference_row_by_row(card_choice):
    cco.reset_strategy_counts()
    ev, model = train(seed=1)
    assert cco.strategy_by_type == {"dense": 4, "resident": 0, "chunked": 0, "sparse": 0}
    p = reference.Pairs(*ev["purchase"], N_USERS, N_ITEMS)
    rows = np.arange(N_ITEMS)
    for name, _, items in TYPES:
        a = reference.Pairs(*ev[name], N_USERS, items)
        ref = reference.indicator_rows(p, a, rows, N_USERS, TOP_K, 0.0, name == "purchase")
        ids, scores = model.indicator_idx[name], model.indicator_llr[name]
        assert ids.shape == (N_ITEMS, TOP_K)
        valid = ids >= 0
        nums = check.compare_rows(ref, ((r, ids[r][valid[r]], scores[r][valid[r]])
                                        for r in rows))
        assert nums["entries_mismatch"] == 0, name
        assert nums["score_err"] < 1e-5 and nums["rank_gap"] < 1e-5, (name, nums)
        assert valid[:, 0].any() and not valid.all(), name


def test_the_resident_route_gives_the_same_tables_bit_for_bit(card_choice):
    _, dense = train(seed=2)
    card_choice.setenv("PIO_CCO_DENSE", "off")
    cco.reset_strategy_counts()
    _, resident = train(seed=2)
    assert cco.strategy_by_type["resident"] == 4 and cco.strategy_by_type["dense"] == 0
    for name, _, _ in TYPES:
        np.testing.assert_array_equal(dense.indicator_idx[name], resident.indicator_idx[name])
        np.testing.assert_array_equal(dense.indicator_llr[name].view(np.int32),
                                      resident.indicator_llr[name].view(np.int32))


def test_each_type_s_dense_run_is_one_cco_dense_span_inside_cco_train(card_choice):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train(seed=3)
    got = sorted((e.start_ns(), e.end_ns(), e.name())
                 for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CPU and e.is_user_annotation()
                 and e.name().startswith("cco."))
    counts = collections.Counter(n for _, _, n in got)
    assert counts["cco.dense"] == len(TYPES) and counts["cco.train"] == 1
    assert counts["cco.tiles"] == 0
    (t0, t1, _), = [r for r in got if r[2] == "cco.train"]
    dense = [r for r in got if r[2] == "cco.dense"]
    assert all(t0 <= s and e <= t1 for s, e, _ in dense)
    # one after the other: a type's dense run ends before the next begins
    assert all(a[1] <= b[0] for a, b in zip(dense, dense[1:]))


@pytest.mark.parametrize("strategy", ["dense", "resident", "chunked", "sparse"])
def test_strategy_by_type_counts_each_type_once_from_a_reset(card_choice, strategy):
    if strategy == "resident":
        card_choice.setenv("PIO_CCO_DENSE", "off")
    elif strategy == "chunked":
        card_choice.setenv("PIO_CCO_DENSE", "off")
        card_choice.setattr(cco, "_resident_budget", lambda device: 0)
    elif strategy == "sparse":
        card_choice.setenv("PIO_CCO_SPARSE", "on")
    cco.strategy_by_type["dense"] += 7        # stale counts from an earlier run
    cco.reset_strategy_counts()
    assert set(cco.strategy_by_type.values()) == {0} and cco.dense_chunks == 0
    train(seed=4)
    train(seed=4)
    want = dict.fromkeys(cco.strategy_by_type, 0)
    want[strategy] = 2 * len(TYPES)
    assert cco.strategy_by_type == want
    assert cco.dense_chunks == (2 * len(TYPES) * N_CHUNKS if strategy == "dense" else 0)


def test_dense_chunks_follow_the_chunk_rule_without_a_budget_override(monkeypatch):
    """At the default 1 GiB budget the small train is one chunk a type;
    ``cco_indicators_coo`` counts its one type."""
    monkeypatch.setenv("PIO_CCO_SPARSE", "off")
    monkeypatch.delenv("PIO_CCO_DENSE", raising=False)
    ev = events(5)
    cco.reset_strategy_counts()
    cco.cco_indicators_coo(*ev["purchase"], *ev["view"], N_USERS, N_ITEMS, N_ITEMS,
                           top_k=TOP_K, device="cpu")
    assert cco.strategy_by_type["dense"] == 1 and cco.dense_chunks == 1


def test_the_dense_route_checks_ids_as_it_stages_them(card_choice):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train(seed=6)
    names = collections.Counter(e.name() for e in prof.profiler.kineto_results.events()
                                if e.device_type() == DeviceType.CPU
                                and e.is_user_annotation())
    assert names["cco.check_ids"] == 1 and names["cco.dense"] == len(TYPES)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("bad", ["user_low", "user_high", "item_low", "item_high"])
@pytest.mark.parametrize("name", ["view", "fav"])
def test_an_id_out_of_range_raises_on_the_dense_route(card_choice, dtype, bad, name):
    ev = events(7)
    which, end = bad.split("_")
    n_items = dict((t[0], t[2]) for t in TYPES)[name]
    u, i = (x.astype(dtype) for x in ev[name])
    arr = u if which == "user" else i
    arr[11] = -1 if end == "low" else (N_USERS if which == "user" else n_items)
    pu, pi = ev["purchase"]
    others = [(t, pu, pi, N_ITEMS) if t == "purchase" else
              ((t, u, i, n_items) if t == name else (t, *ev[t], k))
              for t, _, k in TYPES]
    cco.reset_strategy_counts()
    with pytest.raises(ValueError, match=f"^{name}: {which} ids outside "
                                         rf"\[0, {N_USERS if which == 'user' else n_items}\)$"):
        cco.cco_train_indicators(pu, pi, others, N_USERS, N_ITEMS, top_k=TOP_K,
                                 exclude_self_for="purchase", device="cpu")
    assert cco.strategy_by_type["dense"] == [t for t, _, _ in TYPES].index(name) + 1


@pytest.mark.parametrize("case", ["duplicates", "int64", "sparse_rows", "one_pair", "empty"])
def test_the_seen_lookup_on_the_device_is_from_pairs_array_for_array(case):
    g = np.random.default_rng(8)
    n_rows, n = 500, {"one_pair": 1, "empty": 0}.get(case, 4000)
    hi = 40 if case == "sparse_rows" else n_rows
    rows = g.integers(0, hi, n).astype(np.int32) * (n_rows // hi)
    values = g.integers(0, 9 if case == "duplicates" else 300, n).astype(np.int32)
    if case == "int64":
        rows, values = rows.astype(np.int64), values.astype(np.int64)
    got = engine._seen_lookup(rows, values, n_rows, torch.device("cpu"))
    want = CSRLookup.from_pairs(rows, values, n_rows)
    assert got.indptr.dtype == np.int64 and got.values.dtype == np.int32
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.values, want.values)
    if case == "duplicates":
        assert want.nnz < n


# -- on the card ----------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["duplicates", "sparse_rows"])
def test_the_seen_lookup_on_the_card_is_from_pairs_array_for_array(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: compares the card's seen lookup with the host's")
    g = np.random.default_rng(9)
    hi = 40 if case == "sparse_rows" else 5000
    rows = g.integers(0, hi, 200_000).astype(np.int32)
    values = g.integers(0, 9 if case == "duplicates" else 8192, 200_000).astype(np.int32)
    got = engine._seen_lookup(rows, values, 5000, torch.device("cuda"))
    want = CSRLookup.from_pairs(rows, values, 5000)
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.values, want.values)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["user_low", "user_high", "item_low", "item_high"])
def test_an_id_out_of_range_raises_on_the_card_s_dense_route(card_choice, bad):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the card's id check before its densify")
    ev = events(10)
    which, end = bad.split("_")
    u, i = (x.copy() for x in ev["view"])
    (u if which == "user" else i)[5] = -1 if end == "low" else (
        N_USERS if which == "user" else N_ITEMS)
    pu, pi = ev["purchase"]
    with pytest.raises(ValueError, match=f"^view: {which} ids outside"):
        cco.cco_train_indicators(pu, pi, [("purchase", pu, pi, N_ITEMS),
                                          ("view", u, i, N_ITEMS)],
                                 N_USERS, N_ITEMS, top_k=TOP_K,
                                 exclude_self_for="purchase", device="cuda")
    # the card is still sound: the same train on good ids runs
    cco.cco_train_indicators(pu, pi, [("view", *ev["view"], N_ITEMS)], N_USERS, N_ITEMS,
                             top_k=TOP_K, device="cuda")
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["popular", "trending", "hot"])
def test_backfill_scores_on_the_card_are_the_host_s(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: compares the card's backfill with the host's")
    from predictionio_tpu_torch.models.universal_recommender import popmodel

    g = np.random.default_rng(11)
    items = g.integers(0, 8192, 2_000_000).astype(np.int32)
    times = 1.7e9 + g.uniform(0.0, 777_600.0, 2_000_000)
    args = (kind, items, times, 8192, 500_000.0)
    np.testing.assert_array_equal(popmodel.backfill_scores(*args, device=torch.device("cuda")),
                                  popmodel.backfill_scores(*args))


@pytest.mark.cuda
def test_the_card_s_dense_counts_are_the_cpu_s(card_choice):
    """Each type staged and checked on the card while the previous type's
    chunk loop is queued there: the counts and marginals are the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: compares the card's dense counts with the CPU's")
    ev = events(12)
    pu, pi = ev["purchase"]
    got = {}
    for dev in ("cpu", "cuda"):
        runner = cco._DenseRunner(pu, pi, N_USERS, N_ITEMS, 256, torch.device(dev))
        got[dev] = [runner.counts(*ev[name], items, what=name) for name, _, items in TYPES[1:]]
    for want, card in zip(got["cpu"], got["cuda"]):
        for a, b in zip(want, card):
            assert torch.equal(a, b.cpu())
