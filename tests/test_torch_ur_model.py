"""The port's Universal Recommender training, model state, history store
and popularity backfill against the JAX package.

The corpus is the two-cluster one of tests/_torch_ur_cases.py.  Indicator
scores agree within rtol/atol 1e-4 (f32 log1p differs across frameworks),
ids up to ties; popularity and the seen-item CSR exactly; event reads and
backfill scores exactly.  Serving is in
tests/test_torch_universal_recommender.py.
"""

import numpy as np
import pytest
import torch

from predictionio_tpu.models.universal_recommender import engine as jax_ur
from predictionio_tpu.models.universal_recommender import popmodel as jax_pop
from predictionio_tpu.store.event_store import LEventStore as JaxLEventStore
from predictionio_tpu_torch.models import universal_recommender as ur
from predictionio_tpu_torch.models.universal_recommender import popmodel as port_pop
from predictionio_tpu_torch.ops import hopper_kernels as hk
from predictionio_tpu_torch.storage import set_storage as port_set_storage
from predictionio_tpu_torch.store.event_store import LEventStore

from _torch_ur_cases import (APP, ATOL, NAMES, RTOL, T0, TRAIN_CONFIGS, arrays, close,
                             fill_stores, jax_td, params, port_td, train_jax_model)


def _exact_llr(name, thr):
    """Exact LLR matrix of one event type (numpy counts, the port's plain
    K2), the self-indicator's diagonal masked."""
    users, inter = arrays()
    pu, pi, p_items, _ = inter["purchase"]
    au, ai, a_items, _ = inter[name]
    P = np.zeros((len(users), len(p_items)), np.int64)
    P[pu, pi] = 1
    A = np.zeros((len(users), len(a_items)), np.int64)
    A[au, ai] = 1
    s = hk.llr_masked_scores_plain(
        torch.from_numpy((P.T @ A).astype(np.int32)),
        torch.from_numpy(P.sum(0).astype(np.int32)),
        torch.from_numpy(A.sum(0).astype(np.int32)), float(len(users)), thr).numpy()
    if name == "purchase":
        np.fill_diagonal(s, -np.inf)
    return s


def _assert_indicators(gs, gi, ws, wi, full):
    """Scores within 1e-4, -inf exact; ids equal up to ties (a run cut by
    the top-k boundary may hold any ids the exact matrix scores in it)."""
    fin = np.isfinite(ws)
    np.testing.assert_array_equal(np.isfinite(gs), fin)
    np.testing.assert_array_equal(gi >= 0, fin)
    np.testing.assert_allclose(gs[fin], ws[fin], rtol=RTOL, atol=ATOL)
    for r in range(ws.shape[0]):
        n, j = int(fin[r].sum()), 0
        while j < n:
            e = j + 1
            while e < n and close(ws[r, e], ws[r, e - 1]):
                e += 1
            if e == n and n == ws.shape[1]:
                for ids in (gi[r, j:e], wi[r, j:e]):
                    assert all(close(full[r, i], ws[r, j]) for i in ids)
            else:
                assert set(gi[r, j:e]) == set(wi[r, j:e]), (r, gi[r], wi[r])
            j = e


@pytest.mark.parametrize("config", sorted(TRAIN_CONFIGS))
def test_train_matches_jax(config):
    want = jax_ur.URAlgorithm(params(jax_ur, config)).train(jax_td())
    got = ur.URAlgorithm(params(ur, config), device="cpu").train(port_td())
    assert got.primary_event == want.primary_event == "purchase"
    assert got.item_dict.to_state() == want.item_dict.to_state()
    assert got.user_dict.to_state() == want.user_dict.to_state()
    assert list(got.indicator_idx) == list(want.indicator_idx) == NAMES
    per_type = jax_ur.URAlgorithm.per_type_tuning(params(jax_ur, config), NAMES)
    for name in NAMES:
        assert (got.event_item_dicts[name].to_state()
                == want.event_item_dicts[name].to_state())
        thr = per_type.get(name, (None, TRAIN_CONFIGS[config]["min_llr"]))[1]
        ws, wi = want.indicator_llr[name], want.indicator_idx[name]
        gs, gi = got.indicator_llr[name], got.indicator_idx[name]
        # the model stores -inf padding as LLR 0 with id -1
        _assert_indicators(np.where(gi >= 0, gs, -np.inf), gi,
                           np.where(wi >= 0, ws, -np.inf), wi, _exact_llr(name, thr))
    np.testing.assert_array_equal(got.popularity, want.popularity)
    assert got.popularity.dtype == want.popularity.dtype
    np.testing.assert_array_equal(got.user_seen.indptr, want.user_seen.indptr)
    np.testing.assert_array_equal(got.user_seen.values, want.user_seen.values)
    assert sorted(got.user_seen_by_event) == sorted(want.user_seen_by_event)
    for name, csr in want.user_seen_by_event.items():
        np.testing.assert_array_equal(got.user_seen_by_event[name].values, csr.values)
    assert got.__getstate__().keys() == want.__getstate__().keys()


def test_train_builds_on_the_named_device_and_raises_without_a_card(monkeypatch):
    algo = ur.URAlgorithm(params(ur, "reference_ep"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        algo.train(port_td())
    # a dp above the ranks (one here) raises MeshSpec.resolve's error, as JAX
    with pytest.raises(ValueError, match=r"mesh 2x1 != 1 devices"):
        ur.URAlgorithm(params(ur, "reference_ep", mesh_dp=2), device="cpu").train(
            port_td())


def test_model_state_round_trips_through_the_port():
    state = train_jax_model().__getstate__()
    port_model = ur.ur_model_from_state(state, device="cpu")
    back = port_model.__getstate__()
    assert back.keys() == state.keys()
    for name in state["indicator_idx"]:
        np.testing.assert_array_equal(back["indicator_idx"][name], state["indicator_idx"][name])
        np.testing.assert_array_equal(back["indicator_llr"][name], state["indicator_llr"][name])
    assert back["items"] == state["items"] and back["event_items"] == state["event_items"]


# -- the history store and the popularity backfill ---------------------------------


@pytest.fixture()
def stores(fs_storage, monkeypatch):
    """Both packages' event stores hold the corpus' events (the JAX
    package's in its LocalFS event log, read without its history cache)."""
    monkeypatch.setenv("PIO_HISTORY_CACHE", "off")
    fill_stores(fs_storage)
    yield
    port_set_storage(None)


@pytest.mark.parametrize("user,event,limit", [("u1", "view", 3), ("u16", "purchase", None),
                                              ("u29", "view", 1)])
def test_find_by_entity_matches_jax(stores, user, event, limit):
    want = JaxLEventStore.find_by_entity(APP, "user", user, event_names=[event], limit=limit)
    got = LEventStore.find_by_entity(APP, "user", user, event_names=[event], limit=limit)
    assert [e.target_entity_id for e in got] == [e.target_entity_id for e in want]
    assert [e.event_time for e in got] == [e.event_time for e in want]
    with pytest.raises(ValueError):
        LEventStore.find_by_entity("no-such-app", "user", user)


@pytest.mark.parametrize("text", ["90 days", "12 hours", "3600", "2 w", "1.5h", " 7 d "])
def test_parse_duration_matches_jax(text):
    assert port_pop.parse_duration(text) == jax_pop.parse_duration(text)


@pytest.mark.parametrize("kind", ["popular", "trending", "hot", "none"])
def test_backfill_scores_match_jax(kind):
    rng = np.random.default_rng(3)
    items = rng.integers(0, 40, 3000).astype(np.int32)
    times = np.sort(rng.uniform(T0, T0 + 86400 * 30, 3000))
    args = (kind, items, times, 40, 86400 * 20.0)
    np.testing.assert_array_equal(port_pop.backfill_scores(*args),
                                  jax_pop.backfill_scores(*args))


@pytest.mark.parametrize("config", ["reference_ep", "per_type_blacklist_trending"])
def test_checkpointed_train_resumes_past_finished_types(tmp_path, monkeypatch, config):
    """``checkpoint: true`` snapshots each event type's indicators: a train
    failed by ``PIO_FAULT_INJECT=ur.indicators:2`` leaves the first type's
    snapshot, the retry trains only the second type, the run's directory
    is gone at the end, and the model is bit-identical to a straight
    train.  A run the JAX package faulted resumes in the port (the same
    run key and layout): the first type's tables are JAX's bit for bit."""
    from predictionio_tpu_torch.ops import cco as port_cco
    from predictionio_tpu_torch.utils.checkpoint import InjectedFault

    straight = ur.URAlgorithm(params(ur, config), device="cpu").train(port_td())
    trained = []
    real = port_cco.cco_train_indicators

    def spy(p_user, p_item, others, *a, **kw):
        trained.append([o[0] for o in others])
        return real(p_user, p_item, others, *a, **kw)

    monkeypatch.setattr(port_cco, "cco_train_indicators", spy)
    for writer in ("port", "jax"):
        ck_dir = tmp_path / writer
        monkeypatch.setenv("PIO_FAULT_INJECT", "ur.indicators:2")
        if writer == "port":
            algo = ur.URAlgorithm(params(ur, config, checkpoint=True,
                                         checkpoint_dir=str(ck_dir)), device="cpu")
            with pytest.raises(InjectedFault):
                algo.train(port_td())
            assert trained == [["purchase"]]
        else:
            from predictionio_tpu.utils.checkpoint import InjectedFault as JaxFault

            jalgo = jax_ur.URAlgorithm(params(jax_ur, config, checkpoint=True,
                                              checkpoint_dir=str(ck_dir)))
            with pytest.raises(JaxFault):
                jalgo.train(jax_td())
        (run_dir,) = list(ck_dir.iterdir())
        assert sorted(p.name for p in run_dir.glob("step_*.npz")) == ["step_0.npz"]
        snap = np.load(run_dir / "step_0.npz")
        trained.clear()
        resumed = ur.URAlgorithm(params(ur, config, checkpoint=True,
                                        checkpoint_dir=str(ck_dir)), device="cpu"
                                 ).train(port_td())
        assert trained == [["view"]]
        assert not any(ck_dir.iterdir())
        # the resumed type is the writer's snapshot, the trained one the
        # port's straight train; with the port as writer both are straight
        for name in NAMES:
            if name == "purchase":
                want_i = snap["idx"].astype(np.int32)
                want_s = np.where(np.isfinite(snap["scores"]), snap["scores"],
                                  0.0).astype(np.float32)
            else:
                want_i, want_s = straight.indicator_idx[name], straight.indicator_llr[name]
            np.testing.assert_array_equal(resumed.indicator_idx[name], want_i)
            np.testing.assert_array_equal(resumed.indicator_llr[name].view(np.int32),
                                          want_s.view(np.int32))
        if writer == "port":
            for name in NAMES:
                np.testing.assert_array_equal(resumed.indicator_idx[name],
                                              straight.indicator_idx[name])
                np.testing.assert_array_equal(
                    resumed.indicator_llr[name].view(np.int32),
                    straight.indicator_llr[name].view(np.int32))
        np.testing.assert_array_equal(resumed.popularity, straight.popularity)
        trained.clear()
