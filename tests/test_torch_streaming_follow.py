"""The port's follow-trainer (``streaming/follow.py``) and its hosts: the
query server's embedded follower (``deploy(follow=)``) and ``pio train
--follow``, on the CPU, mirroring the JAX suite's
tests/test_streaming_follow.py.

Each swap must leave no generation-keyed serving structure of the old
model in use (the rule-mask, value-mask, inverted-CSR and popularity-order
caches), and the response cache must keep exactly the entries the fold's
provenance proves unchanged.  The follow edges: a tombstone or a memory
store delete forces a restage, a lag past the bound restages, the state
budget demotes to retrain ticks, a backend without the delta tail
retrains every tick (and says so), a publish failure is retried next tick
(synchronous) or abandoned and restaged (pipelined), pipelined publishes
keep fold order, and a checkpoint restart folds only the suffix.  Every
generation is held against a from-scratch train where the JAX suite
holds it.
"""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest

from predictionio_tpu_torch.cli import main as cli
from predictionio_tpu_torch.models.common import host_topk_desc
from predictionio_tpu_torch.models.universal_recommender.engine import URQuery
from predictionio_tpu_torch.obs.metrics import get_registry
from predictionio_tpu_torch.serve import response_cache as rc
from predictionio_tpu_torch.storage import memory as port_memory
from predictionio_tpu_torch.storage import set_storage
from predictionio_tpu_torch.streaming import FollowTrainer, FoldUnsupported, URFoldState
from predictionio_tpu_torch.streaming import follow as follow_mod
from predictionio_tpu_torch.workflow import core_workflow
from predictionio_tpu_torch.workflow.create_server import deploy
from predictionio_tpu_torch.workflow.create_workflow import engine_from_variant

from _torch_event_cases import port_memory_storage
from _torch_stream_cases import (  # noqa: F401  (fixtures)
    CPU,
    assert_model_equals_fresh,
    assert_models_equivalent,
    buy,
    canon,
    follow_pair,
    fresh_ref,
    host_serving,
    port_fs,
    seed_events,
    set_item,
    ur_setup,
)


def _wait(cond, timeout=30.0, what="condition"):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


# -- hot-swap invalidation ----------------------------------------------------------
# One test a generation-keyed serving structure: a swapped-in model never
# serves entries derived from the previous generation.


def test_swap_invalidates_rule_mask_cache(port_fs, host_serving, monkeypatch):
    monkeypatch.setenv("PIO_UR_SERVE_CANDIDATES", "off")
    app_id, engine, ap, ep = ur_setup(port_fs)
    port_fs.l_events.insert_batch(seed_events(seed=5), app_id)
    port_fs.l_events.insert_batch([set_item(f"i{k}", {"category": "red"}) for k in range(8)],
                                  app_id)
    state, follower = follow_pair(port_fs, engine, ep)
    red = {"user": "u1", "num": 8,
           "fields": [{"name": "category", "values": ["red"], "bias": -1}]}
    assert state.predict(red).item_scores, "fixture: the red filter matches items"
    old_model = follower._fold.model
    old_cache = old_model.rule_mask_cache("host")
    assert len(old_cache) > 0, "fixture: the mask cache populates"
    port_fs.l_events.insert_batch([set_item(f"i{k}", {"category": "blue"}) for k in range(8)],
                                  app_id)
    assert follower.tick() == "fold"
    new_model = follower._fold.model
    assert new_model is not old_model
    assert new_model.rule_mask_cache("host") is not old_cache
    assert state.predict(red).item_scores == []


def test_swap_invalidates_inverted_csr(port_fs, host_serving):
    """New cooccurrences are servable from the candidate-pruned path right
    after the swap (the postings are the new generation's)."""
    app_id, engine, ap, ep = ur_setup(port_fs, event_names=("purchase",))
    port_fs.l_events.insert_batch(
        [buy(f"u{u}", f"i{it}") for u in range(8) for it in range(4) if (u + it) % 2], app_id)
    state, follower = follow_pair(port_fs, engine, ep)
    state.predict({"user": "u1", "num": 4})
    assert follower._fold.model.__dict__.get("_host_inv")
    port_fs.l_events.insert_batch([buy(f"u{u}", "i9") for u in range(8) if u % 2]
                                  + [buy(f"u{u}", "i1") for u in range(8) if u % 2], app_id)
    assert follower.tick() == "fold"
    port_fs.l_events.insert_batch([buy("prober", "i1")], app_id)
    assert follower.tick() == "fold"
    res = state.predict({"user": "prober", "num": 6})
    assert "i9" in [s.item for s in res.item_scores if s.score > 0], canon(res)


def test_swap_invalidates_pop_order(port_fs, host_serving, monkeypatch):
    monkeypatch.setenv("PIO_UR_SERVE_CANDIDATES", "on")
    app_id, engine, ap, ep = ur_setup(port_fs, event_names=("purchase",))
    port_fs.l_events.insert_batch(
        [buy(f"u{u}", f"i{it}") for u in range(6) for it in (0, 1)]
        + [buy(f"w{k}", "iPOP") for k in range(3)], app_id)
    state, follower = follow_pair(port_fs, engine, ep)
    old_model = follower._fold.model
    old_model.host_pop_order()
    port_fs.l_events.insert_batch([buy(f"pop{k}", "iNEW") for k in range(30)], app_id)
    assert follower.tick() == "fold"
    new_model = follower._fold.model
    assert "_host_pop_order" not in new_model.__dict__ or not np.array_equal(
        new_model.__dict__["_host_pop_order"], old_model.__dict__["_host_pop_order"])
    items = [s.item for s in state.predict({"user": "u1", "num": 10}).item_scores]
    assert "iNEW" in items and items.index("iNEW") < items.index("iPOP"), items


def test_swap_invalidates_value_mask_cache(port_fs, host_serving):
    """A $set fold rebuilds the property indexes; a props-untouched fold
    carries them (provably identical); answers track the live model."""
    app_id, engine, ap, ep = ur_setup(port_fs, event_names=("purchase",))
    port_fs.l_events.insert_batch(seed_events(seed=6, n_items=6), app_id)
    port_fs.l_events.insert_batch([set_item("i0", {"tier": "gold"})], app_id)
    state, follower = follow_pair(port_fs, engine, ep)
    gold = {"user": "u2", "num": 6,
            "fields": [{"name": "tier", "values": ["gold"], "bias": -1}]}
    before = {s.item for s in state.predict(gold).item_scores}
    assert before <= {"i0"} and before, before
    m1 = follower._fold.model
    m1.host_value_mask("tier", "gold")
    m1.prop_value_index("tier")
    port_fs.l_events.insert_batch([buy("u0", "i1")], app_id)
    assert follower.tick() == "fold"
    m2 = follower._fold.model
    assert m2.item_properties is m1.item_properties
    assert m2.__dict__.get("_prop_value_index") is m1.__dict__.get("_prop_value_index")
    port_fs.l_events.insert_batch([set_item("i0", {"tier": "silver"}),
                                   set_item("i3", {"tier": "gold"})], app_id)
    assert follower.tick() == "fold"
    m3 = follower._fold.model
    assert m3.item_properties is not m1.item_properties
    assert "_prop_value_index" not in m3.__dict__
    assert {s.item for s in state.predict(gold).item_scores} <= {"i3"}


def test_patched_inverted_equals_rebuilt(port_fs, host_serving):
    app_id, engine, ap, ep = ur_setup(port_fs, event_names=("purchase",))
    port_fs.l_events.insert_batch(seed_events(seed=7, n_users=14), app_id)
    state, follower = follow_pair(port_fs, engine, ep)
    follower._fold.model.host_inverted("purchase")
    port_fs.l_events.insert_batch([buy("u0", "i7")], app_id)
    assert follower.tick() == "fold"
    m2 = follower._fold.model
    patched = m2.__dict__["_host_inv"]["purchase"]
    m2.__dict__.pop("_host_inv")
    for a, b in zip(patched, m2.host_inverted("purchase")):
        assert np.array_equal(a, b)


def test_incremental_emit_identity(port_fs, host_serving):
    """An N-bump fold regathers the inverted weights through the cached
    permutation and merges the pop order (array-identical to rebuilds); a
    duplicate-only fold carries user_seen and props by object."""
    app_id, engine, ap, ep = ur_setup(port_fs, event_names=("purchase",))
    port_fs.l_events.insert_batch(
        [buy(f"u{k % 40}", f"i{k}") for k in range(400)]
        + [buy(f"u{u}", f"i{it}") for u in range(8) for it in range(6) if (u + it) % 3],
        app_id)
    state, follower = follow_pair(port_fs, engine, ep)
    m1 = follower._fold.model
    m1.host_inverted("purchase")
    m1.host_pop_order()
    port_fs.l_events.insert_batch([buy("nb_user", "i5")], app_id)
    assert follower.tick() == "fold"
    m2 = follower._fold.model
    carried = m2.__dict__["_host_inv"]["purchase"]
    merged_order = m2.__dict__["_host_pop_order"]
    m2.__dict__.pop("_host_inv")
    for a, b in zip(carried, m2.host_inverted("purchase")):
        assert np.array_equal(a, b)
    assert np.array_equal(merged_order, host_topk_desc(
        np.asarray(m2.popularity, np.float32), len(m2.item_dict))[1])
    port_fs.l_events.insert_batch([buy("u1", "i300")], app_id)
    assert follower.tick() == "fold"
    m3 = follower._fold.model
    assert m3.user_seen is not m2.user_seen
    port_fs.l_events.insert_batch([buy("u1", "i300")], app_id)
    assert follower.tick() == "fold"
    m4 = follower._fold.model
    assert m4.user_seen is m3.user_seen and m4.item_properties is m3.item_properties


def test_response_cache_keeps_unaffected_entries_across_a_fold_swap(port_fs, host_serving,
                                                                    monkeypatch):
    """The fold's provenance (``_plane_prov``) lets the response cache keep
    the entries it proves unchanged; every answer after the swap equals
    the uncached answer on the new generation."""
    monkeypatch.setenv("PIO_FOLLOW_DENSE_RELLR_BYTES", "0")
    app_id, engine, ap, ep = ur_setup(port_fs, event_names=("purchase",))
    rng = np.random.default_rng(12)
    port_fs.l_events.insert_batch(
        [buy(f"u{u}", f"i{int(i)}") for u in range(40) for i in rng.integers(0, 60, 6)], app_id)
    state, follower = follow_pair(port_fs, engine, ep)
    bodies = [{"user": f"u{u}", "num": 3} for u in range(40)]
    for b in bodies:
        state.predict(b)
    cache = rc.get_cache()
    n_before = len(cache)
    assert n_before > 0
    port_fs.l_events.insert_batch([buy("u0", "i59")], app_id)
    assert follower.tick() == "fold"
    assert cache.last_swap_reason != "no_provenance"
    assert 0 < len(cache) < n_before + 1
    answers = [canon(state.predict(b)) for b in bodies]
    monkeypatch.setenv("PIO_SERVE_CACHE", "off")
    assert answers == [canon(state.predict(b)) for b in bodies]


# -- follow edges -------------------------------------------------------------------


def test_tombstone_mid_follow_forces_restage(port_fs, host_serving):
    app_id, engine, ap, ep = ur_setup(port_fs, event_names=("purchase",))
    port_fs.l_events.insert_batch(seed_events(seed=8), app_id)
    dead_id = port_fs.l_events.insert(buy("deadguy", "i0"), app_id)
    state, follower = follow_pair(port_fs, engine, ep)
    assert follower.tick() == "idle"
    assert port_fs.l_events.delete(dead_id, app_id)
    # a snapshot gives the restage and the reference train one staging
    # source (segment order), so the comparison can be array-exact
    port_fs.l_events.build_snapshot(app_id)
    assert follower.tick() == "restage"
    model = follower._fold.model
    assert model.user_dict.id("deadguy") is None
    assert_model_equals_fresh(model, engine, ep, [URQuery(user=f"u{u}", num=6)
                                                  for u in range(0, 12, 3)])


def test_memory_store_delete_forces_restage(host_serving):
    """On the memory store a delete bumps the bucket's generation, so the
    follower's watermark no longer matches and the next tick restages."""
    store = port_memory_storage()
    set_storage(store)
    try:
        app_id, engine, ap, ep = ur_setup(store, event_names=("purchase",),
                                          max_correlators_per_item=10)
        store.l_events.insert_batch(seed_events(seed=18), app_id)
        dead_id = store.l_events.insert(buy("deadguy", "i2"), app_id)
        state, follower = follow_pair(store, engine, ep)
        store.l_events.insert_batch([buy("u3", "i_mem")], app_id)
        assert follower.tick() == "fold"
        assert store.l_events.delete(dead_id, app_id)
        assert follower.tick() == "restage"
        model = follower._fold.model
        assert model.user_dict.id("deadguy") is None
        # the memory store's training read sorts by event time, its tail
        # keeps insertion order: the item ids may differ in order only
        assert_models_equivalent(model, fresh_ref(engine, ep))
    finally:
        set_storage(None)


def test_max_lag_breach_restages(port_fs, host_serving):
    app_id, engine, ap, ep = ur_setup(port_fs, event_names=("purchase",))
    port_fs.l_events.insert_batch(seed_events(seed=9), app_id)
    state, follower = follow_pair(port_fs, engine, ep)
    follower.max_lag = 2
    port_fs.l_events.insert_batch([buy(f"u{k}", "i1") for k in range(20, 26)], app_id)
    assert follower.tick() == "restage"
    assert_model_equals_fresh(follower._fold.model, engine, ep,
                              [URQuery(user="u21", num=5), URQuery(user="u1", num=5)])


def test_state_budget_falls_back_to_retrain(port_fs, host_serving, monkeypatch):
    """A PIO_FOLLOW_STATE_BYTES breach demotes to retrain ticks, which keep
    publishing, and status reports the mode."""
    monkeypatch.setenv("PIO_FOLLOW_STATE_BYTES", "1")
    app_id, engine, ap, ep = ur_setup(port_fs, event_names=("purchase",))
    port_fs.l_events.insert_batch(seed_events(seed=10), app_id)
    core_workflow.run_train(engine, ep, engine_id="swap-eng", storage=port_fs, device=CPU)
    from predictionio_tpu_torch.workflow.create_server import QueryServerState

    state = QueryServerState(engine, ep, URQuery, "swap-eng", storage=port_fs, device=CPU)
    follower = state.follower = FollowTrainer(engine, ep, "swap-eng", storage=port_fs,
                                              interval=3600, on_publish=state.swap_models,
                                              persist=False, device=CPU)
    assert follower.mode == "fold"
    assert follower.bootstrap()
    assert follower.mode == "retrain"
    gen = state.generation
    port_fs.l_events.insert_batch([buy("late", "i1")], app_id)
    assert follower.tick() == "retrain"
    assert state.generation == gen + 1
    assert state.freshness()["follower"]["stateMode"] == "retrain"
    assert state.freshness()["stateMode"] == "retrain"


def test_backend_without_delta_tail_retrains_every_tick(host_serving, caplog):
    """An event backend lacking the delta-tail protocol cannot fold: the
    follower says so once and retrains each tick with new events."""
    from predictionio_tpu_torch.storage.base import delta_tail_supported, require_delta_tail
    from predictionio_tpu_torch.storage.base import StoreCapabilityError

    class NoTail(port_memory.MemEvents):
        scan_tail_from = None
        scan_events_up_to = None

    store = port_memory_storage()
    store._client("EVENTDATA").events = NoTail()
    assert not delta_tail_supported(store.l_events)
    with pytest.raises(StoreCapabilityError, match="NoTail"):
        require_delta_tail(store.l_events, "fold mode")
    set_storage(store)
    try:
        app_id, engine, ap, ep = ur_setup(store, event_names=("purchase",))
        store.l_events.insert_batch(seed_events(seed=19), app_id)
        published = []
        with caplog.at_level("WARNING", logger="pio.follow"):
            follower = FollowTrainer(engine, ep, "nt-eng", storage=store, interval=3600,
                                     on_publish=lambda m, info: published.append(info),
                                     persist=False, device=CPU)
        assert follower.mode == "retrain"
        assert "delta-tail" in caplog.text
        assert follower.bootstrap()
        assert follower.tick() == "idle"
        store.l_events.insert_batch([buy("u1", "i_nt")], app_id)
        assert follower.tick() == "retrain"
        assert [p["mode"] for p in published] == ["retrain", "retrain"]
        assert follower.status()["mode"] == "retrain"
        assert follow_mod._M_STATE_MODE.value(mode="retrain") == 1
    finally:
        set_storage(None)


def test_follow_kill_switch_and_metrics(port_fs, host_serving, monkeypatch):
    app_id, engine, ap, ep = ur_setup(port_fs, event_names=("purchase",))
    port_fs.l_events.insert_batch(seed_events(seed=11), app_id)
    state, follower = follow_pair(port_fs, engine, ep)
    reg = get_registry()
    monkeypatch.setenv("PIO_FOLLOW", "off")
    assert follower.tick() == "disabled"
    monkeypatch.delenv("PIO_FOLLOW")
    before = reg.counter("pio_follow_folds_total", "x").value(outcome="fold")
    port_fs.l_events.insert_batch([buy("kk", "i2")], app_id)
    assert follower.tick() == "fold"
    assert reg.counter("pio_follow_folds_total", "x").value(outcome="fold") == before + 1
    assert reg.gauge("pio_model_generation", "x").value() >= 2
    assert reg.gauge("pio_follow_state_bytes", "x").value() == follower._fold.state_bytes()
    fresh = state.freshness()
    assert fresh["generation"] == state.generation
    assert fresh["follower"]["lastOutcome"] == "fold"
    assert fresh["stateMode"] == "sparse" and fresh["stateBytes"] > 0


def test_transient_publish_failure_retries_next_tick(port_fs, host_serving):
    app_id, engine, ap, ep = ur_setup(port_fs, event_names=("purchase",))
    port_fs.l_events.insert_batch(seed_events(seed=13) + [buy("pu", "i0")], app_id)
    state, follower = follow_pair(port_fs, engine, ep)
    gen0, fgen0 = state.generation, follower.generation
    port_fs.l_events.insert_batch([buy(f"c{j}", t) for j in range(5) for t in ("i0", "i9")],
                                  app_id)
    real = follower.on_publish
    calls = {"n": 0}

    def flaky(models, info):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError("transient swap error")
        return real(models, info)

    follower.on_publish = flaky
    with pytest.raises(OSError):
        follower.tick()
    assert follower.last_outcome == "error" and follower._pending is not None
    assert follower.generation == fgen0
    assert follower.tick() == "fold"
    assert follower._pending is None and follower.generation == fgen0 + 1
    assert state.generation > gen0
    assert "i9" in [s.item for s in state.predict({"user": "pu", "num": 8}).item_scores]


def test_fold_exception_drops_state_and_restages(port_fs, host_serving, monkeypatch):
    app_id, engine, ap, ep = ur_setup(port_fs, event_names=("purchase",))
    port_fs.l_events.insert_batch(seed_events(seed=17), app_id)
    state, follower = follow_pair(port_fs, engine, ep)
    gen0 = state.generation
    port_fs.l_events.insert_batch([buy("zz", "i1")], app_id)
    orig = URFoldState.fold

    def boom(self, batch):
        raise MemoryError("transient mid-apply failure")

    monkeypatch.setattr(URFoldState, "fold", boom)
    with pytest.raises(MemoryError):
        follower.tick()
    assert follower._fold is None
    monkeypatch.setattr(URFoldState, "fold", orig)
    assert follower.tick() == "restage"
    assert state.generation > gen0
    assert state.predict({"user": "zz", "num": 8}).item_scores


def test_pipelined_publish_ordering_and_drain(port_fs, host_serving):
    """With the publisher thread, ticks enqueue emit + publish: generations
    publish in fold order, coveredEvents reports what the published model
    covers, and the served model ends equal to a train."""
    app_id, engine, ap, ep = ur_setup(port_fs, event_names=("purchase",))
    port_fs.l_events.insert_batch(seed_events(seed=61), app_id)
    state, follower = follow_pair(port_fs, engine, ep)
    n_events = len(follower._fold.batch)
    follower._start_publisher()
    try:
        gens = []
        real = follower.on_publish

        def record(models, info):
            gens.append(info["generation"])
            return real(models, info)

        follower.on_publish = record
        for k in range(4):
            port_fs.l_events.insert_batch([buy(f"pipe{k}", "i1")], app_id)
            n_events += 1
            assert follower.tick() == "fold"
        assert follower._flush_publishes(timeout=30)
        assert gens == sorted(gens) and len(gens) == 4
        assert follower.status()["coveredEvents"] == n_events
        assert_model_equals_fresh(follower._fold.model, engine, ep,
                                  [URQuery(user="pipe3", num=5), URQuery(user="u1", num=5)])
        assert state.predict({"user": "pipe3", "num": 6}).item_scores
    finally:
        follower.stop(timeout=10)


def test_pipelined_publish_failure_restages(port_fs, host_serving):
    app_id, engine, ap, ep = ur_setup(port_fs, event_names=("purchase",))
    port_fs.l_events.insert_batch(seed_events(seed=67), app_id)
    state, follower = follow_pair(port_fs, engine, ep)
    follower.interval = 0.01
    follower._start_publisher()
    try:
        real = follower.on_publish

        def fail(models, info):
            raise OSError("permanent swap failure")

        follower.on_publish = fail
        port_fs.l_events.insert_batch([buy("px", "i1")], app_id)
        assert follower.tick() == "fold"
        _wait(lambda: follower._pub_failed, what="the publisher to give up")
        follower.on_publish = real
        assert follower.tick() == "restage"
        assert state.predict({"user": "px", "num": 6}).item_scores is not None
    finally:
        follower.stop(timeout=10)


# -- the fold-state checkpoint ------------------------------------------------------


def _persisted(store, engine, ep, engine_id="ckpt-eng"):
    return FollowTrainer(engine, ep, engine_id, storage=store, interval=3600, persist=True,
                         device=CPU)


def test_checkpoint_restart_skips_covered_prefix(port_fs, host_serving, monkeypatch):
    """A restart restores the checkpoint and folds ONLY the unapplied
    suffix (the covered-prefix reparse is never reached), equal to a
    train; each generation is a COMPLETED instance."""
    app_id, engine, ap, ep = ur_setup(port_fs, event_names=("purchase",))
    port_fs.l_events.insert_batch(seed_events(seed=51), app_id)
    t1 = _persisted(port_fs, engine, ep)
    assert t1.mode == "fold" and t1.bootstrap()
    covered = len(t1._fold.batch)
    npz_path, batch_path = t1._ckpt_paths()
    assert npz_path.exists() and batch_path.exists()
    suffix = [buy(f"v{k}", "i1") for k in range(4)] + [buy("v0", "i2")]
    port_fs.l_events.insert_batch(suffix, app_id)

    def boom(self, prior):
        raise AssertionError("the covered-prefix reparse ran despite a valid checkpoint")

    monkeypatch.setattr(FollowTrainer, "_bootstrap_from_watermark", boom)
    t2 = _persisted(port_fs, engine, ep)
    assert t2.bootstrap()
    assert t2.bootstrap_events == covered and t2.last_fold_events == len(suffix)
    assert t2.last_outcome == "fold"
    assert_model_equals_fresh(t2._fold.model, engine, ep,
                              [URQuery(user="u1", num=5), URQuery(user="v0", num=5)])
    done = [i for i in port_fs.engine_instances.get_all() if i.status == "COMPLETED"]
    assert len(done) == 2 and t2.instance_id in {i.id for i in done}


def test_checkpoint_env_override_wins(port_fs, host_serving, monkeypatch):
    app_id, engine, ap, ep = ur_setup(port_fs, event_names=("purchase",))
    port_fs.l_events.insert_batch(seed_events(seed=53), app_id)
    t1 = _persisted(port_fs, engine, ep)
    assert t1.bootstrap() and t1._fold.state_mode == "sparse"
    monkeypatch.setenv("PIO_FOLLOW_STATE", "dense")
    t2 = _persisted(port_fs, engine, ep)
    assert t2._load_checkpoint() is None
    assert t2.bootstrap() and t2._fold.state_mode == "dense"


def test_checkpoint_invalid_falls_back(port_fs, host_serving):
    """A tombstone while down, and a truncated npz, both fall back to the
    non-checkpoint restart paths."""
    app_id, engine, ap, ep = ur_setup(port_fs, event_names=("purchase",))
    port_fs.l_events.insert_batch(seed_events(seed=52), app_id)
    dead = port_fs.l_events.insert(buy("deadguy", "i0"), app_id)
    t1 = _persisted(port_fs, engine, ep)
    assert t1.bootstrap()
    assert port_fs.l_events.delete(dead, app_id)
    t2 = _persisted(port_fs, engine, ep)
    assert t2._bootstrap_from_checkpoint(t2._load_state()) is False
    npz_path, _ = t1._ckpt_paths()
    npz_path.write_bytes(npz_path.read_bytes()[:64])
    t3 = _persisted(port_fs, engine, ep)
    assert t3._load_checkpoint() is None
    assert t3.bootstrap() and t3._fold is not None
    assert t3._fold.model.user_dict.id("deadguy") is None


# -- the hosts: deploy(follow=) and pio train --follow ------------------------------


def _variant(app, engine_id):
    return {"id": engine_id, "engineFactory": "universal_recommender",
            "datasource": {"params": {"appName": app, "eventNames": ["purchase"]}},
            "algorithms": [{"name": "ur", "params": {"appName": app,
                                                     "maxCorrelatorsPerItem": 6}}]}


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/queries.json",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as resp:
        return json.loads(resp.read())


def test_deploy_follow_reflects_appends_over_http(port_fs, host_serving, tmp_path):
    """``deploy(follow=)`` hosts the follower: the freshness protocol of
    the reference's bench (a probe user's seed item, then co-buyers of a
    brand-new item) reflects the new item over /queries.json, the stats
    report the follower, and after the drain the answers equal a train."""
    app_id, engine, ap, ep = ur_setup(port_fs, app_name="fapp", event_names=("purchase",))
    port_fs.l_events.insert_batch(seed_events(seed=71), app_id)
    path = tmp_path / "engine.json"
    path.write_text(json.dumps(_variant("fapp", "follow-eng")))
    _, eng, params = engine_from_variant(_variant("fapp", "follow-eng"))
    core_workflow.run_train(eng, params, engine_id="follow-eng", storage=port_fs, device=CPU)
    server = deploy(str(path), host="127.0.0.1", port=0, storage=port_fs, device=CPU,
                    follow=0.05)
    port = server.server_address[1]
    try:
        follower = server.state.follower
        assert follower is not None and follower.mode == "fold"
        n_events = len(seed_events(seed=71))

        def covered(n):
            fr = _get(port, "/stats.json")["freshness"].get("follower") or {}
            return fr.get("lastOutcome") == "idle" and (fr.get("coveredEvents") or 0) >= n

        _wait(lambda: covered(n_events), what="the bootstrap")
        for r in range(2):
            port_fs.l_events.insert_batch([buy(f"probe{r}", "i3")], app_id)
            n_events += 1
            _wait(lambda: covered(n_events), what="the probe's fold")
            cobuyers = [f"cob{r}_{j}" for j in range(6)]
            port_fs.l_events.insert_batch([buy(c, "i3") for c in cobuyers]
                                          + [buy(c, f"fresh{r}") for c in cobuyers], app_id)
            n_events += 12
            _wait(lambda: any(s["item"] == f"fresh{r}" for s in _post(
                port, {"user": f"probe{r}", "num": 30})["itemScores"]),
                what=f"fresh{r} reflected")
        _wait(lambda: covered(n_events), what="the drain")
        fr = _get(port, "/stats.json")["freshness"]
        assert fr["follower"]["mode"] == "fold" and fr["stateMode"] == "sparse"
        got = [_post(port, {"user": u, "num": 10}) for u in ("u1", "probe1", "cob1_0")]
    finally:
        server.shutdown()
        server.server_close()
    assert not follower._thread.is_alive()
    ref = engine.train(ep, device=CPU)[0]
    algo = engine.make_components(ep, device=CPU)[2][0]
    for body, doc in zip(({"user": "u1", "num": 10}, {"user": "probe1", "num": 10},
                          {"user": "cob1_0", "num": 10}), got):
        assert doc == algo.predict(ref, URQuery.from_json(body)).to_json()


def test_pio_train_follow_publishes_generations(port_fs, host_serving, tmp_path,
                                                monkeypatch):
    """``pio train --follow`` bootstraps a COMPLETED instance, then
    publishes one per folded delta, equal to a train; SIGINT's path
    (stop) ends it with exit 0."""
    app_id, engine, ap, ep = ur_setup(port_fs, app_name="tfapp", event_names=("purchase",))
    port_fs.l_events.insert_batch(seed_events(seed=73), app_id)
    (tmp_path / "engine.json").write_text(json.dumps(_variant("tfapp", "tf-eng")))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PIO_TORCH_DEVICE", CPU)
    trainers = []
    real = FollowTrainer.run_forever

    def run_forever(self):
        trainers.append(self)
        real(self)

    monkeypatch.setattr(FollowTrainer, "run_forever", run_forever)
    rc_box = {}
    t = threading.Thread(target=lambda: rc_box.setdefault(
        "rc", cli.main(["train", "--follow", "--follow-interval", "0.05"])), daemon=True)
    t.start()

    def completed():
        return [i for i in port_fs.engine_instances.get_all()
                if i.engine_id == "tf-eng" and i.status == "COMPLETED"]

    try:
        _wait(lambda: len(completed()) >= 1, what="the bootstrap instance")
        assert trainers and trainers[0].mode == "fold" and trainers[0].persist
        port_fs.l_events.insert_batch([buy("late", "i2"), buy("late", "brand_new")], app_id)
        _wait(lambda: len(completed()) >= 2, what="the folded generation")
        _wait(lambda: trainers[0].last_outcome == "idle", what="the drain")
    finally:
        if trainers:
            trainers[0].stop()
        t.join(timeout=30)
    assert not t.is_alive() and rc_box["rc"] == 0
    _, models = core_workflow.load_latest_models("tf-eng", storage=port_fs, device=CPU)
    assert_model_equals_fresh(models[0], engine, ep, [URQuery(user="late", num=5)])


def test_follower_needs_an_app_name():
    """A data source without an app_name has nothing to tail."""
    from predictionio_tpu_torch.controller import EngineParams
    from predictionio_tpu_torch.models.universal_recommender import UniversalRecommenderEngine

    engine = UniversalRecommenderEngine.apply()
    ep = EngineParams(data_source_params=object(), algorithm_params_list=[])
    with pytest.raises(FoldUnsupported, match="app_name"):
        FollowTrainer(engine, ep, "x", storage=port_memory_storage(), device=CPU)
