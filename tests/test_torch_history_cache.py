"""The port's user-history cache (``serve/history_cache.py``) and the
storage append-listener bus it listens on, against the JAX package's.

An append through the memory or the localfs store bumps only the entity
appended for (its next read is ``stale`` and re-reads; other entities
stay ``hit``); an event delete, a channel removal and a new default store
flush everything; ``PIO_HISTORY_CACHE=off`` bypasses.  The cached targets
equal the JAX cache's on the same events, and the UR's answers after
appends equal the ``PIO_HISTORY_CACHE=off`` oracle (and the JAX answer).
"""

import numpy as np
import pytest

from predictionio_tpu.serve import history_cache as jax_hc
from predictionio_tpu_torch.events.event import Event
from predictionio_tpu_torch.serve import history_cache as hc
from predictionio_tpu_torch.storage import App, Storage, StorageConfig, base
from predictionio_tpu_torch.storage import set_storage as port_set_storage

from _torch_serve_cases import APP, Served, canon, env, fresh_caches, jax_oracles  # noqa: F401


def _outcomes():
    return {k: hc._M_LOOKUP.value(outcome=k) for k in ("hit", "miss", "stale", "bypass")}


def _delta(before):
    after = _outcomes()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _buy(user, item, t=None):
    return Event("purchase", "user", user, target_entity_type="item",
                 target_entity_id=item, event_time=t)


@pytest.fixture(params=["memory", "localfs"])
def store(request, tmp_path, fresh_caches):  # noqa: F811
    if request.param == "memory":
        st = Storage(StorageConfig.memory())
    else:
        st = Storage(StorageConfig(
            sources={"FS": {"type": "localfs", "path": str(tmp_path / "store")}},
            repositories={"METADATA": "FS", "EVENTDATA": "FS", "MODELDATA": "FS"}))
    port_set_storage(st)
    app_id = st.apps.insert(App(0, APP))
    st.l_events.insert_batch([_buy(f"u{u}", f"i{u + k}", 1_780_000_000.0 + 10 * u + k)
                              for u in range(4) for k in range(3)], app_id)
    yield st, app_id
    port_set_storage(None)


def _read(user):
    return hc.user_history_targets(APP, "user", user, "purchase", 10)


def test_append_bumps_only_that_entity(store):
    st, app_id = store
    first = {u: _read(u) for u in ("u0", "u1")}
    before = _outcomes()
    assert {u: _read(u) for u in ("u0", "u1")} == first
    assert _delta(before) == {"hit": 2}
    st.l_events.insert(_buy("u0", "i99", 1_780_000_500.0), app_id)
    before = _outcomes()
    got = _read("u0")
    assert got[0] == "i99" and set(got[1:]) == set(first["u0"])
    assert _read("u1") == first["u1"]
    assert _delta(before) == {"stale": 1, "hit": 1}
    assert hc._M_ENTRIES.value() == 2


def test_mutations_without_entities_flush(store):
    st, app_id = store
    _read("u2")
    events = list(st.l_events.find(app_id, entity_id="u2"))
    assert st.l_events.delete(events[0].event_id, app_id)
    before = _outcomes()
    assert len(_read("u2")) == 2
    assert _delta(before) == {"miss": 1}
    assert st.l_events.remove(app_id)
    before = _outcomes()
    assert _read("u2") == ()
    assert _delta(before) == {"miss": 1}
    _read("u3")
    port_set_storage(st)            # a new default store: every entry flushed
    before = _outcomes()
    _read("u3")
    assert _delta(before) == {"miss": 1}


def test_off_bypasses_and_targets_equal_jax(store, mem_storage, monkeypatch):
    """``PIO_HISTORY_CACHE=off`` reads the store every time (bypass); the
    cached targets equal the JAX cache's on the same events."""
    st, app_id = store
    from predictionio_tpu.events.event import Event as JaxEvent
    from predictionio_tpu.storage import App as JaxApp

    jax_id = mem_storage.apps.insert(JaxApp(0, APP))
    mem_storage.l_events.insert_batch([
        JaxEvent(event=e.event, entity_type=e.entity_type, entity_id=e.entity_id,
                 target_entity_type=e.target_entity_type,
                 target_entity_id=e.target_entity_id, event_time=e.event_time)
        for e in st.l_events.find(app_id)], jax_id)
    for u in ("u0", "u3", "nobody"):
        with jax_oracles():
            want = jax_hc.get_cache()._fetch(APP, "user", u, "purchase", 10, None)[0]
        assert _read(u) == want
    monkeypatch.setenv("PIO_HISTORY_CACHE", "off")
    before = _outcomes()
    _read("u0")
    _read("u0")
    assert _delta(before) == {"bypass": 2}


def test_listener_bus_and_unknown_app(fresh_caches):  # noqa: F811
    """The bus calls every listener, idempotently registered, and a failing
    listener never fails the write; an unknown app is an uncached empty
    history."""
    seen = []

    def listener(entities):
        seen.append(entities)

    def broken(entities):
        raise RuntimeError("listener fault")

    base.add_append_listener(listener)
    base.add_append_listener(listener)
    base.add_append_listener(broken)
    try:
        st = Storage(StorageConfig.memory())
        app_id = st.apps.insert(App(0, "busapp"))
        st.l_events.insert_batch([_buy("a", "b"), _buy("c", "d")], app_id)
        assert seen[-1] == [("user", "a"), ("user", "c")]
        st.l_events.compact(app_id, before="2100-01-01T00:00:00Z")
        assert seen[-1] is None
    finally:
        base._APPEND_LISTENERS.remove(listener)
        base._APPEND_LISTENERS.remove(broken)
    port_set_storage(Storage(StorageConfig.memory()))
    try:
        before = _outcomes()
        assert hc.user_history_targets("no-such-app", "user", "a", "purchase", 5) == ()
        assert _delta(before) == {"bypass": 1}
    finally:
        port_set_storage(None)


def test_served_answers_equal_the_uncached_oracle(mem_storage, fresh_caches):  # noqa: F811
    """Answers after appends (purchases of new items by users already
    read) equal the ``PIO_HISTORY_CACHE=off`` oracle and the JAX answer:
    the cache never serves a stale history."""
    s = Served(mem_storage, 3)
    try:
        users = s.users()[:6]
        bodies = [{"user": u, "num": 6} for u in users]
        for b in bodies:
            s.answer(b)
        app_id = s.port_store.apps.get_by_name(APP).id
        jax_app = mem_storage.apps.get_by_name(APP).id
        rng = np.random.default_rng(4)
        from predictionio_tpu.events.event import Event as JaxEvent
        for u in users:
            items = [f"i{int(j)}" for j in rng.integers(0, 30, 3)]
            s.port_store.l_events.insert_batch([_buy(u, it) for it in items], app_id)
            mem_storage.l_events.insert_batch(
                [JaxEvent(event="purchase", entity_type="user", entity_id=u,
                          target_entity_type="item", target_entity_id=it) for it in items],
                jax_app)
        stale = hc._M_LOOKUP.value(outcome="stale")
        got = [canon(s.answer(b)) for b in bodies]
        assert hc._M_LOOKUP.value(outcome="stale") - stale >= len(users)
        with env(PIO_HISTORY_CACHE="off"):
            assert [canon(s.answer(b)) for b in bodies] == got
        assert [canon(s.jax_answer(b)) for b in bodies] == got
    finally:
        port_set_storage(None)
