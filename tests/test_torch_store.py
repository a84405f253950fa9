"""The port's event model, memory store, columnar batches, PEventStore and
the Universal Recommender's ``read_training`` against the JAX package.

Both packages build their events from the same seeded specs
(tests/_torch_event_cases.py: out-of-order inserts, repeated event times,
``$set``/``$unset``/``$delete``, multi-valued properties) in their own
memory stores.  Arrays are equal, dictionary strings equal in order, event
reads equal event for event.
"""

import datetime as dt

import numpy as np
import pytest

from predictionio_tpu.events import event as jax_event
from predictionio_tpu.models import common as jax_common
from predictionio_tpu.models.universal_recommender import engine as jax_ur
from predictionio_tpu.store import columnar as jax_columnar
from predictionio_tpu.store.event_store import PEventStore as JaxPEventStore
from predictionio_tpu_torch.events import event as port_event
from predictionio_tpu_torch.models import common as port_common
from predictionio_tpu_torch.models import universal_recommender as ur
from predictionio_tpu_torch.storage import App, StorageConfig, locator
from predictionio_tpu_torch.storage import set_storage as port_set_storage
from predictionio_tpu_torch.store import columnar as port_columnar
from predictionio_tpu_torch.store.event_store import PEventStore

from _torch_event_cases import (T0, assert_same_batch, fill_both, jax_event_server_writes,
                                jax_events, port_events, port_memory_storage, seeded_corpus)

APP = "storeapp"
SEEDS = [0, 1, 2]


@pytest.fixture()
def stores(mem_storage):
    """(JAX store, port store), both the process default of their package."""
    port_store = port_memory_storage()
    port_set_storage(port_store)
    yield mem_storage, port_store
    port_set_storage(None)


def _ids(events):
    return [e.event_id for e in events]


# -- the event model -----------------------------------------------------------------


@pytest.mark.parametrize("value", [
    "2026-07-29T00:00:00", "2026-07-29T00:00:00Z", "2026-07-29T03:00:00+02:00",
    "2026-07-29", 1_780_000_000, 1_780_000_000.25, dt.datetime(2026, 7, 29, 5),
    dt.datetime(2026, 7, 29, 5, tzinfo=dt.timezone(dt.timedelta(hours=-3))), True])
def test_parse_time_matches_jax(value):
    got, want = port_event.parse_time(value), jax_event.parse_time(value)
    assert got == want and got.utcoffset() == want.utcoffset()


@pytest.mark.parametrize("value", ["29/07/2026", "soon", ""])
def test_parse_time_rejects_like_jax(value):
    for mod in (port_event, jax_event):
        with pytest.raises(ValueError):
            mod.parse_time(value)


@pytest.mark.parametrize("kw", [
    dict(event="$set", entity_type="item", entity_id="i1", target_entity_type="item",
         target_entity_id="i2"),
    dict(event="$unset", entity_type="item", entity_id="i1"),
    dict(event="$merge", entity_type="item", entity_id="i1"),
    dict(event="view", entity_type="user", entity_id=""),
    dict(event="", entity_type="user", entity_id="u1"),
])
def test_event_validation_matches_jax(kw):
    for cls in (port_event.Event, jax_event.Event):
        with pytest.raises(ValueError):
            cls(**kw)


def test_event_json_matches_jax():
    specs = seeded_corpus(5, n_inter=40)
    for p, j in zip(port_events(specs), jax_events(specs)):
        assert p.to_json() == j.to_json()
        assert type(p.properties) is port_event.DataMap


@pytest.mark.parametrize("seed", SEEDS)
def test_aggregate_properties_matches_jax(seed):
    specs = seeded_corpus(seed)
    got = port_event.aggregate_properties(port_events(specs))
    want = jax_event.aggregate_properties(jax_events(specs))
    assert list(got) == list(want)
    for k, w in want.items():
        assert dict(got[k]) == dict(w)
        assert (got[k].first_updated, got[k].last_updated) == (w.first_updated,
                                                               w.last_updated)
    assert any("tags" not in v for v in got.values())       # an $unset held
    assert any(isinstance(v.get("tags"), list) for v in got.values())


# -- the memory store ---------------------------------------------------------------------

FIND_CASES = {
    "all": {},
    "window": dict(start_time=T0 + 3_000.0, until_time=T0 + 9_000.0),
    "item_entities": dict(entity_type="item"),
    "one_user": dict(entity_type="user", entity_id="u3"),
    "names": dict(event_names=["view", "$set"]),
    "target_type": dict(target_entity_type="item"),
    "one_target": dict(target_entity_id="i7"),
    "latest_3": dict(entity_type="user", limit=3, reversed_order=True),
    "limit_0": dict(limit=0),
    "limit_-1": dict(limit=-1, reversed_order=True),
}


@pytest.mark.parametrize("case", sorted(FIND_CASES))
def test_mem_events_find_matches_jax(stores, case):
    jax_store, port_store = stores
    jax_id, port_id = fill_both(jax_store, port_store, APP, seeded_corpus(3))
    kw = dict(FIND_CASES[case])
    for key in ("start_time", "until_time"):
        if key in kw:
            kw[key] = port_event.parse_time(kw[key])
    got = list(port_store.l_events.find(port_id, **kw))
    want = list(jax_store.l_events.find(jax_id, **kw))
    assert _ids(got) == _ids(want)
    assert (len(got) > 0) == (case != "limit_0")


def test_mem_store_crud_matches_jax(stores):
    from predictionio_tpu.storage import Channel as JaxChannel
    from predictionio_tpu_torch.storage import Channel

    jax_store, port_store = stores
    jax_id, port_id = fill_both(jax_store, port_store, APP, seeded_corpus(4, n_inter=30))
    assert port_store.apps.insert(port_store.apps.get(port_id)) is None   # name taken
    for store, app_id, chan in ((jax_store, jax_id, JaxChannel(0, "c", jax_id)),
                                (port_store, port_id, Channel(0, "c", port_id))):
        assert store.channels.insert(chan) == 1
        assert store.l_events.get("ev0000003", app_id).event_id == "ev0000003"
        assert store.l_events.delete("ev0000003", app_id)
        assert store.l_events.get("ev0000003", app_id) is None
        assert not store.l_events.delete("ev0000003", app_id)
    assert _ids(port_store.l_events.find(port_id)) == _ids(jax_store.l_events.find(jax_id))
    assert [c.name for c in port_store.channels.get_by_app_id(port_id)] == ["c"]
    assert port_store.l_events.remove(port_id)
    assert list(port_store.l_events.find(port_id)) == []


# -- the locator -----------------------------------------------------------------------------


def test_locator_reads_the_env_contract():
    env = {"PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
           **{f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "MEM"
              for r in ("METADATA", "EVENTDATA", "MODELDATA")}}
    cfg = StorageConfig.from_env(env)
    assert cfg.sources == {"MEM": {"type": "memory"}}
    storage = locator.Storage(cfg)
    assert storage.l_events is storage.p_events
    assert storage.apps is storage.apps
    with pytest.raises(ValueError, match="MODELDATA"):
        StorageConfig.from_env({k: v for k, v in env.items() if "MODELDATA" not in k})


@pytest.mark.parametrize("typ", ["localfs", "sharedfs", "sharded", "sql", None])
def test_unported_sources_raise_naming_the_roadmap(typ, tmp_path):
    """Every source type of the JAX locator opens a store at its path in the
    port (none raises any more): localfs, named or as the default
    configuration (None: ``$PIO_FS_BASEDIR``), sharedfs, sharded and sql (a
    SQLite file at the path)."""
    path = str(tmp_path / "store")
    env = ({"PIO_FS_BASEDIR": path} if typ is None else
           {"PIO_STORAGE_SOURCES_X_TYPE": typ,
            "PIO_STORAGE_SOURCES_X_PATH": path + (".db" if typ == "sql" else ""),
            **{f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "X"
               for r in ("METADATA", "EVENTDATA", "MODELDATA")}})
    storage = locator.Storage(StorageConfig.from_env(env))   # the default is localfs
    try:
        assert storage.apps.insert(App(0, "a")) is not None
        assert storage.l_events.init(1) and storage.l_events is storage.p_events
        if typ in ("localfs", None):
            assert (tmp_path / "store" / "meta" / "apps.json").exists()
        elif typ == "sql":
            assert (tmp_path / "store.db").exists()
        else:
            assert (tmp_path / "store" / "meta").is_dir()
    finally:
        if hasattr(storage.l_events, "close"):
            storage.l_events.close()
    assert not [n for n in vars(locator) if n.startswith("NOT_")]


# -- columnar batches and PEventStore -----------------------------------------------------------


def _assert_same_batch(got, want):
    for col in ("event_codes", "entity_type_codes", "entity_ids", "target_ids",
                "times_us", "ratings"):
        g, w = getattr(got, col), getattr(want, col)
        assert g.dtype == w.dtype, col
        np.testing.assert_array_equal(g, w, err_msg=col)
    for d in ("event_dict", "entity_type_dict", "entity_dict", "target_dict"):
        assert getattr(got, d).strings() == getattr(want, d).strings(), d


@pytest.mark.parametrize("seed", SEEDS)
def test_event_batch_matches_jax(seed):
    specs = seeded_corpus(seed)
    for k in range(0, len(specs), 7):   # a rating property on some rows
        specs[k] = specs[k][:5] + ({"rating": float(k % 5)},) + specs[k][6:] \
            if specs[k][0] in ("purchase", "view") else specs[k]
    got = port_columnar.EventBatch.from_events(port_events(specs))
    want = jax_columnar.EventBatch.from_events(jax_events(specs))
    _assert_same_batch(got, want)
    assert np.isfinite(got.ratings).any()
    _assert_same_batch(got.select_events(["view", "$unset", "nope"]),
                       want.select_events(["view", "$unset", "nope"]))
    mask = np.arange(len(got)) % 3 == 1
    _assert_same_batch(got.subset(mask), want.subset(mask))


@pytest.mark.parametrize("kw", [
    {}, dict(event_names=["purchase", "view"]), dict(entity_type="item"),
    dict(event_names=["view"], start_time=T0 + 2_000.0, until_time=T0 + 7_000.0)])
def test_pevent_store_batch_matches_jax(stores, kw):
    jax_store, port_store = stores
    fill_both(jax_store, port_store, APP, seeded_corpus(6))
    kw = {k: port_event.parse_time(v) if k.endswith("_time") else v for k, v in kw.items()}
    got = PEventStore.batch(APP, **kw)
    _assert_same_batch(got, JaxPEventStore.batch(APP, **kw))
    assert len(got) > 0
    assert PEventStore.native_batch(APP) is None
    assert _ids(PEventStore.find(APP, **kw)) == _ids(JaxPEventStore.find(APP, **kw))
    with pytest.raises(ValueError, match="does not exist"):
        PEventStore.batch("no-such-app")


@pytest.mark.parametrize("seed", SEEDS)
def test_event_store_reads_a_jax_written_localfs_store(tmp_path, seed):
    """``PEventStore`` and ``LEventStore`` of the port over a localfs store
    the JAX package wrote read what the JAX package reads there."""
    from predictionio_tpu.storage import App as JaxApp
    from predictionio_tpu.storage.locator import Storage as JaxStorage
    from predictionio_tpu.storage.locator import StorageConfig as JaxStorageConfig
    from predictionio_tpu.store.event_store import LEventStore as JaxLEventStore
    from predictionio_tpu_torch.store.event_store import LEventStore

    cfg = dict(sources={"S": {"type": "localfs", "path": str(tmp_path)}},
               repositories={r: "S" for r in ("METADATA", "EVENTDATA", "MODELDATA")})
    jax_store = JaxStorage(JaxStorageConfig(**cfg))
    port_store = locator.Storage(StorageConfig(**cfg))
    jax_id = jax_store.apps.insert(JaxApp(0, APP))
    jax_store.l_events.insert_batch(jax_events(seeded_corpus(seed)), jax_id)
    for kw in ({}, dict(event_names=["view"]), dict(entity_type="item")):
        assert _ids(PEventStore.find(APP, storage=port_store, **kw)) == _ids(
            JaxPEventStore.find(APP, storage=jax_store, **kw))
    for user in ("u0", "u3", "u11", "nobody"):
        for kw in ({}, dict(limit=3), dict(latest=False, event_names=["purchase"])):
            got = LEventStore.find_by_entity(APP, "user", user, storage=port_store, **kw)
            want = JaxLEventStore.find_by_entity(APP, "user", user, storage=jax_store, **kw)
            assert _ids(got) == _ids(want)
    got = PEventStore.aggregate_properties(APP, "item", storage=port_store)
    want = JaxPEventStore.aggregate_properties(APP, "item", storage=jax_store)
    assert got and {k: dict(v) for k, v in got.items()} == {k: dict(v) for k, v in want.items()}


def test_event_store_reads_what_the_jax_event_server_wrote(tmp_path):
    """Events posted to the JAX event server, which appends them to its
    localfs store: the port's ``PEventStore`` reads the rows and the batch
    the JAX package reads there."""
    from predictionio_tpu.storage.locator import Storage as JaxStorage
    from predictionio_tpu.storage.locator import StorageConfig as JaxStorageConfig

    cfg = dict(sources={"S": {"type": "localfs", "path": str(tmp_path)}},
               repositories={r: "S" for r in ("METADATA", "EVENTDATA", "MODELDATA")})
    jax_store = JaxStorage(JaxStorageConfig(**cfg))
    port_store = locator.Storage(StorageConfig(**cfg))
    jax_event_server_writes(jax_store, APP, seeded_corpus(3))
    assert _ids(PEventStore.find(APP, storage=port_store)) == _ids(
        JaxPEventStore.find(APP, storage=jax_store))
    assert_same_batch(PEventStore.batch(APP, storage=port_store),
                      JaxPEventStore.batch(APP, storage=jax_store))


@pytest.mark.parametrize("entity_type", ["item", "user"])
def test_pevent_store_aggregate_properties_matches_jax(stores, entity_type):
    jax_store, port_store = stores
    fill_both(jax_store, port_store, APP, seeded_corpus(7))
    got = PEventStore.aggregate_properties(APP, entity_type)
    want = JaxPEventStore.aggregate_properties(APP, entity_type)
    assert got and list(got) == list(want)
    assert {k: dict(v) for k, v in got.items()} == {k: dict(v) for k, v in want.items()}


# -- URDataSource.read_training --------------------------------------------------------------


def _assert_same_training_data(got, want):
    assert got.event_names == want.event_names
    assert got.user_dict.to_state() == want.user_dict.to_state()
    assert list(got.interactions) == list(want.interactions)
    for name, (wu, wi, wd, wt) in want.interactions.items():
        gu, gi, gd, gt = got.interactions[name]
        for g, w in ((gu, wu), (gi, wi), (gt, wt)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert gd.to_state() == wd.to_state()
    assert got.item_properties == want.item_properties


@pytest.mark.parametrize("seed", SEEDS)
def test_read_training_matches_jax(stores, seed):
    jax_store, port_store = stores
    names = ["purchase", "view", "cart"]
    fill_both(jax_store, port_store, APP, seeded_corpus(seed, names=tuple(names)))
    got = ur.URDataSource(ur.URDataSource.params_class(
        app_name=APP, event_names=names)).read_training()
    want = jax_ur.URDataSource(jax_ur.URDataSourceParams(
        app_name=APP, event_names=names)).read_training()
    _assert_same_training_data(got, want)
    # $set item ids never enroll as users
    assert all(s.startswith("u") for s in got.user_dict.strings())
    assert got.item_properties and any(isinstance(v.get("tags"), list)
                                       for v in got.item_properties.values())


def test_read_training_equals_the_arrays_path(stores):
    """The store path and ``ur_training_data_from_arrays`` give one
    ``URTrainingData`` for the same arrays."""
    jax_store, port_store = stores
    fill_both(jax_store, port_store, APP, seeded_corpus(8))
    got = ur.URDataSource(ur.URDataSource.params_class(app_name=APP)).read_training()
    inter = {name: (u, i, d.to_state(), t) for name, (u, i, d, t) in got.interactions.items()}
    want = ur.ur_training_data_from_arrays(got.event_names, got.user_dict.to_state(), inter,
                                           got.item_properties)
    _assert_same_training_data(got, want)


# -- the LRU of the rule state ------------------------------------------------------------------


def test_lru_cache_matches_jax():
    seen = {"port": [], "jax": []}
    caches = {"port": port_common.LRUCache(3, on_event=seen["port"].append),
              "jax": jax_common.LRUCache(3, on_event=seen["jax"].append)}
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 6, 200)
    for k in keys:
        out = {n: c.get_or_build(int(k), lambda k=k: int(k) * 10) for n, c in caches.items()}
        assert out["port"] == out["jax"] == int(k) * 10
    assert seen["port"] == seen["jax"] and "evict" in seen["port"]
    for attr in ("hits", "misses", "evictions"):
        assert getattr(caches["port"], attr) == getattr(caches["jax"], attr)
    assert len(caches["port"]) == 3 and (int(keys[-1]) in caches["port"])
