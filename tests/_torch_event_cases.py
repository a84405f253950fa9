"""Seeded event corpora written into both packages' stores, shared by the
port's store, workflow, rule, localfs, native and snapshot tests, and
``assert_same_batch``, which holds two columnar batches (either package's)
equal.

A corpus is a list of specs ``(event, entity_type, entity_id, target_type,
target_id, properties, event_time, creation_time)`` in insertion order, so
each package builds its own ``Event`` objects from the same data.  The
seeded corpus inserts out of time order, repeats event times (creation time
breaks the tie), and holds ``$set`` item properties (a single-valued
category, multi-valued tags, ISO-8601 dates), ``$unset``, ``$delete`` and
user ``$set`` events.
"""

import numpy as np

import _torch_native_prebuild  # noqa: F401  (the JAX native libraries, built once)
from predictionio_tpu.events.event import Event as JaxEvent
from predictionio_tpu.storage import App as JaxApp
from predictionio_tpu_torch.events.event import Event as PortEvent
from predictionio_tpu_torch.storage import App as PortApp
from predictionio_tpu_torch.storage import Storage as PortStorage
from predictionio_tpu_torch.storage import StorageConfig as PortStorageConfig

T0 = 1_780_000_000.0
DAY = 86_400.0


def iso(epoch_s: float) -> str:
    import datetime as dt

    return dt.datetime.fromtimestamp(epoch_s, dt.timezone.utc).isoformat()


def seeded_corpus(seed: int, n_users=25, n_items=30, n_inter=400,
                  names=("purchase", "view")):
    """Interactions of ``names`` plus item property events, shuffled."""
    rng = np.random.default_rng(seed)
    specs = []
    for k in range(n_inter):
        t = T0 + float(rng.integers(0, 200)) * 60.0   # repeated times
        specs.append((names[int(rng.integers(len(names)))], "user",
                      f"u{int(rng.integers(n_users))}", "item",
                      f"i{int(rng.integers(n_items))}", {}, t, t + k))
    cats = [f"c{j}" for j in range(5)]
    tags = [f"t{j}" for j in range(8)]
    for j in range(n_items):
        t = T0 + float(rng.integers(0, 300)) * 60.0
        props = {"category": cats[int(rng.zipf(1.5)) % len(cats)],
                 "tags": [str(x) for x in rng.choice(tags, int(rng.integers(1, 4)),
                                                     replace=False)]}
        if rng.random() < 0.9:
            props["releaseDate"] = iso(T0 - float(rng.integers(0, 4000)) * DAY)
        if rng.random() < 0.85:
            props["availableDate"] = iso(T0 - float(rng.integers(-30, 300)) * DAY)
        if rng.random() < 0.85:
            props["expireDate"] = iso(T0 + float(rng.integers(-30, 300)) * DAY)
        specs.append(("$set", "item", f"i{j}", None, None, props, t, t))
        if rng.random() < 0.3:   # a later re-set of one key
            specs.append(("$set", "item", f"i{j}", None, None,
                          {"category": cats[int(rng.integers(len(cats)))]},
                          t + 600.0, t + 600.0))
        if rng.random() < 0.15:
            specs.append(("$unset", "item", f"i{j}", None, None, {"tags": None},
                          t + 1200.0, t + 1200.0))
        if rng.random() < 0.08:
            specs.append(("$delete", "item", f"i{j}", None, None, {},
                          t + 1800.0, t + 1800.0))
            if rng.random() < 0.5:   # set again after the delete
                specs.append(("$set", "item", f"i{j}", None, None,
                              {"category": "c0"}, t + 2400.0, t + 2400.0))
    for u in range(0, n_users, 4):
        t = T0 + float(u)
        specs.append(("$set", "user", f"u{u}", None, None, {"age": 20 + u}, t, t))
    order = rng.permutation(len(specs))
    return [specs[k] for k in order]


def rule_corpus(props_of):
    """The two-cluster corpus of tests/test_universal_recommender.py (its
    ``ur_app`` fixture) with explicit event times, plus ``$set`` events of
    ``props_of`` (item -> property map, applied in order)."""
    rng = np.random.default_rng(11)
    specs, t = [], T0
    e_items = [f"e{i}" for i in range(6)]
    b_items = [f"b{i}" for i in range(6)]
    for u in range(30):
        mine, other = (e_items, b_items) if u < 15 else (b_items, e_items)
        for it in mine:
            if rng.random() < 0.7:
                specs.append(("purchase", "user", f"u{u}", "item", it, {}, t, t))
                t += 60.0
            if rng.random() < 0.9:
                specs.append(("view", "user", f"u{u}", "item", it, {}, t, t))
                t += 60.0
        if u % 2 == 1 and rng.random() < 0.4:
            specs.append(("view", "user", f"u{u}", "item", other[0], {}, t, t))
            t += 60.0
    for it in e_items:
        specs.append(("$set", "item", it, None, None, {"category": "electronics"}, t, t))
    for it in b_items:
        specs.append(("$set", "item", it, None, None, {"category": "books"}, t, t))
    for it, props in props_of:
        t += 60.0
        specs.append(("$set", "item", it, None, None, dict(props), t, t))
    return specs


def ecommerce_corpus():
    """tests/test_ecommerce.py's ``ecomm_app`` events (two taste clusters of
    view/buy, ``$set`` categories) with explicit event times."""
    rng = np.random.default_rng(11)
    specs = []
    for u in range(40):
        items = [f"a{i}" for i in range(6)] if u % 2 == 0 else [f"z{i}" for i in range(6)]
        for it in items:
            t = T0 + len(specs)
            if rng.random() < 0.8:
                specs.append(("view", "user", f"u{u}", "item", it, {}, t, t))
            if rng.random() < 0.3:
                specs.append(("buy", "user", f"u{u}", "item", it, {}, t + 0.5, t + 0.5))
    for i in range(6):
        t = T0 + 10_000 + i
        specs.append(("$set", "item", f"a{i}", None, None, {"categories": ["alpha"]}, t, t))
        specs.append(("$set", "item", f"z{i}", None, None, {"categories": ["zeta"]}, t, t))
    return specs


def rating_corpus(n_users=24, n_items=40, seed=5):
    """Two taste groups of ``rate`` events (tests/test_recommendation.py's
    style): even users rate even items 5 and odd ones 1, odd users the
    reverse."""
    rng = np.random.default_rng(seed)
    specs = []
    for u in range(n_users):
        for i in range(n_items):
            if rng.random() < 0.5:
                t = T0 + len(specs)
                specs.append(("rate", "user", f"u{u}", "item", f"i{i}",
                              {"rating": 5.0 if (i % 2) == u % 2 else 1.0}, t, t))
    return specs


def _build(cls, spec, k):
    ev, et, eid, tt, tid, props, t, ct = spec
    return cls(event=ev, entity_type=et, entity_id=eid, target_entity_type=tt,
               target_entity_id=tid, properties=dict(props), event_time=t,
               creation_time=ct, event_id=f"ev{k:07d}")


def jax_events(specs):
    return [_build(JaxEvent, s, k) for k, s in enumerate(specs)]


def port_events(specs):
    return [_build(PortEvent, s, k) for k, s in enumerate(specs)]


def port_memory_storage():
    """A fresh port ``Storage`` with every repository on one memory source."""
    return PortStorage(PortStorageConfig.memory())


def port_localfs_storage(path):
    """A port ``Storage`` with every repository on the localfs directory
    ``path``, the layout the JAX package writes (its ``fs_storage``)."""
    return PortStorage(PortStorageConfig(
        sources={"FS": {"type": "localfs", "path": str(path)}},
        repositories={r: "FS" for r in ("METADATA", "EVENTDATA", "MODELDATA")}))


def fill_jax(jax_store, app, specs):
    """Create ``app`` in a JAX store and insert ``specs``; returns its id."""
    app_id = jax_store.apps.insert(JaxApp(0, app))
    jax_store.l_events.insert_batch(jax_events(specs), app_id)
    return app_id


def jax_event_server_writes(jax_store, app, specs, key="serverkey"):
    """Create ``app`` (with access key ``key``) in a JAX store and POST
    ``specs`` to the JAX event server in batches of 50, its limit, which
    appends them to the store (event ids and creation times its own);
    returns the app id."""
    import json
    import urllib.request

    from predictionio_tpu.api.event_server import run_event_server
    from predictionio_tpu.storage import AccessKey as JaxAccessKey

    app_id = jax_store.apps.insert(JaxApp(0, app))
    jax_store.l_events.init(app_id)
    jax_store.access_keys.insert(JaxAccessKey(key, app_id, []))
    docs = []
    for ev, et, eid, tt, tid, props, t, _ in specs:
        d = {"event": ev, "entityType": et, "entityId": eid, "eventTime": iso(t)}
        if tt is not None:
            d.update(targetEntityType=tt, targetEntityId=tid)
        if props:
            d["properties"] = props
        docs.append(d)
    srv = run_event_server(host="127.0.0.1", port=0, storage=jax_store, background=True)
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/batch/events.json?accessKey={key}"
        for s in range(0, len(docs), 50):
            req = urllib.request.Request(url, data=json.dumps(docs[s:s + 50]).encode())
            with urllib.request.urlopen(req, timeout=30) as resp:
                statuses = {r["status"] for r in json.loads(resp.read())}
            assert statuses == {201}, statuses
    finally:
        srv.shutdown()
        srv.server_close()
    return app_id


def fill_both(jax_store, port_store, app, specs):
    """Create ``app`` in both stores and insert ``specs``; returns the two
    app ids."""
    jax_id = jax_store.apps.insert(JaxApp(0, app))
    port_id = port_store.apps.insert(PortApp(0, app))
    jax_store.l_events.insert_batch(jax_events(specs), jax_id)
    port_store.l_events.insert_batch(port_events(specs), port_id)
    return jax_id, port_id


def assert_same_batch(got, want):
    """Two columnar batches (either package's) equal: columns with their
    dtypes, dictionaries, property columns and their values."""
    for col in ("event_codes", "entity_type_codes", "entity_ids", "target_ids",
                "times_us", "ratings"):
        g, w = getattr(got, col), getattr(want, col)
        assert g.dtype == w.dtype, col
        np.testing.assert_array_equal(g, w, err_msg=col)
    for d in ("event_dict", "entity_type_dict", "entity_dict", "target_dict"):
        assert getattr(got, d).strings() == getattr(want, d).strings(), d
    assert (got.prop_columns is None) == (want.prop_columns is None)
    if want.prop_columns is None:
        return
    assert list(got.prop_columns) == list(want.prop_columns)
    for key, w in want.prop_columns.items():
        g = got.prop_columns[key]
        for f in ("rows", "kind", "num", "str_offs", "codes"):
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype, (key, f)
            np.testing.assert_array_equal(a, b, err_msg=f"{key}.{f}")
        assert g.dict.strings() == w.dict.strings(), key
        assert [g.value_at(j) for j in range(len(g))] == [w.value_at(j) for j in range(len(w))]
