"""The corpus and parameters shared by tests/test_torch_universal_recommender.py
(serving) and tests/test_torch_ur_model.py (training, the model state, the
history store and the popularity backfill).

The corpus is the two-cluster one of tests/test_universal_recommender.py
(electronics fans u0-u14, book fans u15-u29, a little cross-cluster noise),
built as arrays with explicit event times and handed to both packages.
"""

import numpy as np

from predictionio_tpu.events.event import Event as JaxEvent
from predictionio_tpu.models.universal_recommender import engine as jax_ur
from predictionio_tpu.storage import App as JaxApp
from predictionio_tpu.store.columnar import IdDict as JaxIdDict
from predictionio_tpu_torch.models import universal_recommender as ur
from predictionio_tpu_torch.storage import App as PortApp
from predictionio_tpu_torch.storage import memory as port_mem
from predictionio_tpu_torch.storage import set_storage as port_set_storage

from _torch_event_cases import port_memory_storage

APP = "urapp"
T0 = 1_780_000_000.0
RTOL, ATOL = 1e-4, 1e-4          # indicator (LLR) scores
SERVE_RTOL = 1e-5                # served scores


def _two_cluster_events():
    """(event, user, item, epoch seconds) rows of the two-cluster corpus."""
    rng = np.random.default_rng(11)
    rows, t = [], T0
    e_items = [f"e{i}" for i in range(6)]
    b_items = [f"b{i}" for i in range(6)]
    for u in range(30):
        mine, other = (e_items, b_items) if u < 15 else (b_items, e_items)
        for it in mine:
            if rng.random() < 0.7:
                rows.append(("purchase", f"u{u}", it, t))
                t += 60.0
            if rng.random() < 0.9:
                rows.append(("view", f"u{u}", it, t))
                t += 60.0
        if u % 2 == 1 and rng.random() < 0.4:
            rows.append(("view", f"u{u}", other[0], t))
            t += 60.0
    return rows


EVENTS = _two_cluster_events()
NAMES = ["purchase", "view"]
PROPS = {**{f"e{i}": {"category": "electronics"} for i in range(6)},
         **{f"b{i}": {"category": "books"} for i in range(6)}}


def arrays():
    users = sorted({u for _, u, _, _ in EVENTS}, key=lambda s: int(s[1:]))
    uid = {u: i for i, u in enumerate(users)}
    inter = {}
    for name in NAMES:
        rows = [(uid[u], it, t) for ev, u, it, t in EVENTS if ev == name]
        items = sorted({it for _, it, _ in rows})
        iid = {s: i for i, s in enumerate(items)}
        inter[name] = (np.array([r[0] for r in rows], np.int32),
                       np.array([iid[r[1]] for r in rows], np.int32), items,
                       np.array([r[2] for r in rows], np.float64))
    return users, inter


def jax_td():
    users, inter = arrays()
    return jax_ur.URTrainingData(
        event_names=list(NAMES), user_dict=JaxIdDict(users),
        interactions={n: (u, i, JaxIdDict(items), t)
                      for n, (u, i, items, t) in inter.items()},
        item_properties={k: dict(v) for k, v in PROPS.items()})


def port_td():
    users, inter = arrays()
    return ur.ur_training_data_from_arrays(NAMES, users, inter, PROPS)


TRAIN_CONFIGS = {
    "reference_ep": dict(max_correlators_per_item=8, min_llr=2.0),
    "per_type_blacklist_trending": dict(
        max_correlators_per_item=8, min_llr=0.0,
        indicator_params={"view": {"maxCorrelatorsPerItem": 4, "minLLR": 1.0}},
        blacklist_events=["purchase", "view"], backfill_type="trending",
        backfill_duration="1 hours"),
    "hot_backfill_both_types": dict(
        max_correlators_per_item=11, min_llr=0.0, backfill_type="hot",
        backfill_event_names=["purchase", "view"], backfill_duration="2 hours"),
}


def params(mod, config, **over):
    kw = dict(app_name=APP, mesh_dp=1, **TRAIN_CONFIGS[config])
    kw.update(over)
    return mod.URAlgorithmParams(**kw)


def train_jax_model():
    return jax_ur.URAlgorithm(params(jax_ur, "reference_ep")).train(jax_td())


def close(a, b, rtol=RTOL, atol=ATOL):
    return abs(a - b) <= atol + rtol * abs(b)


def fill_stores(jax_store):
    """Write the corpus' events into the JAX package's bound store (the
    ``fs_storage`` fixture: its LocalFS event log) and into a fresh port
    store, bound as the port's process default.  Returns the port store."""
    app_id = jax_store.apps.insert(JaxApp(0, APP))
    jax_store.l_events.insert_batch(
        [JaxEvent(event=ev, entity_type="user", entity_id=u, target_entity_type="item",
                  target_entity_id=it, event_time=t, creation_time=t)
         for ev, u, it, t in EVENTS], app_id)
    port_store = port_memory_storage()
    port_app = port_store.apps.insert(PortApp(0, APP))
    port_store.l_events.insert_batch(
        [port_mem.Event(ev, "user", u, target_entity_type="item", target_entity_id=it,
                        event_time=t, creation_time=t)
         for ev, u, it, t in EVENTS], port_app)
    port_set_storage(port_store)
    return port_store


def assert_same_answer(got, want):
    """Items equal in order, scores within rtol 1e-5; two items may trade
    places only inside a run of scores within that tolerance."""
    g = [(d["item"], d["score"]) for d in got["itemScores"]]
    w = [(d["item"], d["score"]) for d in want["itemScores"]]
    assert len(g) == len(w), (got, want)
    for (_, gs), (_, ws) in zip(g, w):
        assert close(gs, ws, SERVE_RTOL, 0.0), (got, want)
    j = 0
    while j < len(w):
        e = j + 1
        while e < len(w) and close(w[e][1], w[e - 1][1], SERVE_RTOL, 0.0):
            e += 1
        if e < len(w):
            assert {x for x, _ in g[j:e]} == {x for x, _ in w[j:e]}, (got, want)
        j = e
