"""The port's streaming fold (``streaming/fold.py``) and the memory store's
delta-tail protocol, against the port's own retrain and the JAX package.

Exactness: after any fold sequence (new users, new items appended and
inserted mid-array, ``$set`` items, duplicate-only deltas, sliced and full
re-LLRs, the certificate on and off) the folded model equals a
from-scratch ``engine.train`` on the same device bit for bit, by each
re-selection route: the host lexsort (the CPU's) and the K2/K3 row slices
(the card's, their plain versions here), and the sparse state equals the
dense one.  Parity: on the same storage tails the port's fold and the
JAX fold give the same item spaces, equal ids and scores within rtol/atol
1e-4 (ties only where scores tie within that), and the memory store's
``scan_tail_from``/``scan_events_up_to``/``tombstone_state`` equal the JAX
memory store's, a delete invalidating the watermark in both.  Units: the
sorted-COO counts, the chunked selection, ``from_sorted_pairs``, the
popularity-order merge, the row slices, the budget boundary and the
checkpoint.
"""

import numpy as np
import pytest
import torch

from predictionio_tpu.models.universal_recommender import engine as jax_ur
from predictionio_tpu.storage import memory as jax_memory
from predictionio_tpu.streaming import fold as jax_fold
from predictionio_tpu_torch.models.common import host_topk_desc
from predictionio_tpu_torch.models.universal_recommender.engine import URQuery
from predictionio_tpu_torch.ops import cco
from predictionio_tpu_torch.ops.hopper_kernels import llr_masked_scores_plain
from predictionio_tpu_torch.storage import memory as port_memory
from predictionio_tpu_torch.store.columnar import CSRLookup
from predictionio_tpu_torch.streaming import fold

from _torch_event_cases import assert_same_batch, jax_events, port_events, seeded_corpus
from _torch_stream_cases import (  # noqa: F401  (fixtures)
    CPU,
    assert_model_equals_fresh,
    assert_models_equal,
    buy,
    fresh_ref,
    host_serving,
    port_fs,
    seed_events,
    set_item,
    tail,
    ur_params,
    ur_setup,
)

RTOL = ATOL = 1e-4

#: (re-selection route, PIO_FOLLOW_DENSE_RELLR_BYTES): "kernel" is the card's
#: K2/K3 row-slice route, run here through the kernels' plain versions
ROUTES = [("host", "default"), ("host", "0"), ("kernel", "0")]
ROUTE_IDS = ["host-dense-tail", "host-sparse-tail", "kernel-slices"]


@pytest.fixture()
def route(request, monkeypatch):
    name, dense_rellr = request.param
    if dense_rellr != "default":
        monkeypatch.setenv("PIO_FOLLOW_DENSE_RELLR_BYTES", dense_rellr)
    if name == "kernel":
        monkeypatch.setattr(fold, "_kernel_reselect", lambda device: True)
    return name


def _bootstrap(ap, ep, batch):
    return fold.URFoldState.bootstrap(ap, ep.data_source_params, batch, device=CPU)


# -- fold ≡ retrain ---------------------------------------------------------------


@pytest.mark.parametrize("route", ROUTES, indirect=True, ids=ROUTE_IDS)
def test_fold_matches_train_across_folds(port_fs, host_serving, route):
    """Bootstrap, growth, a mid-array insert, new users and duplicate-only
    folds: after every fold the arrays and answers equal a train."""
    app_id, engine, ap, ep = ur_setup(
        port_fs, use_llr_weights=True,
        indicator_params={"view": {"maxCorrelatorsPerItem": 4}})
    port_fs.l_events.insert_batch(seed_events(seed=1), app_id)
    port_fs.l_events.insert_batch(
        [set_item(f"i{k}", {"category": "red" if k < 4 else "blue"}) for k in range(8)],
        app_id)
    queries = ([URQuery(user=f"u{u}", num=6) for u in range(0, 12, 2)]
               + [URQuery(user="nobody", num=4), URQuery(item="i1", num=5),
                  URQuery.from_json({"user": "u1", "num": 6, "fields": [
                      {"name": "category", "values": ["red"], "bias": -1}]})])
    t = tail(port_fs, app_id, {}, None, None)
    state = _bootstrap(ap, ep, t["batch"])
    wm, heads = t["watermark"], t["heads"]
    assert_model_equals_fresh(state.model, engine, ep, queries)
    deltas = [
        seed_events(n_users=4, seed=2, base_u=5),               # overlap + new
        seed_events(n_users=3, seed=3, base_u=50)               # new users
        + [buy("u50", "a_first_item"),                          # mid-array insert
           set_item("a_first_item", {"category": "red"})],
        [buy("u3", "zz_new_item"), buy("u4", "zz_new_item")],   # pure end growth
        seed_events(seed=1),                                    # pure duplicates
    ]
    for evs in deltas:
        port_fs.l_events.insert_batch(evs, app_id)
        t = tail(port_fs, app_id, wm, state.batch, heads)
        assert t is not None and t["events"] > 0
        model = state.fold(t["batch"])
        wm, heads = t["watermark"], t["heads"]
        assert_model_equals_fresh(model, engine, ep, queries)
    assert all(s["mode"] == "skip" for s in state.last_fold_stats.values())


@pytest.mark.parametrize("route", ROUTES, indirect=True, ids=ROUTE_IDS)
def test_fold_sliced_rows_path_is_exact(port_fs, host_serving, route):
    """A primary pair from an existing user re-LLRs only the touched rows
    of the view type (its marginals hold) and equals a train."""
    app_id, engine, ap, ep = ur_setup(port_fs)
    port_fs.l_events.insert_batch(seed_events(seed=4), app_id)
    t = tail(port_fs, app_id, {}, None, None)
    state = _bootstrap(ap, ep, t["batch"])
    port_fs.l_events.insert_batch([buy("u0", "i7")], app_id)
    t = tail(port_fs, app_id, t["watermark"], state.batch, t["heads"])
    assert t["events"] == 1
    model = state.fold(t["batch"])
    assert state.last_fold_stats["view"]["mode"] == "sliced"
    assert state.last_fold_stats["purchase"]["mode"] == "full"
    assert_model_equals_fresh(model, engine, ep, [URQuery(user=f"u{u}", num=6)
                                                  for u in range(12)])


@pytest.mark.parametrize("dense_rellr", ["0", "default"])
def test_sparse_equals_dense_randomized(port_fs, host_serving, monkeypatch, dense_rellr):
    """Across randomized folds (growth, duplicates, new users, $set, a
    sliced round) the sparse and dense states emit identical models, and
    the last equals a train."""
    if dense_rellr != "default":
        monkeypatch.setenv("PIO_FOLLOW_DENSE_RELLR_BYTES", dense_rellr)
    app_id, engine, ap, ep = ur_setup(
        port_fs, indicator_params={"view": {"maxCorrelatorsPerItem": 4}})
    rng = np.random.default_rng(23)
    port_fs.l_events.insert_batch(seed_events(seed=31), app_id)
    port_fs.l_events.insert_batch(
        [set_item(f"i{k}", {"category": "red" if k < 4 else "blue"}) for k in range(8)],
        app_id)
    t = tail(port_fs, app_id, {}, None, None)
    monkeypatch.setenv("PIO_FOLLOW_STATE", "sparse")
    sparse = _bootstrap(ap, ep, t["batch"])
    monkeypatch.setenv("PIO_FOLLOW_STATE", "dense")
    dense = _bootstrap(ap, ep, t["batch"])
    monkeypatch.delenv("PIO_FOLLOW_STATE")
    assert (sparse.state_mode, dense.state_mode) == ("sparse", "dense")
    assert_models_equal(sparse.model, dense.model, "bootstrap")
    wm, heads = t["watermark"], t["heads"]
    for rnd in range(6):
        evs = [buy(f"u{int(u)}", f"i{int(it)}")
               for u in rng.integers(0, 12, 3) for it in rng.integers(0, 8, 2)]
        if rnd % 2:
            base = 100 + rnd * 10
            evs += [buy(f"u{base + int(u)}", f"i{int(it)}")
                    for u in range(2) for it in rng.integers(0, 10, 3)]
        if rnd == 2:
            evs += [buy("u1", f"i{k}", event="view") for k in (20, 21)]
        if rnd == 3:
            evs += [buy("u2", "i20"), buy("u3", "i21")]
        if rnd == 4:
            evs += [set_item("i2", {"category": "green"})]
        if rnd == 5:
            evs = [buy("u0", "i6")]
        port_fs.l_events.insert_batch(evs, app_id)
        t = tail(port_fs, app_id, wm, sparse.batch, heads)
        ms, md = sparse.fold(t["batch"]), dense.fold(t["batch"])
        wm, heads = t["watermark"], t["heads"]
        assert_models_equal(ms, md, f"round {rnd}")
        assert sparse.last_fold_stats == dense.last_fold_stats, rnd
    assert any(s["mode"] == "sliced" for s in sparse.last_fold_stats.values())
    assert_model_equals_fresh(ms, engine, ep, [URQuery(user="u1", num=6),
                                               URQuery(user="u101", num=5),
                                               URQuery(user="nobody", num=4)])


def _cert_counters():
    return (fold._M_RELLR_ROWS.value(outcome="certified"),
            fold._M_RELLR_ROWS.value(outcome="selected"))


@pytest.mark.parametrize("route", ROUTES, indirect=True, ids=ROUTE_IDS)
def test_pruned_rellr_equals_full_property(port_fs, host_serving, monkeypatch, route):
    """The pruned full re-LLR (the certificate) emits models identical to
    PIO_FOLLOW_RELLR_PRUNE=off and to the dense state across N bumps,
    catalog growth, duplicates, $set and a tombstone restage, ends equal
    to a train, and certifies real rows (past the 4 MiB dense routing, so
    the sparse tail runs at the default too)."""
    app_id, engine, ap, ep = ur_setup(port_fs, event_names=("purchase",))
    rng = np.random.default_rng(29)
    evs = [buy(f"u{k % 120}", f"i{k}") for k in range(1300)]
    evs += [buy(f"u{u}", f"i{it}") for u in range(10) for it in range(8) if (u + it) % 3]
    port_fs.l_events.insert_batch(evs, app_id)
    dead_id = port_fs.l_events.insert(buy("deadguy", "i3"), app_id)
    t = tail(port_fs, app_id, {}, None, None)

    def bootstrap_three(batch):
        monkeypatch.setenv("PIO_FOLLOW_RELLR_PRUNE", "off")
        full = _bootstrap(ap, ep, batch)
        monkeypatch.delenv("PIO_FOLLOW_RELLR_PRUNE")
        pruned = _bootstrap(ap, ep, batch)
        monkeypatch.setenv("PIO_FOLLOW_STATE", "dense")
        dense = _bootstrap(ap, ep, batch)
        monkeypatch.delenv("PIO_FOLLOW_STATE")
        return pruned, full, dense

    pruned, full, dense = bootstrap_three(t["batch"])
    assert_models_equal(pruned.model, full.model, "bootstrap")
    assert_models_equal(pruned.model, dense.model, "bootstrap-dense")
    cert0, _ = _cert_counters()
    wm, heads = t["watermark"], t["heads"]
    for rnd in range(6):
        if rnd == 0:
            evs = [buy("fresh_user_a", "i7")]
        elif rnd == 1:
            evs = [buy("fresh_user_b", "brand_new_1"), buy("fresh_user_b", "i7")]
        elif rnd == 2:
            evs = [buy(f"u{int(u)}", f"i{int(it)}") for u in rng.integers(0, 10, 4)
                   for it in rng.integers(0, 8, 2) if (u + it) % 3] or [buy("u1", "i1")]
        elif rnd == 3:
            evs = [set_item("i2", {"tier": "gold"})]
        elif rnd == 4:
            evs = [buy(f"nb{j}", f"i{(j * 37) % 1300}") for j in range(6)]
        else:
            assert port_fs.l_events.delete(dead_id, app_id)
            port_fs.l_events.build_snapshot(app_id)
            t = tail(port_fs, app_id, {}, None, None)
            pruned, full, dense = bootstrap_three(t["batch"])
            wm, heads = t["watermark"], t["heads"]
            assert_models_equal(pruned.model, full.model, "restage")
            continue
        port_fs.l_events.insert_batch(evs, app_id)
        t = tail(port_fs, app_id, wm, pruned.batch, heads)
        mp = pruned.fold(t["batch"])
        monkeypatch.setenv("PIO_FOLLOW_RELLR_PRUNE", "off")
        mf = full.fold(t["batch"])
        monkeypatch.delenv("PIO_FOLLOW_RELLR_PRUNE")
        md = dense.fold(t["batch"])
        wm, heads = t["watermark"], t["heads"]
        assert_models_equal(mp, mf, f"round {rnd} pruned-vs-full")
        assert_models_equal(mp, md, f"round {rnd} pruned-vs-dense")
        assert pruned.last_fold_stats == full.last_fold_stats, rnd
    cert1, _ = _cert_counters()
    assert cert1 - cert0 > 1000, "the certificate never engaged"
    assert_models_equal(pruned.model, fresh_ref(engine, ep), "vs train")


# -- the port's fold against the JAX fold -------------------------------------------


def _scores(idx, llr):
    return np.where(idx >= 0, llr, -np.inf).astype(np.float32)


def _full_llr(state, name):
    """Every cell's score of one type from the port state's counts (the
    self pairs -inf): what a run cut by the top-k boundary may hold."""
    st = state.types[name]
    n_p = state.types[state.primary].n_items
    C = st.sc.to_dense(n_p, st.n_items) if st.sc is not None else st.C
    t_k, thr = state._tuning(name)
    s = llr_masked_scores_plain(
        torch.from_numpy(C), torch.from_numpy(state.row_counts.astype(np.int32)),
        torch.from_numpy(st.col_counts.astype(np.int32)), float(len(state.user_dict)),
        thr).numpy()
    if name == state.primary:
        np.fill_diagonal(s, -np.inf)
    return s


def _close(a, b):
    return abs(a - b) <= ATOL + RTOL * abs(b)


def _assert_tables_match(got_idx, got_llr, want_idx, want_llr, full):
    """ids equal up to ties: a run of scores within 1e-4 holds the same id
    set, and a run cut by the top-k boundary may hold any ids whose score
    is in the run; scores within 1e-4."""
    gs, ws = _scores(got_idx, got_llr), _scores(want_idx, want_llr)
    assert gs.shape == ws.shape
    fin = np.isfinite(ws)
    np.testing.assert_array_equal(np.isfinite(gs), fin)
    np.testing.assert_allclose(gs[fin], ws[fin], rtol=RTOL, atol=ATOL)
    k = ws.shape[1]
    for r in range(ws.shape[0]):
        n = int(fin[r].sum())
        j = 0
        while j < n:
            e = j + 1
            while e < n and _close(ws[r, e], ws[r, e - 1]):
                e += 1
            if e == n and n == k:
                for ids in (got_idx[r, j:e], want_idx[r, j:e]):
                    assert all(_close(full[r, i], ws[r, j]) for i in ids), (r, ids)
            else:
                assert set(got_idx[r, j:e]) == set(want_idx[r, j:e]), (r, got_idx[r],
                                                                       want_idx[r])
            j = e


def _jax_params(ap):
    return jax_ur.URAlgorithmParams(
        app_name=ap.app_name, mesh_dp=1, max_correlators_per_item=ap.max_correlators_per_item,
        indicator_params=dict(ap.indicator_params))


@pytest.mark.parametrize("dense_rellr", ["0", "default"])
def test_fold_matches_jax_fold_on_the_same_tails(fs_storage, port_fs, monkeypatch,
                                                 dense_rellr):
    """The JAX package writes the log; each package tails it into its own
    fold: after the bootstrap and every fold the item spaces are equal and
    the indicator tables agree (ids up to ties, scores within 1e-4)."""
    if dense_rellr != "default":
        monkeypatch.setenv("PIO_FOLLOW_DENSE_RELLR_BYTES", dense_rellr)
    from predictionio_tpu.storage import App as JaxApp

    jax_app = fs_storage.apps.insert(JaxApp(0, "parity"))
    _, ap, ep = ur_params("parity", indicator_params={"view": {"maxCorrelatorsPerItem": 4}})
    port_app = port_fs.apps.get_by_name("parity").id
    assert port_app == jax_app
    jap = _jax_params(ap)
    jds = jax_ur.URDataSourceParams(app_name="parity", event_names=["purchase", "view"])
    specs = seeded_corpus(41, n_users=30, n_items=24, n_inter=500)
    fs_storage.l_events.insert_batch(jax_events(specs), jax_app)
    pt = tail(port_fs, port_app, {}, None, None)
    jt = fs_storage.l_events.scan_tail_from(jax_app, None, {}, base=None, heads=None)
    port_state = _bootstrap(ap, ep, pt["batch"])
    jax_state = jax_fold.URFoldState.bootstrap(jap, jds, jt["batch"])
    rng = np.random.default_rng(7)
    deltas = [
        seeded_corpus(42, n_users=40, n_items=30, n_inter=60),     # new users, new items
        [("purchase", "user", f"u{int(u)}", "item", f"i{int(i)}", {}, 1.78e9 + k, 1.78e9 + k)
         for k, (u, i) in enumerate(zip(rng.integers(0, 30, 5), rng.integers(0, 24, 5)))],
        specs[:40],                                                # duplicates
    ]
    for k, d in enumerate([[]] + deltas):
        if d:
            evs = jax_events(d)
            for j, e in enumerate(evs):
                e.event_id = f"d{k}-{j}"
            fs_storage.l_events.insert_batch(evs, jax_app)
            pt = tail(port_fs, port_app, pt["watermark"], port_state.batch, pt["heads"])
            jt = fs_storage.l_events.scan_tail_from(jax_app, None, jt["watermark"],
                                                    base=jax_state.batch, heads=jt["heads"])
            port_state.fold(pt["batch"])
            jax_state.fold(jt["batch"])
        pm, jm = port_state.model, jax_state.model
        assert pm.item_dict.strings() == jm.item_dict.strings(), k
        assert set(pm.indicator_idx) == set(jm.indicator_idx)
        for name in pm.indicator_idx:
            assert pm.event_item_dicts[name].strings() == jm.event_item_dicts[name].strings()
            _assert_tables_match(pm.indicator_idx[name], pm.indicator_llr[name],
                                 np.asarray(jm.indicator_idx[name]),
                                 np.asarray(jm.indicator_llr[name]),
                                 _full_llr(port_state, name))
        np.testing.assert_allclose(pm.popularity, np.asarray(jm.popularity), rtol=RTOL,
                                   atol=ATOL)
        assert pm.item_properties == jm.item_properties
        assert port_state.last_fold_stats == jax_state.last_fold_stats, k


def test_checkpoint_arrays_match_jax_and_restore_a_jax_checkpoint(fs_storage, port_fs):
    """On the same tail the port's checkpoint arrays equal the JAX fold's
    (the counts, pairs, marginals and code maps; the layout both packages
    write), and a JAX checkpoint restores into the port as the port's own
    bootstrap."""
    from predictionio_tpu.storage import App as JaxApp

    jax_app = fs_storage.apps.insert(JaxApp(0, "ckapp"))
    _, ap, ep = ur_params("ckapp")
    fs_storage.l_events.insert_batch(
        jax_events(seeded_corpus(5, n_users=20, n_items=16, n_inter=300)), jax_app)
    pt = tail(port_fs, jax_app, {}, None, None)
    jt = fs_storage.l_events.scan_tail_from(jax_app, None, {}, base=None, heads=None)
    port_state = _bootstrap(ap, ep, pt["batch"])
    jax_state = jax_fold.URFoldState.bootstrap(
        _jax_params(ap), jax_ur.URDataSourceParams(app_name="ckapp",
                                                   event_names=["purchase", "view"]),
        jt["batch"])
    pa, pmeta = port_state.checkpoint_arrays()
    ja, jmeta = jax_state.checkpoint_arrays()
    structural = [k for k in ja if not k.endswith(("_idx", "_llr"))]
    assert set(pa) == set(ja)
    for key in structural:
        np.testing.assert_array_equal(pa[key], np.asarray(ja[key]), err_msg=key)
    for key in ("version", "impl", "event_names", "n_users", "props_ever", "fingerprint"):
        assert pmeta[key] == jmeta[key], key
    restored = fold.URFoldState.restore_checkpoint(
        ap, ep.data_source_params, pt["batch"], {k: np.asarray(v) for k, v in ja.items()},
        jmeta, device=CPU)
    for name in restored.model.indicator_idx:
        _assert_tables_match(restored.model.indicator_idx[name],
                             restored.model.indicator_llr[name],
                             port_state.model.indicator_idx[name],
                             port_state.model.indicator_llr[name],
                             _full_llr(port_state, name))
    assert restored.model.user_dict.strings() == port_state.model.user_dict.strings()


# -- the memory store's delta-tail protocol -------------------------------------------


def _assert_same_tail(got, want):
    if want is None:
        assert got is None
        return
    assert got is not None
    assert got["events"] == want["events"]
    assert got.get("watermark") == want.get("watermark")
    assert got.get("heads") == want.get("heads")
    assert_same_batch(got["batch"], want["batch"])
    if "ids" in want:
        assert got["ids"].tolist() == want["ids"].tolist()


def test_memory_delta_tail_matches_jax_memory_store():
    """The same inserts into the JAX and the port memory stores: equal
    tails (batches, watermarks, generations), covered prefixes and
    tombstone sets; a delete, an overwrite and a TTL trim each bump the
    generation and invalidate an outstanding watermark in both."""
    specs = seeded_corpus(11, n_users=15, n_items=12, n_inter=120)
    jm, pm = jax_memory.MemEvents(), port_memory.MemEvents()
    jev, pev = jax_events(specs), port_events(specs)
    jm.insert_batch(jev[:100], 1)
    pm.insert_batch(pev[:100], 1)
    jt = jm.scan_tail_from(1, None, {}, base=None, heads=None)
    pt = pm.scan_tail_from(1, None, {}, base=None, heads=None)
    _assert_same_tail(pt, jt)
    assert pt["watermark"] == {"mem": 100} and pt["heads"] == {"mem": {"gen": 0}}
    for e_j, e_p in zip(jev[100:], pev[100:]):
        jm.insert(e_j, 1)
        pm.insert(e_p, 1)
    _assert_same_tail(pm.scan_tail_from(1, None, pt["watermark"], base=pt["batch"],
                                        heads=pt["heads"]),
                      jm.scan_tail_from(1, None, jt["watermark"], base=jt["batch"],
                                        heads=jt["heads"]))
    # the delta shared the base batch's dictionaries, which grew in place
    assert_same_batch(pt["batch"], jt["batch"])
    for args in ((1, None, {"mem": 60}, None), (1, None, {"mem": 60}, {"mem": {"gen": 0}})):
        _assert_same_tail(pm.scan_events_up_to(*args), jm.scan_events_up_to(*args))
    assert pm.tombstone_state(1) == jm.tombstone_state(1) == frozenset()
    assert pm.scan_tail_from(1, None, {"mem": 10_000}, heads=None) is None
    wm, heads = {"mem": len(specs)}, {"mem": {"gen": 0}}
    mutations = [
        lambda m, ev: m.delete(ev[3].event_id, 1),            # in-place delete
        lambda m, ev: m.insert(ev[5], 1),                     # overwrite of an id
        lambda m, ev: m.compact(1, before="2099-01-01T00:00:00Z"),   # TTL trim
    ]
    for gen, mutate in enumerate(mutations, start=1):
        mutate(jm, jev)
        mutate(pm, pev)
        for m in (jm, pm):
            assert m.scan_tail_from(1, None, wm, base=None, heads=heads) is None
            assert m.scan_events_up_to(1, None, wm, heads=heads) is None
        _assert_same_tail(pm.scan_tail_from(1, None, {}, heads=None),
                          jm.scan_tail_from(1, None, {}, heads=None))
        assert pm.scan_tail_from(1, None, {}, heads=None)["heads"] == {"mem": {"gen": gen}}
        wm = {"mem": len(pm._tail_state(1, None)[0])}
        heads = {"mem": {"gen": gen}}
    assert pm.remove(1) and jm.remove(1)
    assert pm.scan_tail_from(1, None, {}, heads=heads) is None


def test_memory_store_fold_follows_appends(host_serving):
    """A fold state fed by the memory store's tails equals a train from it."""
    from predictionio_tpu_torch.storage import set_storage

    from _torch_event_cases import port_memory_storage

    store = port_memory_storage()
    set_storage(store)
    try:
        app_id, engine, ap, ep = ur_setup(store)
        store.l_events.insert_batch(seed_events(seed=8), app_id)
        t = tail(store, app_id, {}, None, None)
        state = _bootstrap(ap, ep, t["batch"])
        for evs in (seed_events(n_users=3, seed=9, base_u=40), [buy("u1", "new_i")]):
            store.l_events.insert_batch(evs, app_id)
            t = tail(store, app_id, t["watermark"], state.batch, t["heads"])
            assert t["events"] == len(evs)
            state.fold(t["batch"])
        assert_model_equals_fresh(state.model, engine, ep,
                                  [URQuery(user="u1", num=5), URQuery(user="u41", num=5)])
    finally:
        set_storage(None)


# -- units --------------------------------------------------------------------------


def test_sparse_counts_unit():
    """_SparseCounts merge, gather and remaps against a dense reference,
    keys equal to the JAX _SparseCounts' under the same updates."""
    rng = np.random.default_rng(7)
    C = np.zeros((37, 23), np.int32)
    sc, jsc = fold._SparseCounts.empty(), jax_fold._SparseCounts.empty()
    for _ in range(8):
        rows = rng.integers(0, 37, 50).astype(np.int64)
        cols = rng.integers(0, 23, 50).astype(np.int64)
        np.add.at(C, (rows, cols), 1)
        sc.add_pairs(rows, cols)
        jsc.add_pairs(rows, cols)
        assert np.array_equal(sc.to_dense(37, 23), C)
        assert np.all(np.diff(sc.keys) > 0)
        assert np.array_equal(sc.keys, jsc.keys) and np.array_equal(sc.counts, jsc.counts)
    rows = np.asarray(sorted(rng.choice(37, 9, replace=False)), np.int64)
    local, cols, counts = sc.row_cells(rows)
    got = np.zeros((9, 23), np.int32)
    got[local, cols] = counts
    assert np.array_equal(got, C[rows])
    perm = np.sort(rng.choice(30, 23, replace=False)).astype(np.int64)
    sc.remap_cols(perm)
    C2 = np.zeros((37, 30), np.int32)
    C2[:, perm] = C
    assert np.array_equal(sc.to_dense(37, 30), C2)
    rperm = np.sort(rng.choice(45, 37, replace=False)).astype(np.int64)
    sc.remap_rows(rperm)
    C3 = np.zeros((45, 30), np.int32)
    C3[rperm, :] = C2
    assert np.array_equal(sc.to_dense(45, 30), C3)
    assert np.all(np.diff(sc.keys) > 0)
    assert np.array_equal(fold._SparseCounts.from_dense(C3).to_dense(45, 30), C3)


def test_select_topk_chunked_matches_inline(monkeypatch):
    """The thread-pool chunked selection equals one global pass."""
    rng = np.random.default_rng(5)
    n_rows, width = 257, 4
    rows = np.sort(rng.integers(0, n_rows, 20_000)).astype(np.int64)
    cols = rng.integers(0, 900, 20_000).astype(np.int64)
    scores = rng.choice(np.asarray([0.5, 1.25, 3.0, 7.5], np.float32), 20_000)
    monkeypatch.setattr(fold, "_RELLR_CHUNK_MIN_CELLS", 1)
    monkeypatch.setenv("PIO_FOLLOW_RELLR_WORKERS", "3")
    s_c, i_c = fold._select_topk_chunked(rows, cols, scores, n_rows, width)
    s_i, i_i = cco._select_topk_cells(rows, cols, scores, n_rows, width)
    assert np.array_equal(s_c, s_i) and np.array_equal(i_c, i_i)


def test_from_sorted_pairs_matches_from_pairs():
    rng = np.random.default_rng(9)
    flat = np.unique(rng.integers(0, 40, 500) * 97 + rng.integers(0, 97, 500))
    rows, vals = flat // 97, flat % 97
    a = CSRLookup.from_pairs(rows, vals, 40)
    b = CSRLookup.from_sorted_pairs(rows, vals, 40)
    assert np.array_equal(a.indptr, b.indptr) and np.array_equal(a.values, b.values)


def test_merge_pop_order_matches_full_sort():
    """_merge_pop_order ≡ host_topk_desc's full order under heavy ties,
    growth and superset changed sets, and ≡ the JAX merge."""
    rng = np.random.default_rng(3)
    pop = rng.choice(np.asarray([0, 1, 2, 5, 5, 9], np.float32), 300)
    order = host_topk_desc(pop, len(pop))[1]
    for step in range(8):
        grow = rng.integers(0, 12)
        new_pop = np.concatenate([pop, rng.integers(0, 6, grow).astype(np.float32)])
        changed = np.unique(rng.integers(0, len(pop), 25)).astype(np.int64)
        new_pop[changed] += rng.integers(0, 3, len(changed))
        if step % 2:
            changed = np.union1d(changed, np.unique(rng.integers(0, len(pop), 10)))
        changed = np.union1d(changed, np.arange(len(pop), len(new_pop), dtype=np.int64))
        merged = fold._merge_pop_order(order, new_pop, changed)
        assert np.array_equal(merged, host_topk_desc(new_pop, len(new_pop))[1]), step
        assert np.array_equal(merged, jax_fold._merge_pop_order(order, new_pop, changed))
        pop, order = new_pop, merged


@pytest.mark.parametrize("n_cols,top_k", [(300, 6), (40, 50), (1, 1)])
def test_row_slices_match_the_dense_tail(monkeypatch, n_cols, top_k):
    """The card's re-selection route (_llr_topk_row_slices: densified row
    chunks, K2, the self pair at each row's global id, K3) equals the dense
    tail's rows bit for bit, across chunk boundaries."""
    rng = np.random.default_rng(n_cols)
    n_rows, n_users = max(n_cols, 7), 500
    C = (rng.random((n_rows, n_cols)) < 0.3) * rng.integers(1, 9, (n_rows, n_cols))
    C = C.astype(np.int32)
    rc = np.maximum(C.max(axis=1), 1) + rng.integers(0, 20, n_rows)
    cc = np.maximum(C.max(axis=0), 1) + rng.integers(0, 20, n_cols)
    width = min(top_k, n_cols)
    for excl in (False, True):
        want = cco._llr_topk_dense(
            torch.from_numpy(C[:n_cols] if excl else C),
            torch.from_numpy(rc[:n_cols] if excl else rc).to(torch.int32),
            torch.from_numpy(cc).to(torch.int32), float(n_users), 1.0, width, excl)
        rows = np.arange(n_cols if excl else n_rows, dtype=np.int64)
        sub = rows[::2]
        local, cols = np.nonzero(C[sub])
        monkeypatch.setattr(fold, "_RESELECT_SLICE_BYTES", 8 * n_cols * 3)   # 3-row chunks
        s, i = fold._llr_topk_row_slices(local, cols, C[sub][local, cols], rc[sub], cc,
                                         float(n_users), 1.0, sub if excl else None,
                                         width, n_cols, torch.device("cpu"))
        assert np.array_equal(s, want[0].numpy()[sub])
        fin = np.isfinite(s)
        assert np.array_equal(i[fin], want[1].numpy()[sub][fin])


def test_budget_boundary_pins_demotion_threshold(port_fs, host_serving, monkeypatch):
    """A budget the dense state cannot fit holds the sparse state in fold
    mode; one byte under the sparse footprint demotes it."""
    app_id, engine, ap, ep = ur_setup(port_fs, event_names=("purchase",))
    port_fs.l_events.insert_batch([buy(f"u{k % 100}", f"i{k}") for k in range(600)], app_id)
    t = tail(port_fs, app_id, {}, None, None)
    monkeypatch.setenv("PIO_FOLLOW_STATE", "sparse")
    state = _bootstrap(ap, ep, t["batch"])
    sparse_bytes = state.state_bytes()
    dense_equiv = len(state.model.item_dict) ** 2 * 4
    budget = max(sparse_bytes * 2, sparse_bytes + 4096)
    assert sparse_bytes < budget < dense_equiv
    monkeypatch.setenv("PIO_FOLLOW_STATE_BYTES", str(budget))
    port_fs.l_events.insert_batch([buy("u0", "i1")], app_id)
    t2 = tail(port_fs, app_id, t["watermark"], state.batch, t["heads"])
    state.fold(t2["batch"])
    monkeypatch.setenv("PIO_FOLLOW_STATE", "dense")
    with pytest.raises(fold.FoldUnsupported):
        _bootstrap(ap, ep, tail(port_fs, app_id, {}, None, None)["batch"])
    monkeypatch.setenv("PIO_FOLLOW_STATE", "sparse")
    monkeypatch.setenv("PIO_FOLLOW_STATE_BYTES", str(state.state_bytes() - 1))
    port_fs.l_events.insert_batch([buy("u0", "i2")], app_id)
    t3 = tail(port_fs, app_id, t2["watermark"], state.batch, t2["heads"])
    with pytest.raises(fold.FoldUnsupported):
        state.fold(t3["batch"])


def test_checkpoint_roundtrip_bit_exact(port_fs, host_serving):
    """checkpoint_arrays → restore_checkpoint reproduces the model, and the
    same delta folded into both stays identical."""
    app_id, engine, ap, ep = ur_setup(port_fs)
    port_fs.l_events.insert_batch(seed_events(seed=41), app_id)
    port_fs.l_events.insert_batch([set_item("i1", {"category": "red"})], app_id)
    t = tail(port_fs, app_id, {}, None, None)
    state = _bootstrap(ap, ep, t["batch"])
    arrays, meta = state.checkpoint_arrays()
    restored = fold.URFoldState.restore_checkpoint(ap, ep.data_source_params, state.batch,
                                                   arrays, meta, device=CPU)
    assert_models_equal(state.model, restored.model, "restore")
    port_fs.l_events.insert_batch([buy("newguy", "i3"), buy("u1", "i5")], app_id)
    t2 = tail(port_fs, app_id, t["watermark"], state.batch, t["heads"])
    assert_models_equal(state.fold(t2["batch"]), restored.fold(t2["batch"]), "post-restore")


def test_checkpoint_fingerprint_rejects_corruption(port_fs, host_serving):
    app_id, engine, ap, ep = ur_setup(port_fs, event_names=("purchase",))
    port_fs.l_events.insert_batch(seed_events(seed=43), app_id)
    state = _bootstrap(ap, ep, tail(port_fs, app_id, {}, None, None)["batch"])
    arrays, meta = state.checkpoint_arrays()
    bad = dict(arrays)
    pairs = np.array(bad["t0_pairs"])
    pairs[0] ^= 1
    bad["t0_pairs"] = pairs
    with pytest.raises(ValueError, match="fingerprint"):
        fold.URFoldState.restore_checkpoint(ap, ep.data_source_params, state.batch, bad,
                                            meta, device=CPU)
