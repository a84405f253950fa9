"""Corpora and checks shared by tests/test_torch_cco.py and
tests/test_torch_cco_counts.py: the same seeded numpy corpora go through
the JAX package's ``cco_train_indicators`` and the port's.

Tolerances: LLR scores within rtol/atol 1e-4 (the reference's own
Pallas-vs-XLA bar; f32 log1p differs across frameworks in the last bits)
with -inf positions exact.  Indicator ids are equal except inside runs of
scores within 1e-4, where the sets are compared, and at a run cut by the
top-k boundary, where every id must score within 1e-4 of the run.
"""

import functools

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import cco as jax_cco
from predictionio_tpu_torch.ops import cco as port_cco
from predictionio_tpu_torch.ops import hopper_kernels as hk

RTOL, ATOL = 1e-4, 1e-4


def random_events(n_users, n_items, n_events, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_users, n_events).astype(np.int32),
            rng.integers(0, n_items, n_events).astype(np.int32))


def _synth_commerce(n_users, n_items, n_buy, n_view, seed=0):
    """bench.py:synth_commerce (zipf-ish popularity)."""
    rng = np.random.default_rng(seed)
    pop = rng.zipf(1.3, size=n_buy * 4) % n_items
    return (rng.integers(0, n_users, n_buy).astype(np.int32),
            pop[:n_buy].astype(np.int32),
            rng.integers(0, n_users, n_view).astype(np.int32),
            pop[n_buy:n_buy + n_view].astype(np.int32))


def _planted(n_big):
    """Items 0 and 1 bought together by ``n_big`` users, item 2 by 301 of
    them, on top of sparse noise: counts above bf16's exact range."""
    n_users, n_items = n_big + 150, 24
    big = np.arange(n_big, dtype=np.int32)
    nu, ni = random_events(n_users, n_items, 2000, n_big + 1)
    pu = np.concatenate([big, big, big[:301], nu])
    pi = np.concatenate([np.zeros(n_big, np.int32), np.ones(n_big, np.int32),
                         np.full(301, 2, np.int32), ni])
    vu, vi = random_events(n_users, 30, 3000, n_big + 2)
    vu = np.concatenate([big[:301], vu])
    vi = np.concatenate([np.full(301, 5, np.int32), vi])
    return dict(n_users=n_users, n_ip=n_items, n_it=30, pu=pu, pi=pi, vu=vu, vi=vi,
                top_k=6, thr=0.0, per_type=None, tile=8)


def corpus(name):
    """The tests/test_cco.py corpora, bench_ur's smoke shape, duplicated
    events, a threshold with per-type overrides, and planted counts."""
    if name == "naive":
        pu, pi = random_events(50, 20, 300, 1)
        vu, vi = random_events(50, 15, 400, 2)
        return dict(n_users=50, n_ip=20, n_it=15, pu=pu, pi=pi, vu=vu, vi=vi,
                    top_k=15, thr=0.0, per_type=None, tile=8)
    if name == "train":
        pu, pi = random_events(50, 12, 300, 61)
        vu, vi = random_events(50, 18, 600, 62)
        return dict(n_users=50, n_ip=12, n_it=18, pu=pu, pi=pi, vu=vu, vi=vi,
                    top_k=5, thr=0.0, per_type=None, tile=8)
    if name == "resident":
        pu, pi = random_events(70, 14, 400, 101)
        vu, vi = random_events(70, 19, 600, 102)
        return dict(n_users=70, n_ip=14, n_it=19, pu=pu, pi=pi, vu=vu, vi=vi,
                    top_k=5, thr=0.0, per_type=None, tile=8)
    if name == "bench_smoke":
        pu, pi, vu, vi = _synth_commerce(500, 200, 5_000, 10_000)
        return dict(n_users=500, n_ip=200, n_it=200, pu=pu, pi=pi, vu=vu, vi=vi,
                    top_k=10, thr=0.0, per_type=None, tile=128)
    if name == "duplicates":
        pu, pi = random_events(40, 9, 500, 51)
        vu, vi = random_events(40, 11, 700, 52)
        return dict(n_users=40, n_ip=9, n_it=11, pu=np.tile(pu, 3), pi=np.tile(pi, 3),
                    vu=np.tile(vu, 2), vi=np.tile(vi, 2), top_k=4, thr=0.0,
                    per_type=None, tile=8)
    if name == "threshold_per_type":
        pu, pi = random_events(60, 16, 500, 71)
        vu, vi = random_events(60, 21, 900, 72)
        return dict(n_users=60, n_ip=16, n_it=21, pu=pu, pi=pi, vu=vu, vi=vi,
                    top_k=6, thr=1.5, per_type={"view": (3, 0.5)}, tile=8)
    if name.startswith("planted"):
        return _planted(int(name[len("planted"):]))
    raise KeyError(name)


# the reference's own corpora and bench_ur's smoke shape ...
REFERENCE_CORPORA = ["naive", "train", "resident", "bench_smoke"]
# ... and the edge cases of the counts: duplicated events, per-type
# thresholds, counts past bf16's exact range
EDGE_CORPORA = ["duplicates", "threshold_per_type", "planted301", "planted4097"]
CORPORA = REFERENCE_CORPORA + EDGE_CORPORA


def others(c):
    return [("buy", c["pu"], c["pi"], c["n_ip"]), ("view", c["vu"], c["vi"], c["n_it"])]


def _kwargs(c):
    return dict(top_k=c["top_k"], llr_threshold=c["thr"], exclude_self_for="buy",
                item_tile=c["tile"], user_block=16, per_type=c["per_type"])


JAX_ENVS = {
    "default": {},
    "pallas_dense": {"PIO_CCO_SPARSE": "0", "PIO_CCO_DENSE": "1",
                     "PIO_PALLAS": "interpret", "PIO_CCO_TOPK": "pallas"},
    "pallas_tiled": {"PIO_CCO_SPARSE": "0", "PIO_CCO_DENSE": "0",
                     "PIO_PALLAS": "interpret", "PIO_CCO_TOPK": "pallas"},
}


@functools.lru_cache(maxsize=None)
def jax_result(name, ref, chunked=False):
    """The JAX package's indicators under one of ``JAX_ENVS``; ``chunked``
    shrinks its P-resident budget to 0, so its tiled setting takes the
    chunked tiled path (tests/test_cco.py:317)."""
    c = corpus(name)
    mp = pytest.MonkeyPatch()
    try:
        for k in ("PIO_CCO_SPARSE", "PIO_CCO_DENSE", "PIO_PALLAS", "PIO_CCO_TOPK"):
            mp.delenv(k, raising=False)
        for k, v in JAX_ENVS[ref].items():
            mp.setenv(k, v)
        if chunked:
            mp.setattr(jax_cco, "_TILED_P_BYTES", 0)
        return jax_cco.cco_train_indicators(
            c["pu"], c["pi"], others(c), c["n_users"], c["n_ip"], **_kwargs(c))
    finally:
        mp.undo()


#: the port's strategies, each forced at these toy sizes: the budgets
#: grown or shrunk, and the sparse runner off but where it is tested
#: (``auto`` would take it on the CPU)
STRATEGIES = {
    "dense": ({"_DENSE_C_BYTES": 1 << 40}, {"PIO_CCO_SPARSE": "0"}),
    "resident": ({"_DENSE_C_BYTES": 0}, {"PIO_CCO_SPARSE": "0"}),
    "chunked": ({"_DENSE_C_BYTES": 0, "_TILED_P_BYTES": 0}, {"PIO_CCO_SPARSE": "0"}),
    "sparse_host": ({}, {"PIO_CCO_SPARSE": "1", "PIO_CCO_SPARSE_TAIL": "host"}),
    "sparse_device": ({}, {"PIO_CCO_SPARSE": "1", "PIO_CCO_SPARSE_TAIL": "device"}),
}


@functools.lru_cache(maxsize=None)
def port_result(name, strategy):
    c = corpus(name)
    attrs, env = STRATEGIES[strategy]
    mp = pytest.MonkeyPatch()
    try:
        for k in ("PIO_CCO_SPARSE", "PIO_CCO_SPARSE_TAIL", "PIO_CCO_DENSE"):
            mp.delenv(k, raising=False)
        for k, v in env.items():
            mp.setenv(k, v)
        for k, v in attrs.items():
            mp.setattr(port_cco, k, v)
        return port_cco.cco_train_indicators(
            c["pu"], c["pi"], others(c), c["n_users"], c["n_ip"], device="cpu",
            **_kwargs(c))
    finally:
        mp.undo()


def exact_llr(c, name):
    """The full LLR matrix of one event type from exact numpy counts,
    scored by the port's plain K2 (the self-indicator's diagonal masked)."""
    n = c["n_users"]
    P = np.zeros((n, c["n_ip"]), np.int64)
    P[c["pu"], c["pi"]] = 1
    au, ai, n_t = (c["pu"], c["pi"], c["n_ip"]) if name == "buy" else \
        (c["vu"], c["vi"], c["n_it"])
    A = np.zeros((n, n_t), np.int64)
    A[au, ai] = 1
    thr = (c["per_type"] or {}).get(name, (None, c["thr"]))[1]
    s = hk.llr_masked_scores_plain(
        torch.from_numpy((P.T @ A).astype(np.int32)),
        torch.from_numpy(P.sum(0).astype(np.int32)),
        torch.from_numpy(A.sum(0).astype(np.int32)), float(n), thr).numpy()
    if name == "buy":
        np.fill_diagonal(s, -np.inf)
    return s


def _close(a, b):
    return abs(a - b) <= ATOL + RTOL * abs(b)


def assert_indicators_match(got, want, full):
    """Scores within 1e-4 and -inf positions exact; ids equal up to ties:
    a run of scores within 1e-4 must hold the same id set, and a run cut by
    the top-k boundary may hold any ids whose full-matrix score is in the
    run (``full`` is the exact LLR matrix)."""
    gs, gi = got
    ws, wi = want
    assert gs.shape == ws.shape and gi.shape == wi.shape
    fin = np.isfinite(ws)
    np.testing.assert_array_equal(np.isfinite(gs), fin)
    np.testing.assert_array_equal(gi >= 0, fin)
    np.testing.assert_array_equal(wi >= 0, fin)
    np.testing.assert_allclose(gs[fin], ws[fin], rtol=RTOL, atol=ATOL)
    k = ws.shape[1]
    for r in range(ws.shape[0]):
        n = int(fin[r].sum())
        j = 0
        while j < n:
            e = j + 1
            while e < n and _close(ws[r, e], ws[r, e - 1]):
                e += 1
            if e == n and n == k:   # the run may continue past the cut
                for ids in (gi[r, j:e], wi[r, j:e]):
                    assert all(_close(full[r, i], ws[r, j]) for i in ids), (r, ids)
            else:
                assert set(gi[r, j:e]) == set(wi[r, j:e]), (r, gi[r], wi[r])
            j = e


def check_cco_matches_jax(name, strategy, ref):
    """The port's indicators for one corpus, strategy and JAX reference
    path agree with the JAX package's, and no item indicates itself.  The
    port's chunked strategy is held against the JAX tiled setting's
    chunked path."""
    c = corpus(name)
    got = port_result(name, strategy)
    want = jax_result(name, ref, chunked=strategy == "chunked" and ref == "pallas_tiled")
    assert list(got) == ["buy", "view"]
    for event in got:
        assert_indicators_match(got[event], want[event], exact_llr(c, event))
    ids = got["buy"][1]
    assert not (ids == np.arange(c["n_ip"])[:, None]).any()   # exclude_self


def check_jax_written_localfs_store(fs_storage, path, strategy):
    """The "naive" corpus posted as ``buy``/``view`` events to the JAX
    event server, which writes them into its localfs store
    (``fs_storage``): the port's UR training read of the same directory
    equals the JAX one, and its indicators under ``strategy`` match the JAX
    package's on that read."""
    from predictionio_tpu.models.universal_recommender import engine as jax_ur
    from predictionio_tpu_torch.models.universal_recommender import engine as port_ur
    from predictionio_tpu_torch.storage import set_storage as port_set_storage

    from _torch_event_cases import T0, jax_event_server_writes, port_localfs_storage

    c = corpus("naive")
    specs = [(name, "user", f"u{u}", "item", f"{name[0]}{i}", {}, T0 + k, T0 + k)
             for name, us, its in (("buy", c["pu"], c["pi"]), ("view", c["vu"], c["vi"]))
             for k, (u, i) in enumerate(zip(us.tolist(), its.tolist()))]
    jax_event_server_writes(fs_storage, "ccoapp", specs)
    port_set_storage(port_localfs_storage(path))
    try:
        params = dict(app_name="ccoapp", event_names=["buy", "view"])
        got = port_ur.URDataSource(port_ur.URDataSourceParams(**params)).read_training()
        want = jax_ur.URDataSource(jax_ur.URDataSourceParams(**params)).read_training()
    finally:
        port_set_storage(None)
    assert got.user_dict.to_state() == want.user_dict.to_state()
    read = {}
    for name in ("buy", "view"):
        for g, w in zip(got.interactions[name], want.interactions[name]):
            if isinstance(w, np.ndarray):
                np.testing.assert_array_equal(g, w)
            else:
                assert g.to_state() == w.to_state()
        read[name] = got.interactions[name]
    (pu, pi, pd, _), (vu, vi, vd, _) = read["buy"], read["view"]
    r = dict(c, n_users=len(got.user_dict), n_ip=len(pd), n_it=len(vd),
             pu=pu, pi=pi, vu=vu, vi=vi)
    attrs, env = STRATEGIES[strategy]
    mp = pytest.MonkeyPatch()
    try:
        for k in ("PIO_CCO_SPARSE", "PIO_CCO_SPARSE_TAIL", "PIO_CCO_DENSE"):
            mp.delenv(k, raising=False)
        for k, v in env.items():
            mp.setenv(k, v)
        for k, v in attrs.items():
            mp.setattr(port_cco, k, v)
        ours = port_cco.cco_train_indicators(pu, pi, others(r), r["n_users"], r["n_ip"],
                                             device="cpu", **_kwargs(r))
    finally:
        mp.undo()
    theirs = jax_cco.cco_train_indicators(pu, pi, others(r), r["n_users"], r["n_ip"],
                                          **_kwargs(r))
    for event in ("buy", "view"):
        assert_indicators_match(ours[event], theirs[event], exact_llr(r, event))
