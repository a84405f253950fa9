"""CCO at every scale: the port's chunked tiled strategy and host
sparse-count runner against the JAX package, the four strategies bit for
bit, the blocked layout (native and numpy), the single-type entries and
the budgets that choose a strategy.

The corpora, the tolerances and the indicator check are
tests/_torch_cco_cases.py's: LLR within rtol/atol 1e-4, ids equal except
at tied scores.  Between the port's own strategies everything is exact.
The sparse-tail cases are tests/test_cco.py:422-595's, run on the port's
pieces; the host tail scores its cells through ``llr_masked_cells``, the
plain K2's own chain, so it equals the dense tail bit for bit.
"""

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import cco as jax_cco
from predictionio_tpu_torch import native as port_native
from predictionio_tpu_torch.ops import cco as port_cco
from predictionio_tpu_torch.ops import hopper_kernels as hk

from _torch_cco_cases import (CORPORA, JAX_ENVS, REFERENCE_CORPORA, STRATEGIES,
                              check_cco_matches_jax, check_jax_written_localfs_store,
                              port_result, random_events)

CPU = torch.device("cpu")


@pytest.fixture()
def sparse_off(monkeypatch):
    for k in ("PIO_CCO_SPARSE", "PIO_CCO_SPARSE_TAIL", "PIO_CCO_DENSE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PIO_CCO_SPARSE", "0")
    return monkeypatch


def assert_same_tables(a, b):
    """Two indicator tables equal bit for bit: scores (as int32 bits) and
    ids."""
    np.testing.assert_array_equal(np.asarray(a[0], np.float32).view(np.int32),
                                  np.asarray(b[0], np.float32).view(np.int32))
    np.testing.assert_array_equal(a[1], b[1])


# -- the new strategies against the JAX package -----------------------------------


@pytest.mark.parametrize("ref", sorted(JAX_ENVS))
@pytest.mark.parametrize("strategy", ["chunked", "sparse_host", "sparse_device"])
@pytest.mark.parametrize("corpus", REFERENCE_CORPORA)
def test_cco_train_indicators_matches_jax(corpus, strategy, ref):
    check_cco_matches_jax(corpus, strategy, ref)


@pytest.mark.parametrize("name", CORPORA)
def test_every_strategy_is_bit_identical(name):
    dense = port_result(name, "dense")
    for strategy in STRATEGIES:
        got = port_result(name, strategy)
        assert list(got) == list(dense)
        for event in dense:
            assert_same_tables(got[event], dense[event])


# -- the single-type entries -----------------------------------------------------


def _coo_run(monkeypatch, strategy, *args, **kw):
    attrs, env = STRATEGIES[strategy]
    with monkeypatch.context() as mp:
        for k in ("PIO_CCO_SPARSE", "PIO_CCO_SPARSE_TAIL", "PIO_CCO_DENSE"):
            mp.delenv(k, raising=False)
        for k, v in env.items():
            mp.setenv(k, v)
        for k, v in attrs.items():
            mp.setattr(port_cco, k, v)
        return port_cco.cco_indicators_coo(*args, device="cpu", **kw)


@pytest.mark.parametrize("self_pair", [False, True])
def test_cco_indicators_coo_strategies_agree_with_jax(monkeypatch, self_pair):
    """tests/test_cco.py:317 and :344 on the port: dense, resident,
    chunked and both sparse tails of ``cco_indicators_coo`` bit for bit,
    and within the bar of the JAX entry's dense and chunked paths."""
    n_users, n_ip, n_it = 70, 14, 19
    pu, pi = random_events(n_users, n_ip, 400, 101)
    ou, oi = random_events(n_users, n_it, 600, 102)
    if self_pair:
        ou, oi, n_it = pu, pi, n_ip
    kw = dict(top_k=5, item_tile=8, user_block=16, exclude_self=self_pair)
    args = (pu, pi, ou, oi, n_users, n_ip, n_it)
    runs = {s: _coo_run(monkeypatch, s, *args, **kw) for s in STRATEGIES}
    for s, got in runs.items():
        assert_same_tables(got, runs["dense"])
    with monkeypatch.context() as mp:
        mp.setenv("PIO_CCO_DENSE", "0")
        mp.setattr(jax_cco, "_TILED_P_BYTES", 1)
        js, ji = jax_cco.cco_indicators_coo(*args, **kw)
    np.testing.assert_allclose(runs["chunked"][0], js, rtol=1e-4, atol=1e-4)
    for r in range(n_ip):
        keep = js[r] > -np.inf
        assert set(runs["chunked"][1][r][keep]) == set(ji[r][keep])
        if self_pair:
            assert r not in set(runs["chunked"][1][r][runs["chunked"][1][r] >= 0])


def test_cco_indicators_blocked_resident_and_chunked(sparse_off):
    """``cco_indicators`` on the blocked layout, self-pair and two types,
    under PIO_CCO_DENSE=off: resident and chunked (the resident budget at
    0) bit for bit, and equal to the dense path (PIO_CCO_DENSE=on)."""
    n_users, n_ip, n_it = 60, 21, 13
    pu, pi = random_events(n_users, n_ip, 500, 7)
    au, ai = random_events(n_users, n_it, 450, 8)
    p = port_cco.block_interactions(pu, pi, n_users, n_ip, user_block=16)
    a = port_cco.block_interactions(au, ai, n_users, n_it, user_block=16)
    for other, excl in ((p, True), (a, False)):
        def run():
            return port_cco.cco_indicators(p, other, None, None, n_users, top_k=6,
                                           item_tile=8, exclude_self=excl, device="cpu")
        sparse_off.setenv("PIO_CCO_DENSE", "1")
        dense = run()
        sparse_off.setenv("PIO_CCO_DENSE", "0")
        resident = run()
        with sparse_off.context() as mp:
            mp.setattr(port_cco, "_TILED_P_BYTES", 0)
            chunked = run()
        assert_same_tables(resident, dense)
        assert_same_tables(chunked, dense)


def test_chunked_user_block_not_a_multiple_of_8(sparse_off):
    """A user block the int8 product's shape rules do not take is widened
    with zero columns; the counts do not change."""
    n_users, n_items = 45, 17
    u, i = random_events(n_users, n_items, 300, 9)
    sparse_off.setattr(port_cco, "_DENSE_C_BYTES", 0)
    sparse_off.setattr(port_cco, "_TILED_P_BYTES", 0)
    got = port_cco.cco_indicators_coo(u, i, u, i, n_users, n_items, n_items, top_k=4,
                                      item_tile=5, user_block=10, exclude_self=True,
                                      device="cpu")
    sparse_off.setattr(port_cco, "_TILED_P_BYTES", 8 << 30)
    want = port_cco.cco_indicators_coo(u, i, u, i, n_users, n_items, n_items, top_k=4,
                                       item_tile=5, exclude_self=True, device="cpu")
    assert_same_tables(got, want)


def test_chunked_staging_spans_are_slices():
    """The other type staged once, sorted by (tile, block): every span
    holds exactly its tile's items and its block's users."""
    u, i = random_events(100, 50, 2000, 11)
    tile, block = 16, 32
    n_tiles, n_blocks = 4, 4
    staged = port_cco._StagedCOO(u, i, CPU, "item", tile, n_tiles, block=block,
                                 n_blocks=n_blocks)
    total = 0
    for t in range(n_tiles):
        for b in range(n_blocks):
            su, si = staged.span2(t, b)
            total += len(su)
            assert ((si // tile) == t).all() and ((su // block) == b).all()
            want = ((i // tile) == t) & ((u // block) == b)
            assert len(su) == int(want.sum())
    assert total == len(u)


# -- the blocked layout ------------------------------------------------------------


def test_block_interactions_stream_matches_batch(sparse_off):
    """tests/test_cco.py:296: the streamed layout gives the one-shot
    layout's indicators; and both layouts equal the JAX package's, array
    for array (dtypes and widths included)."""
    n_users, n_items = 48, 12
    u, i = random_events(n_users, n_items, 400, 91)
    whole = port_cco.block_interactions(u, i, n_users, n_items, user_block=16)
    streamed = port_cco.block_interactions_stream(
        ((u[s:s + 37], i[s:s + 37]) for s in range(0, 400, 37)),
        n_users, n_items, user_block=16)
    sparse_off.setenv("PIO_CCO_DENSE", "0")
    s1, i1 = port_cco.cco_indicators(whole, whole, None, None, n_users, top_k=5,
                                     item_tile=8, exclude_self=True, device="cpu")
    s2, i2 = port_cco.cco_indicators(streamed, streamed, None, None, n_users, top_k=5,
                                     item_tile=8, exclude_self=True, device="cpu")
    assert_same_tables((s1, i1), (s2, i2))
    jax_streamed = jax_cco.block_interactions_stream(
        ((u[s:s + 37], i[s:s + 37]) for s in range(0, 400, 37)),
        n_users, n_items, user_block=16)
    for name in ("local_u", "item", "mask"):
        got, want = getattr(streamed, name), getattr(jax_streamed, name)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert (streamed.n_users, streamed.n_items, streamed.user_block, streamed.n_blocks) == (
        jax_streamed.n_users, jax_streamed.n_items, jax_streamed.user_block,
        jax_streamed.n_blocks)


@pytest.mark.parametrize("dedup", [False, True])
def test_block_interactions_native_matches_numpy(monkeypatch, dedup):
    """The native counting layout and the numpy one give the same blocks
    (a block's pairs in input order either way), and the same arrays as
    the JAX package's numpy layout."""
    if not port_native.native_available():
        pytest.skip("no C++ compiler: the native layout is not built")
    n_users, n_items = 300, 40
    u, i = random_events(n_users, n_items, 3000, 17)
    native = port_cco.block_interactions(u, i, n_users, n_items, user_block=64, dedup=dedup)
    monkeypatch.setattr(port_native, "layout_chunks", lambda *a, **k: None)
    numpy_ = port_cco.block_interactions(u, i, n_users, n_items, user_block=64, dedup=dedup)
    jax_layout = jax_cco.block_interactions_stream(
        [jax_cco.dedup_pairs(u, i, n_items) if dedup else (u, i)], n_users, n_items,
        user_block=64)
    for name in ("local_u", "item", "mask"):
        for got in (native, numpy_):
            np.testing.assert_array_equal(getattr(got, name), getattr(jax_layout, name))
            assert getattr(got, name).dtype == getattr(jax_layout, name).dtype


def test_native_layout_chunks_matches_numpy():
    """tests/test_native_scanner.py's layout case on the port's library:
    per chunk the same pairs, zeros past the count, and bad input raises."""
    from predictionio_tpu_torch.native import layout_chunks

    if not port_native.native_available():
        pytest.skip("no C++ compiler: the native layout is not built")
    rng = np.random.default_rng(17)
    n_users, chunk, n_chunks = 1000, 256, 4
    u = rng.integers(0, n_users, 5000).astype(np.int32)
    i = rng.integers(0, 300, 5000).astype(np.int32)
    lu, it, cnt = layout_chunks(u, i, chunk, n_chunks)
    assert lu.shape == it.shape and lu.shape[0] == n_chunks and cnt.sum() == 5000
    assert lu.dtype == it.dtype == cnt.dtype == np.int32
    for b in range(n_chunks):
        c = int(cnt[b])
        sel = (u // chunk) == b
        np.testing.assert_array_equal(lu[b, :c], u[sel] % chunk)
        np.testing.assert_array_equal(it[b, :c], i[sel])
        assert (lu[b, c:] == 0).all() and (it[b, c:] == 0).all()
    bad = np.array([chunk * n_chunks + 5], np.int32)
    for args in ((bad, bad), (np.array([-1], np.int32), np.array([0], np.int32)),
                 (u, i[:100])):
        with pytest.raises(ValueError):
            layout_chunks(*args, chunk, n_chunks)


def test_flatten_dedup_and_counts_match_jax():
    u, i = random_events(50, 20, 700, 23)
    blocked = port_cco.block_interactions(u, i, 50, 20, user_block=8)
    fu, fi = port_cco._flatten_blocked(blocked)
    ju, ji = jax_cco._flatten_blocked(jax_cco.block_interactions_stream(
        [(u, i)], 50, 20, user_block=8))
    np.testing.assert_array_equal(np.sort(fu.astype(np.int64) * 20 + fi),
                                  np.sort(ju.astype(np.int64) * 20 + ji))
    for got, want in zip(port_cco.dedup_pairs(u, i, 20), jax_cco.dedup_pairs(u, i, 20)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    np.testing.assert_array_equal(port_cco.distinct_user_counts(u, i, 20),
                                  jax_cco.distinct_user_counts(u, i, 20))


# -- the budgets and switches --------------------------------------------------------


class _Props:
    total_memory = 85_031_714_816   # what an 80 GB H100 reports


def test_resident_budget_on_the_card(monkeypatch):
    """bench_scale's full shape (100,000 x 131,072, tile 4,096) is ~17.8 GB
    of working set: resident on an 80 GB card, beyond the CPU's 8 GiB; the
    card's cut is half its memory."""
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: _Props)
    card = torch.device("cuda")
    assert port_cco._resident_p_ok(100_000, 131_072, 4096, card)
    assert not port_cco._resident_p_ok(100_000, 131_072, 4096, CPU)
    assert port_cco._resident_budget(card) == _Props.total_memory // 2
    # ~40 GB of n_users x I_p is past the cut with the tiles
    assert not port_cco._resident_p_ok(300_000, 140_000, 4096, card)
    assert port_cco._resident_p_ok(20_000, 100_000, 4096, CPU)


def test_strategy_switches(monkeypatch):
    for k in ("PIO_CCO_SPARSE", "PIO_CCO_DENSE"):
        monkeypatch.delenv(k, raising=False)
    assert port_cco._sparse_path_ok(CPU)
    assert not port_cco._sparse_path_ok(torch.device("cuda"))
    monkeypatch.setenv("PIO_CCO_SPARSE", "on")
    assert port_cco._sparse_path_ok(torch.device("cuda"))
    monkeypatch.setenv("PIO_CCO_SPARSE", "off")
    assert not port_cco._sparse_path_ok(CPU)
    assert port_cco._dense_path_ok(10, 10) and not port_cco._dense_path_ok(100_000, 100_000)
    monkeypatch.setenv("PIO_CCO_DENSE", "off")
    assert not port_cco._dense_path_ok(10, 10)
    monkeypatch.setenv("PIO_CCO_DENSE", "1")
    assert port_cco._dense_path_ok(100_000, 100_000)


# -- the sparse tails (tests/test_cco.py:422-595) ---------------------------------


def test_llr_masked_cells_on_gathered_cells_is_the_plain_k2():
    """The one scoring chain: 1-D gathers score each cell exactly as the
    plain K2 does on the whole matrix."""
    rng = np.random.default_rng(3)
    n_p, n_t, n = 70, 90, 400
    C = (rng.random((n_p, n_t)) < 0.2) * rng.integers(1, 30, (n_p, n_t))
    rc = C.sum(1) + rng.integers(0, 20, n_p)
    cc = C.sum(0) + rng.integers(0, 20, n_t)
    dense = hk.llr_masked_scores_plain(torch.from_numpy(C.astype(np.int32)),
                                       torch.from_numpy(rc.astype(np.int32)),
                                       torch.from_numpy(cc.astype(np.int32)), float(n), 0.5)
    rows, cols = np.nonzero(C >= 0)
    cells = port_cco._score_llr_cells(C[rows, cols], rc[rows], cc[cols], n, 0.5)
    np.testing.assert_array_equal(cells.view(np.int32),
                                  dense.numpy()[rows, cols].view(np.int32))


def test_sparse_host_tail_matches_device_tail(monkeypatch):
    n_users, n_items = 300, 64
    u, i = random_events(n_users, n_items, 900, 71)

    def run():
        r = port_cco._SparseHostRunner(u, i, n_users, n_items, CPU)
        return r.collect(r.dispatch(u, i, n_items, 5, 1.0, True, self_pair=True))

    monkeypatch.setenv("PIO_CCO_SPARSE_TAIL", "device")
    ds, di = run()
    monkeypatch.setenv("PIO_CCO_SPARSE_TAIL", "host")
    hs, hi = run()
    assert_same_tables((hs, hi), (ds, di))
    monkeypatch.setenv("PIO_CCO_SPARSE_TAIL", "auto")
    assert_same_tables(run(), (ds, di))
    assert ((hi == -1) == (hs == -np.inf)).all()
    jr = jax_cco._SparseHostRunner(u, i, n_users, n_items)
    monkeypatch.setenv("PIO_CCO_SPARSE_TAIL", "host")
    js, ji = jr.collect(jr.dispatch(u, i, n_items, 5, 1.0, True, self_pair=True))
    np.testing.assert_allclose(hs, js, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(hi >= 0, ji >= 0)


def test_sparse_counts_coo_touched_path():
    n_users, n_ip, n_it = 500, 4200, 4100
    assert n_ip * n_it > port_cco._SPARSE_BINCOUNT_CELLS
    pu, pi = random_events(n_users, n_ip, 3000, 81)
    au, ai = random_events(n_users, n_it, 4000, 82)
    p = port_cco._SparseHostCSR(pu, pi, n_ip, n_users)
    a = port_cco._SparseHostCSR(au, ai, n_it, n_users)
    C, flat = port_cco._sparse_counts(p, a, want_coo=True)
    np.testing.assert_array_equal(flat, np.flatnonzero(C))
    assert len(flat) > 0
    jC = jax_cco._sparse_counts(jax_cco._SparseHostCSR(pu, pi, n_ip, n_users),
                                jax_cco._SparseHostCSR(au, ai, n_it, n_users))
    np.testing.assert_array_equal(C, jC)
    s_host, i_host = port_cco._llr_topk_sparse_host(
        C, p.col_counts, a.col_counts, float(n_users), 0.0, 6, False, flat=flat)
    s_dev, i_dev = port_cco._llr_topk_dense(
        torch.from_numpy(C), torch.from_numpy(p.col_counts),
        torch.from_numpy(a.col_counts), float(n_users), 0.0, 6, False)
    assert_same_tables((s_host, i_host), port_cco._finalize_topk(s_dev, i_dev, n_it))


def test_sparse_counts_coo_bincount_downgrade():
    n_users, n_items = 40, 50
    pu, pi = random_events(n_users, n_items, 700, 91)
    p = port_cco._SparseHostCSR(pu, pi, n_items, n_users)
    total = port_cco._cross_join_pairs(p, p)
    assert total * 8 >= n_items * n_items, "need a dense chunk for the test"
    C, flat = port_cco._sparse_counts(p, p, want_coo=True)
    np.testing.assert_array_equal(flat, np.flatnonzero(C))
    assert len(flat) > 0


def test_pure_coo_counts_match_dense():
    n_users, n_ip, n_it = 400, 300, 250
    pu, pi = random_events(n_users, n_ip, 5000, 101)
    au, ai = random_events(n_users, n_it, 6000, 102)
    p = port_cco._SparseHostCSR(pu, pi, n_ip, n_users)
    a = port_cco._SparseHostCSR(au, ai, n_it, n_users)
    cells, counts = port_cco._sparse_counts_coo(p, a)
    C = np.zeros((n_ip, n_it), np.int32)
    C[cells // n_it, cells % n_it] = counts
    np.testing.assert_array_equal(C, port_cco._sparse_counts(p, a))
    assert np.all(np.diff(cells) > 0)


def test_pure_coo_counts_chunked_merge(monkeypatch):
    n_users, n_items = 200, 60
    pu, pi = random_events(n_users, n_items, 3000, 103)
    p = port_cco._SparseHostCSR(pu, pi, n_items, n_users)
    monkeypatch.setattr(port_cco, "_SPARSE_CHUNK_PAIRS", 16)   # many tiny chunks
    cells, counts = port_cco._sparse_counts_coo(p, p)
    C = np.zeros((n_items, n_items), np.int32)
    C[cells // n_items, cells % n_items] = counts
    np.testing.assert_array_equal(C, port_cco._sparse_counts(p, p))


def test_huge_catalog_coo_dispatch_matches_dense(monkeypatch):
    n_users, n_items = 300, 120
    u, i = random_events(n_users, n_items, 2500, 104)
    monkeypatch.setenv("PIO_CCO_SPARSE_TAIL", "host")

    def run():
        r = port_cco._SparseHostRunner(u, i, n_users, n_items, CPU)
        d = r.dispatch(u, i, n_items, 6, 0.5, True, self_pair=True)
        assert d is not None
        return r.collect(d)

    ref = run()
    monkeypatch.setattr(port_cco, "_SPARSE_C_BYTES", 1024)   # dense C "cannot exist"
    assert_same_tables(run(), ref)


def test_llr_topk_sparse_rows_matches_host_tail_slices():
    rng = np.random.default_rng(105)
    n_p, n_t, n_users = 90, 70, 500
    C = (rng.random((n_p, n_t)) < 0.1).astype(np.int32) * \
        rng.integers(1, 9, (n_p, n_t)).astype(np.int32)
    rc = C.sum(axis=1).astype(np.int64) + rng.integers(0, 5, n_p)
    cc = C.sum(axis=0).astype(np.int64) + rng.integers(0, 5, n_t)
    s_host, i_host = port_cco._llr_topk_sparse_host(
        C, rc, cc, float(n_users), 0.25, top_k=5, exclude_self=True)
    rows = np.asarray(sorted(rng.choice(n_p, 17, replace=False)), np.int64)
    sub = C[rows]
    lr, lc = np.nonzero(sub)
    s_sp, i_sp = port_cco._llr_topk_sparse_rows(
        lr, lc, sub[lr, lc], rc[rows], cc, float(n_users), 0.25,
        top_k=5, n_rows=len(rows), n_cols=n_t, self_cols=rows)
    assert_same_tables((s_sp, i_sp), (s_host[rows], i_host[rows]))


def test_sparse_over_budget_takes_the_device_strategy(monkeypatch):
    """tests/test_cco.py:388: a cross-join over its budget bails to the
    dense strategy, with the same tables."""
    n_users, n_ip, n_it = 70, 13, 19
    pu, pi = random_events(n_users, n_ip, 350, 51)
    ou, oi = random_events(n_users, n_it, 600, 52)
    args = (pu, pi, ou, oi, n_users, n_ip, n_it)
    kw = dict(top_k=6, llr_threshold=0.3, item_tile=8)
    monkeypatch.setenv("PIO_CCO_SPARSE", "1")
    sparse = port_cco.cco_indicators_coo(*args, device="cpu", **kw)
    monkeypatch.setattr(port_cco, "_SPARSE_PAIR_BUDGET", 0)
    bailed = port_cco.cco_indicators_coo(*args, device="cpu", **kw)
    monkeypatch.setenv("PIO_CCO_SPARSE", "0")
    dense = port_cco.cco_indicators_coo(*args, device="cpu", **kw)
    assert_same_tables(sparse, dense)
    assert_same_tables(bailed, dense)


def test_chunked_indicators_from_a_jax_written_localfs_store(fs_storage, tmp_path):
    """A corpus the JAX event server wrote into its localfs store, read by
    the port's UR data source, trains the JAX indicators through the
    chunked strategy."""
    check_jax_written_localfs_store(fs_storage, tmp_path / "store", "chunked")
