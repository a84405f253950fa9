"""The port's CCO training op and the plain versions of its kernels (K2
LLR, K3 top-k) against the JAX package.

The same seeded numpy inputs go through the JAX function (its Pallas
kernels in interpret mode, as tests/test_pallas_kernels.py runs them, or
its plain XLA path) and through the port on CPU tensors, which take the
kernels' plain PyTorch versions.  Tolerances: LLR scores within rtol/atol
1e-4 (the reference's own Pallas-vs-XLA bar; f32 log1p differs across
frameworks in the last bits) with -inf positions exact; top-k values and
ids exact against ``lax.top_k``; K3's carry form against the JAX package's
Pallas top-b followed by its ``merge_desc``, as its tiled CCO step composes
them (values exact, ids by what they point at where the JAX bitonic merge
may reorder ties).  The op runs here on the reference
corpora; tests/_torch_cco_cases.py holds the corpora and the indicator
check.  The CUDA kernels themselves are held against their plain versions
in tests/test_torch_cuda.py, on a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import cco as jax_cco
from predictionio_tpu.ops import pallas_kernels as jax_pk
from predictionio_tpu.ops import topk as jax_topk
from predictionio_tpu_torch.ops import cco as port_cco
from predictionio_tpu_torch.ops import hopper_kernels as hk
from predictionio_tpu_torch.ops.topk import block_width, merge_desc

from _torch_cco_cases import (ATOL, JAX_ENVS, REFERENCE_CORPORA, RTOL, check_cco_matches_jax,
                              check_jax_written_localfs_store)


def _assert_llr(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


# -- K2: LLR scoring + masking ---------------------------------------------------


def _llr_inputs(r, c, seed):
    rng = np.random.default_rng(seed)
    counts = (rng.integers(0, 20, size=(r, c))
              * (rng.random((r, c)) < 0.6)).astype(np.int32)
    row = (counts.sum(1) + rng.integers(0, 50, r)).astype(np.int32)
    col = (counts.sum(0) + rng.integers(0, 50, c)).astype(np.int32)
    return counts, row, col, float(row.sum() + 1000)


@pytest.mark.parametrize("thr", [0.0, 2.0])
@pytest.mark.parametrize("shape", [(37, 190), (130, 700)])
def test_llr_plain_matches_pallas_interpret(monkeypatch, shape, thr):
    monkeypatch.setenv("PIO_PALLAS", "interpret")
    counts, row, col, n = _llr_inputs(shape[0], shape[1], sum(shape))
    want = jax_pk.llr_masked_scores(jnp.asarray(counts, jnp.float32),
                                    jnp.asarray(row, jnp.float32),
                                    jnp.asarray(col, jnp.float32), n, thr)
    got = hk.llr_masked_scores_plain(torch.from_numpy(counts), torch.from_numpy(row),
                                     torch.from_numpy(col), n, thr)
    _assert_llr(got, want)


@pytest.mark.parametrize("thr", [0.0, 2.0])
@pytest.mark.parametrize("shape", [(37, 190), (130, 700)])
def test_llr_plain_matches_xla_path(shape, thr):
    counts, row, col, n = _llr_inputs(shape[0], shape[1], sum(shape) + 1)
    want = jax_cco._llr_mask_scores(jnp.asarray(counts, jnp.float32),
                                    jnp.asarray(row, jnp.float32),
                                    jnp.asarray(col, jnp.float32), n, thr,
                                    pallas="off")
    got = port_cco._llr_mask_scores(torch.from_numpy(counts), torch.from_numpy(row),
                                    torch.from_numpy(col), n, thr)
    _assert_llr(got, want)


def test_llr_score_matches_jax_on_edge_tables():
    tables = np.array([(10, 5, 3, 100), (1, 0, 0, 50), (7, 7, 7, 7),
                       (0, 3, 4, 10), (4097, 3, 2, 95000), (301, 0, 12, 20000)],
                      np.float32)
    want = np.asarray(jax_cco.llr_score(*(jnp.asarray(tables[:, j]) for j in range(4))))
    got = port_cco.llr_score(*(torch.from_numpy(tables[:, j].copy()) for j in range(4)))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_llr_cpu_tensors_take_plain_version():
    counts, row, col, n = _llr_inputs(20, 33, 5)
    args = (torch.from_numpy(counts), torch.from_numpy(row), torch.from_numpy(col))
    before = hk.llr_masked_scores.launches
    got = hk.llr_masked_scores(*args, n, 1.0)
    assert hk.llr_masked_scores.launches == before   # no kernel launched
    assert torch.equal(got, hk.llr_masked_scores_plain(*args, n, 1.0))
    # a row-strided view (the slice of a padded count product) is taken
    wide = torch.zeros((20, 40), dtype=torch.int32)
    wide[:, :33] = args[0]
    assert torch.equal(hk.llr_masked_scores(wide[:, :33], *args[1:], n, 1.0), got)


@pytest.mark.parametrize("bad", ["dtype", "shape", "row", "layout"])
def test_llr_rejects_bad_arguments(bad):
    counts, row, col, n = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                           for a in _llr_inputs(6, 9, 7))
    if bad == "dtype":
        counts = counts.to(torch.int64)
    elif bad == "shape":
        col = col[:8]
    elif bad == "row":
        row = row.to(torch.float64)
    elif bad == "layout":
        counts = counts.T.contiguous().T
    with pytest.raises((TypeError, ValueError)):
        hk.llr_masked_scores(counts, row, col, n)


def _sparse_llr_inputs(r, c, seed):
    """Counts at the deployed training tiles' sparsity: ~0.3% nonzero, every
    fifth row all zero."""
    rng = np.random.default_rng(seed)
    counts = (rng.integers(1, 40, size=(r, c)) * (rng.random((r, c)) < 0.003)).astype(np.int32)
    counts[::5] = 0
    row = (counts.sum(1) + rng.integers(1, 50, r)).astype(np.int32)
    col = (counts.sum(0) + rng.integers(1, 50, c)).astype(np.int32)
    return counts, row, col, float(row.sum() + 1000)


@pytest.mark.parametrize("thr", [0.0, 2.0])
@pytest.mark.parametrize("path", ["pallas", "xla"])
def test_llr_plain_matches_jax_on_sparse_counts(monkeypatch, path, thr):
    """The zero-skipping K2 on training-sparse counts: its plain version
    against the interpret-mode Pallas kernel and the XLA path."""
    monkeypatch.setenv("PIO_PALLAS", "interpret")
    counts, row, col, n = _sparse_llr_inputs(60, 1030, 11)
    assert (counts == 0).mean() >= 0.99
    jargs = (jnp.asarray(counts, jnp.float32), jnp.asarray(row, jnp.float32),
             jnp.asarray(col, jnp.float32), n, thr)
    want = (jax_pk.llr_masked_scores(*jargs) if path == "pallas"
            else jax_cco._llr_mask_scores(*jargs, pallas="off"))
    got = hk.llr_masked_scores(torch.from_numpy(counts), torch.from_numpy(row),
                               torch.from_numpy(col), n, thr)
    _assert_llr(got, want)


@pytest.mark.parametrize("pad", [1, 3])
def test_llr_takes_a_view_whose_stride_is_no_multiple_of_4(pad):
    counts, row, col, n = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                           for a in _sparse_llr_inputs(30, 257, 12))
    wide = torch.zeros((30, 257 + pad + 1), dtype=torch.int32)
    wide[:, 1:258] = counts
    view = wide[:, 1:258]
    assert view.stride(0) % 4 != 0
    assert torch.equal(hk.llr_masked_scores(view, row, col, n, 1.0),
                       hk.llr_masked_scores_plain(counts, row, col, n, 1.0))


# -- K3: exact per-row top-b ---------------------------------------------------------


def _tie_corpus(r, w, seed):
    """Scores with planted exact ties, -inf runs, constant rows and both
    zeros."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-6, 6, size=(r, w)) / 4).astype(np.float32)
    x[0, 3: w // 2] = -np.inf                 # a long -inf run
    x[1, :] = 0.25                            # one value everywhere
    x[2, ::3] = x[2, 1]                       # planted ties
    x[3, :] = -np.inf                         # nothing finite
    x[4, ::2] = -0.0                          # -0.0 ranks below +0.0
    x[4, 1::2] = 0.0
    x[5:] = np.where(rng.random((r - 5, w)) < 0.2, -np.inf, x[5:])
    return x


@pytest.mark.parametrize("b", [8, 64])
@pytest.mark.parametrize("w", [100, 300, 1000])
def test_tile_topk_plain_matches_lax_top_k(w, b):
    x = _tie_corpus(12, w, w + b)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), b)
    got_v, got_i = hk.tile_topk_desc(torch.from_numpy(x), b)
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy().view(np.int32),
                                  np.asarray(want_v).view(np.int32))


def test_tile_topk_pads_rows_narrower_than_b():
    x = _tie_corpus(6, 13, 3)
    got_v, got_i = hk.tile_topk_desc(torch.from_numpy(x), 16, id_offset=100)
    padded = np.concatenate([x, np.full((6, 3), -np.inf, np.float32)], axis=1)
    want_v, want_i = jax.lax.top_k(jnp.asarray(padded), 16)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i) + 100)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("b", [8, 64])
def test_tile_topk_plain_matches_pallas_interpret(monkeypatch, b):
    """The Pallas kernel is exact on values; its ties may reorder, so ids
    are checked by what they point at."""
    monkeypatch.setenv("PIO_PALLAS", "interpret")
    x = _tie_corpus(37, 300, b)
    want_v, want_i = (np.asarray(a) for a in jax_pk.tile_topk_desc(jnp.asarray(x), b))
    got_v, got_i = (a.numpy() for a in hk.tile_topk_desc(torch.from_numpy(x), b))
    np.testing.assert_array_equal(got_v, want_v)
    rows = np.arange(37)[:, None]
    fin = np.isfinite(want_v)
    np.testing.assert_array_equal(x[rows, got_i][fin], got_v[fin])
    np.testing.assert_array_equal(x[rows, np.minimum(want_i, 299)][fin], want_v[fin])


@pytest.mark.parametrize("k", [12, 50])
def test_running_merge_across_tiles_equals_global_topk(k):
    """K3's top-b per tile merged left to right into the carry is exactly
    one lax.top_k over the whole row (every finite entry, ties included)."""
    x = _tie_corpus(9, 64 * 5, k)
    b = block_width(k)
    bs = torch.full((9, b), float("-inf"))
    bi = torch.zeros((9, b), dtype=torch.int32)
    for t in range(5):
        tile = torch.from_numpy(x[:, t * 64:(t + 1) * 64].copy())
        ts, ti = hk.tile_topk_desc(tile, b, id_offset=t * 64)
        bs, bi = merge_desc(bs, bi, ts, ti)
    want_v, want_i = (np.asarray(a) for a in jax.lax.top_k(jnp.asarray(x), b))
    fin = np.isfinite(want_v)
    np.testing.assert_array_equal(bs.numpy().view(np.int32), want_v.view(np.int32))
    np.testing.assert_array_equal(bi.numpy()[fin], want_i[fin])


@pytest.mark.parametrize("bad", ["b", "dtype", "empty", "layout"])
def test_tile_topk_rejects_bad_arguments(bad):
    x = torch.from_numpy(_tie_corpus(6, 40, 1))
    b = 8
    if bad == "b":
        b = 12
    elif bad == "dtype":
        x = x.double()
    elif bad == "empty":
        x = x[:, :0]
    elif bad == "layout":
        x = x.T.contiguous().T
    before = hk.tile_topk_desc.launches
    with pytest.raises((TypeError, ValueError)):
        hk.tile_topk_desc(x, b)
    assert hk.tile_topk_desc.launches == before


# -- K3's carry form: the per-tile top-b with the carry merge fused in --------------


def _carry(r, b, kind, seed):
    """The tiled loop's (-inf, 0) initial carry, or a sorted one with ties
    and a -inf tail whose ids (>= 10**6) cannot be tile columns."""
    if kind == "initial":
        return np.full((r, b), -np.inf, np.float32), np.zeros((r, b), np.int32)
    rng = np.random.default_rng(seed)
    cs = (rng.integers(-8, 8, size=(r, b)) / 2).astype(np.float32)
    cs[:, (3 * b) // 4:] = -np.inf
    cs = -np.sort(-cs, axis=1)
    return cs, (10**6 + rng.permutation(r * b).reshape(r, b)).astype(np.int32)


def _tile_scores(kind, r, w, seed):
    if kind == "ties":
        return _tie_corpus(r, w, seed)
    rng = np.random.default_rng(seed)   # distinct finite scores, a -inf run
    x = rng.permutation(r * w).reshape(r, w).astype(np.float32) / 7
    x[0, 5:] = -np.inf
    return x


def _pointed(x, cs, ci, off, ids):
    """The score each id points at: a carry entry (ids >= 10**6), a tile
    column, or NaN for neither (padding)."""
    out = np.full(ids.shape, np.nan, np.float32)
    for r in range(ids.shape[0]):
        carry = dict(zip(ci[r].tolist(), cs[r].tolist()))
        for j, i in enumerate(ids[r].tolist()):
            if i >= 10**6:
                out[r, j] = carry[i]
            elif 0 <= i - off < x.shape[1]:
                out[r, j] = x[r, i - off]
    return out


@pytest.mark.parametrize("w", [300, 13])
@pytest.mark.parametrize("carry_kind", ["initial", "random"])
@pytest.mark.parametrize("kind", ["distinct", "ties"])
@pytest.mark.parametrize("b", [8, 64])
def test_tile_topk_carry_matches_pallas_then_jax_merge(monkeypatch, b, kind, carry_kind, w):
    """The carry form's plain version against the JAX tiled CCO step with
    its Pallas top-b (interpret mode): ``merge_desc(carry, tile_start +
    tile_topk_desc(scores, b))``."""
    monkeypatch.setenv("PIO_PALLAS", "interpret")
    r, off = 21, 4096
    x = _tile_scores(kind, r, w, b + w)
    cs, ci = _carry(r, b, carry_kind, b)
    ts, ti = jax_pk.tile_topk_desc(jnp.asarray(x), b)
    want_v, want_i = (np.asarray(a) for a in jax_topk.merge_desc(
        jnp.asarray(cs), jnp.asarray(ci), ts, off + ti))
    got_v, got_i = (a.numpy() for a in hk.tile_topk_desc(
        torch.from_numpy(x), b, id_offset=off,
        carry=(torch.from_numpy(cs), torch.from_numpy(ci))))
    if kind == "distinct":
        np.testing.assert_array_equal(got_v.view(np.int32), want_v.view(np.int32))
    else:   # the JAX bitonic network ranks -0.0 and +0.0 as equal
        np.testing.assert_array_equal(got_v, want_v)
    fin = np.isfinite(want_v)
    np.testing.assert_array_equal(_pointed(x, cs, ci, off, got_i)[fin], got_v[fin])
    np.testing.assert_array_equal(_pointed(x, cs, ci, off, want_i)[fin], want_v[fin])
    if kind == "distinct" and carry_kind == "initial":
        np.testing.assert_array_equal(got_i[fin], want_i[fin])


@pytest.mark.parametrize("b", [1, 8, 64])
def test_tile_topk_carry_cpu_is_merge_of_the_unfused_result(b):
    x = torch.from_numpy(_tie_corpus(12, 200, b))
    cs, ci = (torch.from_numpy(a) for a in _carry(12, b, "random", b + 1))
    before = hk.tile_topk_desc.launches
    got = hk.tile_topk_desc(x, b, id_offset=9, carry=(cs, ci))
    assert hk.tile_topk_desc.launches == before   # no kernel launched
    want = merge_desc(cs, ci, *hk.tile_topk_desc(x, b, id_offset=9))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("k, tile", [(12, 64), (12, 50), (50, 64), (50, 37)])
def test_fused_carry_loop_across_tiles_equals_global_topk(k, tile):
    """The tiled loop with K3's carry form, tile by tile from the (-inf, 0)
    carry, is exactly one lax.top_k over the whole row."""
    x = _tie_corpus(9, 64 * 5, k + tile)
    b = block_width(k)
    bs = torch.full((9, b), float("-inf"))
    bi = torch.zeros((9, b), dtype=torch.int32)
    for t0 in range(0, x.shape[1], tile):
        part = torch.from_numpy(x[:, t0:t0 + tile].copy())
        bs, bi = hk.tile_topk_desc(part, b, id_offset=t0, carry=(bs, bi))
    want_v, want_i = (np.asarray(a) for a in jax.lax.top_k(jnp.asarray(x), b))
    fin = np.isfinite(want_v)
    np.testing.assert_array_equal(bs.numpy().view(np.int32), want_v.view(np.int32))
    np.testing.assert_array_equal(bi.numpy()[fin], want_i[fin])


@pytest.mark.parametrize("bad", ["shape", "dtype", "ids", "layout"])
def test_tile_topk_rejects_bad_carry(bad):
    x = torch.from_numpy(_tie_corpus(6, 40, 2))
    cs, ci = (torch.from_numpy(a) for a in _carry(6, 8, "random", 3))
    if bad == "shape":
        cs, ci = cs[:, :4], ci[:, :4]
    elif bad == "dtype":
        cs = cs.double()
    elif bad == "ids":
        ci = ci.to(torch.int64)
    elif bad == "layout":
        cs = cs.T.contiguous().T
    before = hk.tile_topk_desc.launches
    with pytest.raises((TypeError, ValueError)):
        hk.tile_topk_desc(x, 8, carry=(cs, ci))
    assert hk.tile_topk_desc.launches == before


# -- cco_train_indicators against the JAX package ------------------------------------
# (the edge corpora, the strategies and the exact counts are in
# tests/test_torch_cco_counts.py)


@pytest.mark.parametrize("ref", sorted(JAX_ENVS))
@pytest.mark.parametrize("strategy", ["dense", "resident"])
@pytest.mark.parametrize("corpus", REFERENCE_CORPORA)
def test_cco_train_indicators_matches_jax(corpus, strategy, ref):
    check_cco_matches_jax(corpus, strategy, ref)


def test_indicators_from_a_jax_written_localfs_store(fs_storage, tmp_path):
    """A corpus the JAX event server wrote into its localfs store, read by
    the port's UR data source, trains the JAX indicators (dense strategy)."""
    check_jax_written_localfs_store(fs_storage, tmp_path / "store", "dense")
