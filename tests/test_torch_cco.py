"""The port's CCO training op and the plain versions of its kernels (K2
LLR, K3 top-k) against the JAX package.

The same seeded numpy inputs go through the JAX function (its Pallas
kernels in interpret mode, as tests/test_pallas_kernels.py runs them, or
its plain XLA path) and through the port on CPU tensors, which take the
kernels' plain PyTorch versions.  Tolerances: LLR scores within rtol/atol
1e-4 (the reference's own Pallas-vs-XLA bar; f32 log1p differs across
frameworks in the last bits) with -inf positions exact; top-k values and
ids exact against ``lax.top_k``.  The op runs here on the reference
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
from predictionio_tpu_torch.ops import cco as port_cco
from predictionio_tpu_torch.ops import hopper_kernels as hk
from predictionio_tpu_torch.ops.topk import block_width, merge_desc

from _torch_cco_cases import ATOL, JAX_ENVS, REFERENCE_CORPORA, RTOL, check_cco_matches_jax


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


# -- cco_train_indicators against the JAX package ------------------------------------
# (the edge corpora, the strategies and the exact counts are in
# tests/test_torch_cco_counts.py)


@pytest.mark.parametrize("ref", sorted(JAX_ENVS))
@pytest.mark.parametrize("strategy", ["dense", "resident"])
@pytest.mark.parametrize("corpus", REFERENCE_CORPORA)
def test_cco_train_indicators_matches_jax(corpus, strategy, ref):
    check_cco_matches_jax(corpus, strategy, ref)
