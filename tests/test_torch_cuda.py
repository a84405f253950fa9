"""The port's CUDA kernels against their plain PyTorch versions, on a card.

A hand-written CUDA kernel has no CPU mode, so these tests skip without a
card.  They import no JAX, so they also run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest sets JAX up.)
"""

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.ops import hopper_kernels as hk

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from predictionio_tpu_torch.device import resolve_device

    return resolve_device("cuda")


@pytest.mark.parametrize("mask_dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("shape", [(5, 12, 300), (1, 32, 100_000),
                                   (17, 33, 1001), (64, 32, 100_000)])
def test_masked_score_kernel_matches_plain(dev, shape, with_bias, mask_dtype):
    b, k, n = shape
    rng = np.random.default_rng(sum(shape))
    u = torch.from_numpy(rng.normal(size=(b, k)).astype(np.float32)).to(dev)
    v = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32)).to(dev)
    mask = torch.from_numpy(rng.random((b, n)) < 0.1).to(dev, mask_dtype)
    bias = (torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dev)
            if with_bias else None)
    before = hk.masked_score_matmul.launches
    got = hk.masked_score_matmul(u, v, mask, bias)
    want = hk.masked_score_matmul_plain(u, v, mask, bias)
    torch.cuda.synchronize()
    assert hk.masked_score_matmul.launches == before + 1
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-5)


def _strided_mask(hit, dtype):
    """``hit`` in the layout ALS serving hands K1: ``exclusion_mask``'s
    row-strided view (stride I + 1), in ``dtype``."""
    from predictionio_tpu_torch.ops.als import exclusion_mask

    b, n = hit.shape
    ids = torch.where(hit, torch.arange(n, device=hit.device), -1)
    mask = exclusion_mask(ids, n, hit.device)
    if dtype == torch.bool:
        return mask.view(torch.bool)
    if dtype == torch.uint8:
        return mask
    wide = torch.zeros((b, n + 1), dtype=dtype, device=hit.device)
    wide[:, :n] = mask
    return wide[:, :n]


@pytest.mark.parametrize("mask_dtype", [torch.uint8, torch.bool, torch.float32])
@pytest.mark.parametrize("shape", [(1, 32, 100_000), (8, 33, 4099), (9, 32, 100_003),
                                   (17, 12, 100_000), (32, 32, 257), (33, 1, 4099),
                                   (64, 32, 100_000), (65, 33, 100_001)])
def test_masked_score_kernel_strided_mask(dev, shape, mask_dtype):
    """The streaming (B <= 8) and tiled paths on the main path's mask layout,
    whose rows start at every alignment, K and I no multiple of 4."""
    b, k, n = shape
    g = torch.Generator(device=dev).manual_seed(b * k + n)
    u = torch.randn(b, k, generator=g, device=dev)
    v = torch.randn(n, k, generator=g, device=dev)
    mask = _strided_mask(torch.rand(b, n, generator=g, device=dev) < 0.1, mask_dtype)
    assert b == 1 or mask.stride(0) == n + 1
    got = hk.masked_score_matmul(u, v, mask)
    want = hk.masked_score_matmul_plain(u, v, mask)
    torch.cuda.synchronize()
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-5)


def _llr_inputs(dev, r, c, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    counts = torch.randint(0, 8, (r, c), generator=g, device=dev, dtype=torch.int32)
    counts *= torch.rand(r, c, generator=g, device=dev) < 0.3
    row = counts.sum(1, dtype=torch.int32) + torch.randint(
        0, 60, (r,), generator=g, device=dev, dtype=torch.int32)
    col = counts.sum(0, dtype=torch.int32) + torch.randint(
        0, 60, (c,), generator=g, device=dev, dtype=torch.int32)
    return counts, row, col, float(int(row.sum()) + 1000)


@pytest.mark.parametrize("thr", [0.0, 2.0])
@pytest.mark.parametrize("shape", [(37, 190), (1000, 4096), (8192, 1027)])
def test_llr_masked_kernel_matches_plain(dev, shape, thr):
    counts, row, col, n = _llr_inputs(dev, *shape, seed=sum(shape))
    before = hk.llr_masked_scores.launches
    got = hk.llr_masked_scores(counts, row, col, n, thr)
    want = hk.llr_masked_scores_plain(counts, row, col, n, thr)
    torch.cuda.synchronize()
    assert hk.llr_masked_scores.launches == before + 1
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-4, atol=1e-4)
    assert torch.equal(got, want)                    # bit for bit


def _sparse_llr_inputs(dev, r, c, seed):
    """Counts at the training tiles' sparsity: ~0.3% nonzero, every fifth
    row all zero."""
    g = torch.Generator(device=dev).manual_seed(seed)
    counts = torch.randint(1, 40, (r, c), generator=g, device=dev, dtype=torch.int32)
    counts *= torch.rand(r, c, generator=g, device=dev) < 0.003
    counts[::5] = 0
    row = counts.sum(1, dtype=torch.int32) + torch.randint(
        1, 60, (r,), generator=g, device=dev, dtype=torch.int32)
    col = counts.sum(0, dtype=torch.int32) + torch.randint(
        1, 60, (c,), generator=g, device=dev, dtype=torch.int32)
    return counts, row, col, float(int(row.sum()) + 1000)


@pytest.mark.parametrize("layout", ["packed", "strided"])
@pytest.mark.parametrize("shape", [(37, 190), (2000, 4096), (300, 4099)])
def test_llr_masked_kernel_sparse_counts_bit_equal(dev, shape, layout):
    """The zero-skipping path on training-sparse counts, packed and as a
    row-strided view whose stride is no multiple of 4 (rows that start off
    16-byte alignment, each by its own shift)."""
    r, c = shape
    counts, row, col, n = _sparse_llr_inputs(dev, r, c, seed=r + c)
    assert (counts == 0).float().mean().item() >= 0.99
    if layout == "strided":
        wide = torch.zeros((r, c + 3), dtype=torch.int32, device=dev)
        wide[:, 1:c + 1] = counts
        counts = wide[:, 1:c + 1]
        assert counts.stride(0) % 4 != 0
    for thr in (0.0, 2.0):
        got = hk.llr_masked_scores(counts, row, col, n, thr)
        want = hk.llr_masked_scores_plain(counts, row, col, n, thr)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def _topk_rows(dev, kind, r, w, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    if kind == "ties":
        s = torch.round(torch.randn(r, w, generator=g, device=dev) * 4) / 4
        s[:, ::5] = float("-inf")
        s[0, : w // 2] = float("-inf")
        s[-1] = 0.5
    elif kind == "sparse":      # the training tiles: -inf but a few finite
        s = torch.full((r, w), float("-inf"), device=dev)
        keep = torch.rand(r, w, generator=g, device=dev) < 0.002
        s[keep] = torch.rand(int(keep.sum()), generator=g, device=dev) * 50
        s[1] = float("-inf")                        # all -inf
    else:                       # ascending: every key passes the pre-filter
        s = torch.arange(w, device=dev, dtype=torch.float32).repeat(r, 1) / 7
        s[0] = torch.arange(w, device=dev, dtype=torch.float32) // 3   # ties
    return s


@pytest.mark.parametrize("b", [1, 8, 64, 1024])
@pytest.mark.parametrize("shape", [(37, 300), (1000, 4096), (3, 300_000), (5, 6)])
def test_tile_topk_kernel_matches_plain(dev, shape, b):
    r, w = shape
    s = _topk_rows(dev, "ties", r, w, r + w + b)
    before = hk.tile_topk_desc.launches
    got_v, got_i = hk.tile_topk_desc(s, b, id_offset=7)
    want_v, want_i = hk.tile_topk_desc_plain(s, b, id_offset=7)
    torch.cuda.synchronize()
    assert hk.tile_topk_desc.launches == before + 1
    assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)


@pytest.mark.parametrize("b", [8, 64, 1024])
@pytest.mark.parametrize("kind", ["sparse", "ascending"])
@pytest.mark.parametrize("shape", [(500, 4096), (7, 1031)])
def test_tile_topk_kernel_adversarial_rows(dev, shape, kind, b):
    r, w = shape
    s = _topk_rows(dev, kind, r, w, r + w + b)
    if kind == "ascending":
        s = s[:, 1:]                       # rows that start off 16-byte alignment
    got_v, got_i = hk.tile_topk_desc(s, b, id_offset=3)
    want_v, want_i = hk.tile_topk_desc_plain(s, b, id_offset=3)
    torch.cuda.synchronize()
    assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)


@pytest.mark.parametrize("carry_kind", ["initial", "random"])
@pytest.mark.parametrize("kind", ["ties", "sparse", "ascending"])
@pytest.mark.parametrize("b", [8, 64, 1024])
def test_tile_topk_kernel_carry_equals_merge(dev, b, kind, carry_kind):
    """The fused carry form against merge_desc over the unfused result."""
    from predictionio_tpu_torch.ops.topk import merge_desc

    r, w = 300, 2500
    s = _topk_rows(dev, kind, r, w, b + w)
    if carry_kind == "initial":            # the tiled loop's starting carry
        cs = torch.full((r, b), float("-inf"), device=dev)
        ci = torch.zeros((r, b), dtype=torch.int32, device=dev)
    else:                                  # a sorted carry with ties and -inf
        g = torch.Generator(device=dev).manual_seed(b)
        cs = torch.round(torch.randn(r, b, generator=g, device=dev) * 2) / 2
        cs[:, b // 2:] = float("-inf")
        cs = torch.sort(cs, dim=1, descending=True).values
        ci = torch.randint(0, 10**6, (r, b), generator=g, device=dev, dtype=torch.int32)
    before = hk.tile_topk_desc.launches
    got_v, got_i = hk.tile_topk_desc(s, b, id_offset=5000, carry=(cs, ci))
    assert hk.tile_topk_desc.launches == before + 1
    want_v, want_i = merge_desc(cs, ci, *hk.tile_topk_desc_plain(s, b, id_offset=5000))
    torch.cuda.synchronize()
    assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)


def _basket_corpus(seed, n_items, n_events, n_baskets):
    rng = np.random.default_rng(seed)
    b = np.sort(rng.integers(0, n_baskets, n_events)).astype(np.int32)
    i = (rng.zipf(1.3, n_events) % n_items).astype(np.int32)
    return b, i, int(b.max()) + 1


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("shape", [(300, 5000, 2000), (3000, 40_000, 15_000)])
def test_basket_rules_kernel_route_matches_plain(dev, monkeypatch, shape, tiled):
    """``basket_rules`` on the card (the int8 count product, K3 without a
    carry on the dense strategy, K3's carry form a tile on the tiled one)
    against the same call on the CPU (the plain K3): ids and lifts
    bit-equal, one K3 launch a tile."""
    from predictionio_tpu_torch.ops import cco

    n_items, n_events, n_baskets = shape
    b, i, nb = _basket_corpus(n_items, n_items, n_events, n_baskets)
    tile = 512
    if tiled:
        monkeypatch.setattr(cco, "_BASKET_RULES_DENSE_MAX_ITEMS", 64)
    before = hk.tile_topk_desc.launches
    got = cco.basket_rules(b, i, nb, n_items, top_k=20, min_support=1e-4,
                           item_tile=tile, device="cuda")
    launches = hk.tile_topk_desc.launches - before
    want = cco.basket_rules(b, i, nb, n_items, top_k=20, min_support=1e-4,
                            item_tile=tile, device="cpu")
    assert launches == (-(-n_items // tile) if tiled else 1)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    assert (got[1] >= 0).sum() > 0
