"""The CCO marginals: ``hopper_kernels.row_counts``, each row's sum of an
item-major int8 matrix into int32, and ``ops/cco.py:_marginal`` on it.

On the CPU the wrapper takes its plain version (a blocked ``torch.sum(...,
dtype=torch.int32)``), held here against a NumPy row sum on 0/1 and
full-range int8 matrices, row-slice views whose row stride exceeds their
width, ragged widths, zero rows and ``accumulate``; the wrapper's checks
raise on what the kernel does not take.  The ``cuda`` cases hold the kernel
(``ops/csrc/row_count.cu``) to the plain version bit for bit at the
benchmark cells' marginal shapes, on unaligned bases and ragged widths, and
count its launches in a dense and a resident train.  The file imports no
JAX, so on a card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_row_counts.py -q -m cuda
"""

import math

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.ops import cco
from predictionio_tpu_torch.ops import hopper_kernels as hk


def _matrix(rows, cols, kind, seed, ld=None):
    """An int8 [rows, cols] matrix (a row-slice view of a [rows, ld] one
    where ``ld`` is given): 0/1 at about 5% ones, or full-range int8."""
    g = np.random.default_rng(seed)
    width = cols if ld is None else ld
    if kind == "binary":
        a = (g.random((rows, width)) < 0.05).astype(np.int8)
    else:
        a = g.integers(-128, 128, (rows, width)).astype(np.int8)
    return torch.from_numpy(a)[:, :cols]


def _numpy_sums(m):
    return m.numpy().astype(np.int64).sum(axis=1)


@pytest.mark.parametrize("kind", ["binary", "full_range"])
@pytest.mark.parametrize("rows, cols, ld", [(5, 17, None), (9, 4_099, None), (3, 32_008, None),
                                            (7, 17, 33), (6, 4_099, 4_115), (4, 32_008, 32_011),
                                            (4_100, 24, None), (0, 40, None), (3, 0, None)])
def test_row_counts_are_numpy_s_row_sums(kind, rows, cols, ld):
    m = _matrix(rows, cols, kind, rows * cols + (ld or 0), ld)
    assert ld is None or m.stride(0) == ld
    before = hk.row_counts.launches
    got = hk.row_counts(m)
    assert got.dtype == torch.int32 and got.shape == (rows,)
    np.testing.assert_array_equal(got.numpy(), _numpy_sums(m))
    np.testing.assert_array_equal(cco._marginal(m).numpy(), _numpy_sums(m))
    assert hk.row_counts.launches == before   # CPU tensors launch nothing


@pytest.mark.parametrize("kind", ["binary", "full_range"])
@pytest.mark.parametrize("rows, cols, ld", [(11, 4_099, None), (5, 32_008, 32_011),
                                            (4_101, 40, None)])
def test_accumulate_adds_into_out_in_place(kind, rows, cols, ld):
    m = _matrix(rows, cols, kind, rows + cols, ld)
    start = torch.from_numpy(np.random.default_rng(rows).integers(
        -1000, 1000, rows).astype(np.int32))
    out = start.clone()
    got = hk.row_counts(m, out, accumulate=True)
    assert got is out
    np.testing.assert_array_equal(out.numpy(), start.numpy() + _numpy_sums(m))
    again = start.clone()
    cco._marginal(m, again, accumulate=True)
    np.testing.assert_array_equal(again.numpy(), out.numpy())
    written = start.clone()
    hk.row_counts(m, written)   # without accumulate, out is overwritten
    np.testing.assert_array_equal(written.numpy(), _numpy_sums(m))


def test_the_wrapper_raises_on_what_the_kernel_does_not_take():
    m = torch.zeros((4, 64), dtype=torch.int8)
    with pytest.raises(TypeError):
        hk.row_counts(m.to(torch.int32))
    with pytest.raises(TypeError):
        hk.row_counts(m.to(torch.uint8))
    with pytest.raises(ValueError):
        hk.row_counts(m[0])
    with pytest.raises(ValueError):
        hk.row_counts(m.reshape(2, 2, 64))
    with pytest.raises(ValueError):   # column-strided
        hk.row_counts(m[:, ::2])
    with pytest.raises(ValueError):   # column-major
        hk.row_counts(torch.zeros((64, 4), dtype=torch.int8).t())
    with pytest.raises(ValueError):
        hk.row_counts(m, accumulate=True)
    with pytest.raises(ValueError):
        hk.row_counts(m, torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        hk.row_counts(m, torch.zeros(5, dtype=torch.int32))
    with pytest.raises(ValueError):
        hk.row_counts(m, torch.zeros((4, 2), dtype=torch.int32)[:, 0])
    with pytest.raises(ValueError):   # mixed devices
        hk.row_counts(m, torch.zeros(4, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        hk.row_counts(torch.zeros((4, 64), dtype=torch.int8, device="meta"))


# -- on a card ------------------------------------------------------------------


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the row-count kernel has no CPU mode")
    from predictionio_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def _card_matrix(dev, rows, cols, kind, seed, ld=None, offset=0):
    """An int8 [rows, cols] view on the card: of a [rows, ld] matrix, its
    base ``offset`` bytes past a 256-byte boundary."""
    g = torch.Generator(device=dev).manual_seed(seed)
    width = cols if ld is None else ld
    flat = torch.empty(rows * width + offset, dtype=torch.int8, device=dev)
    if kind == "binary":
        flat.copy_((torch.rand(flat.shape, generator=g, device=dev) < 0.05).to(torch.int8))
    else:
        flat.random_(-128, 128, generator=g)
    return flat[offset:].view(rows, width)[:, :cols]


#: (rows, cols, ld, base offset): the cells' marginal shapes (8k's chunk
#: [8,192 x 32,000]; the 100k and 131k tiles), few long rows, and rows
#: long and short on ragged widths and unaligned bases
CARD_SHAPES = [(8_192, 32_000, None, 0), (4_096, 100_096, None, 0), (4_096, 200_064, None, 0),
               (5, 200_064, None, 0), (37, 32_008, 32_011, 3), (4_100, 4_099, None, 1),
               (9_000, 4_095, 4_101, 1), (3, 17, None, 5), (2_111, 4_096, 4_113, 7),
               (64, 15, None, 0), (8, 0, None, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["binary", "full_range"])
@pytest.mark.parametrize("rows, cols, ld, offset", CARD_SHAPES)
def test_the_kernel_is_the_plain_version_bit_for_bit(dev, kind, rows, cols, ld, offset):
    m = _card_matrix(dev, rows, cols, kind, rows + cols + offset, ld, offset)
    before = hk.row_counts.launches
    got = hk.row_counts(m)
    start = torch.arange(rows, dtype=torch.int32, device=dev) * 7 - 1000
    added = hk.row_counts(m, start.clone(), accumulate=True)
    torch.cuda.synchronize()
    assert hk.row_counts.launches == before + 2
    want = hk.row_counts_plain(m)
    assert torch.equal(got, want)
    assert torch.equal(added, start + want)


def _pairs(seed, n_users, n_items, n):
    g = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n_items + 1) ** 0.871
    return (g.integers(0, n_users, n).astype(np.int32),
            g.choice(n_items, n, p=w / w.sum()).astype(np.int32))


def _card_train(n_users, n_items, item_tile):
    """A primary (its self-indicator) and one other type on the card."""
    pu, pi = _pairs(1, n_users, n_items, 6_000)
    au, ai = _pairs(2, n_users, n_items + 37, 9_000)
    return cco.cco_train_indicators(
        pu, pi, [("buy", pu, pi, n_items), ("view", au, ai, n_items + 37)],
        n_users, n_items, top_k=8, exclude_self_for="buy", item_tile=item_tile,
        device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["dense", "resident"])
def test_a_train_launches_the_kernel_for_every_marginal(dev, monkeypatch, route):
    """Dense: two launches a user chunk and type (``rc`` and ``cc``, added
    in place).  Resident: one a tile and type, and the primary's ``rc``
    once.  The tables equal those of the plain sums bit for bit."""
    n_users, n_items, tile = 900, 300, 128
    monkeypatch.setenv("PIO_CCO_SPARSE", "off")
    monkeypatch.setenv("PIO_CCO_DENSE", "on" if route == "dense" else "off")
    monkeypatch.setattr(cco, "_DENSE_CHUNK_BYTES", (n_items + 384) * 2 * 256)
    cco.reset_strategy_counts()
    before = hk.row_counts.launches
    got = _card_train(n_users, n_items, tile)
    launches = hk.row_counts.launches - before
    assert cco.strategy_by_type[route] == 2
    if route == "dense":
        assert cco.dense_chunks > 2
        assert launches == 2 * cco.dense_chunks
    else:
        assert launches == math.ceil(n_items / tile) + math.ceil((n_items + 37) / tile) + 1
    monkeypatch.setattr(cco, "row_counts", hk.row_counts_plain)
    want = _card_train(n_users, n_items, tile)
    assert hk.row_counts.launches - before == launches
    for name in ("buy", "view"):
        np.testing.assert_array_equal(got[name][1], want[name][1])
        np.testing.assert_array_equal(got[name][0].view(np.int32), want[name][0].view(np.int32))
