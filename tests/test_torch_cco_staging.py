"""Where the CCO driver stages its event pairs: the tiled strategies take
a blocked layout to the device as it is and flatten it there
(``_flatten_blocked_on``), the flat-pair entries copy ids in their own
width and widen them there, and ``staging_by_route`` counts each staging
by its route.

The host flatten (``_flatten_blocked``) is the oracle: the device route
keeps exactly its pairs, in its order, and the tables of both routes are
equal bit for bit on the resident and the chunked strategy, self-pair and
two types, over layouts with holes in the mask, duplicate pairs, an empty
block, a short last block and user blocks that are not a multiple of 8.
The file imports no JAX: its card test runs where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.ops import cco

CPU = torch.device("cpu")


def random_events(n_users, n_items, n_events, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_users, n_events).astype(np.int32),
            rng.integers(0, n_items, n_events).astype(np.int32))


@pytest.fixture()
def tiled(monkeypatch):
    """The tiled strategies on the CPU: neither the dense strategy nor the
    host sparse runner."""
    monkeypatch.setenv("PIO_CCO_DENSE", "off")
    monkeypatch.setenv("PIO_CCO_SPARSE", "off")
    return monkeypatch


def assert_same_tables(a, b):
    np.testing.assert_array_equal(np.asarray(a[0], np.float32).view(np.int32),
                                  np.asarray(b[0], np.float32).view(np.int32))
    np.testing.assert_array_equal(a[1], b[1])


def holey_layout(n_users, n_items, user_block, seed, n_events=600):
    """A blocked layout as a caller may hold it: each block's pairs spread
    over its padded width with zero-mask entries between them (holding
    junk ids), a share of pairs repeated, block 1 empty, and the last block
    short when ``n_users`` is not a multiple of ``user_block``.  Masked-out
    items run past the catalog: a route that kept one would fail."""
    rng = np.random.default_rng(seed)
    u, i = random_events(n_users, n_items, n_events, seed)
    dup = rng.integers(0, n_events, n_events // 5)
    u, i = np.concatenate([u, u[dup]]), np.concatenate([i, i[dup]])
    blk = u // user_block
    if blk.max() >= 1:
        drop = blk == 1
        u, i, blk = u[~drop], i[~drop], blk[~drop]
    n_blocks = -(-n_users // user_block)
    sizes = np.bincount(blk, minlength=n_blocks)
    width = int(2 * sizes.max() + 3)
    lu = rng.integers(0, user_block, (n_blocks, width)).astype(np.int32)
    it = rng.integers(0, 2 * n_items, (n_blocks, width)).astype(np.int32)
    mask = np.zeros((n_blocks, width), np.float32)
    for b in range(n_blocks):
        sel = np.flatnonzero(blk == b)
        at = np.sort(rng.choice(width, len(sel), replace=False))
        lu[b, at] = u[sel] - b * user_block
        it[b, at] = i[sel]
        mask[b, at] = rng.choice([1.0, 0.5, 2.0], len(sel))
    mask[mask == 0] = rng.choice([0.0, -1.0], int((mask == 0).sum()))
    return cco.BlockedInteractions(lu, it, mask, n_users, n_items, user_block)


#: (n_users, n_items_p, n_items_t, user_block): a short last block with
#: blocks of 16; blocks of 10 and 13, not multiples of 8
SHAPES = [(60, 21, 13, 16), (45, 17, 11, 10), (70, 19, 23, 13)]


@pytest.mark.parametrize("shape", SHAPES)
def test_device_flatten_keeps_the_host_flattens_pairs_in_order(shape):
    n_users, n_items, _, block = shape
    layout = holey_layout(n_users, n_items, block, seed=block)
    want_u, want_i = cco._flatten_blocked(layout)
    got_u, got_i = cco._flatten_blocked_on(layout, CPU)
    assert got_u.dtype == got_i.dtype == torch.int64
    np.testing.assert_array_equal(got_u.numpy(), want_u)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    assert len(want_u) and len(want_u) < layout.mask.size


@pytest.mark.parametrize("shape", SHAPES)
def test_resident_primary_from_the_layout_is_the_oracles(shape):
    n_users, n_items, _, block = shape
    layout = holey_layout(n_users, n_items, block, seed=block + 1)
    got = cco._ResidentPrimary(layout, n_users, n_items, CPU)
    want = cco._ResidentPrimary(cco._flatten_blocked(layout), n_users, n_items, CPU)
    assert torch.equal(got.pt, want.pt) and torch.equal(got.rc, want.rc)


@pytest.mark.parametrize("strategy", ["resident", "chunked"])
@pytest.mark.parametrize("self_pair", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_blocked_route_tables_equal_the_host_flatten_oracle(tiled, shape, self_pair,
                                                            strategy):
    """``cco_indicators`` on layouts against ``cco_indicators_coo`` on their
    host-flattened pairs, the same strategy: bit for bit; every staging
    of the layouts ran on the device."""
    n_users, n_ip, n_it, block = shape
    if strategy == "chunked":
        tiled.setattr(cco, "_TILED_P_BYTES", 0)
    p = holey_layout(n_users, n_ip, block, seed=3 * block)
    a = p if self_pair else holey_layout(n_users, n_it, block, seed=3 * block + 1)
    pu, pi = cco._flatten_blocked(p)
    au, ai = (pu, pi) if self_pair else cco._flatten_blocked(a)
    kw = dict(top_k=5, item_tile=8, exclude_self=self_pair, device="cpu")
    want = cco.cco_indicators_coo(pu, pi, au, ai, n_users, n_ip, a.n_items,
                                  user_block=block, **kw)
    cco.reset_staging_counts()
    got = cco.cco_indicators(p, a, None, None, n_users, **kw)
    assert cco.staging_by_route == {"blocked_on_device": 1 if self_pair else 2,
                                    "pairs_on_device": 0, "host_flatten": 0}
    assert_same_tables(got, want)
    assert (got[1] >= 0).any()


def test_dense_route_flattens_on_the_host(monkeypatch):
    """The dense strategy and the host sparse runner take host pairs: the
    layout is flattened on the host, and its tables are the tiled route's."""
    n_users, n_items, _, block = SHAPES[0]
    layout = holey_layout(n_users, n_items, block, seed=5)
    kw = dict(top_k=5, item_tile=8, exclude_self=True, device="cpu")
    monkeypatch.setenv("PIO_CCO_DENSE", "off")
    monkeypatch.setenv("PIO_CCO_SPARSE", "off")
    tiled = cco.cco_indicators(layout, layout, None, None, n_users, **kw)
    for sparse in ("on", "off"):
        monkeypatch.setenv("PIO_CCO_DENSE", "on")
        monkeypatch.setenv("PIO_CCO_SPARSE", sparse)
        cco.reset_staging_counts()
        dense = cco.cco_indicators(layout, layout, None, None, n_users, **kw)
        assert cco.staging_by_route["host_flatten"] == 1
        assert cco.staging_by_route["blocked_on_device"] == 0
        assert_same_tables(dense, tiled)


def test_blocked_chunked_route_over_a_one_process_mesh(tiled):
    """Over a mesh the chunked strategy takes this rank's share of the
    layout's pairs on the device: the tables of no mesh."""
    from predictionio_tpu_torch.parallel.mesh import MeshSpec, create_mesh

    n_users, n_ip, n_it, block = SHAPES[2]
    p = holey_layout(n_users, n_ip, block, seed=8)
    a = holey_layout(n_users, n_it, block, seed=9)
    kw = dict(top_k=4, item_tile=8, device="cpu")
    plain = cco.cco_indicators(p, a, None, None, n_users, **kw)
    cco.reset_staging_counts()
    meshed = cco.cco_indicators(p, a, None, None, n_users,
                                mesh=create_mesh(MeshSpec(dp=1)), **kw)
    assert cco.staging_by_route["blocked_on_device"] == 2
    assert_same_tables(meshed, plain)


# -- the flat-pair entry ------------------------------------------------------------


def ur_pairs(seed):
    n_users, n_p, n_v = 50, 30, 40
    pu, pi = random_events(n_users, n_p, 300, seed)
    vu, vi = random_events(n_users, n_v, 700, seed + 1)
    return n_users, n_p, n_v, (pu, pi), (vu, vi)


@pytest.mark.parametrize("strategy", ["dense", "resident", "chunked"])
def test_int32_and_int64_pairs_give_the_same_tables(tiled, strategy):
    n_users, n_p, n_v, (pu, pi), (vu, vi) = ur_pairs(21)
    if strategy == "dense":
        tiled.setenv("PIO_CCO_DENSE", "on")
    elif strategy == "chunked":
        tiled.setattr(cco, "_TILED_P_BYTES", 0)

    def train(cast):
        p_u, p_i = cast(pu), cast(pi)
        others = [("purchase", p_u, p_i, n_p), ("view", cast(vu), cast(vi), n_v)]
        return cco.cco_train_indicators(p_u, p_i, others, n_users, n_p, top_k=5,
                                        item_tile=8, user_block=16,
                                        exclude_self_for="purchase", device="cpu")

    cco.reset_staging_counts()
    narrow = train(lambda x: x.astype(np.int32))
    assert cco.staging_by_route["pairs_on_device"] >= 2
    assert cco.staging_by_route["blocked_on_device"] == 0
    wide = train(lambda x: x.astype(np.int64))
    for name in ("purchase", "view"):
        assert_same_tables(narrow[name], wide[name])


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("bad", ["user_low", "user_high", "item_low", "item_high"])
def test_check_ids_still_raises_on_out_of_range_ids(tiled, dtype, bad):
    n_users, n_p, n_v, (pu, pi), (vu, vi) = ur_pairs(22)
    vu, vi = vu.astype(dtype), vi.astype(dtype)
    which, end = bad.split("_")
    arr = vu if which == "user" else vi
    arr[7] = -1 if end == "low" else (n_users if which == "user" else n_v)
    with pytest.raises(ValueError, match=f"view: {which} ids outside"):
        cco.cco_train_indicators(pu.astype(dtype), pi.astype(dtype),
                                 [("view", vu, vi, n_v)], n_users, n_p, top_k=5,
                                 item_tile=8, device="cpu")


def test_staged_pairs_leave_the_callers_arrays_as_they_were(tiled):
    """On the CPU an int64 array is staged without a copy: nothing the
    staging does writes to it."""
    n_users, n_p, _, (pu, pi), _ = ur_pairs(23)
    pu, pi = pu.astype(np.int64), pi.astype(np.int64)
    before = pu.copy(), pi.copy()
    cco.cco_train_indicators(pu, pi, [("purchase", pu, pi, n_p)], n_users, n_p,
                             top_k=5, item_tile=8, exclude_self_for="purchase",
                             device="cpu")
    np.testing.assert_array_equal(pu, before[0])
    np.testing.assert_array_equal(pi, before[1])


# -- on the card ----------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_resident_primary_from_the_layout_on_the_card(shape):
    """The densified primary the card builds from the layout is the host
    flatten's, densified on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: compares the card's staging with the CPU's")
    n_users, n_items, _, block = shape
    layout = holey_layout(n_users, n_items, block, seed=block + 2)
    card = torch.device("cuda")
    got = cco._ResidentPrimary(layout, n_users, n_items, card)
    want = cco._ResidentPrimary(cco._flatten_blocked(layout), n_users, n_items, CPU)
    assert torch.equal(got.pt.cpu(), want.pt) and torch.equal(got.rc.cpu(), want.rc)
