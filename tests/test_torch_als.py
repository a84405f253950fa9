"""The port's ALS training and its e-commerce rule serving ops against the
JAX package.

Inputs are seeded numpy arrays handed to both packages.  The port draws
its initial factors from a ``torch.Generator`` (JAX from ``PRNGKey``,
which torch cannot reproduce), so the parity cases start both from JAX's
``_als_init`` arrays: the dual layout equal array for array at dp in
{1, 2, 8}; each half-step, explicit and implicit, and the sweeps within
rtol 1e-4, atol 1e-5 (f32 sums in another order: the port's batched
per-row products against XLA's segment-summed outer products).  On the
port's own seed the corpora of tests/test_als.py meet JAX's bars: RMSE <
0.15 and a relative error < 5e-3 against a float64 direct solve.  The
rule ops equal JAX's ``recommend_scores_rules`` family: ids exact away from
ties, scores within rtol 1e-5, atol 1e-6.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as jax_als
from predictionio_tpu_torch.ops import als

CPU = torch.device("cpu")
RTOL, ATOL = 1e-4, 1e-5


def ratings(n_u=60, n_i=40, n_e=1500, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_u, n_e).astype(np.int32),
            rng.integers(0, n_i, n_e).astype(np.int32),
            rng.integers(1, 6, n_e).astype(np.float32), n_u, n_i)


def synthetic_ratings(n_users=40, n_items=30, k_true=4, density=0.5, seed=0):
    """tests/test_als.py's low-rank corpus."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n_users, k_true))
    Y = rng.normal(size=(n_items, k_true))
    R = X @ Y.T
    mask = rng.random((n_users, n_items)) < density
    u, i = np.nonzero(mask)
    return u.astype(np.int32), i.astype(np.int32), R[u, i].astype(np.float32), R, mask


def implicit_counts(n_users=30, n_items=20, seed=0):
    """tests/test_als.py's implicit-count corpus."""
    rng = np.random.default_rng(seed)
    R = np.zeros((n_users, n_items), np.float32)
    for _ in range(200):
        R[rng.integers(n_users), rng.integers(n_items)] += rng.integers(1, 5)
    u, i = np.nonzero(R)
    return u.astype(np.int32), i.astype(np.int32), R[u, i].astype(np.float32), R


def jax_init(data, k, seed=7):
    x0, y0 = jax_als._als_init(data, k, seed)
    return np.array(x0), np.array(y0)


@pytest.fixture()
def jax_init_in_port(monkeypatch):
    """The port's ``_als_init`` returns JAX's arrays for the same layout."""
    def init(data, k, seed):
        jd = jax_als.prepare_als_data(np.zeros(0, np.int32), np.zeros(0, np.int32),
                                      np.zeros(0, np.float32), data.n_users,
                                      data.n_items, data.dp)
        return tuple(torch.as_tensor(a) for a in jax_init(jd, k, seed))

    monkeypatch.setattr(als, "_als_init", init)


@pytest.mark.parametrize("dp", [1, 2, 8])
def test_prepare_als_data_equals_jax(dp):
    u, i, r, n_u, n_i = ratings(n_u=33, n_i=17, n_e=301)
    got = als.prepare_als_data(u, i, r, n_u, n_i, dp)
    want = jax_als.prepare_als_data(u, i, r, n_u, n_i, dp)
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, f.name
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        else:
            assert g == w, f.name


@pytest.mark.parametrize("implicit,alpha", [(False, 1.0), (True, 1.0), (True, 2.5)])
def test_fingerprint_equals_jax(implicit, alpha):
    u, i, r, n_u, n_i = ratings()
    got = als.als_fingerprint(als.prepare_als_data(u, i, r, n_u, n_i, 1), 6, 0.05, 7,
                              implicit, alpha)
    assert got == jax_als.als_fingerprint(
        jax_als.prepare_als_data(u, i, r, n_u, n_i, 1), 6, 0.05, 7, implicit, alpha)


@pytest.mark.parametrize("side", ["user", "item"])
@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("scratch", [als.SCRATCH_BYTES, 2_000])
def test_half_step_matches_jax(side, implicit, scratch):
    """One half-step from the same opposite factors; a 2,000-byte scratch
    sends the wider rows through the sliced sum."""
    u, i, r, n_u, n_i = ratings()
    data = jax_als.prepare_als_data(u, i, r, n_u, n_i, 1)
    k, reg, alpha = 6, 0.05, 2.0
    rng = np.random.default_rng(3)
    if side == "user":
        ev = (data.u_user_local[0], data.u_item_flat[0], data.u_rating[0], data.u_mask[0])
        other, rows = rng.normal(size=(data.item_rows, k)).astype(np.float32), data.user_rows
    else:
        ev = (data.i_item_local[0], data.i_user_flat[0], data.i_rating[0], data.i_mask[0])
        other, rows = rng.normal(size=(data.user_rows, k)).astype(np.float32), data.item_rows
    if scratch < als.SCRATCH_BYTES:
        assert als._d_cap(k, scratch) < np.bincount(ev[0]).max()
    if implicit:
        gram = other.T @ other
        want = jax_als._half_step_implicit(jnp.asarray(other), jnp.asarray(gram),
                                           *map(jnp.asarray, ev), rows, reg, alpha)
        got = als._half_step_implicit(torch.as_tensor(other), torch.as_tensor(gram),
                                      *ev, rows, reg, alpha, scratch_bytes=scratch)
    else:
        want = jax_als._half_step(jnp.asarray(other), *map(jnp.asarray, ev), rows, reg)
        got = als._half_step(torch.as_tensor(other), *ev, rows, reg, scratch_bytes=scratch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("implicit", [False, True])
def test_sweeps_match_jax_from_the_same_init(implicit):
    u, i, r, n_u, n_i = ratings()
    data = als.prepare_als_data(u, i, r, n_u, n_i, 1)
    jdata = jax_als.prepare_als_data(u, i, r, n_u, n_i, 1)
    x0, y0 = jax_init(jdata, 6)
    xw, yw = jax_als._als_sweeps(jdata, jnp.asarray(x0), jnp.asarray(y0), 10, 0.05,
                                 None, implicit=implicit, alpha=2.0)
    x, y = als._als_sweeps(data, torch.as_tensor(x0), torch.as_tensor(y0), 10, 0.05,
                           implicit=implicit, alpha=2.0)
    np.testing.assert_allclose(x.numpy(), np.asarray(xw), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(yw), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("implicit", [False, True])
def test_als_train_matches_jax_from_the_same_init(jax_init_in_port, implicit):
    u, i, r, n_u, n_i = ratings(seed=4)
    X, Y = als.als_train(als.prepare_als_data(u, i, r, n_u, n_i, 1), k=5, reg=0.05,
                         iterations=8, implicit=implicit, alpha=1.5, device="cpu")
    Xw, Yw = jax_als.als_train(jax_als.prepare_als_data(u, i, r, n_u, n_i, 1), k=5,
                               reg=0.05, iterations=8, implicit=implicit, alpha=1.5)
    assert X.shape == (n_u, 5) and Y.shape == (n_i, 5) and X.dtype == np.float32
    np.testing.assert_allclose(X, Xw, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(Y, Yw, rtol=RTOL, atol=ATOL)


def test_init_is_seeded_and_zeroes_the_padding_rows():
    u, i, r, n_u, n_i = ratings(n_i=17)
    data = als.prepare_als_data(u, i, r, n_u, n_i, 1)
    x0, y0 = als._als_init(data, 4, 7)
    again = als._als_init(data, 4, 7)[1]
    assert torch.equal(y0, again) and not torch.equal(y0, als._als_init(data, 4, 8)[1])
    assert x0.shape == (1, data.user_rows, 4) and not x0.any()
    d8 = als.prepare_als_data(u, i, r, n_u, n_i, 8)
    y8 = als._als_init(d8, 4, 7)[1]
    item = np.arange(d8.item_rows)[None, :] * 8 + np.arange(8)[:, None]
    assert not y8[torch.as_tensor(item >= n_i)].any()
    assert y8[torch.as_tensor(item < n_i)].abs().sum(-1).min() > 0


def test_reconstructs_ratings_on_the_ports_seed():
    """JAX's bar (tests/test_als.py:52): RMSE < 0.15 on the observed cells."""
    u, i, r, R, mask = synthetic_ratings()
    X, Y = als.als_train(als.prepare_als_data(u, i, r, 40, 30, 1), k=8, reg=0.01,
                         iterations=12, device="cpu")
    assert X.shape == (40, 8) and Y.shape == (30, 8)
    assert float(np.sqrt(np.mean(((X @ Y.T)[mask] - R[mask]) ** 2))) < 0.15


def test_implicit_matches_direct_solve_on_the_ports_seed():
    """JAX's bar (tests/test_als.py:135): relative error < 5e-3 against a
    float64 per-row direct solve from the port's own initial factors."""
    u, i, r, R = implicit_counts()
    k, reg, alpha, iters = 4, 0.05, 2.0, 6
    data = als.prepare_als_data(u, i, r, *R.shape, 1)
    X, Y = als.als_train(data, k=k, reg=reg, iterations=iters, seed=7,
                         implicit=True, alpha=alpha, device="cpu")
    y = als._als_init(data, k, 7)[1].numpy().reshape(-1, k)[: R.shape[1]].astype(np.float64)
    x = np.zeros((R.shape[0], k))
    c1, p = alpha * R, (R > 0).astype(np.float64)
    for _ in range(iters):
        for side in range(2):
            fixed, rows, c, pp = (y, R.shape[0], c1, p) if side == 0 else (x, R.shape[1], c1.T, p.T)
            g = fixed.T @ fixed
            out = np.zeros((rows, k))
            for e in range(rows):
                a = g + (fixed * c[e][:, None]).T @ fixed + (
                    reg * max((pp[e] > 0).sum(), 1) + 1e-6) * np.eye(k)
                out[e] = np.linalg.solve(a, ((1 + c[e]) * pp[e]) @ fixed)
            if side == 0:
                x = out
            else:
                y = out
    got, want = X @ Y.T, x @ y.T
    assert np.abs(got - want).max() / np.abs(want).max() < 5e-3
    assert got[R > 0].mean() > 2 * got[R == 0].mean()


def test_empty_rows_solve_to_zero_and_stay_finite():
    u = np.array([0, 0], np.int32)
    i = np.array([0, 1], np.int32)
    r = np.array([1.0, 2.0], np.float32)
    for implicit in (False, True):
        X, Y = als.als_train(als.prepare_als_data(u, i, r, 5, 4, 1), k=3, reg=0.1,
                             iterations=3, implicit=implicit, device="cpu")
        assert np.isfinite(X).all() and np.isfinite(Y).all()
        assert not X[1:].any() and not Y[2:].any()


def test_two_trains_are_bit_identical():
    u, i, r, n_u, n_i = ratings(seed=9)
    data = als.prepare_als_data(u, i, r, n_u, n_i, 1)
    a = als.als_train(data, k=6, reg=0.05, iterations=5, implicit=True, device="cpu")
    b = als.als_train(data, k=6, reg=0.05, iterations=5, implicit=True, device="cpu")
    assert all(np.array_equal(p, q) for p, q in zip(a, b))


def test_plan_is_csr_order_in_power_of_two_buckets():
    u, i, r, n_u, n_i = ratings(n_u=50, n_i=300, n_e=900, seed=2)
    data = als.prepare_als_data(u, i, r, n_u, n_i, 1)
    plan = als._als_device_args(data, 8, CPU)[1]
    seen_rows = []
    n_events = 0
    for bk in plan.buckets:
        d = bk.other.shape[1]
        assert d & (d - 1) == 0 and bool(((bk.n_e > d / 2) & (bk.n_e <= d)).all())
        assert torch.equal(bk.mask.sum(1), bk.n_e)
        seen_rows += bk.rows.tolist()
        n_events += int(bk.mask.sum())
        for row, other, m in zip(bk.rows.tolist(), bk.other, bk.mask):
            want = data.i_user_flat[0][(data.i_item_local[0] == row) & (data.i_mask[0] > 0)]
            np.testing.assert_array_equal(other[m > 0].numpy(), want)
    assert n_events == len(u)
    assert sorted(seen_rows) == sorted(set(i.tolist()))


def test_mesh_and_dp_above_one_name_the_roadmap():
    u, i, r, n_u, n_i = ratings()
    with pytest.raises(NotImplementedError, match="torch.distributed"):
        als.als_train(als.prepare_als_data(u, i, r, n_u, n_i, 2), k=4, reg=0.1,
                      iterations=1, device="cpu")
    with pytest.raises(NotImplementedError, match="torch.distributed"):
        als.als_train(als.prepare_als_data(u, i, r, n_u, n_i, 1), k=4, reg=0.1,
                      iterations=1, mesh=object(), device="cpu")


# -- the e-commerce rule serving ops --------------------------------------------


def rule_case(seed, b=5, n_items=300, k=8, n_cats=6):
    rng = np.random.default_rng(seed)
    items = rng.normal(size=(n_items, k)).astype(np.float32)
    items[7] = items[11]                                    # a planted tie
    vecs = rng.normal(size=(b, k)).astype(np.float32)
    cats = rng.random((n_cats, n_items)) < 0.3
    rows = []
    for j in range(b):
        cat = list(rng.choice(n_cats, int(rng.integers(0, 3)), replace=False))
        white = list(rng.choice(n_items, int(rng.integers(0, 2)) * 60, replace=False))
        excl = list(rng.choice(n_items, int(rng.integers(0, 20)), replace=False))
        if j == 1:
            excl += [n_items + 5]                           # outside the catalog
            white += [n_items + 9] if white else []
        rows.append((cat, white, excl))
    return items, vecs, cats, rows


def assert_same_topk(got, want, scores):
    """[.., 2, k]: ids equal except where two scores tie within the bar."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got[..., 0, :], want[..., 0, :], rtol=1e-5, atol=1e-6)
    ids_g, ids_w = got[..., 1, :].astype(int), want[..., 1, :].astype(int)
    for pos in zip(*np.nonzero(ids_g != ids_w)):
        row = scores[pos[0]] if scores.ndim == 2 else scores
        assert abs(row[ids_g[pos]] - row[ids_w[pos]]) <= 1e-5 * abs(row[ids_w[pos]]) + 1e-6


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rule_ops_match_jax(seed):
    items, vecs, cats, rows = rule_case(seed)
    pad = [als.pad_id_rows([r[j] for r in rows]) for j in range(3)]
    for j in range(3):
        np.testing.assert_array_equal(pad[j], jax_als.pad_id_rows([r[j] for r in rows]))
    t_items, t_cats = torch.as_tensor(items), torch.as_tensor(cats)
    scores = vecs @ items.T
    got = als.recommend_batch_rules(torch.as_tensor(vecs), t_items, t_cats, *pad, 16)
    want = jax_als.recommend_batch_rules(jnp.asarray(vecs), jnp.asarray(items),
                                         jnp.asarray(cats), *map(jnp.asarray, pad), 16)
    assert got.shape == (len(rows), 2, 16)
    assert_same_topk(got.numpy(), want, scores)
    got = als.scores_rules_topk_batch(torch.as_tensor(scores), t_cats, *pad, 16)
    want = jax_als.scores_rules_topk_batch(jnp.asarray(scores), jnp.asarray(cats),
                                           *map(jnp.asarray, pad), 16)
    assert_same_topk(got.numpy(), want, scores)
    for b, (cat, white, excl) in enumerate(rows):
        ids = [als.pad_ids(x) for x in (cat, white, excl)]
        got = als.recommend_scores_rules(torch.as_tensor(vecs[b]), t_items, t_cats, *ids, 8)
        want = jax_als.recommend_scores_rules(jnp.asarray(vecs[b]), jnp.asarray(items),
                                              jnp.asarray(cats), *ids, 8)
        assert_same_topk(got.numpy(), want, scores[b])
        got = als.scores_rules_topk(torch.as_tensor(scores[b]), t_cats, *ids, 8)
        want = jax_als.scores_rules_topk(jnp.asarray(scores[b]), jnp.asarray(cats), *ids, 8)
        assert_same_topk(got.numpy(), want, scores[b])


def test_rule_ops_break_ties_by_the_lower_item_id():
    items = np.ones((6, 2), np.float32)
    cats = np.zeros((1, 6), bool)
    none = als.pad_ids([])
    got = als.recommend_scores_rules(torch.ones(2), torch.as_tensor(items),
                                     torch.as_tensor(cats), none, none,
                                     als.pad_ids([2]), 4).numpy()
    assert got[1].tolist() == [0, 1, 3, 4]
    got = als.recommend_scores_rules(torch.ones(2), torch.as_tensor(items),
                                     torch.as_tensor(cats), none, als.pad_ids([5, 1]),
                                     none, 4).numpy()
    assert got[1, :2].tolist() == [1, 5] and np.isinf(got[0, 2:]).all()
