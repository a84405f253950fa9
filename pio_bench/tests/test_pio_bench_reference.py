"""The plain reference against a CCO worked out by hand, and its pieces
against brute force on small random data."""

import math

import numpy as np
import pytest

from pio_bench import reference


def xlogx(x):
    return x * math.log(x) if x > 0 else 0.0


def entropy(*xs):
    return xlogx(sum(xs)) - sum(xlogx(x) for x in xs)


def mahout_llr(k11, k12, k21, k22):
    """Mahout's ``LogLikelihood.logLikelihoodRatio``, in its entropy form."""
    row = entropy(k11 + k12, k21 + k22)
    col = entropy(k11 + k21, k12 + k22)
    mat = entropy(k11, k12, k21, k22)
    return max(0.0, 2.0 * (row + col - mat))


def test_g2_is_mahouts_llr():
    assert mahout_llr(1, 0, 0, 1) == pytest.approx(2.772588722239781, rel=1e-15)
    tables = [(1, 0, 0, 1), (10, 0, 0, 10), (5, 1995, 0, 100000), (1000, 1995, 1000, 100000),
              (2, 1, 0, 1), (3, 7, 11, 400), (1, 5, 5, 25)]
    for t in tables:
        n = sum(t)
        g = reference.g2([t[0]], [t[0] + t[1]], [t[0] + t[2]], n).item()
        assert g == pytest.approx(mahout_llr(*t), rel=1e-9, abs=1e-11)


# users 0..3; primary items 0..2 (one pair twice); other items 0..1
P = [(0, 0), (0, 1), (1, 0), (2, 1), (2, 2), (3, 0), (3, 2), (0, 0)]
A = [(0, 0), (1, 0), (1, 1), (2, 1)]


def pairs(ev, n_items):
    u, i = (np.array(x, np.int32) for x in zip(*ev))
    return reference.Pairs(u, i, 4, n_items)


def test_a_cco_worked_by_hand():
    p, a = pairs(P, 3), pairs(A, 2)
    # item 0 is held by users 0, 1 and 3; other item 0 by users 0, 1 and
    # other item 1 by users 1, 2
    assert [list(r) for r in reference.count_rows(p, a, [0, 1, 2])] == [[2, 1], [1, 1], [0, 1]]
    rows = reference.indicator_rows(p, a, [0, 1, 2], 4, 2, 0.0, False)
    # row 0: tables (2, 1, 0, 1) and (1, 2, 1, 0) score alike, so item 0 first
    assert list(rows[0].top_ids) == [0, 1]
    assert rows[0].top_scores == pytest.approx([mahout_llr(2, 1, 0, 1)] * 2, rel=1e-12)
    assert mahout_llr(2, 1, 0, 1) == pytest.approx(2 * (2 * math.log(4 / 3)
                                                       + math.log(2 / 3) + math.log(2)))
    # row 2 (users 2, 3): only other item 1 (user 2) co-occurs
    assert list(rows[2].top_ids) == [1]
    assert rows[2].top_scores[0] == pytest.approx(mahout_llr(1, 1, 1, 1), abs=1e-12)
    assert rows[2].score_of(np.array([0, 1]))[0] == -np.inf
    # the self-indicator leaves each row's own item out
    own = reference.indicator_rows(p, p, [0, 1, 2], 4, 3, 0.0, True)
    assert list(own[0].top_ids) == [1, 2] or list(own[0].top_ids) == [2, 1]
    assert 0 not in own[0].top_ids and 2 not in own[2].top_ids
    assert list(reference.nonempty_rows(p, a, False)) == [True, True, True]


def test_pieces_against_brute_force():
    g = np.random.default_rng(3)
    users, items = 60, 40
    pu, pi = g.integers(0, users, 400), g.integers(0, items, 400)
    au, ai = g.integers(0, users, 500), g.integers(0, items, 500)
    p = reference.Pairs(pu, pi, users, items)
    a = reference.Pairs(au, ai, users, items)
    dp = np.zeros((users, items), np.int64)
    da = np.zeros((users, items), np.int64)
    dp[pu, pi] = 1
    da[au, ai] = 1
    counts = dp.T @ da
    rows = list(range(items))
    assert np.array_equal(np.stack(reference.count_rows(p, a, rows)), counts)
    selfc = dp.T @ dp
    np.fill_diagonal(selfc, 0)
    assert np.array_equal(reference.nonempty_rows(p, p, True), selfc.sum(1) > 0)
    assert np.array_equal(reference.nonempty_rows(p, a, False), counts.sum(1) > 0)
    assert np.array_equal(a.col, da.sum(0))
    indptr, seen = reference.seen_csr(p)
    for u in range(users):
        assert list(seen[indptr[u]:indptr[u + 1]]) == list(np.flatnonzero(dp[u]))
    ref = reference.indicator_rows(p, a, rows, users, 5, 0.0, False)
    for r in rows:
        nz = np.flatnonzero(counts[r])
        s = [mahout_llr(counts[r, j], dp[:, r].sum() - counts[r, j],
                        da[:, j].sum() - counts[r, j],
                        users - dp[:, r].sum() - da[:, j].sum() + counts[r, j]) for j in nz]
        want = sorted(zip(s, nz), key=lambda t: (-t[0], t[1]))[:5]
        assert ref[r].top_scores == pytest.approx([w[0] for w in want], rel=1e-10, abs=1e-10)
        got_scores = dict(zip(ref[r].cols, ref[r].scores))
        for sc, j in want:
            assert got_scores[j] == pytest.approx(sc, rel=1e-10, abs=1e-10)


def test_popularity_counts_the_window_that_ends_at_the_newest_event():
    item = np.array([0, 1, 1, 2, 2, 2])
    time = np.array([0.0, 50.0, 99.0, 100.0, 1.0, 100.0])
    assert list(reference.popularity(item, time, 4, 60.0)) == [0, 2, 2, 0]
