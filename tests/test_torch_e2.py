"""The port's e2 helpers against the JAX package: ``BinaryVectorizer``,
``CategoricalNaiveBayes`` (tables within 1e-6, log scores and predictions
equal), ``MarkovChain`` (the per-state top-k in ``lax.top_k``'s order,
ties included: ids equal, probabilities bit-equal) and ``k_fold_split``
(the same folds from the same seed)."""

import math

import numpy as np
import pytest

from predictionio_tpu import e2 as jax_e2
from predictionio_tpu_torch import e2


def _rows(seed, n=40):
    rng = np.random.default_rng(seed)
    return [{"color": str(rng.choice(["red", "blue", "green"])),
             "size": str(rng.integers(0, 4)), "extra": "x"} for _ in range(n)]


def test_binary_vectorizer():
    rows = _rows(1)
    got = e2.BinaryVectorizer.fit(rows, ["color", "size"])
    want = jax_e2.BinaryVectorizer.fit(rows, ["color", "size"])
    assert got.index == want.index and got.width == want.width == 7
    np.testing.assert_array_equal(got.transform_many(rows), want.transform_many(rows))
    assert got.transform_many([]).shape == (0, 7)


def _points(seed, n=120):
    rng = np.random.default_rng(seed)
    pts = []
    for _ in range(n):
        a, b = int(rng.integers(3)), int(rng.integers(4))
        label = "yes" if (a + b + rng.integers(0, 2)) % 3 == 0 else "no"
        pts.append((label, [f"a{a}", f"b{b}"]))
    return pts


@pytest.mark.parametrize("alpha", [1.0, 0.5])
def test_categorical_naive_bayes(alpha):
    pts = _points(2)
    got = e2.CategoricalNaiveBayes.train(pts, alpha)
    want = jax_e2.CategoricalNaiveBayes.train(pts, alpha)
    assert got.labels == want.labels and got.feature_values == want.feature_values
    np.testing.assert_allclose(got.prior, want.prior, rtol=1e-6)
    for g, w in zip(got.log_likelihood, want.log_likelihood):
        np.testing.assert_allclose(g, w, rtol=1e-6)
    for feats in (["a0", "b1"], ["a2", "b3"], ["a9", "b0"], ["a1", "b9"]):
        assert e2.CategoricalNaiveBayes.predict(got, feats) == \
            jax_e2.CategoricalNaiveBayes.predict(want, feats)
        np.testing.assert_array_equal(e2.CategoricalNaiveBayes.log_score(got, feats),
                                      jax_e2.CategoricalNaiveBayes.log_score(want, feats))
    assert math.isinf(e2.CategoricalNaiveBayes.log_score(got, ["a9", "b0"])[0])
    with pytest.raises(ValueError):
        e2.CategoricalNaiveBayes.train([])


@pytest.mark.parametrize("top_k", [1, 3, 8, 20])
def test_markov_chain_top_k_order(top_k):
    rng = np.random.default_rng(top_k)
    # few distinct counts a row: many tied probabilities
    trans = [(int(a), int(b)) for a, b in zip(rng.integers(0, 9, 150), rng.integers(0, 9, 150))]
    trans += [(3, j) for j in range(9)]
    got = e2.MarkovChain.train(trans, 10, top_k)
    want = jax_e2.MarkovChain.train(trans, 10, top_k)
    np.testing.assert_array_equal(got.transition_prob, want.transition_prob)
    np.testing.assert_array_equal(got.top_k_idx, want.top_k_idx)
    np.testing.assert_array_equal(got.top_k_prob, want.top_k_prob)
    assert got.top_k_idx.dtype == np.asarray(want.top_k_idx).dtype
    for s in range(10):
        assert got.next_states(s) == want.next_states(s)
    assert got.next_states(9) == []


@pytest.mark.parametrize("k, seed", [(2, 0), (5, 3)])
def test_k_fold_split(k, seed):
    data = list(range(57))
    assert list(e2.k_fold_split(data, k, seed)) == list(jax_e2.k_fold_split(data, k, seed))
    with pytest.raises(ValueError):
        next(e2.k_fold_split(data, 1))
