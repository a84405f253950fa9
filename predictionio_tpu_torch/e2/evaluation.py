"""Cross-validation helpers (reference: e2/.../evaluation/CrossValidation —
splits an RDD into k folds of (training, testing)).

Counterpart of ``predictionio_tpu/e2/evaluation.py`` (a copy: the same
seed gives the same folds)."""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple, TypeVar

import numpy as np

T = TypeVar("T")


def k_fold_split(
    data: Sequence[T], k: int, seed: int = 0
) -> Iterator[Tuple[List[T], List[T]]]:
    """Yield (training, testing) per fold; fold assignment is uniform random
    like the reference's `zipWithUniqueId % k`."""
    if k < 2:
        raise ValueError("k must be >= 2")
    rng = np.random.default_rng(seed)
    fold_of = rng.integers(0, k, size=len(data))
    for f in range(k):
        train = [d for d, g in zip(data, fold_of) if g != f]
        test = [d for d, g in zip(data, fold_of) if g == f]
        yield train, test
