"""The threaded planted-cluster draw."""

import numpy as np

from portbench.datagen import cluster_counts


def test_density_integers_and_order():
    X = cluster_counts(20_000, 3_000, seed=2**31 + 3)
    assert 0.0095 <= X.nnz / (20_000 * 3_000) <= 0.0101
    assert X.data.dtype == np.float32
    assert np.all(X.data == np.round(X.data)) and X.data.min() >= 1 and X.data.max() <= 127
    Y = X.copy()
    Y.sum_duplicates()
    Y.sort_indices()
    assert Y.nnz == X.nnz and (Y != X).nnz == 0


def test_same_seed_same_matrix_whatever_the_threads():
    a = cluster_counts(5_000, 700, seed=11, threads=1)
    b = cluster_counts(5_000, 700, seed=11, threads=4)
    c = cluster_counts(5_000, 700, seed=12, threads=4)
    assert (a != b).nnz == 0
    assert a.nnz != c.nnz or (a != c).nnz > 0
