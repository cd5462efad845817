"""``scoring.py`` of the torch port against the JAX package.

Both packages draw the controls with ``np.random.default_rng(seed)``, so
they pick the same genes; the scores (float32 masked row sums, host
float64 means) agree within 1e-6 of the largest |score| and the phases
are equal.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from single_algebra_tpu import SparseMatrix as JMatrix
from single_algebra_tpu import scoring as js
from single_algebra_tpu_torch import SparseMatrix, score_genes, score_genes_cell_cycle
from single_algebra_tpu_torch import scoring as ts


def lognorm(n=200, p=300, seed=0):
    rng = np.random.default_rng(seed)
    lam = rng.gamma(1.0, 1.0, p)[None, :] * np.where(rng.random((n, 1)) < 0.5, 1.0, 0.3)
    X = np.log1p(rng.poisson(lam * 2)).astype(np.float32)
    return sp.csr_matrix(X)


def rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(np.abs(np.asarray(b)).max(), 1e-300)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("ctrl_size", [5, 50])
def test_score_genes_matches_jax(seed, ctrl_size):
    X = lognorm(seed=seed)
    genes = list(range(10, 40, 3))
    got = score_genes(SparseMatrix.from_scipy(X, device="cpu"), genes, ctrl_size=ctrl_size,
                      seed=seed)
    want = js.score_genes(JMatrix.from_scipy(X), genes, ctrl_size=ctrl_size, seed=seed)
    assert got.dtype == np.float64 and got.shape == (200,)
    assert rel(got, want) <= 1e-6


def test_score_genes_by_name_and_cell_cycle_match_jax():
    X = lognorm(seed=1)
    names = np.asarray([f"G{i}" for i in range(300)])
    s_genes, g2m = [f"G{i}" for i in range(0, 30, 2)], [f"G{i}" for i in range(100, 140, 4)]
    tm, jm = SparseMatrix.from_scipy(X, device="cpu"), JMatrix.from_scipy(X)
    got = score_genes_cell_cycle(tm, s_genes, g2m, var_names=names)
    want = js.score_genes_cell_cycle(jm, s_genes, g2m, var_names=names)
    for a, b in zip(got[:2], want[:2]):
        assert rel(a, b) <= 1e-6
    np.testing.assert_array_equal(got[2], want[2])
    assert set(np.unique(got[2])) <= {"S", "G2M", "G1"}


def test_resolve_and_errors():
    np.testing.assert_array_equal(ts._resolve_genes([3, 1], None, 5), js._resolve_genes([3, 1], None, 5))
    m = SparseMatrix.from_scipy(lognorm(n=20, p=30), device="cpu")
    with pytest.raises(ValueError, match="empty"):
        score_genes(m, [])
    with pytest.raises(ValueError, match="var_names is None"):
        score_genes(m, ["a"])
    with pytest.raises(ValueError, match=r"\[0, 30\)"):
        score_genes(m, [30])
    with pytest.raises(ValueError, match="not in var_names"):
        score_genes(m, ["zz"], var_names=[f"g{i}" for i in range(30)])
