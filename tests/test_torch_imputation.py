"""``imputation.py`` of the torch port against the JAX package.

Both packages build the same fuzzy kNN graph from the same embedding and
diffuse every gene block t times, through the densified operator's
precise product while the [n, n] hi/lo form fits (the CPU plans as the
JAX package does, with a 9 GiB budget) and through the sparse product
otherwise (forced by a zero budget). The imputed matrices agree within
1e-5 of the largest |JAX| value.
"""

import importlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from single_algebra_tpu import SparseMatrix as JMatrix
from single_algebra_tpu.linalg.operators import DensifiedOperator as JDense
from single_algebra_tpu_torch import SparseMatrix, magic
from single_algebra_tpu_torch.linalg.operators import DensifiedOperator
from tests.test_imputation import _trajectory_counts

jimp = importlib.import_module("single_algebra_tpu.imputation")


def rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max()


@pytest.mark.parametrize("route", ["densified", "sparse"])
@pytest.mark.parametrize("sparse_input", [True, False])
def test_magic_matches_jax(route, sparse_input, monkeypatch):
    X, _, emb = _trajectory_counts(n=300, p=40, seed=4)
    if route == "sparse":
        monkeypatch.setattr(DensifiedOperator, "hbm_budget_bytes", staticmethod(lambda d: 0))
        monkeypatch.setattr(JDense, "hbm_budget_bytes", staticmethod(lambda *a: 0))
    kw = dict(embedding=emb, n_neighbors=10, t=3, block=16)
    if sparse_input:
        got = magic(SparseMatrix.from_scipy(sp.csr_matrix(X), device="cpu"), **kw)
        want = jimp.magic(JMatrix.from_scipy(sp.csr_matrix(X)), **kw)
    else:
        got = magic(X, device="cpu", **kw)
        want = jimp.magic(X, **kw)
    assert got.dtype == np.float32 and got.shape == X.shape
    assert rel(got, want) <= 1e-5


def test_magic_device_out_and_default_embedding():
    X, rates, emb = _trajectory_counts(n=200, p=12, seed=5)
    m = SparseMatrix.from_scipy(sp.csr_matrix(X), device="cpu")
    out = magic(m, embedding=emb, n_neighbors=10, t=2, block=5, device_out=True)
    assert isinstance(out, torch.Tensor) and out.shape == (200, 12)
    assert np.abs(out.numpy() - rates).mean() < np.abs(X - rates).mean()
    Xc = (rates + np.random.default_rng(5).normal(0, 0.3, rates.shape)).astype(np.float32)
    got = magic(Xc, t=1, n_neighbors=6, device="cpu")  # the graph of the rows themselves
    want = jimp.magic(Xc, t=1, n_neighbors=6)
    assert rel(got, want) <= 1e-5


def test_magic_validation():
    X, _, emb = _trajectory_counts(n=50, p=8, seed=3)
    with pytest.raises(ValueError, match="t="):
        magic(X, embedding=emb, t=0, device="cpu")
    with pytest.raises(ValueError, match="embedding rows"):
        magic(X, embedding=emb[:10], device="cpu")
