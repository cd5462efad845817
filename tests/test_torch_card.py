"""The port's default device on a card: a scipy matrix handed to
``SparsePCA.fit_transform`` with no device goes to the card and runs there.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_card.py -m requires_cuda
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from single_algebra_tpu_torch import SparseMatrix, SparsePCABuilder
from single_algebra_tpu_torch.linalg.gram import GramPCAEngine
from single_algebra_tpu_torch.models import pca as tpca
from single_algebra_tpu_torch.ops import cuda_lib
from single_algebra_tpu_torch.types import PowerIterationNormalizer as PIN
from single_algebra_tpu_torch.types import SVDMethod


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the default fit runs there")
    return torch.device("cuda")


def clustered_counts(n, p, seed):
    """Poisson counts around 8 cluster centres (a gapped spectrum)."""

    rng = np.random.default_rng(seed)
    lam = rng.gamma(2.0, 1.0, (8, p)) * (rng.random((8, p)) < 0.5)
    return sp.csr_matrix(rng.poisson(lam[rng.integers(0, 8, n)]).astype(np.float32))


@pytest.mark.requires_cuda
def test_cuda_default_fit_runs_on_the_card(cuda, monkeypatch):
    """'auto' on a default-device scipy input: this small matrix's dense
    form fits, so it takes the densified engine on the card; with the dense
    budget at 0 it takes the Gram engine there, through the densify kernel.
    Both give the CPU Gram engine's explained variances."""

    X = clustered_counts(600, 140, seed=3)
    ref = (SparsePCABuilder().n_components(3).engine("gram")
           .svd_method(SVDMethod.random(10, 7, PIN.QR)).build())
    ref.fit(SparseMatrix.from_scipy(X, device="cpu"))
    pca = (SparsePCABuilder().n_components(3)
           .svd_method(SVDMethod.random(10, 7, PIN.QR)).build())
    m = SparseMatrix.from_scipy(X)
    T = pca.fit_transform(m)
    assert isinstance(m._operator_cache["auto"], tpca.DensifiedOperator)
    assert T.device.type == "cuda" and tuple(T.shape) == (600, 3)
    np.testing.assert_allclose(np.asarray(pca.explained_variance_),
                               np.asarray(ref.explained_variance_), rtol=1e-4)
    monkeypatch.setattr(tpca.DensifiedOperator, "hbm_budget_bytes",
                        staticmethod(lambda device: 0))
    cuda_lib.reset_launch_counts()
    m = SparseMatrix.from_scipy(X)
    T = pca.fit_transform(m)
    assert isinstance(m._operator_cache["auto"], GramPCAEngine)
    assert T.device.type == "cuda" and tuple(T.shape) == (600, 3)
    assert bool(torch.isfinite(T).all())
    assert cuda_lib.launch_counts["tiled_ell_densify_t"] > 0
    np.testing.assert_allclose(np.asarray(pca.explained_variance_),
                               np.asarray(ref.explained_variance_), rtol=1e-4)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("engine", ["auto", "tiled"])
@pytest.mark.parametrize("block", [None, 8])
def test_cuda_builder_defaults_run_on_the_card(cuda, engine, block):
    """``SparsePCABuilder``'s defaults (Lanczos, adaptive) and ``lanczos_block`` on
    the card: 'auto' (the densified engine, cuBLAS bf16 products) and the
    tiled engine (its two kernels at one operand column or block) give the
    uncentered singular values of the matrix to 1e-4 of the largest."""

    X = clustered_counts(2048, 300, seed=4)
    pca = SparsePCABuilder().n_components(4).engine(engine).lanczos_block(block).build()
    cuda_lib.reset_launch_counts()
    T = pca.fit_transform(X)
    assert T.device.type == "cuda" and tuple(T.shape) == (2048, 4)
    if engine == "tiled":
        assert cuda_lib.launch_counts["tiled_ell_spmm_t"] > 0
        assert cuda_lib.launch_counts["tiled_ell_rmv_t"] > 0
    s = np.linalg.svd(X.toarray().astype(np.float64), compute_uv=False)[:4]
    ev = np.asarray(pca.explained_variance_, np.float64)
    assert np.abs(ev - s**2 / 2047).max() <= 1e-4 * ev[0]


@pytest.mark.requires_cuda
def test_cuda_dense_routes_identical(cuda):
    """Host densify + upload and the scatter on the card give one payload,
    with a lo half for values that are not bf16-exact."""

    X = clustered_counts(1000, 200, seed=5)
    X.data *= np.float32(1.2345)
    m = SparseMatrix.from_scipy(X)
    host = tpca.DensifiedOperator.from_matrix(m, device=False)
    dev = tpca.DensifiedOperator.from_matrix(m, device=True)
    assert host.hi.device.type == dev.hi.device.type == "cuda"
    assert torch.equal(host.hi.view(torch.int16), dev.hi.view(torch.int16))
    assert torch.equal(host.lo.view(torch.int16), dev.lo.view(torch.int16))
    assert bool((dev.lo != 0).any())
    B = torch.randn((200, 5), device=cuda)
    got = dev.mv_precise(B).double()
    # against the payload's own float64 product: the operand split and the
    # float32 accumulation; against the matrix: the payload's 16 bits a value
    ref = (dev.hi.double() + dev.lo.double()) @ B.double()
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-6
    exact = torch.from_numpy(X.toarray()).to(cuda).double() @ B.double()
    assert float((got - exact).abs().max() / exact.abs().max()) <= 2e-5


@pytest.mark.requires_cuda
def test_cuda_pipeline_runs_on_the_card(cuda, monkeypatch):
    """The reference crate's pipeline on a default-device matrix: the
    statistics and maps stay on the card, the masked fit of the
    log-normalized values takes the Gram engine's float32 tier (float32
    densify slabs), and every engine gives the CPU gather engine's model."""

    from single_algebra_tpu_torch import Direction, MaskedSparsePCABuilder

    X = clustered_counts(3000, 400, seed=6)
    m = SparseMatrix.from_scipy(X)
    m.transpose()  # both layouts: the maps apply to both
    Xl = m.normalize(m.sum_row(), 1e4, Direction.ROW).log1p_normalize()
    var = Xl.var_col()
    assert var.device.type == "cuda" and Xl.ell_data.device.type == "cuda"
    mask = np.zeros(400, bool)
    mask[var.topk(120).indices.cpu().numpy()] = True
    host = sp.csr_matrix((Xl._csr_data_host(), X.indices, X.indptr), shape=X.shape)
    ref = MaskedSparsePCABuilder().mask(mask).n_components(4).engine("sparse").build()
    ref.fit(SparseMatrix.from_scipy(host, device="cpu"))
    evr = np.asarray(ref.explained_variance_, np.float64)
    monkeypatch.setattr(tpca.DensifiedOperator, "hbm_budget_bytes",
                        staticmethod(lambda device: 0))
    cuda_lib.reset_launch_counts()
    pca = MaskedSparsePCABuilder().mask(mask).n_components(4).build()
    T = pca.fit_transform(Xl)
    eng = Xl._operator_cache["auto"]
    assert isinstance(eng, GramPCAEngine) and not eng.meta[3] and not eng.meta[4]
    assert set(cuda_lib.densify_launches_by_dtype) == {"float32"}
    assert T.device.type == "cuda" and tuple(T.shape) == (3000, 4)
    assert np.abs(np.asarray(pca.explained_variance_) - evr).max() <= 1e-4 * evr[0]
    for engine in ("sparse", "tiled", "dense"):
        other = MaskedSparsePCABuilder().mask(mask).n_components(4).engine(engine).build()
        other.fit(Xl)
        assert np.abs(np.asarray(other.explained_variance_) - evr).max() <= 1e-4 * evr[0]
