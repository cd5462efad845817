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
    form fits, so it names the unported dense engine; with the dense budget
    at 0 it takes the Gram engine on the card, through the densify kernel,
    and gives the CPU Gram engine's explained variances."""

    X = clustered_counts(600, 140, seed=3)
    pca = (SparsePCABuilder().n_components(3)
           .svd_method(SVDMethod.random(10, 7, PIN.QR)).build())
    with pytest.raises(NotImplementedError, match="'dense'.*ROADMAP"):
        pca.fit_transform(X)
    monkeypatch.setattr(tpca.DensifiedOperator, "hbm_budget_bytes",
                        staticmethod(lambda device: 0))
    cuda_lib.reset_launch_counts()
    T = pca.fit_transform(X)
    assert T.device.type == "cuda" and tuple(T.shape) == (600, 3)
    assert bool(torch.isfinite(T).all())
    assert cuda_lib.launch_counts["tiled_ell_densify_t"] > 0
    ref = (SparsePCABuilder().n_components(3).engine("gram")
           .svd_method(SVDMethod.random(10, 7, PIN.QR)).build())
    ref.fit(SparseMatrix.from_scipy(X, device="cpu"))
    np.testing.assert_allclose(np.asarray(pca.explained_variance_),
                               np.asarray(ref.explained_variance_), rtol=1e-4)
