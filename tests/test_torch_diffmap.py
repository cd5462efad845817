"""``models/diffmap.py`` of the torch port against the JAX package.

From the same graph and the JAX start block (fed to the port's
``block_lanczos_svd`` through ``V1=``), the eigenvalues agree within
1e-5; the sign-fixed eigenvectors lie within 1e-5 of the largest |entry|
of the float64 ``eigh`` and within 1e-5 of JAX's beyond JAX's own
distance to it (the JAX CPU solve is up to 3.7e-6 from float64, the
port's 2-6e-7); pseudotime is host float64 on the same result. From a dense
embedding each package builds its own fuzzy graph (float32 kNN; the
smooth-kNN calibration carries its rounding), held within 1e-3.
"""

import importlib

import numpy as np
import pytest
import torch

from single_algebra_tpu_torch import SparseMatrix
from single_algebra_tpu_torch.linalg import block_lanczos as tbl
from single_algebra_tpu_torch.models import DiffMapResult, diffmap, diffusion_pseudotime
from tests.test_diffmap import _dense_transition, _graph
from tests.test_torch_spectral import jax_V1

jdm = importlib.import_module("single_algebra_tpu.models.diffmap")


@pytest.fixture
def jax_start(monkeypatch):
    real = tbl.block_lanczos_svd

    def start_from_jax(op, k, block_size=8, steps=None, seed=42, **kw):
        V1 = torch.from_numpy(jax_V1(seed, op.shape[1], block_size)).to(op.device)
        return real(op, k, block_size=block_size, steps=steps, seed=seed, V1=V1, **kw)

    monkeypatch.setattr(tbl, "block_lanczos_svd", start_from_jax)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("as_matrix", [False, True])
def test_diffmap_from_the_jax_start_matches_jax(seed, as_matrix, jax_start):
    W, _ = _graph(seed=seed)
    data = SparseMatrix.from_scipy(W, device="cpu") if as_matrix else W
    got = diffmap(data, n_comps=6, seed=seed, device="cpu")
    want = jdm.diffmap(W, n_comps=6, seed=seed)
    assert isinstance(got, DiffMapResult)
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues, atol=1e-5)
    evals, evecs = np.linalg.eigh(_dense_transition(W))
    truth = evecs[:, ::-1][:, :6]
    truth = truth * np.sign((truth * got.embedding).sum(axis=0))[None, :]
    scale = np.abs(want.embedding).max()
    # the port's float32 solve is 2-6e-7 from the float64 eigenvectors, the
    # JAX package's CPU solve up to 3.7e-6: held to 1e-5 of JAX beyond it
    ours = np.abs(got.embedding - truth).max()
    assert ours <= 1e-5 * scale
    jax_err = np.abs(want.embedding - truth).max()
    assert np.abs(got.embedding - want.embedding).max() <= 1e-5 * scale + jax_err
    np.testing.assert_allclose(got.eigenvalues, evals[::-1][:6], atol=2e-4)
    assert abs(got.eigenvalues[0] - 1.0) < 1e-4
    for root in (0, 17):
        for n_dcs in (None, 4):
            np.testing.assert_allclose(
                diffusion_pseudotime(got, root, n_dcs=n_dcs),
                jdm.diffusion_pseudotime(want, root, n_dcs=n_dcs), atol=1e-4)


def test_diffmap_from_a_dense_embedding_matches_jax(jax_start):
    _, X = _graph(seed=1)
    got = diffmap(X, n_comps=4, n_neighbors=10, seed=0, device="cpu")
    want = jdm.diffmap(X, n_comps=4, n_neighbors=10, seed=0)
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues, atol=1e-3)
    assert got.embedding.shape == (120, 4) and (np.diff(got.eigenvalues) <= 1e-9).all()
    tgot = diffmap(torch.from_numpy(X), n_comps=4, n_neighbors=10, seed=0)
    np.testing.assert_array_equal(tgot.embedding, got.embedding)


def test_pseudotime_orders_a_trajectory():
    rng = np.random.default_rng(2)
    t = np.sort(rng.random(200))
    X = np.stack([10 * t, np.zeros(200)], 1) + rng.normal(0, 0.05, (200, 2))
    res = diffmap(X.astype(np.float32), n_comps=4, n_neighbors=10, seed=0, device="cpu")
    dpt = diffusion_pseudotime(res, int(np.argmin(t)))
    assert np.corrcoef(dpt, t)[0, 1] > 0.95 and dpt.max() == 1.0


def test_validation():
    W, _ = _graph(n=100)
    with pytest.raises(ValueError, match="n_comps"):
        diffmap(W, n_comps=1, device="cpu")
    with pytest.raises(ValueError, match="square"):
        diffmap(W[:, :20], device="cpu")
    res = diffmap(W, n_comps=3, device="cpu")
    with pytest.raises(ValueError, match="root"):
        diffusion_pseudotime(res, 100)
    assert "DiffMapResult(n=100" in repr(res)


def test_a_krylov_budget_past_the_graph_is_capped():
    # 30 nodes, block 5, lanczos_steps 100: 20 block steps would span 100
    # directions of a 30-dimensional space. The port caps the block steps
    # at ceil(30 / 5); the JAX reference keeps the fault (its eigenvalues
    # are not finite there)
    W, _ = _graph(n=30, seed=0)
    got = diffmap(W, n_comps=3, seed=0, lanczos_steps=100, device="cpu")
    evals = np.linalg.eigh(_dense_transition(W))[0][::-1]
    assert np.isfinite(got.eigenvalues).all()
    np.testing.assert_allclose(got.eigenvalues, evals[:3], rtol=0, atol=1e-6)
    want = jdm.diffmap(W, n_comps=3, seed=0, lanczos_steps=100)
    assert not np.isfinite(want.eigenvalues).all()
