"""``models/spectral.py`` of the torch port against the JAX package.

The JAX fit draws its Krylov start block and its k-means++ seeds from
``jax.random``; the tests feed the JAX start block into the port's
``block_lanczos_svd`` (``V1=``) and the JAX k-means++ centers into the
port's Lloyd (``kmeans._lloyd``). From the same start, the spectral
embedding agrees within 1e-5 of the largest |entry| and the labels are
equal; whole fits (each package's own k-means++) give the same partition
(ARI 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from single_algebra_tpu.linalg import block_lanczos as jbl
from single_algebra_tpu.models import SpectralClustering as JSpectral
from single_algebra_tpu.models import kmeans as jkm
from single_algebra_tpu_torch.linalg import block_lanczos as tbl
from single_algebra_tpu_torch.metrics import adjusted_rand_index
from single_algebra_tpu_torch.models import SpectralClustering, SpectralClusteringBuilder
from single_algebra_tpu_torch.models import kmeans as tkm
from single_algebra_tpu_torch.models import spectral as tsp
from tests.test_spectral import blobs, two_moons


def jax_V1(seed, p, b):
    key = jax.random.PRNGKey(jnp.asarray(seed, jnp.uint32))
    return np.array(jnp.linalg.qr(jax.random.normal(key, (p, b), dtype=jnp.float32))[0])


def feed_jax_start(monkeypatch):
    """The port's block Lanczos starts from the JAX package's block."""

    real = tbl.block_lanczos_svd

    def start_from_jax(op, k, block_size=8, steps=None, seed=42, **kw):
        V1 = torch.from_numpy(jax_V1(seed, op.shape[1], block_size)).to(op.device)
        return real(op, k, block_size=block_size, steps=steps, seed=seed, V1=V1, **kw)

    monkeypatch.setattr(tbl, "block_lanczos_svd", start_from_jax)


def sin_to_truth(U, W, k):
    """Largest principal-angle sine between span(U) and the float64 top-k
    eigenspace of I + D^-1/2 W D^-1/2."""

    s = 1.0 / np.sqrt(W.sum(axis=1))
    _, vec = np.linalg.eigh(np.eye(len(s)) + s[:, None] * W * s[None, :])
    T = vec[:, -k:]
    Q, _ = np.linalg.qr(np.asarray(U, np.float64))
    return float(np.linalg.norm(T - Q @ (Q.T @ T), 2))


@pytest.mark.parametrize("data", ["moons", "blobs"])
def test_spectral_embedding_from_the_jax_start_matches_jax(data, monkeypatch):
    """Both graphs have k components: the top eigenvalue 2 of I + M is
    k-fold, and any basis of its eigenspace is the answer. So the test
    holds the eigenvalues within 1e-5 of JAX's, the eigenspace within
    1e-4 (sine) of the float64 truth and no further from it than JAX's,
    the embedding to JAX's up to a rotation of the multiplet, and the
    partition."""

    X, y = two_moons() if data == "moons" else blobs()
    k = 2 if data == "moons" else 4
    feed_jax_start(monkeypatch)
    solves = {}
    real_t, real_j = tbl.block_lanczos_svd, jbl.block_lanczos_svd
    monkeypatch.setattr(tbl, "block_lanczos_svd",
                        lambda *a, **kw: solves.setdefault("t", real_t(*a, **kw)))
    import single_algebra_tpu.linalg as jlinalg

    monkeypatch.setattr(jlinalg, "block_lanczos_svd",
                        lambda *a, **kw: solves.setdefault("j", real_j(*a, **kw)))
    got = SpectralClustering(k, n_neighbors=10, random_seed=3, device="cpu").fit(X)
    want = JSpectral(k, n_neighbors=10, random_seed=3).fit(X)
    np.testing.assert_allclose(solves["t"].s.numpy(), np.asarray(solves["j"].s), rtol=1e-5)
    W = got.affinity_matrix_.to_scipy().toarray().astype(np.float64)
    np.testing.assert_array_equal(W, want.affinity_matrix_.to_scipy().toarray())
    ours = sin_to_truth(solves["t"].u.numpy(), W, k)
    assert ours <= 1e-4 and ours <= sin_to_truth(np.asarray(solves["j"].u), W, k)
    mt, mj = got.maps_.astype(np.float64), np.asarray(want.maps_, np.float64)
    R = np.linalg.lstsq(mj, mt, rcond=None)[0]  # the multiplet's rotation
    assert np.abs(mj @ R - mt).max() <= 1e-4
    assert adjusted_rand_index(got.labels_, np.asarray(want.labels_)) == 1.0
    assert adjusted_rand_index(got.labels_, y) > 0.95


def test_lloyd_on_the_embedding_from_the_jax_centers(monkeypatch):
    X, _ = blobs(seed=4)
    feed_jax_start(monkeypatch)
    maps = SpectralClustering(4, n_neighbors=10, device="cpu").fit(X).maps_.astype(np.float32)
    jX = jnp.asarray(maps)
    x2 = jkm._row_sq_norms(jX).astype(jnp.float32)
    w = jnp.ones((len(maps),), jnp.float32)
    tol2 = jkm.KMeans(4)._tol2(jX)
    key = jax.random.PRNGKey(7)
    C0 = np.array(jkm._plusplus_init(key, jX, x2, w, 4))
    jout = jkm._fit_one(jX, x2, tol2, key, w, k=4, max_iter=300)
    Xt = torch.from_numpy(maps)
    got = tkm._lloyd(Xt, tkm._row_sq_norms(Xt), float(tol2), torch.from_numpy(C0),
                     torch.ones(len(maps)), k=4, max_iter=300)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(jout[1]))


def test_shifted_operator_is_symmetric_psd():
    X, _ = blobs(n=120, seed=5)
    sc = SpectralClustering(3, n_neighbors=8, device="cpu")
    w = sc._affinity(torch.from_numpy(X))
    deg = w.sum_row().numpy().astype(np.float64)
    op = tsp._ShiftedNormalizedAffinity(w, tsp._inv_sqrt(deg, "cpu"))
    V = torch.randn(120, 5, generator=torch.Generator().manual_seed(0))
    M = op.mv(torch.eye(120)).numpy()
    assert np.abs(M - M.T).max() <= 1e-6
    assert np.linalg.eigvalsh(M.astype(np.float64)).min() >= -1e-5
    assert op.rmv is op.mv or torch.equal(op.rmv(V), op.mv(V))
    assert op.dtype == torch.float32 and op.shape == (120, 120)


def test_builder_and_validation():
    sc = (SpectralClusteringBuilder().n_clusters(3).n_neighbors(7).n_init(2).random_seed(1)
          .lanczos_steps(60).lanczos_block(6).device("cpu").build())
    assert (sc.n_clusters, sc.n_neighbors, sc.n_init, sc.random_seed, sc.lanczos_steps,
            sc.lanczos_block, sc.device) == (3, 7, 2, 1, 60, 6, "cpu")
    X, y = blobs(n=150, k=3, seed=6)
    assert adjusted_rand_index(sc.fit_predict(X), y) == 1.0
    with pytest.raises(ValueError, match=">= 2"):
        SpectralClustering(1)
    with pytest.raises(ValueError, match="exceeds n_samples"):
        SpectralClustering(5, n_neighbors=2, device="cpu").fit(X[:4])
    with pytest.raises(ValueError, match="n-1"):
        SpectralClustering(2, n_neighbors=10, device="cpu").fit(X[:6])
