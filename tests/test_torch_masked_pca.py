"""``MaskedSparsePCA`` of the torch port against the JAX package's, on every
engine (the gather, densified, Gram and tiled) with the randomized, Lanczos
and block-Lanczos methods.

Each package draws its own sketch / start vector, so, as in the Lanczos
tests of ``tests/test_torch_pca.py``, explained variances are held to 1e-4
of the largest and scores to 1e-3 x max |JAX scores|; the mean and total
variance (host float64 bookkeeping in both) to 1e-6 relative.
"""

import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import single_algebra_tpu.models as jmodels
from single_algebra_tpu import SparseMatrix as JMatrix
from single_algebra_tpu.types import PowerIterationNormalizer as JPIN
from single_algebra_tpu.types import SVDMethod as JSVD
from single_algebra_tpu_torch import (
    MaskedSparsePCA,
    MaskedSparsePCABuilder,
    SparseMatrix,
    SparsePCABuilder,
)
from single_algebra_tpu_torch.linalg import GramPCAEngine, MaskedOperator
from single_algebra_tpu_torch.types import PowerIterationNormalizer as PIN
from single_algebra_tpu_torch.types import SVDMethod
from tests.conftest import cluster_counts

K = 4


@pytest.fixture(scope="module")
def counts():
    return cluster_counts(500, 120, n_clusters=8, seed=7).astype(np.float32)


@pytest.fixture(scope="module")
def mask():
    m = np.zeros(120, bool)
    m[np.random.default_rng(2).choice(120, 70, replace=False)] = True
    return m


METHODS = {
    "randomized": (lambda b: b.svd_method(SVDMethod.random(10, 7, PIN.QR)),
                   lambda b: b.svd_method(JSVD.random(10, 7, JPIN.QR))),
    "lanczos": (lambda b: b, lambda b: b),
    "lanczos_block": (lambda b: b.lanczos_block(4), lambda b: b.lanczos_block(4)),
}


def fit_both(X, mask, engine, method, center=True):
    tb, jb = METHODS[method]
    tp = tb(MaskedSparsePCABuilder().mask(mask).n_components(K).center(center)
            .engine(engine)).build()
    jp = jb(jmodels.MaskedSparsePCABuilder().mask(mask).n_components(K).center(center)
            .engine(engine)).build()
    with warnings.catch_warnings():  # the Gram engine ignores lanczos_block, and says so
        warnings.simplefilter("ignore", UserWarning)
        T = tp.fit_transform(SparseMatrix.from_scipy(X, device="cpu")).numpy()
        Tj = np.asarray(jp.fit_transform(JMatrix.from_scipy(X)))
    return tp, T, jp, Tj


def assert_match(tp, T, jp, Tj):
    evj = np.asarray(jp.explained_variance_, np.float64)
    assert np.abs(tp.explained_variance_ - evj).max() <= 1e-4 * evj[0]
    assert T.shape == Tj.shape and np.isfinite(T).all()
    assert np.abs(T - Tj).max() <= 1e-3 * np.abs(Tj).max()
    np.testing.assert_allclose(tp.mean_, np.asarray(jp.mean_), rtol=1e-6)
    assert tp.mean_.shape == (120,)  # full width
    assert tp.components_.shape == (K, 70)
    if jp.total_variance_ is not None:
        assert tp.total_variance_ == pytest.approx(jp.total_variance_, rel=1e-6)


@pytest.mark.parametrize("engine", ["sparse", "dense", "gram", "tiled"])
@pytest.mark.parametrize("method", sorted(METHODS))
def test_masked_pca_matches_jax(counts, mask, engine, method):
    assert_match(*fit_both(counts, mask, engine, method))


def test_uncentered(counts, mask):
    tp, T, jp, Tj = fit_both(counts, mask, "gram", "randomized", center=False)
    assert_match(tp, T, jp, Tj)
    assert not tp.mean_.any()


def test_gram_engine_takes_the_masked_submatrix(counts, mask):
    """On the Gram engine the masked fit solves the masked submatrix of the
    cached full Gram: the model equals PCA of the physically sliced
    matrix (same engine, same arithmetic) and the Gram is built once."""

    m = SparseMatrix.from_scipy(counts, device="cpu")
    mp = MaskedSparsePCABuilder().mask(mask).n_components(K).engine("gram").build()
    T = mp.fit_transform(m).numpy()
    eng = m._operator_cache["gram"]
    assert isinstance(eng, GramPCAEngine)
    G = eng.gram_cached()
    mp.fit(m)
    assert eng.gram_cached() is G
    sp_ = SparsePCABuilder().n_components(K).engine("gram").build()
    Ts = sp_.fit_transform(SparseMatrix.from_scipy(counts[:, mask], device="cpu")).numpy()
    np.testing.assert_allclose(mp.explained_variance_, sp_.explained_variance_, rtol=1e-5)
    np.testing.assert_allclose(mp.mean_[mask], sp_.mean_, rtol=1e-6)
    assert mp.total_variance_ == pytest.approx(sp_.total_variance_, rel=1e-6)
    assert np.abs(T - Ts).max() <= 1e-4 * np.abs(Ts).max()


@pytest.mark.parametrize("engine", ["sparse", "gram"])
@pytest.mark.parametrize("method", ["randomized", "lanczos"])
def test_an_all_true_mask_gives_the_unmasked_model(counts, engine, method):
    """Both models run one fit core: a mask over every column gives
    ``SparsePCA``'s model on the same seed and builder (components,
    explained variance, scores to 1e-6 of the largest; mean and total
    variance)."""

    setup = METHODS[method][0]
    mp = setup(MaskedSparsePCABuilder().mask(np.ones(120, bool)).n_components(K)
               .engine(engine)).build()
    sp_ = setup(SparsePCABuilder().n_components(K).engine(engine)).build()
    Tm = mp.fit_transform(SparseMatrix.from_scipy(counts, device="cpu")).numpy()
    Ts = sp_.fit_transform(SparseMatrix.from_scipy(counts, device="cpu")).numpy()
    pairs = {"components": (mp.components_.numpy(), sp_.components_.numpy()),
             "explained_variance": (mp.explained_variance_, sp_.explained_variance_),
             "scores": (Tm, Ts)}
    for name, (got, want) in pairs.items():
        assert got.shape == want.shape, name
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), name
    np.testing.assert_array_equal(mp.mean_, sp_.mean_)
    assert mp.total_variance_ == pytest.approx(sp_.total_variance_, rel=1e-6)


@pytest.mark.parametrize("engine", ["sparse", "dense"])
def test_fit_equals_pca_of_the_sliced_matrix(counts, mask, engine):
    """The Lanczos fit through ``MaskedOperator`` gives the model of the
    sliced matrix: explained variances to 1e-4 of the largest."""

    mp = MaskedSparsePCABuilder().mask(mask).n_components(K).engine(engine).build()
    mp.fit(SparseMatrix.from_scipy(counts, device="cpu"))
    sp_ = SparsePCABuilder().n_components(K).engine(engine).build()
    sp_.fit(SparseMatrix.from_scipy(counts[:, mask], device="cpu"))
    ev = np.asarray(sp_.explained_variance_, np.float64)
    assert np.abs(mp.explained_variance_ - ev).max() <= 1e-4 * ev[0]


def test_transform_and_inverse(counts, mask):
    tp, T, jp, Tj = fit_both(counts, mask, "gram", "randomized")
    T2 = tp.transform(SparseMatrix.from_scipy(counts, device="cpu")).numpy()
    assert np.abs(T2 - T).max() <= 1e-5 * np.abs(T).max()
    R = tp.inverse_transform(torch.from_numpy(T)).numpy()
    Rj = np.asarray(jp.inverse_transform(Tj))
    assert R.shape == (500, 120)
    assert np.abs(R - Rj).max() <= 1e-3 * np.abs(Rj).max()
    np.testing.assert_allclose(R[:, ~mask], np.broadcast_to(tp.mean_[~mask], (500, 50)),
                               rtol=1e-6)
    np.testing.assert_allclose(tp.explained_variance_ratio().numpy(),
                               np.asarray(jp.explained_variance_ratio()), rtol=1e-4)
    assert float(tp.cumulative_explained_variance_ratio()[-1]) == pytest.approx(1.0)
    assert tp.feature_importances().shape == (K, 70)


def test_save_load_across_packages(counts, mask, tmp_path):
    tp, T, jp, Tj = fit_both(counts, mask, "gram", "randomized")
    jp.save(str(tmp_path / "jax_model"))
    loaded = MaskedSparsePCA.load(str(tmp_path / "jax_model"), device="cpu")
    np.testing.assert_array_equal(loaded.mask, mask)
    np.testing.assert_array_equal(loaded.components_.numpy(), np.asarray(jp.components_))
    np.testing.assert_array_equal(loaded.mean_, np.asarray(jp.mean_))
    assert loaded.total_variance_ == jp.total_variance_
    loaded.engine = "gram"
    T2 = loaded.transform(SparseMatrix.from_scipy(counts, device="cpu")).numpy()
    assert np.abs(T2 - Tj).max() <= 1e-4 * np.abs(Tj).max()

    tp.save(str(tmp_path / "torch_model.npz"))
    jl = jmodels.MaskedSparsePCA.load(str(tmp_path / "torch_model.npz"))
    np.testing.assert_array_equal(jl.mask, mask)
    np.testing.assert_array_equal(np.asarray(jl.components_), tp.components_.numpy())
    assert jl.noise_variance_ == pytest.approx(tp.noise_variance_)


def test_mask_length_errors(counts, mask):
    m = SparseMatrix.from_scipy(counts, device="cpu")
    short = MaskedSparsePCABuilder().mask(mask[:-1]).n_components(K).build()
    with pytest.raises(ValueError, match="mask vector length"):
        short.fit(m)
    jshort = jmodels.MaskedSparsePCABuilder().mask(mask[:-1]).n_components(K).build()
    with pytest.raises(ValueError, match="mask vector length"):
        jshort.fit(JMatrix.from_scipy(counts))
    fitted = MaskedSparsePCABuilder().mask(mask).n_components(K).engine("gram").build().fit(m)
    with pytest.raises(ValueError, match="mask vector length"):
        fitted.transform(SparseMatrix.from_scipy(counts[:, :-1], device="cpu"))
    with pytest.raises(ValueError, match="requires a mask"):
        MaskedSparsePCABuilder().build()
    with pytest.raises(RuntimeError, match="fitted"):
        MaskedSparsePCABuilder().mask(mask).build().transform(m)


@pytest.mark.parametrize("engine", ["gram", "sparse"])
def test_fit_after_log1p_uses_the_mapped_values(counts, mask, engine):
    """A matrix whose values live on the device only (after normalize and
    log1p) is fitted on those values, not on the raw counts its host CSR
    was built from: the model equals the one fitted on the same values
    given as host data."""

    m = SparseMatrix.from_scipy(counts, device="cpu")
    from single_algebra_tpu_torch import Direction

    ml = m.normalize(m.sum_row(), 1e4, Direction.ROW).log1p_normalize()
    host = sp.csr_matrix((ml._csr_data_host(), counts.indices, counts.indptr),
                         shape=counts.shape)
    a = MaskedSparsePCABuilder().mask(mask).n_components(K).engine(engine).build()
    a.fit(ml)
    b = MaskedSparsePCABuilder().mask(mask).n_components(K).engine(engine).build()
    b.fit(SparseMatrix.from_scipy(host, device="cpu"))
    np.testing.assert_allclose(a.mean_, b.mean_, rtol=1e-6)
    ev = np.asarray(b.explained_variance_, np.float64)
    assert np.abs(a.explained_variance_ - ev).max() <= 1e-4 * ev[0]
    raw_mean = np.asarray(counts.mean(axis=0)).ravel()
    assert not np.allclose(a.mean_, raw_mean)


def test_scipy_input_goes_to_the_card_by_default(counts, mask):
    mp = MaskedSparsePCABuilder().mask(mask).n_components(K).engine("gram").build()
    if torch.cuda.is_available():
        mp.fit(counts)
        assert mp.components_.device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            mp.fit(counts)  # device defaults to "cuda": no silent CPU fallback
    mp.fit(counts, device="cpu")
    assert mp.components_.device.type == "cpu"


def test_masked_operator_is_what_non_gram_engines_solve(counts, mask, monkeypatch):
    from single_algebra_tpu_torch.models import pca as tm  # the fit core both models share

    seen = []
    orig = tm._fit_graph

    def spy(op, *a, **k):
        seen.append(op)
        return orig(op, *a, **k)

    monkeypatch.setattr(tm, "_fit_graph", spy)
    MaskedSparsePCABuilder().mask(mask).n_components(K).engine("dense").build().fit(
        SparseMatrix.from_scipy(counts, device="cpu"))
    assert isinstance(seen[0], MaskedOperator) and seen[0].shape == (500, 70)


@pytest.mark.parametrize("method", ["randomized", "lanczos"])
def test_dense_engine_float64_centered_matches_jax(counts, mask, method):
    """The masked model's centered operator over the float32 densified
    engine with a float64 mean promotes as ``jnp`` does."""

    tp, T, jp, Tj = fit_both(counts.astype(np.float64), mask, "dense", method)
    assert T.dtype == Tj.dtype == np.float64
    assert tp.components_.numpy().dtype == np.asarray(jp.components_).dtype
    assert_match(tp, T, jp, Tj)
    T2 = tp.transform(SparseMatrix.from_scipy(counts.astype(np.float64), device="cpu"))
    np.testing.assert_allclose(T2.numpy(), T, rtol=0, atol=1e-9 * np.abs(T).max())
